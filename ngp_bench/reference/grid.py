"""Plain multiresolution hash grid: the exact d-linear encode, and the
stochastic-corner estimator with its table gradient.

A frozen copy of the arithmetic of the port's plain path
(`GridEncoding._encode_plain`, `_stochastic_corners`,
`_table_gradient_stochastic_plain`), kept here so that the benchmark's
reference imports nothing of the program. Float32 throughout; the table is
one flat interleaved vector (feature k of entry e at e*F + k).
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

PRIMES = (1, 2654435761, 805459861)
U32 = 0xFFFFFFFF


class Level(NamedTuple):
    scale: float     # float32-rounded
    res: int
    size: int        # rows, 8-aligned
    offset: int      # first row
    hashed: bool


class Grid:
    """The levels of a HashGrid config, derived as the port derives them
    (`derive_grid_config` + `GridEncoding.__init__`)."""

    def __init__(self, n_dims: int, cfg: dict, desired_resolution: float,
                 aabb_scale: float = 1.0):
        self.n_dims = n_dims
        self.n_levels = int(cfg.get("n_levels", 16))
        self.n_features = int(cfg.get("n_features_per_level", 2))
        log2_size = int(cfg.get("log2_hashmap_size", 19))
        base = int(cfg.get("base_resolution", 16))
        pls = float(cfg.get("per_level_scale", 0.0))
        if pls <= 0.0 and self.n_levels > 1:
            pls = math.exp(math.log(desired_resolution * aabb_scale / base)
                           / (self.n_levels - 1))
        log2_pls = math.log2(pls)
        self.exact_axes = int(cfg.get("stochastic_exact_axes", 0))
        self.one_corner_bwd = bool(cfg.get("stochastic_bwd", False))
        self.levels: List[Level] = []
        offset = 0
        for lvl in range(self.n_levels):
            s = float(np.exp2(lvl * log2_pls) * base - 1.0)
            res = int(math.ceil(s)) + 1
            dense = res ** n_dims
            size = min(dense, 1 << log2_size)
            size = (size + 7) // 8 * 8
            self.levels.append(Level(float(np.float32(s)), res, size, offset,
                                     dense > (1 << log2_size)))
            offset += size
        self.n_entries = offset
        self.n_output = self.n_levels * self.n_features

    # -- addressing ------------------------------------------------------
    def index(self, coords: torch.Tensor, lvl: int) -> torch.Tensor:
        """Integer coordinates (..., d) -> table rows (...)."""
        level = self.levels[lvl]
        if level.hashed:
            idx = (coords[..., 0] * PRIMES[0]) & U32
            for k in range(1, self.n_dims):
                idx = idx ^ ((coords[..., k] * PRIMES[k]) & U32)
        else:
            coords = coords.clamp(0, level.res - 1)
            idx, stride = coords[..., 0], 1
            for k in range(1, self.n_dims):
                stride *= level.res
                idx = idx + coords[..., k] * stride
        return idx % level.size + level.offset

    def weights(self, x: torch.Tensor, lvl: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        pos = x * self.levels[lvl].scale + 0.5
        pos0 = torch.floor(pos)
        return pos0.long(), pos - pos0

    def corners(self, device) -> torch.Tensor:
        c = np.stack(np.meshgrid(*([np.arange(2)] * self.n_dims),
                                 indexing="ij"), -1).reshape(-1, self.n_dims)
        return torch.from_numpy(c).long().to(device)

    def exact_rows(self, x: torch.Tensor, lvl: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(rows (N, 2^d), d-linear weights (N, 2^d))."""
        pos0, w = self.weights(x, lvl)
        corners = self.corners(x.device)
        rows = self.index(pos0[:, None, :] + corners[None], lvl)
        sel = corners[None] == 1
        w_sel = torch.where(sel, w[:, None, :], 1.0 - w[:, None, :])
        weight = w_sel[..., 0]
        for k in range(1, self.n_dims):
            weight = weight * w_sel[..., k]
        return rows, weight

    def stochastic_rows(self, x: torch.Tensor, lvl: int, u: torch.Tensor,
                        axis: Optional[torch.Tensor], j: int,
                        sampled_only: bool = False
                        ) -> List[Tuple[torch.Tensor, Optional[torch.Tensor]]]:
        """One level's fetched corners as (rows (N,), weight or None)."""
        d = self.n_dims
        pos0, w = self.weights(x, lvl)
        bern = (u[:, :, lvl].T < w).long()
        if j == 0 or sampled_only:
            return [(self.index(pos0 + bern, lvl), None)]
        axes = torch.arange(d, device=x.device)[None, :]
        a = axis[:, lvl].long()[:, None]
        if j == 1:
            exact = axes == a
            low = exact
        else:
            exact = axes != a
            low = torch.remainder(axes - a - 1, d) == 0
        out = []
        for combo in range(1 << j):
            e_bit = torch.where(low, combo & 1, (combo >> 1) & 1)
            bits = torch.where(exact, e_bit, bern)
            w_k = torch.where(exact, torch.where(e_bit == 1, w, 1.0 - w), 1.0)
            weight = w_k[:, 0]
            for k in range(1, d):
                weight = weight * w_k[:, k]
            out.append((self.index(pos0 + bits, lvl), weight))
        return out

    # -- the encode -------------------------------------------------------
    def encode(self, table: torch.Tensor, x: torch.Tensor,
               chunk: int = 1 << 20) -> torch.Tensor:
        """The exact encode (N, L*F), no gradient."""
        t = table.detach().view(-1, self.n_features)
        out = torch.empty(x.shape[0], self.n_output, device=x.device)
        for i in range(0, x.shape[0], chunk):
            xs = x[i:i + chunk]
            for lvl in range(self.n_levels):
                rows, weight = self.exact_rows(xs, lvl)
                f = self.n_features
                out[i:i + chunk, lvl * f:(lvl + 1) * f] = \
                    (t[rows] * weight[..., None]).sum(dim=1)
        return out

    def encode_exact(self, table: torch.Tensor, x: torch.Tensor
                     ) -> torch.Tensor:
        """The exact encode (N, L*F), differentiable in `table` (every
        corner gets its d-linear weight's share)."""
        t = table.view(-1, self.n_features)
        return torch.cat([(t[rows] * weight[..., None]).sum(dim=1)
                          for rows, weight in (self.exact_rows(x, lvl)
                                               for lvl in
                                               range(self.n_levels))],
                         dim=-1)

    def encode_stochastic(self, table: torch.Tensor, x: torch.Tensor,
                          u: torch.Tensor, axis: Optional[torch.Tensor],
                          j: int) -> torch.Tensor:
        """The stochastic-corner estimator; differentiable in `table`, whose
        gradient goes to the fully sampled corner alone where j = 0 or the
        configuration's backward is one-corner, else to every fetched
        corner with its weight."""
        return _Stochastic.apply(table, x, self, u, axis, j)


class _Stochastic(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, x, grid, u, axis, j):
        ctx.save_for_backward(x, u, *([] if axis is None else [axis]))
        ctx.grid, ctx.j = grid, j
        t = table.detach().view(-1, grid.n_features)
        outs = []
        for lvl in range(grid.n_levels):
            out = None
            for rows, weight in grid.stochastic_rows(x, lvl, u, axis, j):
                feats = t[rows]
                if weight is not None:
                    feats = feats * weight[:, None]
                out = feats if out is None else out + feats
            outs.append(out)
        return torch.cat(outs, dim=-1)

    @staticmethod
    def backward(ctx, grad_out):
        x, u, *axis = ctx.saved_tensors
        axis = axis[0] if axis else None
        grid, j = ctx.grid, ctx.j
        f = grid.n_features
        grad = torch.zeros(grid.n_entries, f, device=grad_out.device)
        for lvl in range(grid.n_levels):
            g = grad_out[:, lvl * f:(lvl + 1) * f]
            for rows, weight in grid.stochastic_rows(
                    x, lvl, u, axis, j, sampled_only=grid.one_corner_bwd):
                grad.index_add_(0, rows, g if weight is None
                                else g * weight[:, None])
        return grad.view(-1), None, None, None, None, None
