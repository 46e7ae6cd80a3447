"""Multiresolution hash/dense/tiled grid encoding: the exact d-linear
encode with both of its gradients, and the stochastic-corner estimator of
it (counterpart of instant_ngp_tpu/ops/grid_encoding.py).

- L levels; level l has scale s_l = N_min * 2^(l * log2(b)) - 1 and
  resolution r_l = ceil(s_l) + 1.
- A point x in [0,1]^d maps to pos = x * s_l + 0.5; the 2^d surrounding
  corners are d-linearly interpolated (Linear, Smoothstep or Nearest).
- Per-level table size = min(r_l^d, 2^log2_hashmap_size), 8-aligned.
  Dense addressing when the level fits (clamped, or wrapped for Tiled
  grids), else the spatial hash: XOR of uint32 coordinate * prime.
- `max_level` zeroes the features of every level above it.

The table is one flat float32 parameter in the INTERLEAVED layout: feature
k of entry e sits at e*F + k, so one entry's F features are one row of
`params.view(-1, F)`. `convert_layout` maps planar (feature-major) tables
of old snapshots into it.

Under autograd (grad mode on and the table requires grad) the forward
runs inside `_GridEncode`, which saves x alone; its backward recomputes
each level's indices and d-linear weights and deposits grad * weight into
the table gradient, one level at a time, with `ordered_deposit`: on a
CUDA device `index_put_(..., accumulate=True)`, which sorts the level's
indices and adds each entry's deposits in one fixed sequence, and on the
CPU `index_add_`, which adds serially in index order. So the gradient has
the same bits in every run (`index_add_` adds by atomics on the card, and
`index_put_` from several threads on the CPU, in orders that change
between runs, and Adam's eps of 1e-15 turns the differences of near-zero
sums into full-size steps; data-parallel replicas stay identical only if
the arithmetic each repeats is deterministic).
Autograd through `table[idx]` would instead keep every level's gather
alive. Where x requires grad (camera optimisation), the backward
also returns the hand-derived gradient with respect to x: per corner, the
feature times d(weight)/dx_k, which is the interpolant's derivative along
axis k (1, Smoothstep's 6w(1-w), or 0 for Nearest) times the other axes'
weights times the level's scale.

The stochastic-corner estimator (`forward(x, draws=...)` or
`generator=...`; training only) fetches fewer corners per (sample, level).
Along each axis k the upper corner is taken with probability w_k
(`u_k < w_k`), so a fully sampled corner with weight 1 is an unbiased
estimate of the d-linear interpolation. `stochastic_exact_axes` = j keeps
j axes exact: their two endpoints are both fetched and weighted, 2^j
fetches instead of 2^d.
- j = 0: one fetch at the sampled corner, weight 1;
- j = 1: a uniformly drawn axis a is exact, the others sampled;
- j = 2 (3D): a is the sampled axis, the other two are exact; the
  enumeration's low bit goes to the axis after a in cyclic order, the high
  bit to the one after that.
Its backward gives the table gradient only (the gradient with respect to x
is zero by design: callers that need it use the exact path). With
`stochastic_bwd` and j > 0 the deposit goes to ONE corner, the fully
sampled one, with weight 1, which is unbiased too; otherwise to every
corner the forward fetched, with its weight. The Function saves x and the
draws and recomputes the indices.

Five methods dispatch by the device of x: `_encode`,
`_encode_stochastic`, `_table_gradient`, `_table_gradient_stochastic` and
`_input_gradient` launch the hand-written kernels of
`csrc/grid_encoding.cu` (through `ops/kernels/grid_kernels.py`) on a CUDA
tensor, and on a CPU tensor run their plain PyTorch versions (the
`_*_plain` methods: one gather per level and fetched corner, the deposit
by `ordered_deposit`). On the card a kernel runs or the call raises. The
kernels' table gradient keeps the plain card path's order (a stable sort
of the table rows, then one sequential float32 sum a row) and so its bits.
`plain_calls_on_cuda` counts calls of a plain version on a CUDA tensor,
which no path of the port makes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .kernels import grid_kernels

_PRIMES = (1, 2654435761, 805459861)
_U32_MASK = 0xFFFFFFFF


def ordered_deposit(grad: torch.Tensor, rows: torch.Tensor,
                    values: torch.Tensor) -> None:
    """grad[rows] += values (rows may repeat), summed in an order that the
    rows alone fix (see the module docstring): on a CUDA device by
    `index_put_` with accumulate, which sorts; on the CPU by `index_add_`,
    which adds in the order of `rows` (`index_put_` adds there from several
    threads at once)."""
    if grad.device.type == "cpu":
        grad.index_add_(0, rows, values)
    else:
        grad.index_put_((rows,), values, accumulate=True)


def grid_scale(level: int, log2_per_level_scale: float,
               base_resolution: int) -> float:
    return float(np.exp2(level * log2_per_level_scale) * base_resolution - 1.0)


def grid_resolution(scale: float) -> int:
    return int(math.ceil(scale)) + 1


def convert_layout(params, n_features: int, src: str, dst: str):
    """Permute a flat table (numpy array or tensor) between the 'planar'
    layout (feature k of entry e at k*n_entries + e) and 'interleaved'."""
    if src == dst:
        return params
    if src == "planar" and dst == "interleaved":
        return params.reshape(n_features, -1).T.reshape(-1)
    if src == "interleaved" and dst == "planar":
        return params.reshape(-1, n_features).T.reshape(-1)
    raise ValueError(f"unknown grid layouts {src!r} -> {dst!r}")


@dataclasses.dataclass
class CornerDraws:
    """The random numbers of one stochastic-corner encode of N points over
    L levels."""

    u: torch.Tensor                 # (d, N, L) float32 uniforms in [0, 1)
    axis: Optional[torch.Tensor]    # (N, L) integer in [0, d); unused, and
    #                                 may be None, at exact_axes = 0

    def rows(self, lo: int, hi: int) -> "CornerDraws":
        """The draws of points lo..hi."""
        return CornerDraws(self.u[:, lo:hi], None if self.axis is None
                           else self.axis[lo:hi])


def draw_corner_randoms(generator: torch.Generator, n: int, n_dims: int,
                        n_levels: int, exact_axes: int = 1) -> CornerDraws:
    """Draws for n points on the generator's device."""
    dev = generator.device
    u = torch.rand(n_dims, n, n_levels, generator=generator, device=dev)
    axis = None
    if exact_axes > 0:
        axis = torch.randint(0, n_dims, (n, n_levels), generator=generator,
                             device=dev)
    return CornerDraws(u, axis)


class GridEncoding(nn.Module):
    """Grid encoding whose table is the flat float32 parameter `params`
    (interleaved layout).

    stochastic_exact_axes, stochastic_bwd: the defaults of the
    stochastic-corner estimator (see the module docstring); they change
    nothing unless `forward` is given draws or a generator."""

    #: calls of a plain version (`_*_plain`) on a CUDA tensor
    plain_calls_on_cuda = 0

    def __init__(self, n_dims: int, n_levels: int = 16,
                 n_features_per_level: int = 2, log2_hashmap_size: int = 19,
                 base_resolution: int = 16, per_level_scale: float = 2.0,
                 grid_type: str = "Hash", interpolation: str = "Linear",
                 stochastic_exact_axes: int = 0,
                 stochastic_bwd: bool = False):
        super().__init__()
        if n_dims not in (2, 3):
            raise ValueError("grid encoding supports 2D and 3D inputs")
        if grid_type not in ("Hash", "Dense", "Tiled"):
            raise ValueError(f"unknown grid type {grid_type!r}")
        if interpolation not in ("Linear", "Smoothstep", "Nearest"):
            raise ValueError(f"unknown interpolation {interpolation!r}")
        self.n_dims = n_dims
        self.n_levels = n_levels
        self.n_features_per_level = n_features_per_level
        self.grid_type = grid_type
        self.interpolation = interpolation
        self.n_output_dims = n_levels * n_features_per_level
        self.stochastic_exact_axes = int(stochastic_exact_axes)
        self.stochastic_bwd = bool(stochastic_bwd)

        log2_pls = math.log2(per_level_scale)
        hashmap_size = 1 << log2_hashmap_size
        self.levels = []   # per level: (scale f32, res, size, offset, hashed)
        offset = 0
        for lvl in range(n_levels):
            s = grid_scale(lvl, log2_pls, base_resolution)
            r = grid_resolution(s)
            dense_size = r ** n_dims
            if grid_type == "Dense":
                size, hashed = dense_size, False
            elif grid_type == "Tiled":
                size, hashed = min(dense_size, hashmap_size), False
            else:
                size = min(dense_size, hashmap_size)
                hashed = dense_size > hashmap_size
            size = (size + 7) // 8 * 8
            # the JAX package computes positions with the f32-rounded scale
            self.levels.append((float(np.float32(s)), r, size, offset,
                                hashed))
            offset += size
        self.n_entries = offset
        self.params = nn.Parameter(
            torch.zeros(offset * n_features_per_level), requires_grad=False)
        corners = np.stack(np.meshgrid(*([np.arange(2)] * n_dims),
                                       indexing="ij"), -1).reshape(-1, n_dims)
        self.register_buffer("corners", torch.from_numpy(corners).long(),
                             persistent=False)
        self._kernel_desc = None

    @classmethod
    def from_config(cls, n_dims: int, config: Dict[str, Any]
                    ) -> "GridEncoding":
        otype = config.get("otype", "HashGrid")
        gtype = {"HashGrid": "Hash", "DenseGrid": "Dense",
                 "TiledGrid": "Tiled",
                 "Grid": config.get("type", "Hash")}[otype]
        n_levels = config.get("n_levels", 16)
        base_res = config.get("base_resolution", 16)
        if "per_level_scale" in config:
            pls = config["per_level_scale"]
        elif "desired_resolution" in config and n_levels > 1:
            pls = math.exp(math.log(config["desired_resolution"] / base_res)
                           / (n_levels - 1))
        else:
            pls = 2.0
        return cls(n_dims=n_dims, n_levels=n_levels,
                   n_features_per_level=config.get("n_features_per_level", 2),
                   log2_hashmap_size=config.get("log2_hashmap_size", 19),
                   base_resolution=base_res, per_level_scale=pls,
                   grid_type=gtype,
                   interpolation=config.get("interpolation", "Linear"),
                   stochastic_exact_axes=config.get("stochastic_exact_axes",
                                                    0),
                   stochastic_bwd=config.get("stochastic_bwd", False))

    @property
    def n_params(self) -> int:
        return self.params.numel()

    def level_params(self, params, level: int):
        """The (size_l, F) slice of one level of a flat interleaved table
        (a tensor or a numpy array)."""
        f = self.n_features_per_level
        _, _, size, offset, _ = self.levels[level]
        return params[offset * f:(offset + size) * f].reshape(size, f)

    def level_stats(self, params=None) -> List[Dict[str, float]]:
        """Per level of `params` (by default the module's own table): min,
        max, mean, sigma, the fraction of zeros and the count of values
        (the reference's LevelStats diagnostic)."""
        if params is None:
            params = self.params
        if isinstance(params, torch.Tensor):
            params = params.detach().cpu().numpy()
        stats = []
        for lvl in range(self.n_levels):
            t = np.asarray(self.level_params(params, lvl)).ravel()
            n = t.size
            stats.append({
                "min": float(t.min()) if n else 0.0,
                "max": float(t.max()) if n else 0.0,
                "mean": float(t.mean()) if n else 0.0,
                "sigma": float(t.std()) if n else 0.0,
                "fraczero": float(1.0 - np.count_nonzero(t) / n)
                if n else 0.0,
                "count": int(n),
            })
        return stats

    def init_params(self, generator: torch.Generator) -> None:
        """U(-1e-4, 1e-4), the tcnn grid default, drawn from `generator`."""
        p = torch.rand(self.n_params, generator=generator) * 2e-4 - 1e-4
        with torch.no_grad():
            self.params.copy_(p)

    def _level_weights(self, x: torch.Tensor, lvl: int):
        """-> (pos0 (N, d) int64 lower corner, w (N, d) weight of the upper
        corner along each axis, dw (N, d) = dw/dpos)."""
        pos = x * self.levels[lvl][0] + 0.5
        pos0 = torch.floor(pos)
        w = pos - pos0
        if self.interpolation == "Smoothstep":
            dw = 6.0 * w * (1.0 - w)
            w = w * w * (3.0 - 2.0 * w)
        elif self.interpolation == "Nearest":
            dw = torch.zeros_like(w)
            w = torch.round(w)
        else:
            dw = torch.ones_like(w)
        return pos0.long(), w, dw

    def _index(self, coords: torch.Tensor, lvl: int) -> torch.Tensor:
        """Integer grid coordinates (..., d) -> table rows (...)."""
        _, res, size, offset, hashed = self.levels[lvl]
        if hashed:
            # uint32 wraparound: the low 32 bits of the int64 product
            # (|coord| < 2^31, so the product itself cannot overflow)
            idx = (coords[..., 0] * _PRIMES[0]) & _U32_MASK
            for k in range(1, self.n_dims):
                idx = idx ^ ((coords[..., k] * _PRIMES[k]) & _U32_MASK)
        else:
            if self.grid_type == "Tiled":
                coords = torch.remainder(coords, res)
            else:
                coords = coords.clamp(0, res - 1)
            idx = coords[..., 0]
            stride = 1
            for k in range(1, self.n_dims):
                stride *= res
                idx = idx + coords[..., k] * stride
        return idx % size + offset

    def _level_corners(self, x: torch.Tensor, lvl: int, parts: bool = False):
        """Table rows and d-linear weights of the 2^d corners around each
        point at one level -> (idx (N, C) int64, weight (N, C)); with
        `parts` also the per-axis corner-selected weights w_sel (N, C, d)
        and their derivatives with respect to x (N, C, d)."""
        pos0, w, dw = self._level_weights(x, lvl)
        corners = self.corners                                   # (C, d)
        idx = self._index(pos0[:, None, :] + corners[None], lvl)
        sel = corners[None] == 1                                 # (1, C, d)
        w_sel = torch.where(sel, w[:, None, :], 1.0 - w[:, None, :])
        weight = w_sel[..., 0]
        for k in range(1, self.n_dims):
            weight = weight * w_sel[..., k]
        if not parts:
            return idx, weight
        dw_sel = torch.where(sel, dw[:, None, :], -dw[:, None, :]) \
            * self.levels[lvl][0]
        return idx, weight, w_sel, dw_sel

    def _masked(self, max_level: Optional[float], lvl: int) -> bool:
        return max_level is not None and not max_level >= lvl

    # ---- dispatch: the kernels on CUDA tensors, the plain versions on
    # CPU tensors ------------------------------------------------------------
    @property
    def kernel_desc(self):
        """The levels as `ops/kernels/grid_kernels.py` takes them (built on
        first use; raises where the kernels cannot take this grid)."""
        if self._kernel_desc is None:
            self._kernel_desc = grid_kernels.grid_desc(
                self.n_dims, self.n_features_per_level, self.grid_type,
                self.interpolation, self.levels)
        return self._kernel_desc

    def _active_levels(self, max_level: Optional[float]) -> int:
        """How many levels `max_level` leaves on: the masked ones are the
        levels above it (all of them where it is NaN)."""
        return sum(not self._masked(max_level, lvl)
                   for lvl in range(self.n_levels))

    def _encode(self, params: torch.Tensor, x: torch.Tensor,
                max_level: Optional[float]) -> torch.Tensor:
        """The exact encode (N, L*F): `grid_kernels.encode_forward` on a
        CUDA tensor, `_encode_plain` on a CPU one."""
        if x.device.type == "cpu":
            return self._encode_plain(params, x, max_level)
        return grid_kernels.encode_forward(
            self.kernel_desc, params.detach(), x.detach().contiguous(),
            self._active_levels(max_level))

    def _table_gradient(self, x: torch.Tensor, grad_out: torch.Tensor,
                        max_level: Optional[float]) -> torch.Tensor:
        """d(loss)/d(params) of the exact encode, flat like params:
        `grid_kernels.table_gradient` on a CUDA tensor,
        `_table_gradient_plain` on a CPU one."""
        if x.device.type == "cpu":
            return self._table_gradient_plain(x, grad_out, max_level)
        return grid_kernels.table_gradient(
            self.kernel_desc, x.detach().contiguous(), grad_out.contiguous(),
            self._active_levels(max_level), grid_kernels.EXACT)

    def _input_gradient(self, params: torch.Tensor, x: torch.Tensor,
                        grad_out: torch.Tensor, max_level: Optional[float]
                        ) -> torch.Tensor:
        """d(loss)/d(x) (N, d) of the exact encode:
        `grid_kernels.input_gradient` on a CUDA tensor,
        `_input_gradient_plain` on a CPU one."""
        if x.device.type == "cpu":
            return self._input_gradient_plain(params, x, grad_out, max_level)
        return grid_kernels.input_gradient(
            self.kernel_desc, params.detach(), x.detach().contiguous(),
            grad_out.contiguous(), self._active_levels(max_level))

    def _encode_stochastic(self, params: torch.Tensor, x: torch.Tensor,
                           max_level: Optional[float], draws: CornerDraws,
                           j: int) -> torch.Tensor:
        """The stochastic-corner forward with j exact axes:
        `grid_kernels.encode_forward` on a CUDA tensor,
        `_encode_stochastic_plain` on a CPU one."""
        if x.device.type == "cpu":
            return self._encode_stochastic_plain(params, x, max_level,
                                                 draws, j)
        return grid_kernels.encode_forward(
            self.kernel_desc, params.detach(), x.detach().contiguous(),
            self._active_levels(max_level), draws, j)

    def _table_gradient_stochastic(self, x: torch.Tensor,
                                   grad_out: torch.Tensor,
                                   max_level: Optional[float],
                                   draws: CornerDraws, j: int
                                   ) -> torch.Tensor:
        """The stochastic-corner encode's table gradient (every fetched
        corner, or the fully sampled one alone where j = 0 or
        `stochastic_bwd`): `grid_kernels.table_gradient` on a CUDA tensor,
        `_table_gradient_stochastic_plain` on a CPU one."""
        if x.device.type == "cpu":
            return self._table_gradient_stochastic_plain(x, grad_out,
                                                         max_level, draws, j)
        one = j == 0 or self.stochastic_bwd
        return grid_kernels.table_gradient(
            self.kernel_desc, x.detach().contiguous(), grad_out.contiguous(),
            self._active_levels(max_level),
            grid_kernels.ONE_CORNER if one else grid_kernels.FETCHED,
            draws, 0 if one else j)

    # ---- the plain versions ------------------------------------------------
    def _count_plain(self, x: torch.Tensor) -> None:
        if x.device.type == "cuda":
            GridEncoding.plain_calls_on_cuda += 1

    def _encode_plain(self, params: torch.Tensor, x: torch.Tensor,
                      max_level: Optional[float]) -> torch.Tensor:
        self._count_plain(x)
        table = params.view(-1, self.n_features_per_level)
        outs = []
        for lvl in range(self.n_levels):
            idx, weight = self._level_corners(x, lvl)
            if self._masked(max_level, lvl):
                weight = torch.zeros_like(weight)
            feats = table[idx]                                   # (N, C, F)
            outs.append((feats * weight[..., None]).sum(dim=1))
        return torch.cat(outs, dim=-1)

    def _table_gradient_plain(self, x: torch.Tensor, grad_out: torch.Tensor,
                              max_level: Optional[float]) -> torch.Tensor:
        """d(loss)/d(params) from grad_out (N, L*F): flat, like params."""
        self._count_plain(x)
        n_feat = self.n_features_per_level
        grad = torch.zeros(self.n_entries, n_feat, dtype=grad_out.dtype,
                           device=grad_out.device)
        for lvl in range(self.n_levels):
            if self._masked(max_level, lvl):
                continue       # the forward zeroed this level's features
            idx, weight = self._level_corners(x, lvl)
            g = grad_out[:, lvl * n_feat:(lvl + 1) * n_feat]     # (N, F)
            deposit = g[:, None, :] * weight[..., None]          # (N, C, F)
            ordered_deposit(grad, idx.reshape(-1),
                            deposit.reshape(-1, n_feat))
        return grad.view(-1)

    def _input_gradient_plain(self, params: torch.Tensor, x: torch.Tensor,
                              grad_out: torch.Tensor,
                              max_level: Optional[float]) -> torch.Tensor:
        """d(loss)/d(x) (N, d) of the exact encode from grad_out (N, L*F):
        sum over levels and corners of (grad . feature) * d(weight)/dx_k,
        with d(weight)/dx_k = dw_sel_k * prod of the other axes' w_sel."""
        self._count_plain(x)
        n_feat = self.n_features_per_level
        table = params.view(-1, n_feat)
        grad = torch.zeros_like(x)
        for lvl in range(self.n_levels):
            if self._masked(max_level, lvl):
                continue
            idx, _, w_sel, dw_sel = self._level_corners(x, lvl, parts=True)
            g = grad_out[:, lvl * n_feat:(lvl + 1) * n_feat]
            dweight = (table[idx] * g[:, None, :]).sum(dim=-1)   # (N, C)
            for k in range(self.n_dims):
                term = dweight * dw_sel[..., k]
                for j in range(self.n_dims):
                    if j != k:
                        term = term * w_sel[..., j]
                grad[:, k] += term.sum(dim=1)
        return grad

    # ---- the stochastic-corner estimator --------------------------------
    def _stochastic_corners(self, x: torch.Tensor, lvl: int,
                            draws: CornerDraws, j: int,
                            sampled_only: bool = False
                            ) -> List[Tuple[torch.Tensor,
                                            Optional[torch.Tensor]]]:
        """One level's corners as (rows (N,), weight (N,) or None for 1):
        the 2^j corners the forward fetches, or with `sampled_only` the
        fully sampled corner alone (which is all there is at j = 0)."""
        d = self.n_dims
        pos0, w, _ = self._level_weights(x, lvl)
        bern = (draws.u[:, :, lvl].T < w).long()                 # (N, d)
        if j == 0 or sampled_only:
            return [(self._index(pos0 + bern, lvl), None)]
        axes = torch.arange(d, device=x.device)[None, :]         # (1, d)
        a = draws.axis[:, lvl].long()[:, None]                   # (N, 1)
        if j == 1:
            exact = axes == a
            low = exact                # the one exact axis takes bit 0
        else:
            exact = axes != a
            # enumeration bits go to the exact axes in cyclic order after
            # the sampled axis a: bit 0 to axis a + 1, bit 1 to axis a + 2
            low = torch.remainder(axes - a - 1, d) == 0
        pairs = []
        for combo in range(1 << j):
            e_bit = torch.where(low, combo & 1, (combo >> 1) & 1)
            bits = torch.where(exact, e_bit, bern)
            w_k = torch.where(exact, torch.where(e_bit == 1, w, 1.0 - w),
                              1.0)
            weight = w_k[:, 0]
            for k in range(1, d):
                weight = weight * w_k[:, k]
            pairs.append((self._index(pos0 + bits, lvl), weight))
        return pairs

    def _encode_stochastic_plain(self, params: torch.Tensor, x: torch.Tensor,
                                 max_level: Optional[float],
                                 draws: CornerDraws, j: int) -> torch.Tensor:
        self._count_plain(x)
        table = params.view(-1, self.n_features_per_level)
        outs = []
        for lvl in range(self.n_levels):
            if self._masked(max_level, lvl):
                outs.append(torch.zeros(x.shape[0],
                                        self.n_features_per_level,
                                        dtype=params.dtype, device=x.device))
                continue
            out = None
            for idx, weight in self._stochastic_corners(x, lvl, draws, j):
                # (N, F) at a time
                feats = table[idx]
                if weight is not None:
                    feats = feats * weight[:, None]
                out = feats if out is None else out + feats
            outs.append(out)
        return torch.cat(outs, dim=-1)

    def _table_gradient_stochastic_plain(self, x: torch.Tensor,
                                         grad_out: torch.Tensor,
                                         max_level: Optional[float],
                                         draws: CornerDraws, j: int
                                         ) -> torch.Tensor:
        self._count_plain(x)
        n_feat = self.n_features_per_level
        grad = torch.zeros(self.n_entries, n_feat, dtype=grad_out.dtype,
                           device=grad_out.device)
        for lvl in range(self.n_levels):
            if self._masked(max_level, lvl):
                continue
            g = grad_out[:, lvl * n_feat:(lvl + 1) * n_feat]
            for idx, weight in self._stochastic_corners(
                    x, lvl, draws, j, sampled_only=self.stochastic_bwd):
                ordered_deposit(grad, idx, g if weight is None
                         else g * weight[:, None])
        return grad.view(-1)

    def forward(self, x: torch.Tensor, max_level: Optional[float] = None,
                draws: Optional[CornerDraws] = None,
                generator: Optional[torch.Generator] = None,
                exact_axes: Optional[int] = None) -> torch.Tensor:
        """x (N, d) in [0,1]^d -> (N, L*F) float32 features.

        With `draws`, or a `generator` to make them from, the
        stochastic-corner estimator with `exact_axes` exact axes (default:
        the configuration's `stochastic_exact_axes`); with neither, the
        exact d-linear encode."""
        x = x.reshape(-1, self.n_dims).float()
        train = torch.is_grad_enabled() and self.params.requires_grad
        if draws is None and generator is None:
            if train or (torch.is_grad_enabled() and x.requires_grad):
                return _GridEncode.apply(self.params, x, self, max_level)
            return self._encode(self.params, x, max_level)
        j = self.stochastic_exact_axes if exact_axes is None \
            else int(exact_axes)
        if not 0 <= j < self.n_dims:
            raise ValueError(f"exact_axes must be in [0, {self.n_dims}), "
                             f"got {j}")
        if draws is None:
            draws = draw_corner_randoms(generator, x.shape[0], self.n_dims,
                                        self.n_levels, j)
        if train:
            return _StochasticGridEncode.apply(self.params, x, self,
                                               max_level, draws, j)
        # no gradient reaches x on this path either
        return self._encode_stochastic(self.params, x.detach(), max_level,
                                       draws, j)


class _GridEncode(torch.autograd.Function):
    """The exact encode with hand-written gradients; saves x only, and the
    table besides when x wants a gradient."""

    @staticmethod
    def forward(ctx, params, x, encoding, max_level):
        if ctx.needs_input_grad[1]:
            ctx.save_for_backward(x, params)
        else:
            ctx.save_for_backward(x)
        ctx.encoding = encoding
        ctx.max_level = max_level
        return encoding._encode(params, x, max_level)

    @staticmethod
    def backward(ctx, grad_out):
        x = ctx.saved_tensors[0]
        grad_out = grad_out.contiguous()
        grad = grad_x = None
        if ctx.needs_input_grad[0]:
            grad = ctx.encoding._table_gradient(x, grad_out, ctx.max_level)
        if ctx.needs_input_grad[1]:
            grad_x = ctx.encoding._input_gradient(
                ctx.saved_tensors[1], x, grad_out, ctx.max_level)
        return grad, grad_x, None, None


class _StochasticGridEncode(torch.autograd.Function):
    """The stochastic-corner encode: table gradient only (zero for x);
    saves x and the draws."""

    @staticmethod
    def forward(ctx, params, x, encoding, max_level, draws, j):
        saved = [x, draws.u] + ([] if draws.axis is None else [draws.axis])
        ctx.save_for_backward(*saved)
        ctx.encoding, ctx.max_level, ctx.j = encoding, max_level, j
        return encoding._encode_stochastic(params, x, max_level, draws, j)

    @staticmethod
    def backward(ctx, grad_out):
        x, u, *axis = ctx.saved_tensors
        draws = CornerDraws(u, axis[0] if axis else None)
        grad = ctx.encoding._table_gradient_stochastic(
            x, grad_out.contiguous(), ctx.max_level, draws, ctx.j)
        grad_x = torch.zeros_like(x) if ctx.needs_input_grad[1] else None
        return grad, grad_x, None, None, None, None
