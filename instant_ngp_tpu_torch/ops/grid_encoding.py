"""Multiresolution hash/dense/tiled grid encoding, forward and table
gradient (counterpart of instant_ngp_tpu/ops/grid_encoding.py, exact
d-linear path).

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
the table gradient with `index_add_` (atomic adds on a CUDA device, so the
summation order varies between runs). Autograd through `table[idx]` would
instead keep every level's gather alive and sort all indices in
`index_put_`. The gradient with respect to x is not implemented.

This is plain PyTorch: one gather per level. Its CUDA kernel, for both
directions, is the next kernel the port needs (the JAX package has no TPU
kernel for it).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

_PRIMES = (1, 2654435761, 805459861)
_U32_MASK = 0xFFFFFFFF


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


class GridEncoding(nn.Module):
    """Grid encoding whose table is the flat float32 parameter `params`
    (interleaved layout)."""

    def __init__(self, n_dims: int, n_levels: int = 16,
                 n_features_per_level: int = 2, log2_hashmap_size: int = 19,
                 base_resolution: int = 16, per_level_scale: float = 2.0,
                 grid_type: str = "Hash", interpolation: str = "Linear"):
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
                   interpolation=config.get("interpolation", "Linear"))

    @property
    def n_params(self) -> int:
        return self.params.numel()

    def init_params(self, generator: torch.Generator) -> None:
        """U(-1e-4, 1e-4), the tcnn grid default, drawn from `generator`."""
        p = torch.rand(self.n_params, generator=generator) * 2e-4 - 1e-4
        with torch.no_grad():
            self.params.copy_(p)

    def _level_corners(self, x: torch.Tensor, lvl: int):
        """Table rows and d-linear weights of the 2^d corners around each
        point at one level -> (idx (N, C) int64, weight (N, C))."""
        scale, res, size, offset, hashed = self.levels[lvl]
        corners = self.corners                                   # (C, d)
        pos = x * scale + 0.5
        pos0 = torch.floor(pos)
        w = pos - pos0
        if self.interpolation == "Smoothstep":
            w = w * w * (3.0 - 2.0 * w)
        elif self.interpolation == "Nearest":
            w = torch.round(w)
        coords = pos0.long()[:, None, :] + corners[None]         # (N, C, d)
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
        idx = idx % size + offset
        sel = corners[None] == 1                                 # (1, C, d)
        w_sel = torch.where(sel, w[:, None, :], 1.0 - w[:, None, :])
        weight = w_sel[..., 0]
        for k in range(1, self.n_dims):
            weight = weight * w_sel[..., k]
        return idx, weight

    def _encode(self, params: torch.Tensor, x: torch.Tensor,
                max_level: Optional[float]) -> torch.Tensor:
        table = params.view(-1, self.n_features_per_level)
        outs = []
        for lvl in range(self.n_levels):
            idx, weight = self._level_corners(x, lvl)
            if max_level is not None and not max_level >= lvl:
                weight = torch.zeros_like(weight)
            feats = table[idx]                                   # (N, C, F)
            outs.append((feats * weight[..., None]).sum(dim=1))
        return torch.cat(outs, dim=-1)

    def _table_gradient(self, x: torch.Tensor, grad_out: torch.Tensor,
                        max_level: Optional[float]) -> torch.Tensor:
        """d(loss)/d(params) from grad_out (N, L*F): flat, like params."""
        n_feat = self.n_features_per_level
        grad = torch.zeros(self.n_entries, n_feat, dtype=grad_out.dtype,
                           device=grad_out.device)
        for lvl in range(self.n_levels):
            if max_level is not None and not max_level >= lvl:
                continue       # the forward zeroed this level's features
            idx, weight = self._level_corners(x, lvl)
            g = grad_out[:, lvl * n_feat:(lvl + 1) * n_feat]     # (N, F)
            deposit = g[:, None, :] * weight[..., None]          # (N, C, F)
            grad.index_add_(0, idx.reshape(-1),
                            deposit.reshape(-1, n_feat))
        return grad.view(-1)

    def forward(self, x: torch.Tensor,
                max_level: Optional[float] = None) -> torch.Tensor:
        """x (N, d) in [0,1]^d -> (N, L*F) float32 features."""
        if torch.is_grad_enabled() and x.requires_grad:
            raise NotImplementedError(
                "the grid encoding's gradient with respect to its input is "
                "not ported yet (camera optimisation and the Normals mode "
                "need it)")
        x = x.reshape(-1, self.n_dims).float()
        if torch.is_grad_enabled() and self.params.requires_grad:
            return _GridEncode.apply(self.params, x, self, max_level)
        return self._encode(self.params, x, max_level)


class _GridEncode(torch.autograd.Function):
    """The encode with a hand-written table gradient; saves x only."""

    @staticmethod
    def forward(ctx, params, x, encoding, max_level):
        ctx.save_for_backward(x)
        ctx.encoding = encoding
        ctx.max_level = max_level
        return encoding._encode(params, x, max_level)

    @staticmethod
    def backward(ctx, grad_out):
        (x,) = ctx.saved_tensors
        grad = ctx.encoding._table_gradient(x, grad_out.contiguous(),
                                            ctx.max_level)
        return grad, None, None, None
