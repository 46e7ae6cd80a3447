"""Takikawa (NGLOD-style) octree feature encoding (counterpart of
instant_ngp_tpu/ops/takikawa.py; instant-ngp's takikawa_encoding.cuh).

For each level from `starting_level` to the octree's depth - 1: find the
octree cell holding x, interpolate trilinearly the features stored at its
8 corner vertices, and concatenate the levels' features (or sum them).
Where a level's cell is not occupied, that level gives zeros. The table is
one flat float32 parameter, `n_vertices * n_features_per_level` long (row
v = the features of global vertex v), drawn from U(-1e-4, 1e-4). Its
gradient, and the input's, come from autograd through the gather and the
weights.
"""

from __future__ import annotations

import torch
from torch import nn

from ..geom.triangle_octree import TriangleOctree


class TakikawaEncoding(nn.Module):
    def __init__(self, octree: TriangleOctree, starting_level: int = 4,
                 n_features_per_level: int = 4,
                 sum_instead_of_concat: bool = False):
        super().__init__()
        self.octree = octree
        self.starting_level = starting_level
        self.n_features_per_level = n_features_per_level
        self.sum_instead_of_concat = sum_instead_of_concat
        self.n_dims = 3
        self.n_active_levels = octree.depth - starting_level
        if self.n_active_levels <= 0:
            raise ValueError(f"an octree of depth {octree.depth} has no "
                             f"level from {starting_level} on")
        self.n_output_dims = n_features_per_level * (
            1 if sum_instead_of_concat else self.n_active_levels)
        self.params = nn.Parameter(torch.zeros(self.n_params),
                                   requires_grad=False)

    @property
    def n_params(self) -> int:
        return self.octree.n_vertices * self.n_features_per_level

    def init_params(self, generator: torch.Generator) -> None:
        """U(-1e-4, 1e-4), as tcnn's grid encodings."""
        u = torch.rand(self.n_params, generator=generator)
        with torch.no_grad():
            self.params.copy_(u * 2e-4 - 1e-4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (N, 3) in [0, 1]^3 -> (N, n_output_dims) float32."""
        xf = x.reshape(-1, 3).float()
        table = self.params.view(-1, self.n_features_per_level)
        outs = []
        for level in range(self.starting_level, self.octree.depth):
            res = 1 << level
            pos = xf * res
            cell = torch.floor(pos).to(torch.int32).clamp(0, res - 1)
            w = pos - cell.float()
            ids, occupied = self.octree.vertex_indices(level, cell)
            feats = table[ids]                               # (N, 8, F)
            weights = []
            for cx in (0, 1):
                for cy in (0, 1):
                    for cz in (0, 1):
                        wx = w[:, 0] if cx else 1 - w[:, 0]
                        wy = w[:, 1] if cy else 1 - w[:, 1]
                        wz = w[:, 2] if cz else 1 - w[:, 2]
                        weights.append(wx * wy * wz)
            weight = torch.stack(weights, dim=-1)             # (N, 8)
            out = (feats * weight[..., None]).sum(dim=1)
            outs.append(torch.where(occupied[:, None], out, 0.0))
        if self.sum_instead_of_concat:
            result = outs[0]
            for out in outs[1:]:
                result = result + out
        else:
            result = torch.cat(outs, dim=-1)
        return result.reshape(*x.shape[:-1], self.n_output_dims)
