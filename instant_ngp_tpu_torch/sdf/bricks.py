"""SDF voxel bricks: the ground-truth signed distance cached on a lattice
in every octree cell (counterpart of instant_ngp_tpu/sdf/bricks.py;
instant-ngp's ESDFGroundTruthMode::SDFBricks, testbed.cu:4388-4406).

The build evaluates the watertight signed distance on a B^3 lattice (B =
`brick_res`, corners on the cell's faces) of every occupied octree cell at
`brick_level`, through the BVH on the host, at most `MAX_VOXELS` points
(the level is lowered until they fit). `distance` runs on the device: one
`searchsorted` over the cells' Morton codes and a trilinear interpolation
of the brick, so the sphere tracer can march it like the learned SDF.
"""

from __future__ import annotations

import numpy as np
import torch

from ..nerf.march import morton3d, morton3d_coords


class SdfBricks:
    MAX_VOXELS = 1 << 20

    def __init__(self, octree, bvh, brick_res: int = 5,
                 brick_level: int = 10, device="cpu"):
        """octree: a TriangleOctree and bvh: a TriangleBvh, both in
        [0, 1]^3; the bricks go to `device`."""
        self.brick_res = B = int(brick_res)
        level = min(octree.depth - 1, brick_level)
        while level > 0 and len(octree.levels[level].cell_codes) * B ** 3 \
                > self.MAX_VOXELS:
            level -= 1
        self.level = level
        self.cell_codes = np.asarray(octree.levels[level].cell_codes,
                                     np.int64)
        res = 1 << level
        self.res = res

        x, y, z = (v.numpy() for v in morton3d_coords(
            torch.from_numpy(self.cell_codes)))
        base = np.stack([x, y, z], -1).astype(np.float32) / res   # (C, 3)
        step = 1.0 / (res * (B - 1))
        g = np.mgrid[0:B, 0:B, 0:B].astype(np.float32)
        lattice = g.transpose(1, 2, 3, 0).reshape(-1, 3) * step
        pos = (base[:, None, :] + lattice[None, :, :]).reshape(-1, 3)
        d = bvh.signed_distance(pos, mode="Watertight") if len(pos) else \
            np.zeros(0, np.float32)
        self.data = torch.from_numpy(
            d.reshape(-1, B, B, B).astype(np.float32)).to(device)
        self._ctable = torch.from_numpy(self.cell_codes).to(device)

    def distance(self, pos: torch.Tensor) -> torch.Tensor:
        """(N, 3) in [0, 1]^3 -> the interpolated signed distance. Outside
        every occupied cell: half a cell, so the sphere tracer keeps
        stepping through empty space."""
        B, res = self.brick_res, self.res
        n_cells = self.data.shape[0]
        if n_cells == 0:
            return torch.full(pos.shape[:-1], 0.5 / res, device=pos.device)
        c = torch.floor(pos * res).to(torch.int32).clamp(0, res - 1)
        code = morton3d(c[..., 0], c[..., 1], c[..., 2])
        ci = torch.searchsorted(self._ctable, code).clamp(0, n_cells - 1)
        occupied = self._ctable[ci] == code

        f = ((pos * res - c) * (B - 1)).clamp(0.0, B - 1 - 1e-6)
        i0 = torch.floor(f).to(torch.int64)
        t = f - i0
        out = torch.zeros(pos.shape[:-1], dtype=self.data.dtype,
                          device=pos.device)
        for dx in (0, 1):
            for dy in (0, 1):
                for dz in (0, 1):
                    w = ((t[..., 0] if dx else 1 - t[..., 0])
                         * (t[..., 1] if dy else 1 - t[..., 1])
                         * (t[..., 2] if dz else 1 - t[..., 2]))
                    v = self.data[ci, (i0[..., 0] + dx).clamp(max=B - 1),
                                  (i0[..., 1] + dy).clamp(max=B - 1),
                                  (i0[..., 2] + dz).clamp(max=B - 1)]
                    out = out + w * v
        return torch.where(occupied, out, 0.5 / res)
