"""Sparse surface octree over a triangle mesh (counterpart of
instant_ngp_tpu/geom/triangle_octree.py; instant-ngp's
triangle_octree.cuh).

Each level keeps the SORTED Morton codes of the cells that touch the mesh
and of those cells' corner vertices, whose features the Takikawa encoding
stores (instant-ngp's "dual nodes", 8 vertex ids a cell). The build runs
once on the host in numpy: a cell is occupied where a triangle's bounding
box overlaps it (a superset of instant-ngp's exact triangle test, which
only changes how tightly the tree hugs the surface). The queries,
`contains` and `vertex_indices`, are `torch.searchsorted` over the codes on
the device of their input (the tables are moved there once per device).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..nerf.march import morton3d, morton3d_coords


def _morton_np(x, y, z) -> np.ndarray:
    return morton3d(torch.from_numpy(np.asarray(x, np.int64)),
                    torch.from_numpy(np.asarray(y, np.int64)),
                    torch.from_numpy(np.asarray(z, np.int64))).numpy()


@dataclasses.dataclass
class OctreeLevel:
    cell_codes: np.ndarray      # sorted Morton codes of occupied cells
    vertex_codes: np.ndarray    # sorted Morton codes of corner vertices
    vertex_offset: int          # first feature-vertex index of this level


class TriangleOctree:
    def __init__(self, triangles: np.ndarray, depth: int):
        self.depth = depth
        self.levels: List[OctreeLevel] = []
        tris = np.asarray(triangles, np.float32).reshape(-1, 3, 3)
        lo = tris.min(axis=1)
        hi = tris.max(axis=1)

        total_vertices = 0
        for level in range(depth):
            res = 1 << level
            clo = np.clip((lo * res).astype(np.int64), 0, res - 1)
            chi = np.clip((hi * res).astype(np.int64), 0, res - 1)
            span = chi - clo
            # rasterise each triangle's box of cells
            max_span = int(span.max()) if len(span) else 0
            codes = []
            for dx in range(max_span + 1):
                for dy in range(max_span + 1):
                    for dz in range(max_span + 1):
                        sel = ((span[:, 0] >= dx) & (span[:, 1] >= dy)
                               & (span[:, 2] >= dz))
                        if not sel.any():
                            continue
                        c = clo[sel] + [dx, dy, dz]
                        codes.append(_morton_np(c[:, 0], c[:, 1], c[:, 2]))
            cell_codes = (np.unique(np.concatenate(codes))
                          if codes else np.zeros(0, np.int64))

            # corner vertices on the (res + 1)^3 lattice, without repeats
            if len(cell_codes):
                x, y, z = (v.numpy() for v in morton3d_coords(
                    torch.from_numpy(cell_codes.astype(np.int64))))
                corners = [_morton_np(x + cx, y + cy, z + cz)
                           for cx in (0, 1) for cy in (0, 1) for cz in (0, 1)]
                vertex_codes = np.unique(np.concatenate(corners))
            else:
                vertex_codes = np.zeros(0, np.int64)

            self.levels.append(OctreeLevel(
                cell_codes.astype(np.int64), vertex_codes.astype(np.int64),
                total_vertices))
            total_vertices += len(vertex_codes)
        self.n_vertices = total_vertices
        self._tables: Dict[Tuple[int, str], Tuple[torch.Tensor,
                                                  torch.Tensor]] = {}

    def tables(self, level: int, device) -> Tuple[torch.Tensor,
                                                  torch.Tensor]:
        """(cell codes, vertex codes) of a level as int64 tensors on
        `device`, moved there once."""
        key = (level, str(torch.device(device)))
        if key not in self._tables:
            lvl = self.levels[level]
            self._tables[key] = (
                torch.from_numpy(lvl.cell_codes).to(device),
                torch.from_numpy(lvl.vertex_codes).to(device))
        return self._tables[key]

    def contains(self, pos: torch.Tensor, level: int) -> torch.Tensor:
        """(..., 3) in [0, 1]^3 -> whether each lies in an occupied cell."""
        res = 1 << level
        c = (pos * res).to(torch.int32).clamp(0, res - 1)
        code = morton3d(c[..., 0], c[..., 1], c[..., 2])
        table, _ = self.tables(level, pos.device)
        if table.numel() == 0:
            return torch.zeros(pos.shape[:-1], dtype=torch.bool,
                               device=pos.device)
        i = torch.searchsorted(table, code).clamp(0, table.numel() - 1)
        return table[i] == code

    def vertex_indices(self, level: int, cell_coords: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Integer cell coordinates (..., 3) -> (the 8 corner vertices'
        GLOBAL feature rows (..., 8), in x-major (cx, cy, cz) order;
        whether the cell is occupied)."""
        ctable, vtable = self.tables(level, cell_coords.device)
        offset = self.levels[level].vertex_offset
        x, y, z = (cell_coords[..., k] for k in range(3))
        code = morton3d(x, y, z)
        ci = torch.searchsorted(ctable, code).clamp(
            0, max(ctable.numel() - 1, 0))
        occupied = (ctable[ci] == code) if ctable.numel() else \
            torch.zeros(code.shape, dtype=torch.bool, device=code.device)
        ids = []
        for cx in (0, 1):
            for cy in (0, 1):
                for cz in (0, 1):
                    vc = morton3d(x + cx, y + cy, z + cz)
                    vi = torch.searchsorted(vtable, vc).clamp(
                        0, max(vtable.numel() - 1, 0))
                    ids.append(vi + offset)
        return torch.stack(ids, dim=-1), occupied
