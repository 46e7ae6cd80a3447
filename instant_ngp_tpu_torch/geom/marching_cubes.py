"""Marching cubes with a 256-case table derived at import (own copy of
instant_ngp_tpu/geom/marching_cubes.py; numpy only).

The table is not the usual hard-coded 256 x 16 one: it is built by walking
surface cycles on each sign configuration.
- corners are indexed x + 2y + 4z; an edge is a (corner, corner) pair; an
  edge is cut when its endpoints straddle the iso value;
- on every face with two cut edges they connect; on an ambiguous face (4
  cut edges, diagonal corners inside) the cuts pair so the inside corners
  (field < iso) stay separated, the standard table's choice;
- the cut edges then form closed cycles; each fans into triangles,
  oriented so normals point to the outside (field > iso).
Extraction is vectorised: one table lookup per cell, up to 5 triangles a
cell, edge vertices shared between cells through global edge ids.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

# corner c = x + 2y + 4z; corner coordinates
_CORNER = np.array([[x, y, z] for z in (0, 1) for y in (0, 1)
                    for x in (0, 1)])  # index = x + 2y + 4z
_CORNER = _CORNER[np.argsort(_CORNER[:, 0] + 2 * _CORNER[:, 1]
                             + 4 * _CORNER[:, 2])]

# 12 edges as corner pairs (axis-aligned)
_EDGES: List[Tuple[int, int]] = []
for c in range(8):
    x, y, z = _CORNER[c]
    for axis, d in ((0, 1), (1, 2), (2, 4)):
        if _CORNER[c][axis] == 0:
            _EDGES.append((c, c + d))
_EDGES = sorted(set(tuple(sorted(e)) for e in _EDGES))
assert len(_EDGES) == 12

# 6 faces: (corner set, outward normal)
_FACES = []
for axis in range(3):
    for side in (0, 1):
        corners = tuple(c for c in range(8) if _CORNER[c][axis] == side)
        normal = np.zeros(3)
        normal[axis] = 1.0 if side else -1.0
        _FACES.append((corners, normal))

_EDGE_MID = np.array([(_CORNER[a] + _CORNER[b]) / 2.0 for a, b in _EDGES])


def _face_pairs(config: int, face, normal) -> List[Tuple[int, int]]:
    """DIRECTED cut-segment pairs (a -> b) on one face, oriented so the
    inside region lies left of a->b when viewed from outside along the
    face normal. Direction depends only on the face's own corner signs,
    so the two cells sharing a face (opposite normals) emit opposite
    directions — windings match and the mesh closes without holes."""
    inside = [(config >> c) & 1 for c in range(8)]
    cut = []
    for ei, (a, b) in enumerate(_EDGES):
        if a in face and b in face and inside[a] != inside[b]:
            cut.append(ei)
    if not cut:
        return []
    if len(cut) == 2:
        # unambiguous: the face's inside corners form one region
        ref_c = np.mean([_CORNER[c] for c in face if inside[c]], axis=0)
        pairs = [(cut[0], cut[1], ref_c)]
    else:
        # ambiguous face (diagonal corners inside): keep the inside
        # corners separated — each inside corner's two incident cut
        # edges pair together (the canonical MC choice)
        pairs = []
        for c in face:
            if inside[c]:
                inc = [ei for ei in cut if c in _EDGES[ei]]
                pairs.append((inc[0], inc[1], _CORNER[c].astype(float)))
    out = []
    for a, b, ref_c in pairs:
        d = _EDGE_MID[b] - _EDGE_MID[a]
        toward_inside = ref_c - (_EDGE_MID[a] + _EDGE_MID[b]) / 2.0
        if np.dot(np.cross(normal, d), toward_inside) < 0:
            a, b = b, a
        out.append((a, b))
    return out


def _build_case(config: int) -> List[Tuple[int, int, int]]:
    """Triangles (as edge-id triples) for one sign configuration."""
    if config in (0, 255):
        return []
    # directed successor map: each cut edge has exactly one outgoing and
    # one incoming segment -> disjoint directed cycles
    nxt = {}
    for face, normal in _FACES:
        for a, b in _face_pairs(config, face, normal):
            nxt[a] = b
    tris = []
    seen = set()
    for start in nxt:
        if start in seen:
            continue
        cycle = [start]
        seen.add(start)
        cur = nxt[start]
        while cur != start:
            cycle.append(cur)
            seen.add(cur)
            cur = nxt[cur]
        for k in range(1, len(cycle) - 1):
            # reversed fan: outward normals (positive signed volume
            # w.r.t. the inside = field < iso convention)
            tris.append((cycle[0], cycle[k + 1], cycle[k]))
    return tris


def _build_tables():
    tri_table = np.full((256, 15), -1, np.int32)
    n_tris = np.zeros(256, np.int32)
    for cfg in range(256):
        tris = _build_case(cfg)
        n_tris[cfg] = len(tris)
        flat = [e for t in tris for e in t]
        tri_table[cfg, :len(flat)] = flat
    return tri_table, n_tris


TRI_TABLE, N_TRIS = _build_tables()

_EDGE_C0 = np.array([e[0] for e in _EDGES], np.int32)
_EDGE_C1 = np.array([e[1] for e in _EDGES], np.int32)


def marching_cubes(field: np.ndarray, iso: float = 0.0,
                   origin=None, spacing=None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Extract the iso-surface of a dense (nx, ny, nz) scalar field.
    Returns (verts (V, 3) in index space, faces (F, 3)). Vectorized:
    per-cell table lookup, shared edge-vertex dedup via global edge ids."""
    field = np.asarray(field, np.float32)
    nx, ny, nz = field.shape
    cx, cy, cz = nx - 1, ny - 1, nz - 1
    if min(cx, cy, cz) < 1:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)

    # corner values per cell: (cx, cy, cz, 8)
    corners = np.empty((cx, cy, cz, 8), np.float32)
    for c in range(8):
        x, y, z = _CORNER[c]
        corners[..., c] = field[x:x + cx, y:y + cy, z:z + cz]
    inside = corners < iso
    config = np.zeros((cx, cy, cz), np.int32)
    for c in range(8):
        config |= inside[..., c].astype(np.int32) << c

    active = np.argwhere((config != 0) & (config != 255))
    if len(active) == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    cfg_a = config[active[:, 0], active[:, 1], active[:, 2]]

    # per active cell: emit up to 5 triangles of LOCAL edge ids
    tri_slots = TRI_TABLE[cfg_a]                       # (A, 15)
    slot_valid = tri_slots >= 0

    # global edge id: edge (cell_xyz, local edge) -> canonical
    # (corner coordinate, axis) so shared edges between cells unify
    cell = active[:, None, :]                          # (A, 1, 3)
    e_ids = np.where(slot_valid, tri_slots, 0)
    c0 = _EDGE_C0[e_ids]                               # (A, 15)
    base = cell + _CORNER[c0]                          # (A, 15, 3)
    axis = (_CORNER[_EDGE_C1[e_ids]]
            - _CORNER[c0]).argmax(-1)                  # (A, 15)
    gid = ((base[..., 0] * (ny + 1) + base[..., 1]) * (nz + 1)
           + base[..., 2]) * 3 + axis                  # (A, 15)

    flat_gid = gid[slot_valid]
    uniq, inv = np.unique(flat_gid, return_inverse=True)

    # interpolate each unique edge vertex
    u_axis = uniq % 3
    u_lin = uniq // 3
    ux = u_lin // ((ny + 1) * (nz + 1))
    uy = (u_lin // (nz + 1)) % (ny + 1)
    uz = u_lin % (nz + 1)
    p0 = np.stack([ux, uy, uz], -1).astype(np.float32)
    step = np.eye(3, dtype=np.float32)[u_axis]
    i1 = (p0 + step).astype(np.int64)
    v0 = field[ux, uy, uz]
    v1 = field[i1[:, 0], i1[:, 1], i1[:, 2]]
    denom = np.where(np.abs(v1 - v0) < 1e-12, 1.0, v1 - v0)
    t = np.clip((iso - v0) / denom, 0.0, 1.0)
    verts = p0 + t[:, None] * step

    # faces: every 3 consecutive valid slots form a triangle
    n_valid = slot_valid.sum()
    assert n_valid % 3 == 0
    faces = inv.reshape(-1, 3).astype(np.int32)
    verts = verts.astype(np.float32)
    if spacing is not None:
        verts = verts * np.asarray(spacing, np.float32)
    if origin is not None:
        verts = verts + np.asarray(origin, np.float32)
    return verts, faces
