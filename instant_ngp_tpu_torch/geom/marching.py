"""Meshes and density-field pictures on the host (own copy of
instant_ngp_tpu/geom/marching.py; numpy only, PIL imported only where a
PNG is written):
- `marching_tetrahedra`: each cell splits into 6 tetrahedra along its main
  diagonal, whose iso-crossings need no case table (about twice the
  triangles of marching cubes, watertight on shared faces);
- `weld_vertices`, `smooth_mesh` (1-ring Laplacian), `vertex_normals`,
  `save_mesh` (PLY or OBJ) and `load_mesh`, its inverse;
- the per-axis grid resolution of a box, the grayscale slice atlas and the
  false-colour slice.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

# Kuhn 6-tetrahedra split: every tet shares the main diagonal 0-7
# (corner index = x + 2y + 4z); tets follow edge paths 0->a->b->7
_TETS = np.array([
    [0, 1, 3, 7],
    [0, 3, 2, 7],
    [0, 2, 6, 7],
    [0, 6, 4, 7],
    [0, 4, 5, 7],
    [0, 5, 1, 7],
], dtype=np.int32)

_CORNERS = np.array([[x, y, z] for z in (0, 1) for y in (0, 1)
                     for x in (0, 1)], dtype=np.int32)
# corner index convention: x + 2y + 4z
_CORNERS = _CORNERS[np.argsort(_CORNERS[:, 0] + 2 * _CORNERS[:, 1]
                               + 4 * _CORNERS[:, 2])]


def _interp(p0, p1, v0, v1, iso):
    t = (iso - v0) / np.where(np.abs(v1 - v0) < 1e-12, 1e-12, v1 - v0)
    t = np.clip(t, 0.0, 1.0)[..., None]
    return p0 + t * (p1 - p0)


def marching_tetrahedra(field: np.ndarray, iso: float = 0.0,
                        origin=(0.0, 0.0, 0.0), spacing=None
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """field (X, Y, Z) scalar -> (verts (V,3), faces (F,3)).

    Surface where field crosses `iso`; vertex positions in world units
    origin + index*spacing. Vectorized over all cells and tets."""
    field = np.asarray(field, np.float32)
    nx, ny, nz = field.shape
    if spacing is None:
        spacing = (1.0 / max(nx - 1, 1),) * 3
    spacing = np.asarray(spacing, np.float32)
    origin = np.asarray(origin, np.float32)

    # cell corner values: (nx-1, ny-1, nz-1, 8)
    cv = np.empty((nx - 1, ny - 1, nz - 1, 8), np.float32)
    cp = np.empty((nx - 1, ny - 1, nz - 1, 8, 3), np.float32)
    base = np.stack(np.meshgrid(np.arange(nx - 1), np.arange(ny - 1),
                                np.arange(nz - 1), indexing="ij"), -1)
    for ci, (dx, dy, dz) in enumerate(_CORNERS):
        cv[..., ci] = field[dx:nx - 1 + dx, dy:ny - 1 + dy, dz:nz - 1 + dz]
        cp[..., ci, :] = (base + np.array([dx, dy, dz])) * spacing + origin

    cv = cv.reshape(-1, 8)
    cp = cp.reshape(-1, 8, 3)
    # quick reject cells with no crossing
    crossing = (cv.min(1) <= iso) & (cv.max(1) >= iso)
    cv = cv[crossing]
    cp = cp[crossing]
    if len(cv) == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)

    tris = []
    for tet in _TETS:
        v = cv[:, tet]                       # (C, 4)
        p = cp[:, tet]                       # (C, 4, 3)
        inside = v < iso                     # (C, 4)
        n_in = inside.sum(1)

        # case 1 vertex inside (or 3 inside → flip roles): one triangle
        for flip in (False, True):
            sel_in = ~inside if flip else inside
            cases = np.where((sel_in.sum(1) == 1))[0]
            if len(cases) == 0:
                continue
            idx_in = np.argmax(sel_in[cases], axis=1)
            others = np.array([[j for j in range(4) if j != i]
                               for i in range(4)])
            o = others[idx_in]               # (c, 3)
            a = p[cases, idx_in]
            va = v[cases, idx_in]
            tri = np.stack([
                _interp(a, p[cases, o[:, k]], va, v[cases, o[:, k]], iso)
                for k in range(3)], axis=1)
            tris.append(tri)

        # case 2 inside: quad = 2 triangles
        cases = np.where(n_in == 2)[0]
        if len(cases):
            ins = inside[cases]
            # indices of the two inside and two outside corners
            order = np.argsort(~ins, axis=1, kind="stable")
            i0, i1, o0, o1 = (order[:, 0], order[:, 1], order[:, 2],
                              order[:, 3])
            c = cases
            e00 = _interp(p[c, i0], p[c, o0], v[c, i0], v[c, o0], iso)
            e01 = _interp(p[c, i0], p[c, o1], v[c, i0], v[c, o1], iso)
            e10 = _interp(p[c, i1], p[c, o0], v[c, i1], v[c, o0], iso)
            e11 = _interp(p[c, i1], p[c, o1], v[c, i1], v[c, o1], iso)
            tris.append(np.stack([e00, e01, e10], axis=1))
            tris.append(np.stack([e10, e01, e11], axis=1))

    tri = np.concatenate(tris, axis=0)
    verts, faces = weld_vertices(tri)
    return verts, faces


def weld_vertices(tri_soup: np.ndarray, decimals: int = 6
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """(T, 3, 3) soup -> unique verts + index faces."""
    flat = tri_soup.reshape(-1, 3)
    key = np.round(flat, decimals)
    uniq, inv = np.unique(key, axis=0, return_inverse=True)
    # representative positions (first occurrence)
    seen = np.full(len(uniq), len(flat), np.int64)
    order = np.arange(len(flat))
    np.minimum.at(seen, inv, order)
    verts = flat[seen]
    faces = inv.reshape(-1, 3)
    # drop degenerate faces
    ok = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
          & (faces[:, 0] != faces[:, 2]))
    return verts.astype(np.float32), faces[ok]


def smooth_mesh(verts: np.ndarray, faces: np.ndarray,
                iterations: int = 1, lam: float = 0.5) -> np.ndarray:
    """1-ring Laplacian smoothing: each of `iterations` moves every vertex
    by `lam` towards the mean of its neighbours (counted once per edge of
    each face)."""
    v = verts.copy()
    for _ in range(iterations):
        acc = np.zeros_like(v)
        cnt = np.zeros(len(v), np.float32)
        for a, b in ((0, 1), (1, 2), (2, 0)):
            np.add.at(acc, faces[:, a], v[faces[:, b]])
            np.add.at(acc, faces[:, b], v[faces[:, a]])
            np.add.at(cnt, faces[:, a], 1)
            np.add.at(cnt, faces[:, b], 1)
        mean = acc / np.maximum(cnt, 1)[:, None]
        v = v + lam * (mean - v)
    return v


def vertex_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    fn = np.cross(verts[faces[:, 1]] - verts[faces[:, 0]],
                  verts[faces[:, 2]] - verts[faces[:, 0]])
    n = np.zeros_like(verts)
    for k in range(3):
        np.add.at(n, faces[:, k], fn)
    return n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)


def save_mesh(path: str, verts: np.ndarray, faces: np.ndarray,
              colors: Optional[np.ndarray] = None,
              normals: Optional[np.ndarray] = None) -> None:
    """Write a mesh as PLY (binary; `.ply`) or OBJ (any other suffix):
    vertices with optional colours in [0, 1] and normals, triangles."""
    if path.endswith(".ply"):
        _save_ply(path, verts, faces, colors, normals)
        return
    with open(path, "w") as f:
        f.write("# instant_ngp_tpu_torch mesh export\n")
        for i, v in enumerate(verts):
            if colors is not None:
                c = np.clip(colors[i], 0, 1)
                f.write(f"v {v[0]} {v[1]} {v[2]} {c[0]} {c[1]} {c[2]}\n")
            else:
                f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        if normals is not None:
            for n in normals:
                f.write(f"vn {n[0]} {n[1]} {n[2]}\n")
        for face in faces:
            a, b, c = face + 1
            if normals is not None:
                f.write(f"f {a}//{a} {b}//{b} {c}//{c}\n")
            else:
                f.write(f"f {a} {b} {c}\n")


def _save_ply(path, verts, faces, colors, normals):
    n_v, n_f = len(verts), len(faces)
    with open(path, "wb") as f:
        header = ["ply", "format binary_little_endian 1.0",
                  f"element vertex {n_v}",
                  "property float x", "property float y",
                  "property float z"]
        if normals is not None:
            header += ["property float nx", "property float ny",
                       "property float nz"]
        if colors is not None:
            header += ["property uchar red", "property uchar green",
                       "property uchar blue"]
        header += [f"element face {n_f}",
                   "property list uchar int vertex_indices", "end_header"]
        f.write(("\n".join(header) + "\n").encode())
        for i in range(n_v):
            f.write(verts[i].astype("<f4").tobytes())
            if normals is not None:
                f.write(normals[i].astype("<f4").tobytes())
            if colors is not None:
                f.write((np.clip(colors[i], 0, 1) * 255).astype(
                    np.uint8).tobytes())
        for face in faces:
            f.write(np.uint8(3).tobytes())
            f.write(face.astype("<i4").tobytes())


def load_mesh(path: str) -> Tuple[np.ndarray, np.ndarray,
                                   Optional[np.ndarray]]:
    """Read back what `save_mesh` wrote -> (verts (V, 3) float32, faces
    (F, 3) int64, colours (V, 3) float32 in [0, 1] or None)."""
    if path.endswith(".ply"):
        with open(path, "rb") as f:
            raw = f.read()
        head, body = raw.split(b"end_header\n", 1)
        lines = head.decode().splitlines()
        n_v = next(int(ln.split()[2]) for ln in lines
                   if ln.startswith("element vertex"))
        n_f = next(int(ln.split()[2]) for ln in lines
                   if ln.startswith("element face"))
        props = [ln.split()[2] for ln in lines[:lines.index(
            f"element face {n_f}")] if ln.startswith("property")]
        fields = [(p, "<f4") for p in props
                  if p not in ("red", "green", "blue")]
        fields += [(p, "u1") for p in props if p in ("red", "green", "blue")]
        vert = np.frombuffer(body, np.dtype(fields), n_v)
        face = np.frombuffer(body, np.dtype([("n", "u1"), ("i", "<i4", 3)]),
                             n_f, vert.nbytes)
        verts = np.stack([vert["x"], vert["y"], vert["z"]], -1)
        colors = None
        if "red" in props:
            colors = np.stack([vert[c] for c in ("red", "green", "blue")],
                              -1).astype(np.float32) / 255.0
        return verts.astype(np.float32), face["i"].astype(np.int64), colors
    verts, colors, faces = [], [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if parts and parts[0] == "v":
                verts.append([float(v) for v in parts[1:4]])
                colors.append([float(v) for v in parts[4:7]])
            elif parts and parts[0] == "f":
                faces.append([int(p.split("/")[0]) - 1 for p in parts[1:4]])
    colors = np.asarray(colors, np.float32) \
        if colors and all(len(c) == 3 for c in colors) else None
    return (np.asarray(verts, np.float32).reshape(-1, 3),
            np.asarray(faces, np.int64).reshape(-1, 3), colors)


def marching_cubes_res(res_1d: int, aabb_min, aabb_max):
    """Per-axis grid resolution proportional to the AABB extents, each
    rounded up to a multiple of 16."""
    ext = np.asarray(aabb_max, np.float64) - np.asarray(aabb_min,
                                                        np.float64)
    scale = float(res_1d) / max(float(ext.max()), 1e-9)
    res3d = np.floor(ext * scale + 0.5).astype(np.int64)
    res3d = np.maximum(res3d, 1)
    res3d = (res3d + 15) // 16 * 16
    return tuple(int(v) for v in res3d)


def density_slice_atlas(field: np.ndarray, thresh: float,
                        density_range: float = 4.0,
                        flip_y_and_z: bool = False) -> np.ndarray:
    """Tile a (X, Y, Z) scalar field into one grayscale slice atlas:
    floor(sqrt(n_slices)) tile rows, slices filling each row left to
    right; pixel value maps [thresh - range, thresh + range] onto
    [0, 256) with 128 at the threshold; unused tiles are black.

    Default orientation: one tile per z slice, vertical axis is y with
    +y up (flipped). flip_y_and_z: one tile per *y* slice, vertical
    axis is z, unflipped. Returns a uint8 (H, W) image."""
    f = np.asarray(field, np.float32)
    assert f.ndim == 3, "field must be (X, Y, Z)"
    if flip_y_and_z:
        # stack[slice, v, u] = field[u, slice, v]
        stack = f.transpose(1, 2, 0)
    else:
        # stack[slice, v, u] = field[u, Y-1-v, slice]
        stack = f.transpose(2, 1, 0)[:, ::-1, :]
    n, h, w = stack.shape
    px = np.clip((stack - thresh) * (128.0 / density_range) + 128.5,
                 0.0, 255.0).astype(np.uint8)
    ndown = max(int(math.sqrt(n)), 1)
    nacross = (n + ndown - 1) // ndown
    pad = ndown * nacross - n
    if pad:
        px = np.concatenate(
            [px, np.zeros((pad, h, w), np.uint8)], axis=0)
    return px.reshape(ndown, nacross, h, w).transpose(
        0, 2, 1, 3).reshape(ndown * h, nacross * w)


def save_density_slices_png(path: str, field: np.ndarray, thresh: float,
                            density_range: float = 4.0,
                            flip_y_and_z: bool = False) -> None:
    """Write the grayscale slice atlas of `field` as a PNG (raw byte
    values, no color management)."""
    from PIL import Image

    atlas = density_slice_atlas(field, thresh, density_range,
                                flip_y_and_z)
    Image.fromarray(atlas, mode="L").save(path)


def density_slice_image(field: np.ndarray, axis: int = 2,
                        index: Optional[int] = None) -> np.ndarray:
    """False-colour picture of one slice of a scalar field, scaled between
    its 1st and 99th percentile."""
    if index is None:
        index = field.shape[axis] // 2
    sl = np.take(field, index, axis=axis).astype(np.float32)
    lo, hi = np.percentile(sl, [1, 99])
    norm = np.clip((sl - lo) / max(hi - lo, 1e-9), 0, 1)
    r = np.clip(norm * 3, 0, 1)
    g = np.clip(norm * 3 - 1, 0, 1)
    b = np.clip(norm * 3 - 2, 0, 1)
    return np.stack([r, g, b], axis=-1)
