"""Triangle BVH on the host: a ctypes binding of the port's own C++ source
(counterpart of instant_ngp_tpu/geom/triangle_bvh.py).

`csrc/triangle_bvh.cpp` is compiled with g++ on first use by
`ops/kernels/_build.py::build_host_library` into the gitignored
`build/instant_ngp_tpu_torch/` (a failed build raises with the compiler's
output). It is host code, as in the JAX package, not a kernel: it labels
SDF training samples (signed distance in the Watertight, Raystab and
Unsigned modes), traces the ground-truth frames and scores IoU. Inputs and
outputs are numpy arrays. PathEscape (OptiX-only in instant-ngp) is
approximated by Raystab, as instant-ngp itself does without OptiX.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np


@functools.lru_cache(maxsize=1)
def _load_library() -> ctypes.CDLL:
    from ..ops.kernels._build import build_host_library

    lib = ctypes.CDLL(str(build_host_library("triangle_bvh.cpp")))
    fp, ip = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int)
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.bvh_build.restype = ptr
    lib.bvh_build.argtypes = [fp, i32, i32]
    lib.bvh_free.argtypes = [ptr]
    lib.bvh_n_nodes.argtypes = [ptr]
    lib.bvh_n_nodes.restype = i32
    lib.bvh_signed_distance.argtypes = [ptr, fp, i32, fp, i32, f32, f32]
    lib.bvh_ray_trace.argtypes = [ptr, fp, fp, i32, fp, ip]
    lib.bvh_closest_point.argtypes = [ptr, fp, i32, fp, ip]
    return lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))


def _points(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.float32).reshape(-1, 3)


_SDF_MODES = {"Watertight": 0, "Raystab": 1, "PathEscape": 1, "Unsigned": 2}


class TriangleBvh:
    """BVH over a triangle soup (n, 3, 3) float32."""

    def __init__(self, triangles: np.ndarray, leaf_size: int = 4):
        self.triangles = np.ascontiguousarray(triangles, np.float32) \
            .reshape(-1, 3, 3)
        self._lib = _load_library()
        self._handle = self._lib.bvh_build(
            _fptr(self.triangles), len(self.triangles), leaf_size)

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.bvh_free(self._handle)
            self._handle = None

    @property
    def n_nodes(self) -> int:
        return self._lib.bvh_n_nodes(self._handle)

    def signed_distance(self, positions: np.ndarray, mode: str = "Raystab",
                        rng_offset: Tuple[float, float] = (0.0, 0.0)
                        ) -> np.ndarray:
        """(n, 3) points -> (n,) signed distances (negative inside);
        `rng_offset` rotates Raystab's lattice of stab rays."""
        pos = _points(positions)
        out = np.empty(len(pos), np.float32)
        self._lib.bvh_signed_distance(
            self._handle, _fptr(pos), len(pos), _fptr(out),
            _SDF_MODES[mode], rng_offset[0], rng_offset[1])
        return out

    def ray_trace(self, origins: np.ndarray, dirs: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray]:
        """-> (t, triangle index); t = 10 (MAX_DIST) and index -1 on a
        miss."""
        o, d = _points(origins), _points(dirs)
        t = np.empty(len(o), np.float32)
        idx = np.empty(len(o), np.int32)
        self._lib.bvh_ray_trace(self._handle, _fptr(o), _fptr(d), len(o),
                                _fptr(t), _iptr(idx))
        return t, idx

    def closest_point(self, positions: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """-> (closest points on the mesh (n, 3), their triangles (n,))."""
        pos = _points(positions)
        out = np.empty_like(pos)
        idx = np.empty(len(pos), np.int32)
        self._lib.bvh_closest_point(self._handle, _fptr(pos), len(pos),
                                    _fptr(out), _iptr(idx))
        return out, idx

    def triangle_normals(self) -> np.ndarray:
        a, b, c = (self.triangles[:, 0], self.triangles[:, 1],
                   self.triangles[:, 2])
        n = np.cross(b - a, c - a)
        return n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True),
                              1e-12)


def load_obj(path: str) -> np.ndarray:
    """An OBJ file as a triangle soup (n, 3, 3) float32: `v` and `f` lines,
    polygons fan-triangulated, 1-based or negative indices."""
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]),
                              float(parts[3])])
            elif line.startswith("f "):
                idx = [int(p.split("/")[0]) for p in line.split()[1:]]
                for i in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[i], idx[i + 1]])
    v = np.asarray(verts, np.float32)
    f = np.asarray(faces, np.int64)
    f = np.where(f > 0, f - 1, len(v) + f)
    return v[f]


def normalize_mesh_to_unit_cube(triangles: np.ndarray,
                                inflation: float = 1.0 / 9.0
                                ) -> Tuple[np.ndarray, float, np.ndarray]:
    """Scale and centre a mesh into the unit cube, leaving a margin of
    `inflation` of the cube on each side (instant-ngp's load_mesh,
    testbed_sdf.cu:1099-1184) -> (triangles, scale, offset) with world =
    mesh * scale + offset."""
    lo = triangles.reshape(-1, 3).min(0)
    hi = triangles.reshape(-1, 3).max(0)
    size = float((hi - lo).max())
    scale = (1.0 - 2 * inflation) / size
    center = (hi + lo) * 0.5
    offset = 0.5 - center * scale
    out = triangles * scale + offset
    return out.astype(np.float32), scale, offset.astype(np.float32)
