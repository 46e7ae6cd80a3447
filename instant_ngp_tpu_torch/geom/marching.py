"""Density-field pictures on the host: the per-axis grid resolution of a
box, the grayscale slice atlas and the false-colour slice (own copy of the
numpy helpers of instant_ngp_tpu/geom/marching.py; the mesh extraction
itself is not ported). PIL is imported only where the PNG is written.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np


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
