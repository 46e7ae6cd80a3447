"""The wavefront renderer's march and pack as one CUDA kernel
(`csrc/nerf_march.cu`) behind `march_and_pack`.

It has no TPU counterpart: the JAX package marches with plain XLA
(instant_ngp_tpu/nerf/sampler.py::march_rays). Its plain PyTorch version is
`nerf/render.py::WavefrontRenderer._march_and_pack_plain`, and
`WavefrontRenderer._march_and_pack` calls this wrapper for CUDA tensors and
the plain version for CPU tensors. The wrapper takes CUDA tensors only: it
launches the kernel or raises, and never falls back. It counts its
launches (`march_and_pack.launches`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from ...common import (MAX_CONE_STEPSIZE, MIN_CONE_STEPSIZE, NERF_CASCADES,
                       NERF_GRID_N_CELLS)
from .grid_kernels import _check, _lib, _raise


@functools.lru_cache(maxsize=None)
def _stepping(cone_angle: float, device: torch.device):
    """The kernel's f32 stepping constants [min_step, max_step, inv_min,
    inv_max, log1p_c, a, b, at, bt] (ngp_march::Stepping) and its cone
    flag. A division of a CUDA tensor by a Python number multiplies by the
    number's f32 reciprocal, so the step sizes come with theirs; log1p_c
    .. bt are march.py::_stepping_constants as this device computes them,
    read once."""
    from ...nerf.march import _stepping_constants

    f32 = np.float32
    steps = [f32(MIN_CONE_STEPSIZE), f32(MAX_CONE_STEPSIZE)]
    steps += [f32(1.0) / v for v in steps]
    cone = cone_angle > 1e-5      # march.py's switch to the uniform step
    consts = steps + (torch.stack(_stepping_constants(cone_angle, device))
                      .tolist() if cone else [0.0] * 5)
    return (ctypes.c_float * 9)(*consts), int(cone)


def march_and_pack(origins: torch.Tensor, dirs: torch.Tensor,
                   bitfield: torch.Tensor, aabb_min: torch.Tensor,
                   aabb_max: torch.Tensor, cone_angle: float, max_mip: int,
                   n_march: int, max_samples_per_ray: int, n_cols: int,
                   chunk: int) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor, torch.Tensor]:
    """Rays (R, 3) f32 (normalized dirs) through the occupancy `bitfield`
    (uint8, at least max_mip + 1 cascades) in the box [aabb_min, aabb_max]
    -> (packed ts (R, n_cols) f32, packed ok (R, n_cols) bool, n_cand (R,)
    int64, valid (R,) bool), as WavefrontRenderer._march_and_pack_plain
    returns them: row r holds ray r's first `max_samples_per_ray` emitted
    candidates of `n_march` in time order; columns from n_cand up to the
    next multiple of `chunk` hold zeros, later ones are not written."""
    dev = origins.device
    if dev.type != "cuda":
        raise ValueError(f"march_and_pack: no kernel for {dev}")
    if origins.dim() != 2:
        raise ValueError(f"origins has shape {tuple(origins.shape)}")
    n = int(origins.shape[0])
    _check("origins", origins, torch.float32, (n, 3), dev)
    _check("dirs", dirs, torch.float32, (n, 3), dev)
    _check("aabb_min", aabb_min, torch.float32, (3,), dev)
    _check("aabb_max", aabb_max, torch.float32, (3,), dev)
    if not 0 <= max_mip < NERF_CASCADES:
        raise ValueError(f"march_and_pack: max_mip {max_mip}")
    n_bytes = (max_mip + 1) * NERF_GRID_N_CELLS // 8
    if bitfield.dim() != 1 or bitfield.numel() < n_bytes:
        raise ValueError(f"bitfield has shape {tuple(bitfield.shape)}, "
                         f"max_mip {max_mip} needs {n_bytes} bytes")
    _check("bitfield", bitfield, torch.uint8, tuple(bitfield.shape), dev)
    if not (0 <= n_march < 1 << 24 and chunk >= 1 and n_cols % chunk == 0
            and 1 <= max_samples_per_ray <= n_cols):
        raise ValueError(f"march_and_pack: n_march {n_march}, "
                         f"max_samples_per_ray {max_samples_per_ray}, "
                         f"n_cols {n_cols}, chunk {chunk}")
    if n >= 1 << 31:
        raise ValueError("march_and_pack: more than 2^31 rays")
    ts = torch.empty(n, n_cols, dtype=torch.float32, device=dev)
    ok = torch.empty(n, n_cols, dtype=torch.bool, device=dev)
    n_cand = torch.empty(n, dtype=torch.int64, device=dev)
    valid = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return ts, ok, n_cand, valid
    consts, cone = _stepping(float(cone_angle), dev)
    with torch.cuda.device(dev):
        err = _lib().nerf_march_pack_launch(
            origins.data_ptr(), dirs.data_ptr(), bitfield.data_ptr(),
            aabb_min.data_ptr(), aabb_max.data_ptr(), consts, cone,
            int(max_mip), int(n_march), int(max_samples_per_ray),
            int(n_cols), int(chunk), n, ts.data_ptr(), ok.data_ptr(),
            n_cand.data_ptr(), valid.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise("march_and_pack", err)
    march_and_pack.launches += 1
    return ts, ok, n_cand, valid


march_and_pack.launches = 0
