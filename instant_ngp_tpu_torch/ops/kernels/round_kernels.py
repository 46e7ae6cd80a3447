"""The wavefront renderer's RGB-net input rows as one CUDA kernel
(`csrc/nerf_network_round.cu`) behind `rgb_net_rows`.

It has no TPU counterpart: the JAX package builds these rows with plain XLA
(instant_ngp_tpu/nerf/model.py::apply_components). The plain version is
`rgb_net_rows_plain`, what a round of `nerf/render.py::_eval_network`
computes; `nerf/render.py::_eval_network_rows` calls the wrapper where a
round's direction features are SH degree 4 alone, on the card, outside
autograd. The wrapper takes CUDA tensors only: it launches the kernel or
raises, and never falls back. It counts its launches
(`rgb_net_rows.launches`).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..encodings import SphericalHarmonicsEncoding
from .grid_kernels import _check, _lib, _raise

#: the density net's outputs and the SH basis of degree 4: a row's halves
N_DENSITY_OUT = 16
N_SH = 16


def rgb_net_rows_plain(density_out: torch.Tensor, ray_dirs: torch.Tensor,
                       samples_per_ray: int, row_offset: int = 0
                       ) -> torch.Tensor:
    """The plain round's rows: each ray's direction expanded to its
    `samples_per_ray` rows and warped to [0, 1], SH degree 4 of it (the
    encoding unwarps), concatenated after the density outputs."""
    n = density_out.shape[0]
    dirw = ((ray_dirs + 1.0) * 0.5)[:, None, :].expand(
        -1, samples_per_ray, -1).reshape(-1, 3)[row_offset:row_offset + n]
    return torch.cat([density_out,
                      SphericalHarmonicsEncoding(3, 4)(dirw).float()], dim=-1)


def rgb_net_rows(density_out: torch.Tensor, ray_dirs: torch.Tensor,
                 samples_per_ray: int, row_offset: int = 0,
                 raw_density: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """density_out (n, 16) float32: the density net's outputs of rows
    row_offset .. row_offset + n of a round whose ray b owns the rows
    b * samples_per_ray .. (b + 1) * samples_per_ray - 1; ray_dirs (B, 3)
    float32, the rays' unit directions -> (n, 32) float32, the bits of
    `rgb_net_rows_plain`. `raw_density` (n,) float32, where given, receives
    column 0 of density_out (the raw density the composite reads)."""
    dev = density_out.device
    if density_out.dim() != 2 or ray_dirs.dim() != 2:
        raise ValueError(f"rgb_net_rows: density_out "
                         f"{tuple(density_out.shape)}, ray_dirs "
                         f"{tuple(ray_dirs.shape)}")
    n, n_rays = int(density_out.shape[0]), int(ray_dirs.shape[0])
    _check("density_out", density_out, torch.float32, (n, N_DENSITY_OUT),
           dev)
    _check("ray_dirs", ray_dirs, torch.float32, (n_rays, 3), dev)
    k, row0 = int(samples_per_ray), int(row_offset)
    if k < 1 or row0 < 0 or row0 + n > n_rays * k:
        raise ValueError(f"rgb_net_rows: rows {row0} .. {row0 + n} of "
                         f"{n_rays} rays x {k} samples")
    if n_rays * k >= 1 << 31:
        raise ValueError("rgb_net_rows: more than 2^31 rows in the round")
    if raw_density is not None:
        _check("raw_density", raw_density, torch.float32, (n,), dev)
    if dev.type != "cuda":
        raise ValueError(f"rgb_net_rows: no kernel for {dev}")
    if density_out.data_ptr() % 16:
        raise ValueError("rgb_net_rows: density_out must be 16-byte aligned "
                         "(a thread moves a float4)")
    out = torch.empty(n, N_DENSITY_OUT + N_SH, dtype=torch.float32,
                      device=dev)
    if n == 0:
        return out
    with torch.cuda.device(dev):
        err = _lib().nerf_rgb_net_rows_launch(
            density_out.data_ptr(), ray_dirs.data_ptr(), n, n_rays, k, row0,
            out.data_ptr(),
            None if raw_density is None else raw_density.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise("rgb_net_rows", err)
    rgb_net_rows.launches += 1
    return out


rgb_net_rows.launches = 0
