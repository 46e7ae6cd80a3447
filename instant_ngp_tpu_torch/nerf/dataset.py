"""Device-resident NeRF training data and the scene constants fixed at
load (counterpart of instant_ngp_tpu/nerf/dataset.py).

- `NerfTrainingData`: the images packed as one (N, H, W, 4) tensor that
  stays uint8 (LDR) or float16 (HDR) on the device and is converted at
  gather time by `read_rgba` (sRGB to linear, premultiplied alpha, the
  hot-pink mask to -1), plus the per-image camera tensors;
- `NerfSceneConfig`: the aabb from aabb_scale, max_cascade =
  log2(aabb_scale), cone angle 0 for unit scenes else 1/256, Exponential
  RGB for HDR data else Logistic, and the lens of the first image.
Depth images pack as (N, H, W) metric depths (0 = no depth); a dataset with
light directions carries them as per-image extra dims, one with
`n_extra_learnable_dims` gets latent codes drawn from N(0, 0.1).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..camera import lens_mode_id
from ..common import NERF_CASCADES
from ..data.nerf_loader import NerfDataset


@dataclasses.dataclass
class NerfTrainingData:
    """All tensors a train step reads, on one device."""

    pixels: torch.Tensor            # (N, Hmax, Wmax, 4) uint8 | float16
    resolutions: torch.Tensor       # (N, 2) float32 true (w, h) per image
    xforms_start: torch.Tensor      # (N, 3, 4)
    xforms_end: torch.Tensor        # (N, 3, 4)
    focal_lengths: torch.Tensor     # (N, 2)
    principal_points: torch.Tensor  # (N, 2)
    rolling_shutter: torch.Tensor   # (N, 4)
    lens_params: torch.Tensor       # (N, 7)
    exposures: torch.Tensor         # (N, 3) log2-exposure per image
    depths: Optional[torch.Tensor] = None      # (N, Hmax, Wmax) float32
    extra_dims: Optional[torch.Tensor] = None  # (N, n_extra) latent codes

    @property
    def n_images(self) -> int:
        return self.pixels.shape[0]

    @property
    def resolution(self) -> Tuple[int, int]:
        """(W, H)."""
        return self.pixels.shape[2], self.pixels.shape[1]


@dataclasses.dataclass
class NerfSceneConfig:
    aabb_scale: int
    max_cascade: int
    cone_angle_constant: float
    rgb_activation: str
    density_activation: str
    aabb_min: np.ndarray
    aabb_max: np.ndarray
    n_extra_dims: int
    lens_mode: int = 0
    near_distance: float = 0.0


def scene_config(aabb_scale: int = 1, is_hdr: bool = False,
                 n_extra_dims: int = 0) -> NerfSceneConfig:
    if aabb_scale & (aabb_scale - 1) or not 1 <= aabb_scale <= (
            1 << (NERF_CASCADES - 1)):
        raise ValueError(f"aabb_scale must be a power of two <= "
                         f"{1 << (NERF_CASCADES - 1)}, got {aabb_scale}")
    side = min(aabb_scale, 128)
    return NerfSceneConfig(
        aabb_scale=aabb_scale,
        max_cascade=int(math.log2(aabb_scale)) if aabb_scale > 1 else 0,
        cone_angle_constant=0.0 if aabb_scale <= 1 else 1.0 / 256.0,
        rgb_activation="Exponential" if is_hdr else "Logistic",
        density_activation="Exponential",
        aabb_min=np.full(3, 0.5 - side / 2, np.float32),
        aabb_max=np.full(3, 0.5 + side / 2, np.float32),
        n_extra_dims=n_extra_dims,
    )


def scene_config_from_dataset(ds: NerfDataset) -> NerfSceneConfig:
    scene = scene_config(ds.aabb_scale, ds.is_hdr, ds.n_extra_dims)
    scene.lens_mode = lens_mode_id(ds.metadata[0].lens.mode)
    return scene


def pack_training_data(ds: NerfDataset, device,
                       generator: Optional[torch.Generator] = None,
                       extra_dims=None) -> NerfTrainingData:
    """Pack the per-image host arrays into tensors on `device`. Images of
    different sizes are padded to the largest; `resolutions` keeps each
    image's true (w, h), and every uv is relative to it, so the padding
    is never sampled. Learnable latent codes start at 0.1 * N(0, 1) drawn
    from `generator` (a CPU generator; seed 0 by default), or at
    `extra_dims` (N, n_extra) where the caller supplies them."""
    res_list = [m.resolution for m in ds.metadata]  # (w, h) per image
    w_max = max(r[0] for r in res_list)
    h_max = max(r[1] for r in res_list)
    if len(set(res_list)) == 1:
        imgs = np.stack(ds.images)  # (N, H, W, 4)
    else:
        imgs = np.zeros((len(ds.images), h_max, w_max, 4),
                        ds.images[0].dtype)
        for i, im in enumerate(ds.images):
            imgs[i, :im.shape[0], :im.shape[1]] = im

    def f32(a):
        return torch.from_numpy(np.array(a, np.float32)).to(device)

    depths = None
    if any(d is not None for d in ds.depths):
        depths = np.zeros((len(ds.images), h_max, w_max), np.float32)
        for i, d in enumerate(ds.depths):
            if d is not None:
                depths[i, :d.shape[0], :d.shape[1]] = d

    extra = None
    if ds.n_extra_dims:
        if extra_dims is not None:
            extra = np.asarray(extra_dims, np.float32).reshape(
                ds.n_images, ds.n_extra_dims)
        elif ds.has_light_dirs:
            extra = np.stack([m.light_dir for m in ds.metadata])
        else:
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            extra = 0.1 * torch.randn(
                ds.n_images, ds.n_extra_learnable_dims,
                generator=generator).numpy()

    return NerfTrainingData(
        pixels=torch.from_numpy(imgs).to(device),
        resolutions=f32(res_list),
        xforms_start=f32(ds.xforms_start),
        xforms_end=f32(ds.xforms_end),
        focal_lengths=f32(np.stack([m.focal_length for m in ds.metadata])),
        principal_points=f32(
            np.stack([m.principal_point for m in ds.metadata])),
        rolling_shutter=f32(
            np.stack([m.rolling_shutter for m in ds.metadata])),
        lens_params=f32(np.stack([m.lens.params for m in ds.metadata])),
        exposures=torch.zeros(ds.n_images, 3, device=device),
        depths=None if depths is None else f32(depths),
        extra_dims=None if extra is None else f32(extra),
    )


def read_rgba(pixels: torch.Tensor, img_idx: torch.Tensor, px: torch.Tensor
              ) -> torch.Tensor:
    """Gather and convert pixels: pixels (N, H, W, 4) uint8 or float16,
    px (R, 2) integer (x, y) -> (R, 4) float32. uint8 is sRGB: converted
    to linear and premultiplied by alpha; the hot-pink mask colour
    (255, 0, 255, 0) becomes -1 in every channel."""
    h, w = pixels.shape[1], pixels.shape[2]
    x = px[:, 0].long().clamp(0, w - 1)
    y = px[:, 1].long().clamp(0, h - 1)
    raw = pixels[img_idx.long(), y, x]                      # (R, 4)
    if pixels.dtype != torch.uint8:
        return raw.float()
    val = raw.float() / 255.0
    rgb, alpha = val[:, :3], val[:, 3:4]
    lin = torch.where(rgb <= 0.04045, rgb / 12.92,
                      torch.pow((rgb + 0.055) / 1.055, 2.4))
    out = torch.cat([lin * alpha, alpha], dim=-1)
    masked = ((raw[:, 0] == 255) & (raw[:, 1] == 0)
              & (raw[:, 2] == 255) & (raw[:, 3] == 0))
    return torch.where(masked[:, None], -1.0, out)
