"""Training-ray generation, marching through the occupancy grid and sample
compaction (counterpart of instant_ngp_tpu/nerf/sampler.py).

1. `generate_rays`: one ray per lane from a random (image, pixel): the
   target colour is read, the ray built through the image's camera (with
   its rolling shutter), clipped to the aabb, and its start jittered by a
   fraction of one step. The random numbers come as a `TrainDraws`: drawn
   by `draw_train_randoms` from a `torch.Generator`, or supplied by the
   caller (the tests feed the JAX package's own draws). The pick is
   uniform over images and pixels, or, given the error map's CDFs, half
   of it follows them (`sample_rays`). `build_rays` is differentiable in
   the per-image camera offsets `cam` = {"pos" (N, 3) translations, "rot"
   (N, 3) axis-angle rotations applied on the left, "focal" (2,) relative
   focal-length offset} and in the trained `distortion_map`; the rays go
   through the lens `lens_mode` names with each image's `lens_params`.
2. `march_rays`: occupancy at the analytic (R, n_march) candidate grid.
   The sequential DDA march of the reference always lands on integer
   stepping-space coordinates, so every position it can visit is
   from_stepping_space(s0 + k). Testing occupancy at all k at once emits
   the same sample set; since the bitfield is max-pooled across mips, a
   candidate the DDA would skip tests empty at its own mip as well.
3. `compact_samples`: prefix-sum compaction of the emitted candidates
   into flat (capacity,) buffers: a prefix sum gives every emitted
   candidate its slot, one scatter inverts slot -> candidate. Ray-major
   for training (each ray's samples contiguous), depth-major for
   `render_tile` (a capacity that truncates sheds the deep tail of every
   ray). No sort, no host sync, no `torch.nonzero`.

A sample carries the warped position in [0,1]^3, the warped direction
dir/2 + 0.5 and the warped dt.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..camera import uv_to_ray, xform_with_rolling_shutter
from .dataset import NerfTrainingData, read_rgba
from .march import (advance_n_steps, calc_dt, density_grid_occupied_at,
                    from_stepping_space, mip_from_dt, ray_intersect_aabb,
                    to_stepping_space, warp_dt)


class RayBatch(NamedTuple):
    origins: torch.Tensor    # (R, 3)
    dirs: torch.Tensor       # (R, 3) normalized
    t_start: torch.Tensor    # (R,) march start
    valid: torch.Tensor      # (R,) bool (masked pixels and misses excluded)
    # training rays only
    img_idx: Optional[torch.Tensor] = None   # (R,) source image
    uv: Optional[torch.Tensor] = None        # (R, 2) position in the image
    rgba: Optional[torch.Tensor] = None      # (R, 4) premultiplied linear


class SampleBatch(NamedTuple):
    """Compacted flat samples and the per-ray segment table."""

    positions: torch.Tensor  # (S, 3) warped
    dirs: torch.Tensor       # (S, 3) warped
    dts: torch.Tensor        # (S,) warped
    t_mid: torch.Tensor      # (S,) ray distance of the sample
    ray_id: torch.Tensor     # (S,) source ray lane of each sample
    ray_base: torch.Tensor   # (R,) first sample index of each ray
    ray_count: torch.Tensor  # (R,) number of samples of each ray
    n_samples: torch.Tensor  # () valid samples (<= S)
    cand_slot: torch.Tensor  # (R, M) flat sample index of each candidate;
    #                          >= S means "no kept sample here"
    cand_src: torch.Tensor   # (S,) flat candidate index (r*M + k) of each
    #                          sample; == R*M in the invalid tail


class TrainDraws(NamedTuple):
    """The random numbers of one train step. The last five are needed only
    when the pick follows the error map's CDFs (`sample_rays`); `img_idx`
    and `uv` only when it does not."""

    img_idx: Optional[torch.Tensor]  # (R,) integer in [0, n_images)
    uv: Optional[torch.Tensor]     # (R, 2) in [0, 1)
    motionblur_time: torch.Tensor  # (R,) in [0, 1)
    start_jitter: torch.Tensor     # (R,) in [0, 1): fraction of a step
    bg_color: torch.Tensor         # (R, 3) in [0, 1): sRGB background
    u_img: Optional[torch.Tensor] = None    # (R,) in [0, 1): the image
    use_cdf: Optional[torch.Tensor] = None  # (R,) bool: image by the CDF
    u2: Optional[torch.Tensor] = None       # (R, 2): (column, row) lookups
    u_mix: Optional[torch.Tensor] = None    # (R, 2): < 0.5 keeps uniform
    jitter: Optional[torch.Tensor] = None   # (R, 2): place inside the cell

    def to(self, device) -> "TrainDraws":
        return TrainDraws(*(None if v is None else v.to(device)
                            for v in self))


def draw_train_randoms(generator: torch.Generator, n_rays: int,
                       n_images: int, with_cdf: bool = False) -> TrainDraws:
    """Uniform draws on the generator's device; `with_cdf` draws what the
    error-map pick needs instead of the uniform image and pixel."""
    dev = generator.device

    def uniform(*shape):
        return torch.rand(*shape, generator=generator, device=dev)

    common = dict(motionblur_time=uniform(n_rays),
                  start_jitter=uniform(n_rays), bg_color=uniform(n_rays, 3))
    if with_cdf:
        return TrainDraws(
            img_idx=None, uv=None, u_img=uniform(n_rays),
            use_cdf=uniform(n_rays) >= 0.5, u2=uniform(n_rays, 2),
            u_mix=uniform(n_rays, 2), jitter=uniform(n_rays, 2), **common)
    return TrainDraws(
        img_idx=torch.randint(0, n_images, (n_rays,), generator=generator,
                              device=dev),
        uv=uniform(n_rays, 2), **common)


def sample_rays(draws: TrainDraws, data: NerfTrainingData,
                snap_to_pixel_centers: bool = False,
                error_cdfs: Optional[Dict[str, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(img_idx, uv, motionblur_time) per lane: uniform over images and
    pixels, or, with `error_cdfs` = {"cdf_img" (N,), "cdf_y" (N, H_c),
    "cdf_x_cond_y" (N, H_c, W_c)}, importance-sampled by the error map:
    half of the lanes take their image from its CDF, and half of the
    pixels come from the image's 2D CDF (a row by `cdf_y`, a column by the
    row's conditional CDF, a jittered place inside that cell), the other
    halves stay uniform."""
    if error_cdfs is None:
        img_idx, uv = draws.img_idx.long(), draws.uv
    else:
        n_images = data.n_images
        u_img = draws.u_img
        img_uniform = (u_img * n_images).to(torch.int32).long() % n_images
        img_cdf = torch.searchsorted(error_cdfs["cdf_img"], u_img)
        img_idx = torch.where(draws.use_cdf, img_cdf,
                              img_uniform).clamp(0, n_images - 1)
        cdf_y, cdf_x = error_cdfs["cdf_y"], error_cdfs["cdf_x_cond_y"]
        ch, cw = cdf_y.shape[1], cdf_x.shape[2]
        u2 = draws.u2
        # the first entry not below the lookup (ties resolve to the left)
        row = torch.searchsorted(cdf_y[img_idx], u2[:, 1:2].contiguous()
                                 )[:, 0].clamp(0, ch - 1)
        col = torch.searchsorted(cdf_x[img_idx, row],
                                 u2[:, 0:1].contiguous()
                                 )[:, 0].clamp(0, cw - 1)
        uv_cdf = torch.stack([(col + draws.jitter[:, 0]) / cw,
                              (row + draws.jitter[:, 1]) / ch], dim=-1)
        uv = torch.where(draws.u_mix < 0.5, draws.u_mix * 2.0, uv_cdf)
    if snap_to_pixel_centers:
        res = data.resolutions[img_idx]
        uv = (torch.floor(uv * res) + 0.5) / res
    return img_idx, uv, draws.motionblur_time


def rotvec_matrix(r: torch.Tensor) -> torch.Tensor:
    """(..., 3) axis-angle -> (..., 3, 3) rotation, differentiable AT ZERO.

    The unnormalised Rodrigues form R = I + a K + b K^2 with a = sin(t)/t
    and b = (1 - cos(t))/t^2, and their Taylor series below t^2 = 1e-8.
    Camera offsets start at exactly zero, where a norm has a NaN gradient:
    the square root is taken of a safe argument there, so the untaken
    branch's gradient is finite as well."""
    rx, ry, rz = r[..., 0], r[..., 1], r[..., 2]
    zero = torch.zeros_like(rx)
    K = torch.stack([torch.stack([zero, -rz, ry], -1),
                     torch.stack([rz, zero, -rx], -1),
                     torch.stack([-ry, rx, zero], -1)], -2)
    t2 = (r * r).sum(dim=-1)[..., None, None]
    small = t2 < 1e-8
    safe_t2 = torch.where(small, 1.0, t2)
    t = torch.sqrt(safe_t2)
    a = torch.where(small, 1.0 - t2 / 6.0, torch.sin(t) / t)
    b = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(t)) / safe_t2)
    eye = torch.eye(3, dtype=r.dtype, device=r.device).expand_as(K)
    return eye + a * K + b * (K @ K)


def build_rays(data: NerfTrainingData, img_idx: torch.Tensor,
               uv: torch.Tensor, motionblur_time: torch.Tensor,
               lens_mode: int,
               cam: Optional[Dict[str, torch.Tensor]] = None,
               distortion_map: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """uv and image -> (origins, normalized dirs, valid); differentiable in
    the camera offsets `cam` {"pos", "rot", "focal"} and in the
    `distortion_map` (H, W, 2) when given."""
    xform = xform_with_rolling_shutter(
        data.xforms_start[img_idx], data.xforms_end[img_idx],
        data.rolling_shutter[img_idx], uv, motionblur_time)
    focal = data.focal_lengths[img_idx]
    if cam is not None:
        rot = rotvec_matrix(cam["rot"][img_idx])               # (R, 3, 3)
        new_t = (xform[..., :3, 3] + cam["pos"][img_idx])[..., None]
        xform = torch.cat([rot @ xform[..., :3, :3], new_t], dim=-1)
        focal = focal * (1.0 + cam["focal"][None, :])
    origins, dirs_un, ray_ok = uv_to_ray(
        uv, data.resolutions[img_idx], focal, xform,
        screen_center=(0.5, 0.5), lens_mode=lens_mode,
        lens_params=data.lens_params[img_idx],
        distortion_map=distortion_map)
    dirs = dirs_un / torch.linalg.norm(dirs_un, dim=-1, keepdim=True)
    return origins, dirs, ray_ok


def generate_rays(draws: TrainDraws, data: NerfTrainingData,
                  aabb_min: torch.Tensor, aabb_max: torch.Tensor,
                  cone_angle: float, lens_mode: int,
                  snap_to_pixel_centers: bool = False, cam=None,
                  error_cdfs=None, distortion_map=None
                  ) -> Tuple[RayBatch, torch.Tensor]:
    """One ray per lane -> (rays, motionblur_time)."""
    img_idx, uv, motionblur_time = sample_rays(
        draws, data, snap_to_pixel_centers, error_cdfs)
    # truncation towards zero picks the pixel, as the reference does
    px = (uv * data.resolutions[img_idx]).to(torch.int32)
    rgba = read_rgba(data.pixels, img_idx, px)
    valid = rgba[:, 0] >= 0.0          # the hot-pink mask skips the lane

    origins, dirs, ray_ok = build_rays(data, img_idx, uv, motionblur_time,
                                       lens_mode, cam, distortion_map)
    tmin, tmax = ray_intersect_aabb(origins, dirs, aabb_min, aabb_max)
    tmin = tmin.clamp(min=0.0)
    valid = valid & ray_ok & (tmax >= tmin)
    t_start = advance_n_steps(tmin, cone_angle, draws.start_jitter)
    return RayBatch(origins, dirs, t_start, valid, img_idx, uv, rgba), \
        motionblur_time


def march_rays(rays: RayBatch, bitfield: torch.Tensor,
               aabb_min: torch.Tensor, aabb_max: torch.Tensor,
               cone_angle: float, max_mip: int, n_march: int,
               max_samples_per_ray: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (ts, dts, emit), each (R, n_march) and time-ordered along dim 1.
    Emissions past `max_samples_per_ray` per ray are masked off."""
    s0 = to_stepping_space(rays.t_start, cone_angle)
    k = torch.arange(n_march, dtype=torch.float32, device=s0.device)
    ts = from_stepping_space(s0[:, None] + k[None, :], cone_angle)
    dts = calc_dt(ts, cone_angle)
    pos = rays.origins[:, None, :] + ts[..., None] * rays.dirs[:, None, :]
    inside = ((pos >= aabb_min) & (pos <= aabb_max)).all(dim=-1)
    mip = mip_from_dt(dts, pos, max_mip).clamp(0, max_mip)
    occupied = density_grid_occupied_at(pos, bitfield, mip)
    emit = inside & occupied & rays.valid[:, None]
    emit &= torch.cumsum(emit, dim=1) <= max_samples_per_ray
    return ts, dts, emit


def compact_samples(rays: RayBatch, ts: torch.Tensor, emits: torch.Tensor,
                    aabb_min: torch.Tensor, aabb_max: torch.Tensor,
                    capacity: int, cone_angle: float, order: str = "ray"
                    ) -> SampleBatch:
    """Compact the emitted candidates of the (R, n_march) grid into flat
    (capacity,) buffers.

    order="ray" (training): ray-major, each ray's samples contiguous and
    time-ordered (the loss needs per-ray segments); when capacity
    truncates, whole late rays starve. Every emitted candidate's slot is
    its ray's base (an exclusive prefix sum of the per-ray counts) plus its
    rank within the ray.
    order="depth" (rendering): depth-major, every ray's step k before any
    ray's step k + 1, so a capacity that is a query budget sheds the DEEP
    tail of every ray alike instead of starving late rays. The slot is the
    exclusive prefix sum over the transposed grid; `ray_base` is zero and
    `ray_count` the samples kept per ray.

    One scatter of the candidate indices into a buffer with a spill slot
    past `capacity` inverts the map. dt, positions and directions are
    recomputed from (ray, t) on the compacted domain."""
    if order not in ("ray", "depth"):
        raise ValueError(f"compact_samples order={order!r}")
    n_rays, n_march = emits.shape
    n = n_rays * n_march
    dev = emits.device
    e = emits.long()
    count = e.sum(dim=1)                                       # (R,)
    if order == "depth":
        e_t = e.t().reshape(-1)
        rank = (torch.cumsum(e_t, dim=0) - e_t).view(n_march, n_rays).t()
        n_samples = count.sum().clamp(max=capacity)
        base_c = torch.zeros_like(count)
        count_c = ((rank < capacity) & emits).sum(dim=1)
    else:
        base = torch.cumsum(count, dim=0) - count              # (R,)
        rank = base[:, None] + (torch.cumsum(e, dim=1) - e)    # (R, M)
        n_samples = (base[-1] + count[-1]).clamp(max=capacity)
        base_c = base.clamp(max=capacity)
        count_c = torch.minimum(count, capacity - base_c)
    cand_slot = torch.where(emits, rank, capacity).clamp(max=capacity)

    # slot -> candidate: kept candidates' slots are unique and < capacity;
    # the rest all land in one spill slot past it, which is cut off
    src = torch.full((capacity + 1,), n, dtype=torch.long, device=dev)
    src.scatter_(0, cand_slot.reshape(-1), torch.arange(n, device=dev))
    cand_src = src[:capacity]
    src_c = cand_src.clamp(max=n - 1)

    ray_id = src_c // n_march                                  # (S,)
    t_flat = ts.reshape(-1)[src_c]
    # dt is a function of t alone: recomputed, not gathered
    dt_flat = warp_dt(calc_dt(t_flat, cone_angle))
    d_r = rays.dirs[ray_id]
    positions = (rays.origins[ray_id] + t_flat[:, None] * d_r
                 - aabb_min) / (aabb_max - aabb_min)
    dirs = (d_r + 1.0) * 0.5
    return SampleBatch(positions, dirs, dt_flat, t_flat, ray_id, base_c,
                       count_c, n_samples, cand_slot, cand_src)
