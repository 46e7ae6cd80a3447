"""NeRF rendering: camera rays through every lens, `render_tile` with its
render modes, and the early-out wavefront renderer (counterpart of
instant_ngp_tpu/nerf/render.py).

Both renderers compute the same function: each ray's emitted march
candidates, in time order, are composited front to back with
alpha = 1 - exp(-sigma * dt), and a sample adds weight only while the
transmittance before it is >= min_transmittance.

`render_tile` evaluates one tile of rays at once: march, depth-major
compaction into at most `sample_capacity` samples (a capacity that
truncates sheds every ray's deep tail), one network evaluation of the kept
samples, the outputs scattered back onto the (rays, candidates) plane and
composited there. What is composited depends on `RenderConfig.render_mode`:
Shade (the network's colour), Depth (the sample's distance), AO (white:
the accumulated opacity), Normals (minus the normalised gradient of the raw
density with respect to the position, from autograd through the exact
encode and the density MLP), Positions (the warped position), EncodingVis
(the first three encoding features) and Cost (march samples per ray / 128).

`WavefrontRenderer` does it the way a GPU does it naturally: the
candidates of every ray are packed once into a row of their own, then each
round takes the next `chunk` candidates of the rays still alive (an
on-device alive set from `torch.nonzero`), evaluates the network on them
and composites with `index` updates. A ray whose transmittance fell below
the threshold or whose candidates ran out is never evaluated again. On the
card one kernel (`ops/kernels/march_kernels.py`) walks each ray's
candidates and writes its packed row; on the CPU the plain version marches
`march_chunk` rays at a time on the (rays, n_march) plane and packs it with
a prefix sum. A network call evaluates at most `query_budget` samples. It
serves Shade, Depth and AO, which are weighted sums of what it
accumulates.

With `RenderConfig.stochastic_corners` and a generator, the position
encoding runs its stochastic-corner estimator (the configuration's exact
axes) with fresh draws in every network call, so the noise differs between
the passes of a multi-sample frame and averages out like subpixel jitter.
Off by default: renders use the exact encode.

`extra_dims` (n_extra,) is the latent code every sample of a render takes
into the direction encoding, for a network built with latent dims.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from ..camera import pos_to_uv, uv_to_ray
from ..ops.kernels import march_kernels
from ..utils import span
from .march import advance_n_steps, calc_dt, ray_intersect_aabb
from .model import NerfNetwork, network_to_density, network_to_rgb
from .sampler import RayBatch, compact_samples, march_rays

RENDER_TILE_MODES = ("Shade", "Depth", "AO", "Normals", "Positions",
                     "EncodingVis", "Cost")


class RenderConfig(NamedTuple):
    n_march: int                 # march candidates per ray
    max_samples_per_ray: int     # emitted samples kept per ray
    cone_angle: float
    max_mip: int
    rgb_activation: str
    density_activation: str
    min_transmittance: float = 1e-2
    query_budget: int = 2 << 20  # most samples per network call
    stochastic_corners: bool = False  # the encode's estimator, given draws
    render_mode: str = "Shade"   # what `render_tile` composites
    # `render_tile`'s compacted samples per tile; 0 = rays x
    # max_samples_per_ray, at most the query budget
    sample_capacity: int = 0


def _march_start(origins, dirs, aabb_min, aabb_max, cone_angle):
    """-> (t_start half a step past the box's entry, valid)."""
    tmin, tmax = ray_intersect_aabb(origins, dirs, aabb_min, aabb_max)
    tmin = tmin.clamp(min=0.0)
    return advance_n_steps(tmin, cone_angle, 0.5), tmax >= tmin


def _eval_network(model: NerfNetwork, pos: torch.Tensor, dirs: torch.Tensor,
                  extra_dims: Optional[torch.Tensor], step: int,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    """Raw network outputs (n, 4) in calls of at most `step` samples."""
    outs = []
    for i in range(0, pos.shape[0], step):
        p = pos[i:i + step]
        extra = None if extra_dims is None \
            else extra_dims.expand(p.shape[0], -1)
        outs.append(model.apply_components(p, dirs[i:i + step], extra,
                                           encode_generator=generator))
    return torch.cat(outs)


def render_tile(model: NerfNetwork, cfg: RenderConfig,
                origins: torch.Tensor, dirs: torch.Tensor,
                bitfield: torch.Tensor, aabb_min: torch.Tensor,
                aabb_max: torch.Tensor, bg_color: torch.Tensor,
                extra_dims: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
    """Render one tile of rays in `cfg.render_mode`: origins, normalized
    dirs (R, 3); bg_color (3,) or (R, 3) linear; extra_dims (n_extra,).
    -> {"rgb" (R, 3) over the background, "alpha", "depth" (R,),
    "n_samples": () the compacted samples, all evaluated}.

    Call it under `torch.no_grad()`: the MLPs then run through the fused
    kernel. Normals alone opens a grad scope of its own, around the exact
    encode and the density MLP on the tile's samples (so the tile bounds
    its graph), and evaluates nothing else."""
    mode = cfg.render_mode
    if mode not in RENDER_TILE_MODES:
        raise ValueError(f"render_tile has no mode {mode!r}")
    n_rays = origins.shape[0]
    dev = origins.device
    t_start, valid = _march_start(origins, dirs, aabb_min, aabb_max,
                                  cfg.cone_angle)
    rays = RayBatch(origins, dirs, t_start, valid)
    ts, dts, emits = march_rays(rays, bitfield, aabb_min, aabb_max,
                                cfg.cone_angle, cfg.max_mip, cfg.n_march,
                                cfg.max_samples_per_ray)
    capacity = cfg.sample_capacity or min(
        n_rays * cfg.max_samples_per_ray, cfg.query_budget)
    samples = compact_samples(rays, ts, emits, aabb_min, aabb_max, capacity,
                              cfg.cone_angle, order="depth")
    # only the kept samples are evaluated (one read of the device per tile)
    n = int(samples.n_samples)
    pos, dirw = samples.positions[:n], samples.dirs[:n]

    if n == 0:                      # every ray missed what is occupied
        flat = pos.new_zeros(0, 4)
    elif mode == "Normals":
        with torch.enable_grad():
            p = pos.detach().requires_grad_(True)
            density_out = model.density_forward(p)
            grad, = torch.autograd.grad(density_out[:, 0].sum(), p)
        normals = -grad / torch.linalg.norm(grad, dim=-1,
                                            keepdim=True).clamp(min=1e-9)
        flat = torch.cat([normals * 0.5 + 0.5,
                          density_out.detach()[:, :1]], dim=-1)
    else:
        raw = _eval_network(
            model, pos, dirw, extra_dims, cfg.query_budget,
            generator if cfg.stochastic_corners else None)
        if mode == "Positions":
            colour = pos
        elif mode == "EncodingVis":
            colour = model.pos_encoding(pos)[:, :3].float() * 20.0 + 0.5
        else:
            colour = network_to_rgb(raw[:, :3], cfg.rgb_activation)
        flat = torch.cat([colour, raw[:, 3:4]], dim=-1)

    # flat outputs -> the (R, M) candidate plane; the compacted tail that
    # holds no sample points at a spill row past the plane, which is cut
    n_cand = n_rays * cfg.n_march
    plane = torch.zeros(n_cand + 1, 4, device=dev)
    plane.index_copy_(0, samples.cand_src[:n], flat)
    plane = plane[:n_cand].view(n_rays, cfg.n_march, 4)
    mask = samples.cand_slot < capacity
    if mode == "Depth":
        colour = ts[..., None]
    elif mode == "AO":
        colour = torch.ones_like(ts)[..., None]
    else:
        colour = plane[..., :3]

    sigma = network_to_density(plane[..., 3], cfg.density_activation)
    alpha = torch.where(mask, 1.0 - torch.exp(-sigma * dts), 0.0)
    prefix = torch.cumprod(1.0 - alpha, dim=1)
    t_before = torch.cat([torch.ones_like(prefix[:, :1]), prefix[:, :-1]],
                         dim=1)
    weight = torch.where(mask & (t_before >= cfg.min_transmittance),
                         alpha * t_before, 0.0)
    opacity = weight.sum(dim=1)
    bg = bg_color.expand(n_rays, 3)
    rgb = (weight[..., None] * colour).sum(dim=1) \
        + (1.0 - opacity)[:, None] * bg
    if mode == "Cost":
        rgb = (mask.sum(dim=1).float() / 128.0)[:, None].expand(n_rays, 3)
    return {
        "rgb": torch.where(valid[:, None], rgb, bg),
        "alpha": torch.where(valid, opacity, 0.0),
        "depth": torch.where(valid, (weight * ts).sum(dim=1), 0.0),
        "n_samples": samples.n_samples,
    }


class WavefrontRenderer:
    #: rays the plain version marches together: bounds its (rays, n_march)
    #: march planes
    march_chunk = 1 << 15

    def __init__(self, model: NerfNetwork, cfg: RenderConfig,
                 aabb_min: torch.Tensor, aabb_max: torch.Tensor,
                 chunk: int = 32):
        self.model = model
        self.cfg = cfg
        self.aabb_min = aabb_min
        self.aabb_max = aabb_max
        self.chunk = chunk
        # packed candidates are padded to whole rounds of `chunk`
        self._c_pad = -(-cfg.max_samples_per_ray // chunk) * chunk

    def _march_and_pack(self, origins: torch.Tensor, dirs: torch.Tensor,
                        bitfield: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                   torch.Tensor]:
        """-> (packed ts (R, C), packed ok (R, C), n_cand (R,), valid (R,)):
        row r holds ray r's emitted candidates in time order. The rounds
        read a row up to n_cand rounded up to whole rounds of `chunk`,
        which holds zeros past n_cand. CUDA tensors go to the kernel, which
        leaves the columns past that unwritten, CPU tensors to the plain
        version."""
        cfg = self.cfg
        if origins.device.type == "cuda":
            return march_kernels.march_and_pack(
                origins.contiguous(), dirs.contiguous(), bitfield,
                self.aabb_min, self.aabb_max, cfg.cone_angle, cfg.max_mip,
                cfg.n_march, cfg.max_samples_per_ray, self._c_pad, self.chunk)
        return self._march_and_pack_plain(origins, dirs, bitfield)

    def _march_and_pack_plain(self, origins, dirs, bitfield):
        """The plain version of `_march_and_pack`, every column written:
        `march_chunk` rays at a time on the (rays, n_march) candidate
        plane."""
        parts = [self._march_chunk_plain(origins[i:i + self.march_chunk],
                                         dirs[i:i + self.march_chunk],
                                         bitfield)
                 for i in range(0, origins.shape[0], self.march_chunk)]
        return tuple(torch.cat(p) for p in zip(*parts))

    def _march_chunk_plain(self, origins, dirs, bitfield):
        cfg = self.cfg
        t_start, valid = _march_start(origins, dirs, self.aabb_min,
                                      self.aabb_max, cfg.cone_angle)
        rays = RayBatch(origins, dirs, t_start, valid)
        ts, _, emit = march_rays(rays, bitfield, self.aabb_min,
                                 self.aabb_max, cfg.cone_angle, cfg.max_mip,
                                 cfg.n_march, cfg.max_samples_per_ray)
        # slot of each emitted candidate in its ray; the rest go to a
        # spill column that is cut off below
        slot = torch.cumsum(emit, dim=1) - 1
        slot = torch.where(emit, slot, self._c_pad)
        n_rays = origins.shape[0]
        packed_ts = torch.zeros(n_rays, self._c_pad + 1, device=ts.device)
        packed_ok = torch.zeros(n_rays, self._c_pad + 1, dtype=torch.bool,
                                device=ts.device)
        packed_ts.scatter_(1, slot, ts)
        packed_ok.scatter_(1, slot, emit)
        n_cand = emit.sum(dim=1)
        return (packed_ts[:, :self._c_pad], packed_ok[:, :self._c_pad],
                n_cand, valid)

    def render(self, origins: torch.Tensor, dirs: torch.Tensor,
               bitfield: torch.Tensor, bg_color: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               extra_dims: Optional[torch.Tensor] = None
               ) -> Dict[str, torch.Tensor]:
        """origins, normalized dirs (R, 3); bg_color (3,) or (R, 3) linear;
        generator: the stochastic-corner draws' source (on the rays'
        device), used only with `cfg.stochastic_corners`; extra_dims
        (n_extra,): the latent code of every sample.
        -> {"rgb" (R, 3) over the background, "alpha", "depth" (R,),
        "n_samples": network evaluations made}."""
        cfg = self.cfg
        if not cfg.stochastic_corners:
            generator = None
        n_rays = origins.shape[0]
        dev = origins.device
        with span("render.march"):
            packed_ts, packed_ok, n_cand, valid = self._march_and_pack(
                origins, dirs, bitfield)
        trans = torch.ones(n_rays, device=dev)
        acc_rgb = torch.zeros(n_rays, 3, device=dev)
        acc_alpha = torch.zeros(n_rays, device=dev)
        acc_depth = torch.zeros(n_rays, device=dev)
        extent = self.aabb_max - self.aabb_min
        n_evaluated = 0
        for start in range(0, cfg.max_samples_per_ray, self.chunk):
            with span("render.select"):
                idx = torch.nonzero(valid & (trans >= cfg.min_transmittance)
                                    & (n_cand > start)).squeeze(1)
            if idx.numel() == 0:
                break
            # the network's span takes the gather of its inputs
            with span("render.network"):
                rt = packed_ts[idx, start:start + self.chunk]    # (B, K)
                rv = packed_ok[idx, start:start + self.chunk]
                o_b, d_b = origins[idx], dirs[idx]
                pos = ((o_b[:, None, :] + rt[..., None] * d_b[:, None, :])
                       - self.aabb_min) / extent
                dirw = ((d_b + 1.0) * 0.5)[:, None, :].expand_as(pos)
                raw = _eval_network(
                    self.model, pos.reshape(-1, 3), dirw.reshape(-1, 3),
                    extra_dims, cfg.query_budget, generator
                ).reshape(*rt.shape, 4)
            n_evaluated += rt.numel()
            with span("render.composite"):
                rgb = network_to_rgb(raw[..., :3], cfg.rgb_activation)
                sigma = network_to_density(raw[..., 3],
                                           cfg.density_activation)
                alpha = torch.where(rv, 1.0 - torch.exp(
                    -sigma * calc_dt(rt, cfg.cone_angle)), 0.0)
                prefix = torch.cumprod(1.0 - alpha, dim=1)
                t_in = trans[idx]
                t_before = t_in[:, None] * torch.cat(
                    [torch.ones_like(prefix[:, :1]), prefix[:, :-1]], dim=1)
                w = torch.where(rv & (t_before >= cfg.min_transmittance),
                                alpha * t_before, 0.0)
                trans[idx] = t_in * prefix[:, -1]
                acc_rgb[idx] += (w[..., None] * rgb).sum(dim=1)
                acc_alpha[idx] += w.sum(dim=1)
                acc_depth[idx] += (w * rt).sum(dim=1)
        bg = bg_color.expand(n_rays, 3)
        rgb = acc_rgb + (1.0 - acc_alpha)[:, None] * bg
        return {
            "rgb": torch.where(valid[:, None], rgb, bg),
            "alpha": torch.where(valid, acc_alpha, 0.0),
            "depth": torch.where(valid, acc_depth, 0.0),
            "n_samples": n_evaluated,
        }


def _frame_uv(width: int, height: int, device,
              jitter: Optional[Sequence[float]] = None) -> torch.Tensor:
    """(H*W, 2) uv of a frame's pixels, row by row; `jitter` (2,) is the
    subpixel offset (default the pixel centres)."""
    off = (0.5, 0.5) if jitter is None else jitter
    x = torch.arange(width, dtype=torch.float32, device=device)
    y = torch.arange(height, dtype=torch.float32, device=device)
    gx, gy = torch.meshgrid((x + float(off[0])) / width,
                            (y + float(off[1])) / height, indexing="xy")
    return torch.stack([gx, gy], dim=-1).reshape(-1, 2)


def _f32(value, device) -> Optional[torch.Tensor]:
    return None if value is None else torch.as_tensor(
        value, dtype=torch.float32, device=device)


def camera_rays_for_frame(width: int, height: int,
                          focal_length: Sequence[float],
                          camera_matrix, *, device,
                          screen_center=(0.5, 0.5), lens_mode: int = 0,
                          lens_params=None,
                          distortion_map: Optional[torch.Tensor] = None,
                          jitter: Optional[Sequence[float]] = None,
                          aperture_size: float = 0.0, focus_z: float = 1.0,
                          aperture_samples: Optional[torch.Tensor] = None,
                          generator: Optional[torch.Generator] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(H*W, 3) origins and normalized directions of a frame on `device`,
    row by row, through the lens `lens_mode` with `lens_params` (7,) and
    the trained `distortion_map`. With `aperture_size` != 0 every pixel's
    origin is moved on the aperture's disk and its direction refocused on
    the plane at `focus_z`: the disk samples are `aperture_samples`
    (H*W, 2) in [0, 1), or drawn from `generator` (on `device`)."""
    uv = _frame_uv(width, height, device, jitter)
    if aperture_size != 0.0 and aperture_samples is None:
        if generator is None:
            raise ValueError("an aperture needs its samples or a generator")
        aperture_samples = torch.rand(uv.shape[0], 2, generator=generator,
                                      device=device)
    origins, dirs, _ = uv_to_ray(
        uv, (width, height), _f32(focal_length, device),
        _f32(camera_matrix, device), screen_center, lens_mode=lens_mode,
        lens_params=_f32(lens_params, device),
        distortion_map=distortion_map, aperture_size=aperture_size,
        focus_z=focus_z, aperture_samples=aperture_samples)
    return origins, dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)


def hsv_to_rgb(h: torch.Tensor, s: torch.Tensor, v: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """HSV -> RGB per channel; the hue wraps at 1."""
    h6 = torch.remainder(h, 1.0) * 6.0
    c = v * s
    x = c * (1.0 - (torch.remainder(h6, 2.0) - 1.0).abs())
    m = v - c
    i = torch.remainder(torch.floor(h6).long(), 6)
    zero = torch.zeros_like(c)

    def pick(*by_sector):
        out = by_sector[5]
        for k in range(4, -1, -1):
            out = torch.where(i == k, by_sector[k], out)
        return out

    return (pick(c, x, zero, zero, x, c) + m,
            pick(x, c, c, x, zero, zero) + m,
            pick(zero, zero, x, c, c, x) + m)


def distortion_flow_image(width: int, height: int,
                          focal_length: Sequence[float], camera_matrix, *,
                          device, screen_center=(0.5, 0.5),
                          lens_mode: int = 0, lens_params=None,
                          distortion_map: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """The Distortion render mode -> (H, W, 4): every pixel's ray through
    the lens and the distortion map is projected back through the pinhole
    model at distance 1, and the displacement in uv, times 64, is shown as
    a flow field (hue = direction, value = magnitude)."""
    uv = _frame_uv(width, height, device)
    fl = _f32(focal_length, device)
    cam = _f32(camera_matrix, device)
    origins, dirs, _ = uv_to_ray(
        uv, (width, height), fl, cam, screen_center, lens_mode=lens_mode,
        lens_params=_f32(lens_params, device),
        distortion_map=distortion_map)
    uv_after, _ = pos_to_uv(origins + dirs, (width, height), fl, cam,
                            screen_center)
    d = (uv_after - uv) * 64.0
    mag = torch.sqrt(d[:, 0] ** 2 + d[:, 1] ** 2)
    hue = torch.atan2(d[:, 1], d[:, 0]) / (2.0 * math.pi) + 0.5
    r, g, b = hsv_to_rgb(hue, torch.ones_like(mag), mag)
    return torch.stack([r, g, b, torch.ones_like(mag)],
                       dim=-1).reshape(height, width, 4)
