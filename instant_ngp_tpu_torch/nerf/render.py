"""NeRF rendering: camera rays and the early-out wavefront renderer, Shade
mode (counterpart of instant_ngp_tpu/nerf/render.py::WavefrontRenderer and
camera_rays_for_frame).

The renderer computes the same function as the JAX one: each ray's
emitted march candidates, in time order, are composited front to back with
alpha = 1 - exp(-sigma * dt), and a sample adds weight only while the
transmittance before it is >= min_transmittance. It does so the way a GPU
does it naturally: the candidates of every ray are packed once with a
prefix sum, then each round takes the next `chunk` candidates of the rays
still alive (an on-device alive set from `torch.nonzero`), evaluates the
network on them and composites with `index` updates. A ray whose
transmittance fell below the threshold or whose candidates ran out is
never evaluated again. Memory is bounded by marching `march_chunk` rays at
a time and evaluating at most `query_budget` samples per network call.

With `RenderConfig.stochastic_corners` and a generator, the position
encoding runs its stochastic-corner estimator (the configuration's exact
axes) with fresh draws in every network call, so the noise differs between
the passes of a multi-sample frame and averages out like subpixel jitter.
Off by default: renders use the exact encode.

Depth, AO, Normals and the other render modes, and `render_tile`, are not
ported yet.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from ..camera import uv_to_ray
from .march import advance_n_steps, calc_dt, ray_intersect_aabb
from .model import NerfNetwork, network_to_density, network_to_rgb
from .sampler import RayBatch, march_rays


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


class WavefrontRenderer:
    #: rays marched together: bounds the (rays, n_march) march planes
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
        row r holds ray r's emitted candidates in time order."""
        cfg = self.cfg
        tmin, tmax = ray_intersect_aabb(origins, dirs, self.aabb_min,
                                        self.aabb_max)
        tmin = tmin.clamp(min=0.0)
        valid = tmax >= tmin
        rays = RayBatch(origins, dirs,
                        advance_n_steps(tmin, cfg.cone_angle, 0.5), valid)
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

    def _prep(self, origins, dirs, bitfield):
        parts = [self._march_and_pack(origins[i:i + self.march_chunk],
                                      dirs[i:i + self.march_chunk], bitfield)
                 for i in range(0, origins.shape[0], self.march_chunk)]
        return tuple(torch.cat(p) for p in zip(*parts))

    def _eval(self, pos: torch.Tensor, dirs: torch.Tensor,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Raw network outputs (n, 4) in calls of at most query_budget."""
        step = self.cfg.query_budget
        return torch.cat([self.model.apply_components(
            pos[i:i + step], dirs[i:i + step], encode_generator=generator)
            for i in range(0, pos.shape[0], step)])

    def render(self, origins: torch.Tensor, dirs: torch.Tensor,
               bitfield: torch.Tensor, bg_color: torch.Tensor,
               generator: Optional[torch.Generator] = None
               ) -> Dict[str, torch.Tensor]:
        """origins, normalized dirs (R, 3); bg_color (3,) or (R, 3) linear;
        generator: the stochastic-corner draws' source (on the rays'
        device), used only with `cfg.stochastic_corners`.
        -> {"rgb" (R, 3) over the background, "alpha", "depth" (R,),
        "n_samples": network evaluations made}."""
        cfg = self.cfg
        if not cfg.stochastic_corners:
            generator = None
        n_rays = origins.shape[0]
        dev = origins.device
        packed_ts, packed_ok, n_cand, valid = self._prep(origins, dirs,
                                                         bitfield)
        trans = torch.ones(n_rays, device=dev)
        acc_rgb = torch.zeros(n_rays, 3, device=dev)
        acc_alpha = torch.zeros(n_rays, device=dev)
        acc_depth = torch.zeros(n_rays, device=dev)
        span = self.aabb_max - self.aabb_min
        n_evaluated = 0
        for start in range(0, cfg.max_samples_per_ray, self.chunk):
            idx = torch.nonzero(valid & (trans >= cfg.min_transmittance)
                                & (n_cand > start)).squeeze(1)
            if idx.numel() == 0:
                break
            rt = packed_ts[idx, start:start + self.chunk]        # (B, K)
            rv = packed_ok[idx, start:start + self.chunk]
            o_b, d_b = origins[idx], dirs[idx]
            pos = ((o_b[:, None, :] + rt[..., None] * d_b[:, None, :])
                   - self.aabb_min) / span
            dirw = ((d_b + 1.0) * 0.5)[:, None, :].expand_as(pos)
            raw = self._eval(pos.reshape(-1, 3), dirw.reshape(-1, 3),
                             generator).reshape(*rt.shape, 4)
            n_evaluated += rt.numel()
            rgb = network_to_rgb(raw[..., :3], cfg.rgb_activation)
            sigma = network_to_density(raw[..., 3], cfg.density_activation)
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


def camera_rays_for_frame(width: int, height: int,
                          focal_length: Sequence[float],
                          camera_matrix, *, device,
                          screen_center=(0.5, 0.5),
                          jitter: Optional[Sequence[float]] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(H*W, 3) origins and normalized directions of a pinhole frame on
    `device`, row by row; `jitter` (2,) is the subpixel offset (default
    pixel centres)."""
    off = (0.5, 0.5) if jitter is None else jitter
    x = torch.arange(width, dtype=torch.float32, device=device)
    y = torch.arange(height, dtype=torch.float32, device=device)
    gx, gy = torch.meshgrid((x + off[0]) / width, (y + off[1]) / height,
                            indexing="xy")
    uv = torch.stack([gx, gy], dim=-1).reshape(-1, 2)
    fl = torch.as_tensor(focal_length, dtype=torch.float32, device=device)
    cam = torch.as_tensor(camera_matrix, dtype=torch.float32, device=device)
    origins, dirs, _ = uv_to_ray(uv, (width, height), fl, cam,
                                 screen_center)
    return origins, dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
