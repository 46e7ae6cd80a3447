"""NeRF training step: volumetric composite loss, autograd, optimizer
(counterpart of instant_ngp_tpu/nerf/training.py).

- Rays, march and compaction run under `torch.no_grad()`; the network
  runs on the compacted (S,) sample batch under autograd.
- The composite is a differentiable masked computation over the (R, M)
  march CANDIDATE grid: the network's flat outputs are routed onto it
  with one `index_copy` (whose backward is a gather), alpha = 1 -
  exp(-sigma dt), transmittance by an exclusive prefix product, and the
  training early-out (T < 1e-4) as a mask, so that samples past the
  cutoff get neither loss nor gradient, like compaction in the reference.
- The reference's hand-added regularizer gradients are loss terms whose
  gradients equal them: L2 on positive Exponential RGB outputs, L1 on
  negative raw densities while the mean density is low, and the
  near-plane density penalty.
- Normalisation: the per-ray channel-mean loss, summed and divided by the
  number of ray LANES, valid or not.
- Background: a random colour per ray (drawn in sRGB, composited in the
  space the network trains in), applied only to rays that composited all
  their samples.

Camera, exposure, extra-dims, envmap and distortion optimisation, depth
supervision, the error map and stochastic-corner encoding are not ported
yet: their switches raise.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Union

import torch

from ..common import NERF_MIN_OPTICAL_THICKNESS
from ..ops.losses import LossType, loss_and_gradient
from ..ops.optimizers import Optimizer, tree_leaves, tree_map
from ..ops.trainer import default_l2_mask
from .dataset import NerfTrainingData
from .model import NerfNetwork, network_to_density, network_to_rgb
from .sampler import (RayBatch, SampleBatch, TrainDraws, compact_samples,
                      draw_train_randoms, generate_rays, march_rays)

EPSILON = 1e-4  # training transmittance cutoff


def _linear_to_srgb(x: torch.Tensor) -> torch.Tensor:
    # the clamp keeps the untaken branch's gradient finite at x = 0
    return torch.where(x <= 0.0031308, 12.92 * x,
                       1.055 * torch.pow(x.clamp(min=1e-12), 1.0 / 2.4)
                       - 0.055)


def _srgb_to_linear(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x <= 0.04045, x / 12.92,
                       torch.pow((x.clamp(min=0.0) + 0.055) / 1.055, 2.4))


class CompositeResult(NamedTuple):
    loss_for_grad: torch.Tensor       # scalar; what autograd differentiates
    per_ray_loss: torch.Tensor        # (R,) reported loss per lane
    measured_compacted: torch.Tensor  # () samples surviving the T cutoff
    rgb_rays: torch.Tensor            # (R, 3) composited colour
    depth_rays: torch.Tensor          # (R,)


def composite_loss(raw: torch.Tensor, samples: SampleBatch,
                   ts: torch.Tensor, dts: torch.Tensor, rays: RayBatch,
                   bg_color: torch.Tensor, exposure: torch.Tensor,
                   rgb_activation: str, density_activation: str,
                   loss_type: LossType, mean_density: torch.Tensor,
                   near_distance: float,
                   train_in_linear_colors: bool = False,
                   disable_regularizers: bool = False) -> CompositeResult:
    """Composite in the (R, M) candidate domain.

    raw: (S, 4) pre-activation network outputs (r, g, b, sigma) on the
    compacted sample batch. ts, dts: (R, M) candidate times and raw step
    sizes. bg_color: (R, 3) LINEAR background. exposure: (R, 3)
    log2-exposure of each ray's source image."""
    n_lanes, n_march = samples.cand_slot.shape
    n_cand = n_lanes * n_march
    mask = samples.cand_slot < raw.shape[0]                     # (R, M)

    # flat outputs -> candidate grid; the invalid tail lands in a spill
    # row that is cut off
    plane = torch.zeros(n_cand + 1, 4, dtype=raw.dtype, device=raw.device)
    plane = plane.index_copy(0, samples.cand_src, raw)
    plane = plane[:n_cand].view(n_lanes, n_march, 4)
    raw_rgb, raw_sigma = plane[..., :3], plane[..., 3]

    rgb = network_to_rgb(raw_rgb, rgb_activation)               # (R, M, 3)
    sigma = network_to_density(raw_sigma, density_activation)
    alpha = torch.where(mask, 1.0 - torch.exp(-sigma * dts), 0.0)

    # transmittance BEFORE each sample: exclusive prefix product
    t_prefix = torch.cumprod(1.0 - alpha, dim=1)
    t_before = torch.cat([torch.ones_like(t_prefix[:, :1]),
                          t_prefix[:, :-1]], dim=1)

    # the training early-out: samples past T < EPSILON carry neither loss
    # nor gradient
    alive = mask & (t_before >= EPSILON)
    weight = torch.where(alive, alpha * t_before, 0.0)

    ray_rgb = (weight[..., None] * rgb).sum(dim=1)              # (R, 3)
    depth_ray = (weight * ts).sum(dim=1)
    t_final = 1.0 - weight.sum(dim=1)                           # residual

    # background and target colour. Training in sRGB (the default), the
    # composited colour lives in sRGB space, so the background is warped
    # before compositing.
    exp_scale = torch.exp2(exposure)
    tex, a = rays.rgba[:, :3], rays.rgba[:, 3:4]                # premult
    if train_in_linear_colors:
        bg_net = bg_color
        target = exp_scale * tex + (1.0 - a) * bg_net
    else:
        bg_net = _linear_to_srgb(bg_color)
        straight = torch.where(a > 0, tex / a.clamp(min=1e-8), 0.0)
        target = torch.where(
            a > 0, _linear_to_srgb(exp_scale * straight) * a
            + (1.0 - a) * bg_net, bg_net)

    # a ray is finished if the early-out cut none of its samples; only
    # finished rays composite the background
    n_alive = alive.sum(dim=1)
    n_valid = mask.sum(dim=1)
    finished = n_alive == n_valid
    ray_rgb = ray_rgb + torch.where(finished, t_final, 0.0)[:, None] * bg_net

    lane_valid = rays.valid & (n_valid > 0)
    loss, _ = loss_and_gradient(loss_type, target, ray_rgb)
    per_ray_loss = torch.where(lane_valid, loss.sum(dim=-1) / 3.0, 0.0)
    loss_main = per_ray_loss.sum() / n_lanes

    measured = n_alive.sum()
    if disable_regularizers:
        return CompositeResult(loss_main, per_ray_loss, measured, ray_rgb,
                               depth_ray)
    reg = 0.0
    if rgb_activation == "Exponential":
        # grad += max(0, 1e-4 * out): the loss term 0.5e-4 * relu(out)^2
        reg = reg + 1e-4 * 0.5 * torch.where(
            alive[..., None], raw_rgb.clamp(min=0.0) ** 2, 0.0).sum() \
            / n_lanes
    # L1 on the density while the scene is still mostly empty: the
    # gradient is -1e-4 for raw < 0, the loss term 1e-4 * relu(-raw)
    l1_on = torch.where(mean_density < NERF_MIN_OPTICAL_THICKNESS, 1e-4, 0.0)
    reg = reg + l1_on * torch.where(
        alive, (-raw_sigma).clamp(min=0.0), 0.0).sum() / n_lanes
    # near-plane penalty: a constant +1e-4 gradient on the raw density of
    # samples closer than near_distance (and raw > -10)
    if near_distance > 0.0:
        near = alive & (ts < near_distance) & (raw_sigma > -10.0)
        reg = reg + 1e-4 * torch.where(near, raw_sigma, 0.0).sum() / n_lanes
    return CompositeResult(loss_main + reg, per_ray_loss, measured, ray_rgb,
                           depth_ray)


class NerfTrainStepConfig(NamedTuple):
    """The fixed knobs of a train step."""

    n_rays: int
    n_march: int
    max_samples_per_ray: int
    sample_capacity: int
    lens_mode: int
    cone_angle: float
    max_mip: int
    rgb_activation: str
    density_activation: str
    loss_type: LossType
    near_distance: float
    train_in_linear_colors: bool = False
    random_bg_color: bool = True
    snap_to_pixel_centers: bool = False
    disable_regularizers: bool = False
    # not ported yet: each raises when switched on
    depth_supervision_lambda: float = 0.0
    optimize_camera: bool = False
    optimize_exposure: bool = False
    optimize_extra_dims: bool = False
    use_error_map: bool = False
    stochastic_corners: bool = False


REMAINDER = "ROADMAP queue 1: the training chain's remainder"
NOT_PORTED = {
    "depth_supervision_lambda": f"depth supervision ({REMAINDER})",
    "optimize_camera": f"extrinsics and focal-length optimisation with "
                       f"ops/host_adam.py ({REMAINDER})",
    "optimize_exposure": f"exposure optimisation with ops/host_adam.py "
                         f"({REMAINDER})",
    "optimize_extra_dims": f"per-image extra dims ({REMAINDER})",
    "use_error_map": f"error-map importance sampling ({REMAINDER})",
    "stochastic_corners": "stochastic-corner grid encoding (ROADMAP queue "
                          "1: stochastic corners)",
}


def check_ported(cfg: NerfTrainStepConfig) -> None:
    for name, what in NOT_PORTED.items():
        if getattr(cfg, name):
            raise NotImplementedError(f"{name}: {what} is not ported yet")


def nerf_train_step(model: NerfNetwork, optimizer: Optimizer,
                    cfg: NerfTrainStepConfig, aabb_min: torch.Tensor,
                    aabb_max: torch.Tensor, opt_state: Dict[str, Any],
                    data: NerfTrainingData, bitfield: torch.Tensor,
                    mean_density: torch.Tensor,
                    draws: Union[TrainDraws, torch.Generator]
                    ) -> Dict[str, torch.Tensor]:
    """One training step: updates the model's parameters (which must
    require grad) and `opt_state` in place and returns the step's stats,
    all on the device: "loss", "measured_batch_size",
    "measured_batch_size_before_compaction", "n_rays" and "fused", the
    four as one float32 vector so that the host reads them in one copy.

    draws: the step's random numbers, or the generator to draw them
    from (on the data's device)."""
    check_ported(cfg)
    if isinstance(draws, torch.Generator):
        draws = draw_train_randoms(draws, cfg.n_rays, data.n_images)

    with torch.no_grad():
        rays, _ = generate_rays(draws, data, aabb_min, aabb_max,
                                cfg.cone_angle, cfg.lens_mode,
                                cfg.snap_to_pixel_centers)
        ts, dts, emits = march_rays(rays, bitfield, aabb_min, aabb_max,
                                    cfg.cone_angle, cfg.max_mip, cfg.n_march,
                                    cfg.max_samples_per_ray)
        samples = compact_samples(rays, ts, emits, aabb_min, aabb_max,
                                  cfg.sample_capacity, cfg.cone_angle)
        bg = draws.bg_color if cfg.random_bg_color \
            else torch.zeros_like(draws.bg_color)
        bg = _srgb_to_linear(bg)
        exposure = data.exposures[rays.img_idx]

    params = model.param_tree()
    leaves = tree_leaves(params)
    with torch.enable_grad():
        raw = model.apply_components(samples.positions, samples.dirs)
        result = composite_loss(
            raw, samples, ts, dts, rays, bg, exposure, cfg.rgb_activation,
            cfg.density_activation, cfg.loss_type, mean_density,
            cfg.near_distance, cfg.train_in_linear_colors,
            cfg.disable_regularizers)
        grads = iter(torch.autograd.grad(result.loss_for_grad, leaves))
    optimizer.step(opt_state, params, tree_map(lambda _: next(grads), params),
                   l2_mask=default_l2_mask(params))

    with torch.no_grad():
        stats = {
            "loss": result.per_ray_loss.sum() / cfg.n_rays,
            "measured_batch_size": result.measured_compacted,
            "measured_batch_size_before_compaction": samples.n_samples,
            "n_rays": rays.valid.sum(),
        }
        stats["fused"] = torch.stack([v.to(torch.float32)
                                      for v in stats.values()])
    return stats
