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
- Stochastic corners (`cfg.stochastic_corners`): the position encoding
  runs its stochastic-corner estimator with the step's draws.
- Camera optimisation (`cfg.optimize_camera` with `cam` offsets): the rays
  are rebuilt under autograd from the offsets, and the samples' positions
  and directions recomputed from them at the FIXED distances the march
  chose; the encode is then the exact one, whatever `stochastic_corners`
  says, because its estimator passes no gradient to positions. The
  gradients of the loss with respect to the offsets come back in the stats
  as "cam_gradient" {"pos", "rot", "focal"}; with `cfg.optimize_exposure`
  the per-image exposures are a leaf too ("exposure_gradient"). The
  testbed applies both with Adam on the host.
- Error map (`cfg.use_error_map` with `error_map`): every ray's loss is
  deposited bilinearly at its pixel into a coarse per-image map ("error_map"
  in the stats), from which the testbed rebuilds the CDFs that
  `sample_rays` follows. The deposit is summed like the hash table's
  gradient (`ops/grid_encoding.py::ordered_deposit`), in an order the
  cells fix, as JAX's `.at[].add` is: atomic adds would change the map's
  bits, and with them every later CDF, from run to run.

- Depth supervision (`cfg.depth_supervision_lambda` with depth images in
  the data): the composited depth of each ray against the depth image's
  value at its pixel (0 = no depth there), as one more loss term.
- Per-image latent codes (`data.extra_dims`): every sample takes the code
  of its ray's image into the direction encoding; with
  `cfg.optimize_extra_dims` the codes are a leaf and their gradient, a
  segment sum over each image's samples, comes back as
  "extra_dims_gradient".
- Environment map (`envmap` given): looked up by the rays' directions and
  composited behind the random background; its gradient comes back as
  "envmap_gradient".
- Distortion map (`distortion` given): the rays are built through it, and
  rebuilt under autograd as for the camera, so the exact encode runs; its
  gradient comes back as "distortion_gradient".
The testbed steps the three buffers with their own optimizers.

- Data parallel (`group` given, the role of JAX's `axis_name`): every rank
  takes its own `cfg.n_rays` rays, and one all-reduce over the group's
  ranks, before the optimizer, turns the rank's numbers into the global
  batch's, as JAX reduces them: the parameter gradients by mean, so that
  every replica takes the same step; the auxiliary gradients (camera,
  exposure, latent codes, envmap, distortion map) and the error map's
  deposit by sum; the stats' loss by sum over the rank count and the
  three counts by sum.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple, Union

import torch
import torch.distributed as dist

from ..common import NERF_MIN_OPTICAL_THICKNESS
from ..ops.grid_encoding import CornerDraws, ordered_deposit
from ..ops.losses import LossType, loss_and_gradient
from ..ops.optimizers import Optimizer, tree_leaves, tree_map
from ..ops.trainable_buffer import read_envmap
from ..ops.trainer import default_l2_mask
from ..parallel.mesh import psum_many
from ..utils import span
from .dataset import NerfTrainingData
from .model import NerfNetwork, network_to_density, network_to_rgb
from .sampler import (RayBatch, SampleBatch, TrainDraws, build_rays,
                      compact_samples, draw_train_randoms, generate_rays,
                      march_rays)

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
                   disable_regularizers: bool = False,
                   depth_target: Optional[torch.Tensor] = None,
                   depth_supervision_lambda: float = 0.0,
                   depth_loss_type: LossType = LossType.L1
                   ) -> CompositeResult:
    """Composite in the (R, M) candidate domain.

    raw: (S, 4) pre-activation network outputs (r, g, b, sigma) on the
    compacted sample batch. ts, dts: (R, M) candidate times and raw step
    sizes. bg_color: (R, 3) LINEAR background. exposure: (R, 3)
    log2-exposure of each ray's source image. depth_target: (R,) metric
    depth of each ray's pixel, supervised where it is > 0."""
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

    if depth_supervision_lambda > 0.0 and depth_target is not None:
        d_elem, _ = loss_and_gradient(depth_loss_type, depth_target,
                                      depth_ray)
        has_depth = lane_valid & (depth_target > 0)
        loss_main = loss_main + depth_supervision_lambda * torch.where(
            has_depth, d_elem, 0.0).sum() / n_lanes

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
    optimize_camera: bool = False      # "cam_gradient" in the stats
    optimize_exposure: bool = False    # "exposure_gradient" in the stats
    use_error_map: bool = False        # CDF sampling and the deposit
    error_map_res: Tuple[int, int] = (0, 0)   # (W_c, H_c) of the error map
    stochastic_corners: bool = False   # the estimator instead of the exact
    #                                    encode, unless rays are rebuilt
    depth_supervision_lambda: float = 0.0
    optimize_extra_dims: bool = False  # "extra_dims_gradient" in the stats


def deposit_error_map(error_map: torch.Tensor, rays: RayBatch,
                      per_ray_loss: torch.Tensor, res: Tuple[int, int]
                      ) -> torch.Tensor:
    """error_map (n_images, H_c * W_c) plus each ray's loss, spread
    bilinearly over the four cells around its pixel (`res` = (W_c, H_c))."""
    delta = error_map_delta(error_map, rays, per_ray_loss, res)
    return (error_map.reshape(-1) + delta).view_as(error_map)


def error_map_delta(error_map: torch.Tensor, rays: RayBatch,
                    per_ray_loss: torch.Tensor, res: Tuple[int, int]
                    ) -> torch.Tensor:
    """What `deposit_error_map` adds, flat (n_images * H_c * W_c,): the
    four corners' deposits in one sum whose order the cells alone fix
    (`ordered_deposit`), so that a run repeats past the CDF rebuilds that
    read the map."""
    cw, ch = res
    scale = torch.tensor([cw, ch], dtype=torch.float32,
                         device=error_map.device)
    pos = torch.minimum((rays.uv * scale - 0.5).clamp(min=0.0),
                        scale - 1.001)
    p0 = pos.to(torch.int32).long()
    w = pos - p0
    flat_img = rays.img_idx * (cw * ch)
    cells, values = [], []
    for dx, dy, weight in ((0, 0, (1 - w[:, 0]) * (1 - w[:, 1])),
                           (1, 0, w[:, 0] * (1 - w[:, 1])),
                           (0, 1, (1 - w[:, 0]) * w[:, 1]),
                           (1, 1, w[:, 0] * w[:, 1])):
        cells.append(flat_img + (p0[:, 1] + dy) * cw + (p0[:, 0] + dx))
        values.append(weight * per_ray_loss)
    delta = torch.zeros(error_map.numel(), dtype=error_map.dtype,
                        device=error_map.device)
    ordered_deposit(delta, torch.cat(cells), torch.cat(values))
    return delta


class StepDraws(NamedTuple):
    """A train step's random numbers: the rays' and, where the encode is
    the stochastic one, its corners' for the `sample_capacity` samples (or
    the generator to draw those from when the samples are known)."""

    rays: TrainDraws
    corners: Union[CornerDraws, torch.Generator, None] = None


def nerf_train_step(model: NerfNetwork, optimizer: Optimizer,
                    cfg: NerfTrainStepConfig, aabb_min: torch.Tensor,
                    aabb_max: torch.Tensor, opt_state: Dict[str, Any],
                    data: NerfTrainingData, bitfield: torch.Tensor,
                    mean_density: torch.Tensor,
                    draws: Union[StepDraws, TrainDraws, torch.Generator],
                    cam: Optional[Dict[str, torch.Tensor]] = None,
                    error_cdfs: Optional[Dict[str, torch.Tensor]] = None,
                    error_map: Optional[torch.Tensor] = None,
                    envmap: Optional[torch.Tensor] = None,
                    distortion: Optional[torch.Tensor] = None,
                    group: Optional[dist.ProcessGroup] = None
                    ) -> Dict[str, Any]:
    """One training step: updates the model's parameters (which must
    require grad) and `opt_state` in place and returns the step's stats,
    all on the device: "loss", "measured_batch_size",
    "measured_batch_size_before_compaction", "n_rays" and "fused", the
    four as one float32 vector so that the host reads them in one copy;
    besides, "cam_gradient", "exposure_gradient", "extra_dims_gradient",
    "envmap_gradient", "distortion_gradient" and "error_map" where the
    configuration asks for them (the module docstring says when).

    draws: the step's random numbers (a `StepDraws`, or the rays' alone
    where no corner is sampled), or the generator to draw them all from
    (on the data's device).
    cam: the current per-image camera offsets; the rays are built through
    them whether or not their gradient is taken.
    envmap (H, W, 4), distortion (H, W, 2): the trainable buffers' current
    values; given, they take part in the step and their gradients come
    back.
    group: the data-parallel process group (the module docstring says what
    is reduced over it); `draws` are then this rank's."""
    use_cdfs = cfg.use_error_map and error_cdfs is not None
    cam_grad = cfg.optimize_camera and cam is not None
    rebuild = cam_grad or distortion is not None
    stochastic = cfg.stochastic_corners and not rebuild
    if isinstance(draws, torch.Generator):
        draws = StepDraws(draw_train_randoms(draws, cfg.n_rays,
                                             data.n_images, use_cdfs),
                          draws)
    elif isinstance(draws, TrainDraws):
        draws = StepDraws(draws)
    ray_draws, corners = draws
    if stochastic and corners is None:
        raise ValueError("stochastic_corners needs the corners' draws, or "
                         "a generator to make them from")

    with torch.no_grad(), span("nerf.sample"):
        rays, motionblur_time = generate_rays(
            ray_draws, data, aabb_min, aabb_max, cfg.cone_angle,
            cfg.lens_mode, cfg.snap_to_pixel_centers, cam=cam,
            error_cdfs=error_cdfs if use_cdfs else None,
            distortion_map=distortion)
        ts, dts, emits = march_rays(rays, bitfield, aabb_min, aabb_max,
                                    cfg.cone_angle, cfg.max_mip, cfg.n_march,
                                    cfg.max_samples_per_ray)
        samples = compact_samples(rays, ts, emits, aabb_min, aabb_max,
                                  cfg.sample_capacity, cfg.cone_angle)
        bg = ray_draws.bg_color if cfg.random_bg_color \
            else torch.zeros_like(ray_draws.bg_color)
        bg = _srgb_to_linear(bg)
        sample_img = None if data.extra_dims is None \
            else rays.img_idx[samples.ray_id]
        depth_target = None
        if cfg.depth_supervision_lambda > 0 and data.depths is not None:
            px = (rays.uv * data.resolutions[rays.img_idx]).to(torch.int32)
            x = px[:, 0].long().clamp(0, data.depths.shape[2] - 1)
            y = px[:, 1].long().clamp(0, data.depths.shape[1] - 1)
            depth_target = data.depths[rays.img_idx, y, x]

    params = model.param_tree()
    leaves = tree_leaves(params)
    # the step's own leaves for what the host optimizes
    def leaf(t):
        return t.detach().clone().requires_grad_(True)

    aux = {}
    if cam_grad:
        aux.update({f"cam.{k}": leaf(v) for k, v in cam.items()})
    if cfg.optimize_exposure:
        aux["exposure"] = leaf(data.exposures)
    if cfg.optimize_extra_dims and data.extra_dims is not None:
        aux["extra"] = leaf(data.extra_dims)
    if envmap is not None:
        aux["envmap"] = leaf(envmap)
    if distortion is not None:
        aux["distortion"] = leaf(distortion)
    with torch.enable_grad():
        if rebuild:
            # rays again, differentiably in the offsets and the distortion
            # map; the samples stay at the distances the march chose
            origins, dirs, _ = build_rays(
                data, rays.img_idx, rays.uv, motionblur_time, cfg.lens_mode,
                {k: aux[f"cam.{k}"] for k in cam} if cam_grad else cam,
                distortion_map=aux.get("distortion"))
            d_s = dirs[samples.ray_id]
            positions = (origins[samples.ray_id]
                         + samples.t_mid[:, None] * d_s
                         - aabb_min) / (aabb_max - aabb_min)
            dirs_warped = (d_s + 1.0) * 0.5
        else:
            positions, dirs_warped = samples.positions, samples.dirs
        encode = {}
        if stochastic:
            key = "encode_generator" if isinstance(corners, torch.Generator) \
                else "encode_draws"
            encode[key] = corners
        extra = None
        if sample_img is not None:
            # each sample's latent: its ray's image's code (the backward of
            # this gather is the segment sum over an image's samples)
            extra = aux.get("extra", data.extra_dims)[sample_img]
        with span("nerf.forward"):
            raw = model.apply_components(positions, dirs_warped, extra,
                                         spans=True, **encode)
        with span("nerf.composite"):
            exposure = aux.get("exposure", data.exposures)[rays.img_idx]
            if "envmap" in aux:
                # the envmap behind the random background
                env = read_envmap(aux["envmap"], rays.dirs)
                bg = env[:, :3] + bg * (1.0 - env[:, 3:4])
            result = composite_loss(
                raw, samples, ts, dts, rays, bg, exposure,
                cfg.rgb_activation, cfg.density_activation, cfg.loss_type,
                mean_density, cfg.near_distance, cfg.train_in_linear_colors,
                cfg.disable_regularizers, depth_target,
                cfg.depth_supervision_lambda)
        with span("nerf.backward"):
            grads = torch.autograd.grad(result.loss_for_grad,
                                        leaves + list(aux.values()))
    with torch.no_grad():
        stats = {
            "loss": result.per_ray_loss.sum() / cfg.n_rays,
            "measured_batch_size": result.measured_compacted,
            "measured_batch_size_before_compaction": samples.n_samples,
            "n_rays": rays.valid.sum(),
        }
        fused = torch.stack([v.to(torch.float32) for v in stats.values()])
        deposit = None
        if cfg.use_error_map and error_map is not None:
            deposit = error_map_delta(error_map, rays,
                                      result.per_ray_loss.detach(),
                                      cfg.error_map_res)
        if group is not None:
            # one all-reduce of everything a rank contributes
            n_dev, n_grads = dist.get_world_size(group), len(grads)
            parts = psum_many(list(grads) + [fused] + (
                [] if deposit is None else [deposit]), group)
            grads = [g / n_dev for g in parts[:len(leaves)]] \
                + parts[len(leaves):n_grads]
            fused = parts[n_grads] / torch.tensor(
                [n_dev, 1.0, 1.0, 1.0], device=fused.device)
            if deposit is not None:
                deposit = parts[n_grads + 1]
            stats = dict(zip(stats, fused))
    aux_grads = dict(zip(aux, grads[len(leaves):]))
    grads = iter(grads[:len(leaves)])
    with span("nerf.optimizer"):
        optimizer.step(opt_state, params,
                       tree_map(lambda _: next(grads), params),
                       l2_mask=default_l2_mask(params))

    with torch.no_grad():
        stats["fused"] = fused
        if cam_grad:
            stats["cam_gradient"] = {k: aux_grads[f"cam.{k}"] for k in cam}
        for key, name in (("exposure", "exposure_gradient"),
                          ("extra", "extra_dims_gradient"),
                          ("envmap", "envmap_gradient"),
                          ("distortion", "distortion_gradient")):
            if key in aux_grads:
                stats[name] = aux_grads[key]
        if deposit is not None:
            stats["error_map"] = (error_map.reshape(-1)
                                  + deposit).view_as(error_map)
    return stats
