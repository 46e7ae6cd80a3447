"""NeRF testbed: data, network, occupancy grid, training and rendering
(counterpart of instant_ngp_tpu/nerf/testbed_nerf.py::NerfTestbed).

Built from a `NerfDataset` it trains: `train(n_steps)` runs, per step, the
occupancy-grid maintenance on its cadence (`training_prep`) and one
`nerf_train_step`, and every `sync_every` steps reads the step's stats
back once and adapts the rays per batch. Built from a `NerfSceneConfig` it
only renders, with parameters from a seed or from `load_params`.

Everything lives on one device: the CUDA device unless `device` names
another (it raises where there is none).

Two networks of one configuration exist while training: `model` holds the
raw parameters the optimizer steps, `inference_model` holds the
optimizer's EMA copy, its parameter tensors being the optimizer state's
`ema` leaves themselves, updated in place. Density-grid updates and
renders go through `inference_model` under `torch.no_grad()`, which sends
the MLPs through the fused kernel; the kernel's packed weights are keyed
by the tensors' versions, so an optimizer step repacks them.

Not ported yet, each raising `NotImplementedError` when switched on:
stochastic-corner encoding, camera/focal/exposure optimisation, envmap and
distortion training, extra dims, depth supervision, the error map, the
scanned multi-step block and a device mesh.
"""

from __future__ import annotations

import math
import time
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..common import NERF_GRID_N_CELLS, TestbedMode
from ..convert import opt_state_to_jax, params_to_jax
from ..data.nerf_loader import NerfDataset
from ..metrics import mse, psnr
from ..ops.losses import loss_type_from_string
from ..ops.optimizers import create_optimizer, tree_map
from ..ops.sampling import ld_pixel_offset
from ..utils import Ema, PhaseTimers
from .dataset import (NerfSceneConfig, pack_training_data,
                      scene_config_from_dataset)
from .march import ray_intersect_aabb, to_stepping_space
from .model import NerfNetwork, network_to_density
from .occupancy import (CellDraws, cell_densities, density_grid_mean,
                        draw_cell_randoms, init_bitfield, init_density_grid,
                        mark_untrained_cells, sample_cells, splat_and_ema,
                        update_bitfield)
from .render import RenderConfig, WavefrontRenderer, camera_rays_for_frame
from .sampler import TrainDraws, build_rays, draw_train_randoms
from .training import REMAINDER, NerfTrainStepConfig, nerf_train_step
from .visibility import compute_visible_cells


class NerfTestbed:
    mode = TestbedMode.Nerf
    #: steps between reads of the stats (each read waits for the device)
    sync_every = 16
    #: steps between density-grid updates once the warm-up sweeps are done
    prep_every = 16

    def __init__(self, dataset: Union[NerfDataset, NerfSceneConfig],
                 network_config: Dict[str, Any], device=None,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 seed: int = 1337, mesh=None):
        if mesh is not None:
            raise NotImplementedError("mesh: data-parallel training is not "
                                      "ported yet (ROADMAP queue 1: the "
                                      "port on four cards)")
        # the card unless the caller names another device; never the CPU
        # by itself
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("a CUDA device was asked for but none is "
                               "available")
        self.config = network_config
        self.seed = seed
        if isinstance(dataset, NerfDataset):
            self.dataset: Optional[NerfDataset] = dataset
            self.scene = scene_config_from_dataset(dataset)
            self.data = pack_training_data(dataset, self.device)
        else:
            self.dataset, self.scene, self.data = None, dataset, None
        scene = self.scene
        if scene.n_extra_dims:
            raise NotImplementedError("per-image latent dims are not "
                                      "ported yet")

        def network():
            return NerfNetwork(
                n_pos_dims=3, n_dir_dims=3, n_extra_dims=scene.n_extra_dims,
                encoding_config=network_config["encoding"],
                dir_encoding_config=network_config.get(
                    "dir_encoding",
                    {"otype": "SphericalHarmonics", "degree": 4}),
                network_config=network_config["network"],
                rgb_network_config=network_config.get(
                    "rgb_network", network_config["network"]),
                desired_resolution=2048.0, aabb_scale=scene.aabb_scale,
                compute_dtype=compute_dtype)

        self.model = network()
        # seeded on the CPU, so a seed gives the same weights on any device
        self._generator = torch.Generator().manual_seed(seed)
        self.model.init_params(self._generator)
        self.model.to(self.device)
        # the network that density updates and renders go through
        self.inference_model = self.model
        self.aabb_min = torch.as_tensor(scene.aabb_min, device=self.device)
        self.aabb_max = torch.as_tensor(scene.aabb_max, device=self.device)

        self.density_grid = init_density_grid(scene.max_cascade + 1,
                                              self.device)
        self.bitfield = init_bitfield(self.device)
        self.mean_density = torch.zeros((), device=self.device)
        self.density_grid_ema_step = 0

        # march candidates per ray: derived from the training cameras;
        # without cameras it is the cap
        self.n_march = 1024 if self.data is None else self._derive_n_march()
        self.max_samples_per_ray = 1024
        # per-ray candidate cap at render time (None = min(march cap, 512))
        self.render_max_samples_per_ray: Optional[int] = None
        # most network queries per call (the reference's target_n_queries)
        self.render_query_budget = 2 << 20
        # network evaluations of the last render_frame
        self.last_frame_n_samples = 0

        self.training_step = 0
        self.loss_scalar = float("nan")
        if self.data is not None:
            self._init_training(network)

    def _init_training(self, network) -> None:
        cfg = self.config
        self.optimizer = create_optimizer(cfg["optimizer"])
        self.loss_type = loss_type_from_string(
            cfg.get("loss", {}).get("otype", "L2"))
        self.model.requires_grad_(True)
        self.opt_state = self.optimizer.init(self.model.param_tree())
        if "ema" in self.opt_state:
            # a second network whose parameters ARE the EMA leaves
            self.inference_model = network().to(self.device)
            self.inference_model.load_params(self.opt_state["ema"])
            self.opt_state["ema"] = self.inference_model.param_tree()
        # the train step's draws, on the device
        self._train_generator = torch.Generator(
            device=self.device).manual_seed(self.seed)

        # adaptive ray batching towards the target sample count
        self.target_batch_size = 1 << 18
        self.rays_per_batch = 1 << 12
        self.adapt_ray_batch = True
        self.measured_batch_size = 0
        self.measured_batch_size_before_compaction = 0
        # the network runs on the full capacity, so it is the target
        self.sample_capacity_multiplier = 1

        # density-update sample counts; None = the reference cadence
        self.density_samples_override: Optional[int] = None
        # full-grid sweeps before the steady 1/4 uniform + 1/4 occupied
        self.warmup_full_grid_preps = 4
        self._visible_cells = None

        self.random_bg_color = True
        self.train_in_linear_colors = False
        self.disable_regularizers = False

        # switches of what is not ported yet: each raises when set
        self.stochastic_corners = False
        self.optimize_extrinsics = False
        self.optimize_focal_length = False
        self.optimize_exposure = False
        self.optimize_extra_dims = False
        self.train_envmap = False
        self.optimize_distortion = False
        self.use_error_map_sampling = False
        self.steps_per_dispatch = 1

        self.timers = PhaseTimers()
        self.loss_ema = Ema(half_life_s=1.0)
        self.samples_per_s = Ema(half_life_s=2.0)
        self.rays_per_s = Ema(half_life_s=2.0)
        self.steps_per_s = Ema(half_life_s=2.0)
        self.mean_samples_per_ray = 0.0
        self._last_sync_t = None
        self._steps_at_last_sync = 0

    # ------------------------------------------------------------------
    # parameters
    # ------------------------------------------------------------------
    @torch.no_grad()
    def load_params(self, params: Dict[str, Any]) -> None:
        """Load parameters in the JAX layout (numpy arrays or tensors). A
        training testbed starts afresh from them: zero moments, step 0 and
        an EMA equal to the parameters."""
        self.load_state(params)

    @torch.no_grad()
    def load_state(self, params: Dict[str, Any],
                   opt_state: Optional[Dict[str, Any]] = None) -> None:
        """Parameters and, for a training testbed, the optimizer state
        {"step", "m", "v", "ema"}, in the JAX layout; copied in place."""
        self.model.load_params(params)
        if self.data is None:
            return
        state = self.opt_state
        if opt_state is None:
            opt_state = {"step": 0}

        def fill(dst, src):
            dst.copy_(torch.as_tensor(src, dtype=dst.dtype).reshape(
                dst.shape))

        state["step"].fill_(int(opt_state["step"]))
        for k in ("m", "v"):
            if k in opt_state:
                tree_map(fill, state[k], opt_state[k])
            else:
                tree_map(lambda t: t.zero_(), state[k])
        if "ema" in state:
            tree_map(fill, state["ema"], opt_state.get("ema", params))

    def inference_params(self) -> Dict[str, Any]:
        """The parameter tensors renders and density updates use: the EMA
        copy when the optimizer keeps one."""
        return self.inference_model.param_tree()

    # ------------------------------------------------------------------
    # density grid maintenance
    # ------------------------------------------------------------------
    @torch.no_grad()
    def set_density_grid(self, grid) -> None:
        """Replace the density grid and rebuild the bitfield from it."""
        if not torch.is_tensor(grid):
            grid = torch.from_numpy(np.array(grid, np.float32))
        grid = grid.to(self.device, torch.float32)
        if grid.shape != self.density_grid.shape:
            raise ValueError(f"density grid {tuple(grid.shape)} != "
                             f"{tuple(self.density_grid.shape)}")
        self.density_grid = grid.clone()
        self.bitfield = update_bitfield(self.density_grid,
                                        self.scene.max_cascade)
        self.mean_density = density_grid_mean(self.density_grid)

    @torch.no_grad()
    def update_density_grid_full(self, decay: float = 0.95) -> None:
        """One density query at a jittered point of every cell (jitter from
        the testbed's generator), then the max-EMA merge."""
        n_cells = NERF_GRID_N_CELLS * (self.scene.max_cascade + 1)
        self.update_density_grid(
            torch.arange(n_cells, device=self.device),
            torch.rand(n_cells, 3, generator=self._generator), decay)

    @torch.no_grad()
    def update_density_grid(self, indices: torch.Tensor,
                            jitter: torch.Tensor, decay: float = 0.95
                            ) -> None:
        """Query the density (inference parameters) at a point of each cell
        in `indices`, offset by `jitter` (n, 3) in [0, 1), max-EMA merge it
        into the grid and rebuild the bitfield (what the JAX testbed's
        `_density_update_body` does after sampling the cells)."""
        idx = indices.to(self.device, torch.long)
        act = self.scene.density_activation
        net = self.inference_model
        dens = cell_densities(
            lambda pos: network_to_density(net.density(pos), act),
            idx, jitter.to(self.device, torch.float32), self.aabb_min,
            self.aabb_max)
        self.density_grid = splat_and_ema(self.density_grid, idx, dens,
                                          decay)
        self.bitfield = update_bitfield(self.density_grid,
                                        self.scene.max_cascade)
        self.mean_density = density_grid_mean(self.density_grid)

    def _prep_draws(self, n_uniform: int, n_nonuniform: int
                    ) -> Tuple[Optional[CellDraws], torch.Tensor]:
        """The random numbers of one `training_prep`: the cell probes (none
        for a full sweep) and the (n, 3) jitter inside the cells."""
        n_cascades = self.scene.max_cascade + 1
        draws = None
        if (n_uniform, n_nonuniform) != (NERF_GRID_N_CELLS * n_cascades, 0):
            draws = draw_cell_randoms(self._train_generator, n_uniform,
                                      n_nonuniform, n_cascades)
        return draws, torch.rand(n_uniform + n_nonuniform, 3,
                                 device=self.device,
                                 generator=self._train_generator)

    def _train_draws(self, n_rays: int) -> TrainDraws:
        """The random numbers of one train step."""
        return draw_train_randoms(self._train_generator, n_rays,
                                  self.data.n_images)

    @torch.no_grad()
    def training_prep(self, decay: float = 0.95) -> None:
        """Occupancy-grid maintenance before a train step: at step 0 the
        cells no camera sees are marked untrained; then a full sweep of
        every cell (the first `warmup_full_grid_preps` steps) or 1/4 of
        the cells sampled regardless of state plus 1/4 sampled among the
        occupied ones, queried with the inference parameters."""
        self._require_training()
        n_cascades = self.scene.max_cascade + 1
        n_cells = NERF_GRID_N_CELLS * n_cascades
        if self.training_step == 0 and not self.dataset.has_rays:
            if self._visible_cells is None:
                self._visible_cells = compute_visible_cells(self.data,
                                                            self.scene)
            self.density_grid = mark_untrained_cells(self.density_grid,
                                                     self._visible_cells)
        full_sweep = self.training_step < self.warmup_full_grid_preps
        if self.density_samples_override is not None:
            n = self.density_samples_override
            counts = (n, 0 if full_sweep else n)
        elif full_sweep:
            counts = (n_cells, 0)
        else:
            counts = (n_cells // 4, n_cells // 4)
        draws, jitter = self._prep_draws(*counts)
        idx = sample_cells(draws, self.density_grid, *counts, n_cascades)
        self.update_density_grid(idx, jitter, decay)
        self.density_grid_ema_step += 1

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------
    def _require_training(self) -> None:
        if self.data is None:
            raise RuntimeError("this testbed was built from a scene config "
                               "and only renders; build it from a "
                               "NerfDataset to train")

    def _train_cfg(self, n_rays: int, max_k: int) -> NerfTrainStepConfig:
        for name, what in (
                ("train_envmap", f"envmap training ({REMAINDER})"),
                ("optimize_distortion",
                 f"distortion-map training ({REMAINDER})")):
            if getattr(self, name):
                raise NotImplementedError(f"{name}: {what} is not ported "
                                          f"yet")
        if self.steps_per_dispatch != 1:
            raise NotImplementedError(
                "steps_per_dispatch > 1: the scanned multi-step block is a "
                "dispatch workaround of the JAX package and is not ported "
                "(ROADMAP: do not port TPU workarounds)")
        # nerf_train_step raises on the switches it carries
        return NerfTrainStepConfig(
            n_rays=n_rays, n_march=self.n_march, max_samples_per_ray=max_k,
            sample_capacity=self.target_batch_size
            * self.sample_capacity_multiplier,
            lens_mode=self.scene.lens_mode,
            cone_angle=self.scene.cone_angle_constant,
            max_mip=self.scene.max_cascade,
            rgb_activation=self.scene.rgb_activation,
            density_activation=self.scene.density_activation,
            loss_type=self.loss_type,
            near_distance=self.scene.near_distance,
            train_in_linear_colors=self.train_in_linear_colors,
            random_bg_color=self.random_bg_color,
            disable_regularizers=self.disable_regularizers,
            optimize_camera=(self.optimize_extrinsics
                             or self.optimize_focal_length),
            optimize_exposure=self.optimize_exposure,
            optimize_extra_dims=self.optimize_extra_dims,
            use_error_map=self.use_error_map_sampling,
            stochastic_corners=self.stochastic_corners)

    def train_step(self) -> Dict[str, torch.Tensor]:
        """One train step without the prep, the sync or the adaptation:
        -> the step's stats, on the device."""
        self._require_training()
        n_rays = self.rays_per_batch
        cfg = self._train_cfg(n_rays, self._bucket_k(n_rays))
        stats = nerf_train_step(
            self.model, self.optimizer, cfg, self.aabb_min, self.aabb_max,
            self.opt_state, self.data, self.bitfield, self.mean_density,
            self._train_draws(n_rays))
        self.training_step += 1
        return stats

    def train(self, n_steps: int) -> float:
        """n_steps full training iterations (prep, step, adapt) -> the
        loss at the last sync."""
        self._require_training()
        n_pending = 0
        for i in range(n_steps):
            if (self.training_step < self.warmup_full_grid_preps
                    or self.training_step % self.prep_every == 0):
                with self.timers.time("training_prep"):
                    self.training_prep()
            with self.timers.time("train_step"):
                stats = self.train_step()
            n_pending += 1
            if n_pending >= self.sync_every or i == n_steps - 1:
                with self.timers.time("train_sync"):
                    self._sync_stats(stats)
                n_pending = 0
        return self.loss_scalar

    def _sync_stats(self, stats: Dict[str, torch.Tensor]) -> None:
        """Read one step's fused stats vector (the one wait for the device
        per `sync_every` steps), update the counters and adapt the rays
        per batch."""
        loss_v, measured, measured_pre, n_rays_stat = \
            stats["fused"].cpu().tolist()
        measured, measured_pre = int(measured), int(measured_pre)
        n_rays_stat = int(n_rays_stat)
        if measured == 0:
            self.loss_scalar = 0.0
            raise RuntimeError("NeRF training generated 0 samples; "
                               "aborting")
        self.loss_scalar = loss_v * measured / self.target_batch_size
        self.loss_ema.update(self.loss_scalar)
        self.measured_batch_size = measured
        self.measured_batch_size_before_compaction = measured_pre

        now = time.perf_counter()
        steps_done = self.training_step - self._steps_at_last_sync
        if self._last_sync_t is not None and steps_done > 0:
            dt = max(now - self._last_sync_t, 1e-9)
            self.steps_per_s.update(steps_done / dt)
            self.samples_per_s.update(steps_done * measured / dt)
            self.rays_per_s.update(steps_done * n_rays_stat / dt)
            self.mean_samples_per_ray = measured / max(n_rays_stat, 1)
        self._last_sync_t = now
        self._steps_at_last_sync = self.training_step

        if not self.adapt_ray_batch:
            return
        # towards the target batch, and so that the GENERATED samples fit
        # the capacity
        new_rays = int(self.rays_per_batch * self.target_batch_size
                       / max(measured, 1))
        capacity = self.target_batch_size * self.sample_capacity_multiplier
        cap_rays = int(self.rays_per_batch * capacity
                       / max(measured_pre, 1))
        # the candidate-domain composite holds (rays, n_march) planes:
        # at most 2^14 rays keeps each under 16 M lanes
        self.rays_per_batch = min(max(min(new_rays, cap_rays), 256),
                                  1 << 14)

    def performance_stats(self) -> Dict[str, Any]:
        return {
            "steps_per_s": self.steps_per_s.value,
            "rays_per_s": self.rays_per_s.value,
            "samples_per_s": self.samples_per_s.value,
            "mean_samples_per_ray": self.mean_samples_per_ray,
            "loss_ema": self.loss_ema.value,
            "measured_batch_size": self.measured_batch_size,
            "rays_per_batch": self.rays_per_batch,
            "phase_ms": self.timers.summary(),
        }

    @torch.no_grad()
    def _derive_n_march(self) -> int:
        """Worst-case candidates per ray for this scene's cameras: the
        largest stepping-space span of a ray inside the aabb over a sparse
        pixel grid of every camera, plus 10 % and 32 steps, rounded up to
        a multiple of 128, at most 1024."""
        cone = self.scene.cone_angle_constant
        n_img = self.data.n_images
        lin = torch.linspace(0.02, 0.98, 8, device=self.device)
        uv1 = torch.stack(torch.meshgrid(lin, lin, indexing="xy"),
                          -1).reshape(-1, 2)                    # (64, 2)
        uv = uv1.repeat(n_img, 1)
        idx = torch.arange(n_img, device=self.device).repeat_interleave(
            uv1.shape[0])
        o, d, ok = build_rays(self.data, idx, uv,
                              torch.zeros(idx.shape[0], device=self.device),
                              self.scene.lens_mode)
        tmin, tmax = ray_intersect_aabb(o, d, self.aabb_min, self.aabb_max)
        tmin = tmin.clamp(min=0.0)
        span = torch.where(ok & (tmax > tmin),
                           to_stepping_space(tmax, cone)
                           - to_stepping_space(tmin, cone), 0.0)
        need = int(float(span.max()) * 1.1) + 32
        return min(max((need + 127) // 128 * 128, 128), 1024)

    def _bucket_k(self, n_rays: int) -> int:
        """Samples kept per ray: enough to cover the target batch at this
        ray count four times over, a power of two, at most the march
        cap."""
        k = self.target_batch_size // max(n_rays, 1) * 4
        k = 1 << int(math.ceil(math.log2(max(k, 8))))
        return min(max(k, 8), self.max_samples_per_ray)

    # ------------------------------------------------------------------
    # rendering
    # ------------------------------------------------------------------
    def _renderer(self, min_transmittance: float) -> WavefrontRenderer:
        k_render = (self.render_max_samples_per_ray
                    or min(self.max_samples_per_ray, 512))
        cfg = RenderConfig(
            n_march=self.n_march, max_samples_per_ray=k_render,
            cone_angle=self.scene.cone_angle_constant,
            max_mip=self.scene.max_cascade,
            rgb_activation=self.scene.rgb_activation,
            density_activation=self.scene.density_activation,
            min_transmittance=min_transmittance,
            query_budget=self.render_query_budget)
        return WavefrontRenderer(self.inference_model, cfg, self.aabb_min,
                                 self.aabb_max)

    @torch.no_grad()
    def render_frame(self, width: int, height: int, camera_matrix,
                     focal_length=None, spp: int = 1,
                     background_color=(0.0, 0.0, 0.0),
                     min_transmittance: float = 1e-2,
                     tile: Optional[int] = None,
                     screen_center=(0.5, 0.5)) -> np.ndarray:
        """Render a Shade frame with the inference parameters -> (H, W, 4)
        linear float32 (rgb, alpha).

        camera_matrix: (3, 4) NGP-space camera. focal_length: pixels, a
        scalar or (fx, fy); by default the first training camera's,
        scaled to the frame (a render-only testbed has none and requires
        it). spp > 1 averages jittered subpixel samples. tile bounds the
        rays rendered together (default 2^19)."""
        if focal_length is None:
            if self.data is None:
                raise ValueError("focal_length is required: a render-only "
                                 "testbed has no training camera")
            res0 = self.data.resolution
            fl = self.data.focal_lengths[0].cpu().numpy() \
                * np.array([width / res0[0], height / res0[1]], np.float32)
        else:
            fl = np.array(focal_length, np.float32)
            if fl.ndim == 0:
                fl = np.array([fl, fl], np.float32)
        tile = tile or (1 << 19)
        renderer = self._renderer(min_transmittance)
        bg = torch.as_tensor(background_color, dtype=torch.float32,
                             device=self.device)
        n_pixels = width * height
        acc = torch.zeros(n_pixels, 4, device=self.device)
        self.last_frame_n_samples = 0
        for s in range(spp):
            jitter = None if spp == 1 else ld_pixel_offset(s)
            origins, dirs = camera_rays_for_frame(
                width, height, fl, np.array(camera_matrix, np.float32),
                jitter=jitter, device=self.device,
                screen_center=screen_center)
            for i in range(0, n_pixels, tile):
                out = renderer.render(origins[i:i + tile], dirs[i:i + tile],
                                      self.bitfield, bg)
                acc[i:i + tile, :3] += out["rgb"]
                acc[i:i + tile, 3] += out["alpha"]
                self.last_frame_n_samples += out["n_samples"]
        return (acc / spp).reshape(height, width, 4).cpu().numpy()

    def render_training_view(self, img_idx: int, spp: int = 1,
                             width: Optional[int] = None,
                             height: Optional[int] = None,
                             min_transmittance: float = 1e-4,
                             background_color=(0.0, 0.0, 0.0)
                             ) -> np.ndarray:
        """Render from a training camera, through its own focal length and
        principal point."""
        self._require_training()
        if self.scene.lens_mode != 0:
            raise NotImplementedError(f"lens mode {self.scene.lens_mode} is "
                                      f"not ported yet (only the pinhole "
                                      f"lens)")
        w0, h0 = (int(v) for v in self.data.resolutions[img_idx].tolist())
        width, height = width or w0, height or h0
        fl = self.data.focal_lengths[img_idx].cpu().numpy() \
            * np.array([width / w0, height / h0], np.float32)
        return self.render_frame(
            width, height, self.data.xforms_start[img_idx].cpu().numpy(), fl,
            spp=spp, min_transmittance=min_transmittance,
            background_color=background_color,
            screen_center=self.data.principal_points[img_idx].tolist())

    def eval_psnr(self, img_idx: int, spp: int = 1, downscale: int = 1
                  ) -> float:
        """PSNR of a rendered training view against its image, in sRGB over
        a black background. The network trains in sRGB, so the rendered
        values are sRGB already."""
        self._require_training()
        if self.data.pixels.dtype != torch.uint8 \
                or self.train_in_linear_colors:
            raise NotImplementedError("eval_psnr of HDR images or of a "
                                      "network trained in linear colours "
                                      "is not ported yet")
        w0, h0 = (int(v) for v in self.data.resolutions[img_idx].tolist())
        w, h = w0 // downscale, h0 // downscale
        render = self.render_training_view(img_idx, spp=spp, width=w,
                                           height=h)
        gt = self.data.pixels[img_idx, :h0, :w0].cpu().numpy() \
            .astype(np.float32) / 255.0
        gt_srgb = gt[..., :3] * gt[..., 3:4]   # premultiplied, on black
        if downscale != 1:
            # area average: rendered pixel i spans source block
            # [i*ds, (i+1)*ds) and its ray passes through the block centre
            ds = downscale
            gt_srgb = gt_srgb[:h * ds, :w * ds] \
                .reshape(h, ds, w, ds, 3).mean(axis=(1, 3))
        return psnr(mse(np.clip(render[..., :3], 0.0, 1.0), gt_srgb))

    # ------------------------------------------------------------------
    # snapshots
    # ------------------------------------------------------------------
    def save_snapshot(self, path: str) -> None:
        """A snapshot in the JAX package's format, with the config
        embedded: parameters, optimizer state, density grid, step counts."""
        from ..data.snapshot import save_snapshot

        self._require_training()
        n_img = self.data.n_images
        save_snapshot(path, {
            "mode": self.mode.value,
            "config": self.config,
            "grid_layout": "interleaved",
            "trainer": {"params": params_to_jax(self.model.param_tree()),
                        "opt": opt_state_to_jax(self.opt_state)},
            "density_grid": self.density_grid,
            "training_step": self.training_step,
            "density_grid_ema_step": self.density_grid_ema_step,
            "aabb_scale": self.scene.aabb_scale,
            "dataset_paths": list(self.dataset.paths),
            "camera": {
                "pos_offset": np.zeros((n_img, 3), np.float32),
                "rot_offset": np.zeros((n_img, 3), np.float32),
                "focal_offset": np.zeros(2, np.float32),
                "exposures": self.data.exposures,
            },
            "extra_dims": None,
        })

    def load_snapshot_state(self, snapshot: Dict[str, Any]) -> None:
        """Restore from `data.snapshot.load_snapshot`'s dict."""
        trainer = snapshot["trainer"]
        self.load_state(trainer["params"], trainer.get("opt"))
        self.set_density_grid(snapshot["density_grid"])
        self.training_step = int(snapshot.get("training_step", 0))
        self.density_grid_ema_step = int(
            snapshot.get("density_grid_ema_step", 0))
