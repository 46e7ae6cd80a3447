"""NeRF testbed: data, network, occupancy grid, training and rendering
(counterpart of instant_ngp_tpu/nerf/testbed_nerf.py::NerfTestbed).

Built from a `NerfDataset` it trains: `train(n_steps)` runs, per step, the
occupancy-grid maintenance on its cadence (`training_prep`) and one
`nerf_train_step`, and every `sync_every` steps reads the step's stats
back once and adapts the rays per batch. Built from a `NerfSceneConfig` it
only renders, with parameters from a seed or from `load_params`.

Everything lives on one device: the CUDA device unless `device` names
another (it raises where there is none), or the mesh's device of this
rank.

Two networks of one configuration exist while training: `model` holds the
raw parameters the optimizer steps, `inference_model` holds the
optimizer's EMA copy, its parameter tensors being the optimizer state's
`ema` leaves themselves, updated in place. Density-grid updates and
renders go through `inference_model` under `torch.no_grad()`, which sends
the MLPs through the fused kernel; the kernel's packed weights are keyed
by the tensors' versions, so an optimizer step repacks them.

Training runs what the JAX testbed runs with its defaults:
- `stochastic_corners` (on): train steps and density updates use the
  position encoding's stochastic-corner estimator, the train step with the
  configuration's exact axes and backward rule, the density update with
  one sampled corner (its max-EMA already samples one random position per
  cell and only errs towards keeping a cell). `stochastic_corners_until`
  (from the encoding's config, default never) switches to the exact encode
  at that step. Renders use the exact encode unless
  `render_stochastic_corners` is set.
- `use_error_map_sampling` (the dataset's `wants_importance_sampling`):
  every step deposits the rays' losses into a coarse per-image error map;
  every `n_steps_between_error_map_updates` steps the map becomes the CDFs
  that half of the ray picks follow, on the host, and is zeroed.
- `optimize_extrinsics`, `optimize_focal_length`, `optimize_exposure` (off):
  per-image translation and axis-angle offsets, one relative focal offset
  and per-image log2 exposures, stepped by Adam on the host every
  `n_steps_between_cam_updates` steps from the gradients the train steps
  return. The pose and focal gradients need the exact encode and a second
  ray build, so they are taken on one step per `cam_grad_interval` and
  scaled by it. `effective_xform` is a training camera with its offsets.
- `train_envmap`, `optimize_distortion` (off) and `optimize_extra_dims`
  (on where the dataset has extra dims): the lat-long environment map
  behind the scene, the lens-distortion map added on the image plane and
  the per-image latent codes are `TrainableBuffer`s; every train step
  returns their gradients and each buffer's own optimizer steps it on the
  device. `depth_supervision_lambda` (0) weighs the depth term where the
  dataset has depth images.
The two host-side updates are the only reads of the device besides the
stats: `host_syncs` counts them.

Rendering: `render_frame` renders any mode of `common.RenderMode` through
any lens. Shade, Depth and AO go through the wavefront renderer (unless
`render_wavefront` is off), the other marching modes through
`render_tile`; Distortion is a screen-space picture of the lens, Slice a
false-colour density slice (`render_density_slice`).

Meshes: `compute_marching_cubes_mesh` extracts the density's iso-surface
on a grid (marching cubes, or tetrahedra with `mesh_algorithm = "tets"`)
and colours its vertices through the inference network (the MLPs through
the fused kernel); `optimise_mesh_step` moves vertices towards the
iso-surface along the density's input gradient (taken under autograd:
plain matmuls, no kernel), with Laplacian smoothing, by Adam on the host.

Data parallel (`mesh`, a `parallel.mesh.Mesh`, with `mesh_axis`): the same
loop on every rank of the axis, each on its own device (the mesh's). Each
rank takes `rays_per_batch // n` rays and `1/n` of the sample capacity and
of a density update's cells, with draws of its own (its own generator
stream; the hooks below hand each rank its own); nerf/parallel.py reduces
the gradients, stats and error map and gathers the cells' densities, so
the parameters, the occupancy grid, the error map's CDFs and the host-side
camera updates stay the same on every rank. On the mesh a step always
takes the camera gradient, unscaled (`cam_grad_interval` applies to one
device only, as in the JAX testbed).

Not ported, raising `NotImplementedError`: the scanned multi-step block
(`steps_per_dispatch`, a TPU dispatch workaround).
"""

from __future__ import annotations

import math
import time
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..camera import lens_mode_id
from ..common import (NERF_GRID_N_CELLS, NERF_MIN_OPTICAL_THICKNESS,
                      TestbedMode, linear_to_srgb)
from ..convert import buffer_state_to_jax, opt_state_to_jax, params_to_jax
from ..data.nerf_loader import NerfDataset
from ..metrics import mse, psnr
from ..ops.grid_encoding import CornerDraws
from ..ops.host_adam import HostAdam, RotationHostAdam, rotvec_to_matrix
from ..ops.losses import loss_type_from_string
from ..ops.optimizers import create_optimizer, tree_map
from ..ops.sampling import ld_pixel_offset
from ..ops.trainable_buffer import TrainableBuffer, read_envmap
from ..parallel.mesh import Mesh
from ..utils import Ema, PhaseTimers
from .dataset import (NerfSceneConfig, pack_training_data,
                      scene_config_from_dataset)
from .march import (cascaded_grid_idx_at, mip_from_pos, ray_intersect_aabb,
                    to_stepping_space, warp_direction, warp_position)
from .model import NerfNetwork, network_to_density, network_to_rgb
from .occupancy import (CellDraws, cell_densities, density_grid_mean,
                        draw_cell_randoms, init_bitfield, init_density_grid,
                        mark_untrained_cells, sample_cells, splat_and_ema,
                        update_bitfield)
from .parallel import make_sharded_density_update, shard_counts
from .render import (RENDER_TILE_MODES, RenderConfig, WavefrontRenderer,
                     camera_rays_for_frame, distortion_flow_image,
                     render_tile)
from .sampler import build_rays, draw_train_randoms
from .training import NerfTrainStepConfig, StepDraws, nerf_train_step
from .visibility import compute_visible_cells


class NerfTestbed:
    mode = TestbedMode.Nerf
    #: steps between reads of the stats (each read waits for the device)
    sync_every = 16
    #: steps between density-grid updates once the warm-up sweeps are done
    prep_every = 16
    #: "mc" (marching cubes) or "tets" (marching tetrahedra)
    mesh_algorithm = "mc"

    def __init__(self, dataset: Union[NerfDataset, NerfSceneConfig],
                 network_config: Dict[str, Any], device=None,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 seed: int = 1337, mesh: Optional[Mesh] = None,
                 mesh_axis: str = "data"):
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a parallel.mesh.Mesh, not "
                            f"{type(mesh).__name__}")
        self.mesh, self.mesh_axis = mesh, mesh_axis
        self._n_shards = 1 if mesh is None else mesh.size(mesh_axis)
        self._group = None if mesh is None else mesh.group(mesh_axis)
        if mesh is not None and device is None:
            device = mesh.device
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
            # learnable latent codes start from a generator of their own
            self.data = pack_training_data(
                dataset, self.device,
                generator=torch.Generator().manual_seed(seed ^ 0xE7D1))
        else:
            self.dataset, self.scene, self.data = None, dataset, None
        scene = self.scene

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
        # Shade, Depth and AO through the early-out wavefront renderer;
        # off = through render_tile like the other modes
        self.render_wavefront = True
        # network evaluations of the last render_frame
        self.last_frame_n_samples = 0
        # render with the position encoding's stochastic-corner estimator
        # (the configuration's exact axes), fresh draws in every network
        # call; off = the exact encode
        self.render_stochastic_corners = False

        # the render-time latent code: a training view's (view 0 unless
        # set otherwise), or an explicit vector
        self.rendering_extra_dims_from_training_view = 0
        self._rendering_extra_dims: Optional[torch.Tensor] = None
        self._init_buffers()

        self.training_step = 0
        self.loss_scalar = float("nan")
        if self.data is not None:
            self._init_training(network)

    def _init_buffers(self) -> None:
        """The trainable buffers: the environment map (sized and seeded by
        the dataset's, else 8 x 16 of zeros), the distortion map (the
        config's resolution, default 32 x 32, zeros) and the per-image
        latent codes, each with the optimizer its config names (default
        the network's)."""
        cfg, dataset = self.config, self.dataset
        self.train_envmap = False
        self.optimize_distortion = False
        self.optimize_extra_dims = self.scene.n_extra_dims > 0
        default_opt = cfg.get("optimizer", {"otype": "Adam"})
        env_cfg = cfg.get("envmap", {})
        dist_cfg = cfg.get("distortion_map", {})
        env_res, env_init = (8, 16), None      # (H, W)
        if dataset is not None and dataset.envmap is not None:
            env_init = np.asarray(dataset.envmap, np.float32)
            env_res = env_init.shape[:2]
        self.has_dataset_envmap = env_init is not None
        self.envmap = TrainableBuffer(
            (env_res[0], env_res[1], 4),
            env_cfg.get("optimizer", default_opt), env_init,
            device=self.device)
        dist_res = dist_cfg.get("resolution", [32, 32])
        self.distortion_map = TrainableBuffer(
            (dist_res[1], dist_res[0], 2),
            dist_cfg.get("optimizer", default_opt), device=self.device)
        self._extra_dims_buf: Optional[TrainableBuffer] = None
        if self.data is not None and self.data.extra_dims is not None:
            self._extra_dims_buf = TrainableBuffer(
                tuple(self.data.extra_dims.shape), default_opt,
                self.data.extra_dims, device=self.device)
            # the data's codes ARE the buffer's tensor, stepped in place
            self.data.extra_dims = self._extra_dims_buf.params

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
        # the train step's draws, on the device; a stream of its own for
        # every rank of a mesh (the seed's low 32 bits differ: the CPU
        # generator reads no others)
        rank = 0 if self.mesh is None else self.mesh.index(self.mesh_axis)
        self._train_generator = torch.Generator(
            device=self.device).manual_seed(
            self.seed ^ (0x9E3779B1 * rank & 0xFFFFFFFF))

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

        # the stochastic-corner encode in train steps and density updates
        # (the exact encode wherever a step takes the camera gradient, and
        # at render time), until this step (None = always)
        self.stochastic_corners = True
        self.stochastic_corners_until: Optional[int] = cfg.get(
            "encoding", {}).get("stochastic_corners_until", None)

        # camera, focal-length and exposure optimisation
        self.optimize_extrinsics = False
        self.optimize_focal_length = False
        self.optimize_exposure = False
        self.extrinsic_learning_rate = 1e-3
        self.extrinsic_l2_reg = 1e-4
        self.intrinsic_l2_reg = 1e-4
        self.exposure_l2_reg = 0.0
        self.n_steps_between_cam_updates = 16
        # the pose and focal gradients are taken on one step per interval
        # and scaled by it (clamped to the update window; 1 = every step);
        # exposure gradients rebuild no rays and come from every step
        self.cam_grad_interval = 16
        n_img = self.data.n_images
        self.cam_pos_offset = np.zeros((n_img, 3), np.float32)
        self.cam_rot_offset = np.zeros((n_img, 3), np.float32)
        self.cam_focal_offset = np.zeros(2, np.float32)
        self._cam_pos_adam = HostAdam(1e-4)
        self._cam_rot_adam = RotationHostAdam(1e-4)
        self._focal_adam = HostAdam(1e-5)
        self._exposure_adam = HostAdam(1e-3)
        self._cam_grad_accum = None
        self._exposure_grad_accum = None
        self._n_steps_since_cam_update = 0
        self._cam_on_device = None   # (the three host arrays, their copies)

        # error-map importance sampling
        self.use_error_map_sampling = bool(
            self.dataset.wants_importance_sampling)
        self.n_steps_between_error_map_updates = 128
        self._error_map = None
        self._error_cdfs = None
        self._n_steps_since_error_update = 0
        self._error_map_res = (0, 0)
        # reads of the device by the two host-side updates
        self.host_syncs = {"camera_updates": 0, "error_cdfs": 0}

        # weight of the depth term (needs depth images in the dataset)
        self.depth_supervision_lambda = 0.0
        # the scanned multi-step block is not ported: anything but 1 raises
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
                            jitter: torch.Tensor, decay: float = 0.95,
                            corners: Union[CornerDraws, torch.Generator,
                                           None] = None) -> None:
        """Query the density (`evaluate_density`) at a point of each cell in
        `indices`, max-EMA merge it into the grid and rebuild the bitfield
        (what the JAX testbed's `_density_update_body` does after sampling
        the cells)."""
        idx = indices.to(self.device, torch.long)
        dens = self.evaluate_density(idx, jitter, corners)
        self.density_grid = splat_and_ema(self.density_grid, idx, dens,
                                          decay)
        self.bitfield = update_bitfield(self.density_grid,
                                        self.scene.max_cascade)
        self.mean_density = density_grid_mean(self.density_grid)

    @torch.no_grad()
    def evaluate_density(self, indices: torch.Tensor, jitter: torch.Tensor,
                         corners: Union[CornerDraws, torch.Generator,
                                        None] = None) -> torch.Tensor:
        """The density (inference parameters) at a point of each cell in
        `indices`, offset by `jitter` (n, 3) in [0, 1) -> (n,): the
        evaluation half of a density update (the JAX testbed's
        `_density_update_body(..., evaluate_only=True)`). With `corners`
        (the draws of all n cells, or a generator to draw each chunk's
        from) the encode samples one corner per cell and level."""
        idx = indices.to(self.device, torch.long)
        act = self.scene.density_activation
        net = self.inference_model

        def density(pos, start):
            if corners is None:
                raw = net.density(pos)
            elif isinstance(corners, torch.Generator):
                raw = net.density(pos, encode_generator=corners,
                                  exact_axes=0)
            else:
                raw = net.density(
                    pos, exact_axes=0,
                    encode_draws=corners.rows(start, start + pos.shape[0]))
            return network_to_density(raw, act)

        return cell_densities(
            density, idx, jitter.to(self.device, torch.float32),
            self.aabb_min, self.aabb_max)

    def _prep_draws(self, n_uniform: int, n_nonuniform: int
                    ) -> Tuple[Optional[CellDraws], torch.Tensor,
                               Union[CornerDraws, torch.Generator, None]]:
        """The random numbers of one `training_prep`: the cell probes (none
        for a full sweep), the (n, 3) jitter inside the cells, and the
        source of the encode's corner draws (asked for only while the
        stochastic encode is on): the generator, so that each chunk of
        cells draws its own, or all the cells' draws."""
        n_cascades = self.scene.max_cascade + 1
        draws = None
        if (n_uniform, n_nonuniform) != (NERF_GRID_N_CELLS * n_cascades, 0):
            draws = draw_cell_randoms(self._train_generator, n_uniform,
                                      n_nonuniform, n_cascades)
        jitter = torch.rand(n_uniform + n_nonuniform, 3, device=self.device,
                            generator=self._train_generator)
        return draws, jitter, self._train_generator

    def _train_draws(self, n_rays: int) -> StepDraws:
        """The random numbers of one train step: the rays' (those of the
        CDF pick once there are CDFs) and the source of the encode's."""
        return StepDraws(
            draw_train_randoms(self._train_generator, n_rays,
                               self.data.n_images,
                               with_cdf=self.use_error_map_sampling
                               and self._error_cdfs is not None),
            self._train_generator)

    @torch.no_grad()
    def training_prep(self, decay: float = 0.95) -> None:
        """Occupancy-grid maintenance before a train step: at step 0 the
        cells no camera sees are marked untrained; then a full sweep of
        every cell (the first `warmup_full_grid_preps` steps) or 1/4 of
        the cells sampled regardless of state plus 1/4 sampled among the
        occupied ones, queried with the inference parameters. On a mesh
        each rank samples and queries its share of the cells with its own
        draws (`make_sharded_density_update`)."""
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
        if self.mesh is not None:
            update = make_sharded_density_update(self, self.mesh,
                                                 self.mesh_axis, *counts)
            draws, jitter, corners = self._prep_draws(
                *shard_counts(*counts, self._n_shards))
            self.density_grid, self.bitfield, self.mean_density = update(
                self.density_grid, draws, jitter,
                corners if self._stoch_now() else None, decay)
        else:
            draws, jitter, corners = self._prep_draws(*counts)
            idx = sample_cells(draws, self.density_grid, *counts,
                               n_cascades)
            self.update_density_grid(
                idx, jitter, decay, corners if self._stoch_now() else None)
        self.density_grid_ema_step += 1

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------
    def _require_training(self) -> None:
        if self.data is None:
            raise RuntimeError("this testbed was built from a scene config "
                               "and only renders; build it from a "
                               "NerfDataset to train")

    def _stoch_now(self) -> bool:
        """Whether train steps and density updates use the stochastic
        encode at the current training step."""
        if not self.stochastic_corners:
            return False
        until = self.stochastic_corners_until
        return until is None or self.training_step < until

    def _cam_grad_interval_eff(self) -> int:
        """The camera-gradient interval, clamped so that every update
        window sees at least one gradient step."""
        return max(1, min(self.cam_grad_interval,
                          self.n_steps_between_cam_updates))

    def _cam_dict(self) -> Optional[Dict[str, torch.Tensor]]:
        """The camera offsets on the device (copied when the host arrays
        were replaced), or None while nothing of the camera is optimised."""
        if not (self.optimize_extrinsics or self.optimize_focal_length
                or self.optimize_exposure):
            return None
        host = (self.cam_pos_offset, self.cam_rot_offset,
                self.cam_focal_offset)
        cached = self._cam_on_device
        if cached is None or any(a is not b for a, b in zip(cached[0],
                                                            host)):
            self._cam_on_device = cached = (host, {
                k: torch.as_tensor(np.asarray(v, np.float32),
                                   device=self.device)
                for k, v in zip(("pos", "rot", "focal"), host)})
        return cached[1]

    def _train_cfg(self, n_rays: int, max_k: int) -> NerfTrainStepConfig:
        if self.steps_per_dispatch != 1:
            raise NotImplementedError(
                "steps_per_dispatch > 1: the scanned multi-step block is a "
                "dispatch workaround of the JAX package and is not ported "
                "(ROADMAP: do not port TPU workarounds)")
        return NerfTrainStepConfig(
            n_rays=n_rays, n_march=self.n_march, max_samples_per_ray=max_k,
            # the global target batch, split over the shards
            sample_capacity=self.target_batch_size
            * self.sample_capacity_multiplier // self._n_shards,
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
            optimize_extra_dims=(self.optimize_extra_dims
                                 and self.data.extra_dims is not None),
            depth_supervision_lambda=self.depth_supervision_lambda,
            use_error_map=self.use_error_map_sampling,
            error_map_res=self._error_map_res,
            stochastic_corners=self._stoch_now())

    def train_step(self) -> Dict[str, Any]:
        """One train step without the density update, the stats' sync or
        the adaptation, but with what follows a step on the device and on
        its own cadence: the camera and exposure gradients accumulate and
        are applied every `n_steps_between_cam_updates` steps, the error
        map takes the step's deposit and becomes CDFs every
        `n_steps_between_error_map_updates` steps; the envmap, the
        distortion map and the latent codes take their optimizers' steps.
        -> the step's stats, on the device."""
        self._require_training()
        self._maybe_init_error_map()
        # per rank; the effective batch is n_rays times the shards
        n_rays = self.rays_per_batch // self._n_shards
        cfg = self._train_cfg(n_rays, self._bucket_k(n_rays * self._n_shards))
        # on a mesh every step takes the camera gradient, unscaled
        interval = 1 if self.mesh is not None \
            else self._cam_grad_interval_eff()
        if cfg.optimize_camera and \
                self._n_steps_since_cam_update % interval != interval - 1:
            # an off-interval step: no pose or focal gradient, and so no
            # second ray build and no exact encode; the rays still go
            # through the current offsets
            cfg = cfg._replace(optimize_camera=False)
        stats = nerf_train_step(
            self.model, self.optimizer, cfg, self.aabb_min, self.aabb_max,
            self.opt_state, self.data, self.bitfield, self.mean_density,
            self._train_draws(n_rays), cam=self._cam_dict(),
            error_cdfs=self._error_cdfs, error_map=self._error_map,
            envmap=self.envmap.params if self.train_envmap else None,
            distortion=self.distortion_map.params
            if self.optimize_distortion else None, group=self._group)
        self.training_step += 1

        if "extra_dims_gradient" in stats:
            self._extra_dims_buf.step(stats["extra_dims_gradient"])
        if "envmap_gradient" in stats:
            self.envmap.step(stats["envmap_gradient"])
        if "distortion_gradient" in stats:
            self.distortion_map.step(stats["distortion_gradient"])

        if "cam_gradient" in stats:
            g = stats["cam_gradient"]
            if interval > 1:    # one step stands for the interval's
                g = {k: v * float(interval) for k, v in g.items()}
            acc = self._cam_grad_accum
            self._cam_grad_accum = g if acc is None \
                else {k: acc[k] + g[k] for k in g}
        if "exposure_gradient" in stats:
            g, acc = stats["exposure_gradient"], self._exposure_grad_accum
            self._exposure_grad_accum = g if acc is None else acc + g
        self._n_steps_since_cam_update += 1
        if self._n_steps_since_cam_update >= \
                self.n_steps_between_cam_updates:
            self._apply_camera_updates()
            self._n_steps_since_cam_update = 0
        if "error_map" in stats:
            self._error_map = stats["error_map"]
            self._n_steps_since_error_update += 1
            if self._n_steps_since_error_update >= \
                    self.n_steps_between_error_map_updates:
                self._rebuild_error_cdfs()
                self._n_steps_since_error_update = 0
        return stats

    def _maybe_init_error_map(self) -> None:
        """The error map, (n_images, H_c * W_c) zeros, made at the first
        step and again after a rebuild of the CDFs if the rays per batch
        ask for another size: a side of sqrt(sqrt(rays per image between
        rebuilds)) * 3.5 cells, rounded up to a multiple of 8, at most the
        images' own."""
        if not self.use_error_map_sampling:
            return
        if self._error_map is None or self._n_steps_since_error_update == 0:
            n_samples_per_image = (self.n_steps_between_error_map_updates
                                   * self.rays_per_batch
                                   // max(self.data.n_images, 1))
            w0, h0 = self.data.resolution
            side = int(math.sqrt(math.sqrt(max(n_samples_per_image, 1)))
                       * 3.5)
            side = max((side + 7) // 8 * 8, 8)
            res = (min(side, w0), min(side, h0))
            if res != self._error_map_res or self._error_map is None:
                self._error_map_res = res
                self._error_map = torch.zeros(
                    self.data.n_images, res[0] * res[1], device=self.device)

    def _rebuild_error_cdfs(self) -> None:
        """The error map -> the CDFs `sample_rays` follows, on the host in
        float64 (one read of the device): every cell gets a floor of 1e-8,
        then per row the normalised prefix sum over x, per image the one
        over the rows' sums, and over the images' sums the image CDF. The
        map starts again from zero."""
        self.host_syncs["error_cdfs"] += 1
        cw, ch = self._error_map_res
        em = self._error_map.cpu().numpy().reshape(
            self.data.n_images, ch, cw).astype(np.float64) + 1e-8
        cdf_x = np.cumsum(em, axis=2)
        row_sum = cdf_x[:, :, -1:]
        cdf_x = cdf_x / row_sum
        cdf_y = np.cumsum(row_sum[:, :, 0], axis=1)
        img_sum = cdf_y[:, -1:]
        cdf_y = cdf_y / img_sum
        cdf_img = np.cumsum(img_sum[:, 0])
        cdf_img = cdf_img / cdf_img[-1]
        self._error_cdfs = {
            k: torch.from_numpy(v.astype(np.float32)).to(self.device)
            for k, v in (("cdf_x_cond_y", cdf_x), ("cdf_y", cdf_y),
                         ("cdf_img", cdf_img))}
        self._error_map = torch.zeros_like(self._error_map)

    def _apply_camera_updates(self) -> None:
        """Adam on the host over the gradients accumulated since the last
        update (one read of the device): scaled by n_images / window, plus
        the L2 terms; the extrinsics' rate decays as 0.33^(t / 128); the
        exposures are brought back to zero mean."""
        if self._cam_grad_accum is None and self._exposure_grad_accum is None:
            return
        self.host_syncs["camera_updates"] += 1
        n = max(self.data.n_images, 1)
        scale = n / float(self.n_steps_between_cam_updates)
        if self._cam_grad_accum is not None:
            g = {k: v.cpu().numpy() * scale
                 for k, v in self._cam_grad_accum.items()}
            if self.optimize_extrinsics:
                g["pos"] += self.cam_pos_offset * self.extrinsic_l2_reg
                g["rot"] += self.cam_rot_offset * self.extrinsic_l2_reg
                lr = self.extrinsic_learning_rate * math.pow(
                    0.33, self._cam_pos_adam.t / 128)
                self._cam_pos_adam.learning_rate = lr
                self._cam_rot_adam.learning_rate = lr
                self.cam_pos_offset = self._cam_pos_adam.step(
                    self.cam_pos_offset, g["pos"])
                self.cam_rot_offset = self._cam_rot_adam.step(
                    self.cam_rot_offset, g["rot"])
            if self.optimize_focal_length:
                g["focal"] += self.cam_focal_offset * self.intrinsic_l2_reg
                self.cam_focal_offset = self._focal_adam.step(
                    self.cam_focal_offset, g["focal"])
        if self._exposure_grad_accum is not None and self.optimize_exposure:
            g = self._exposure_grad_accum.cpu().numpy() * scale
            exposures = self.data.exposures.cpu().numpy()
            g += exposures * self.exposure_l2_reg
            new_exp = self._exposure_adam.step(exposures, g)
            new_exp -= new_exp.mean(0, keepdims=True)
            self.data.exposures = torch.from_numpy(new_exp).to(self.device)
        self._cam_grad_accum = None
        self._exposure_grad_accum = None

    def effective_xform(self, img_idx: int) -> np.ndarray:
        """A training camera (3, 4) with its optimised offsets applied."""
        cam = self.data.xforms_start[img_idx].cpu().numpy()
        if self.optimize_extrinsics:
            rot = rotvec_to_matrix(self.cam_rot_offset[img_idx])
            cam = np.concatenate(
                [rot @ cam[:3, :3],
                 (cam[:3, 3] + self.cam_pos_offset[img_idx])[:, None]],
                axis=1).astype(np.float32)
        return cam

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
        # at most 2^14 rays a rank keeps each under 16 M lanes
        self.rays_per_batch = min(max(min(new_rays, cap_rays), 256),
                                  (1 << 14) * self._n_shards)

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
    def set_rendering_extra_dims_from_training_view(self, trainview: int
                                                   ) -> None:
        """Render with training view `trainview`'s latent code."""
        self._require_training()
        if not 0 <= trainview < self.data.n_images:
            raise ValueError(f"invalid training view {trainview}")
        self.rendering_extra_dims_from_training_view = trainview
        self._rendering_extra_dims = None

    def set_rendering_extra_dims(self, vals) -> None:
        """Render with an explicit latent vector (n_extra,)."""
        vals = np.asarray(vals, np.float32).reshape(-1)
        if vals.size != self.scene.n_extra_dims:
            raise ValueError(f"expected {self.scene.n_extra_dims} extra dims")
        self.rendering_extra_dims_from_training_view = -1
        self._rendering_extra_dims = torch.from_numpy(vals).to(self.device)

    def get_rendering_extra_dims(self) -> Optional[torch.Tensor]:
        """The latent code renders use, (n_extra,), or None for a network
        without latent dims."""
        view = self.rendering_extra_dims_from_training_view
        if self.data is not None and self.data.extra_dims is not None \
                and view >= 0:
            return self.data.extra_dims[view]
        if self.scene.n_extra_dims and self._rendering_extra_dims is None:
            raise ValueError("this network has latent dims and no training "
                             "view to take them from: call "
                             "set_rendering_extra_dims first")
        return self._rendering_extra_dims

    def _render_config(self, mode: str, min_transmittance: float,
                       tile: int) -> RenderConfig:
        k_render = (self.render_max_samples_per_ray
                    or min(self.max_samples_per_ray, 512))
        return RenderConfig(
            n_march=self.n_march, max_samples_per_ray=k_render,
            cone_angle=self.scene.cone_angle_constant,
            max_mip=self.scene.max_cascade,
            rgb_activation=self.scene.rgb_activation,
            density_activation=self.scene.density_activation,
            min_transmittance=min_transmittance,
            query_budget=self.render_query_budget,
            stochastic_corners=(self.render_stochastic_corners
                                and mode not in ("Normals", "EncodingVis")),
            render_mode=mode,
            # the budget, not tile x samples per ray: depth-major
            # compaction sheds every ray's deep tail where it binds
            sample_capacity=min(tile * k_render, self.render_query_budget))

    def _uses_wavefront(self, mode: str) -> bool:
        return self.render_wavefront and mode in ("Shade", "Depth", "AO")

    def _get_render_fn(self, tile: int, mode: str, min_transmittance: float):
        """fn(origins, dirs, bg, extra_dims, generator) -> render_tile's
        dict for one tile of rays: the wavefront renderer for Shade, Depth
        and AO (which are weighted sums of what it accumulates), else
        `render_tile`."""
        cfg = self._render_config(mode, min_transmittance, tile)
        net = self.inference_model
        if not self._uses_wavefront(mode):
            return lambda o, d, bg, extra, gen: render_tile(
                net, cfg, o, d, self.bitfield, self.aabb_min, self.aabb_max,
                bg, extra, gen)
        renderer = WavefrontRenderer(net, cfg, self.aabb_min, self.aabb_max)
        if mode == "Shade":
            return lambda o, d, bg, extra, gen: renderer.render(
                o, d, self.bitfield, bg, gen, extra)

        def fn(o, d, bg, extra, gen):
            out = renderer.render(o, d, self.bitfield, torch.zeros_like(bg),
                                  gen, extra)
            value = out["depth"] if mode == "Depth" else out["alpha"]
            out["rgb"] = value[:, None].expand(-1, 3) \
                + (1.0 - out["alpha"])[:, None] * bg
            return out
        return fn

    @torch.no_grad()
    def render_frame(self, width: int, height: int, camera_matrix,
                     focal_length=None, spp: int = 1,
                     background_color=(0.0, 0.0, 0.0),
                     render_mode: str = "Shade",
                     min_transmittance: float = 1e-2,
                     tile: Optional[int] = None,
                     lens_mode: int = 0, lens_params=None,
                     screen_center=(0.5, 0.5),
                     use_distortion_map: bool = False,
                     aperture_size: float = 0.0, focus_z: float = 1.0,
                     use_envmap_background: Optional[bool] = None,
                     extra_dims=None) -> np.ndarray:
        """Render a frame with the inference parameters -> (H, W, 4) linear
        float32 (rgb, alpha).

        camera_matrix: (3, 4) NGP-space camera. focal_length: pixels, a
        scalar or (fx, fy); by default the first training camera's,
        scaled to the frame (a render-only testbed has none and requires
        it). spp > 1 averages jittered subpixel samples.
        render_mode: a `common.RenderMode` or its name; Slice is
        `render_density_slice`'s. tile bounds the rays rendered together:
        by default 2^19 for the wavefront renderer, whose march is chunked
        inside, and 2^13 for `render_tile`, whose planes are (tile,
        n_march). lens_mode (a `camera.LENS_*` id or its name),
        lens_params (7,), screen_center: the lens the rays go through;
        use_distortion_map adds the trained distortion map (always added
        while `optimize_distortion` is on).
        aperture_size, focus_z: depth of field; every spp pass draws fresh
        disk samples per pixel (on the host, from a seeded generator, so a
        frame is the same on every device), so the average converges to the
        thin-lens blur. use_envmap_background: the envmap behind the scene,
        by each ray's direction; by default on while an envmap is trained or
        came with the dataset. extra_dims: the latent code of the frame; by
        default `get_rendering_extra_dims()`."""
        mode = getattr(render_mode, "value", render_mode)
        if isinstance(lens_mode, str):
            lens_mode = lens_mode_id(lens_mode)
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
        cam = np.array(camera_matrix, np.float32)
        dist_map = self.distortion_map.params \
            if use_distortion_map or self.optimize_distortion else None

        if mode == "Distortion":
            # a screen-space picture of the lens: no marching
            return distortion_flow_image(
                width, height, fl, cam, device=self.device,
                screen_center=screen_center, lens_mode=lens_mode,
                lens_params=lens_params, distortion_map=dist_map
            ).cpu().numpy()
        if mode not in RENDER_TILE_MODES:
            raise ValueError(f"render_frame has no mode {mode!r} (the Slice "
                             f"mode is render_density_slice)")

        if extra_dims is None:
            extra_dims = self.get_rendering_extra_dims()
        else:
            extra_dims = torch.as_tensor(extra_dims, dtype=torch.float32,
                                         device=self.device)
        if tile is None:
            tile = (1 << 19) if self._uses_wavefront(mode) else (1 << 13)
        fn = self._get_render_fn(tile, mode, min_transmittance)
        bg_const = torch.as_tensor(background_color, dtype=torch.float32,
                                   device=self.device)
        if use_envmap_background is None:
            use_envmap_background = (self.train_envmap
                                     or self.has_dataset_envmap)
        n_pixels = width * height
        acc = torch.zeros(n_pixels, 4, device=self.device)
        self.last_frame_n_samples = 0
        corner_gen = None
        if self.render_stochastic_corners:
            corner_gen = torch.Generator(device=self.device).manual_seed(
                self.seed ^ 0x7E4D)
        aperture_gen = None
        if aperture_size != 0.0:
            aperture_gen = torch.Generator().manual_seed(0xAB)
        for s in range(spp):
            jitter = None if spp == 1 else ld_pixel_offset(s)
            aperture_samples = None if aperture_gen is None else torch.rand(
                n_pixels, 2, generator=aperture_gen).to(self.device)
            origins, dirs = camera_rays_for_frame(
                width, height, fl, cam, device=self.device,
                screen_center=screen_center, lens_mode=lens_mode,
                lens_params=lens_params, distortion_map=dist_map,
                jitter=jitter, aperture_size=aperture_size, focus_z=focus_z,
                aperture_samples=aperture_samples)
            for i in range(0, n_pixels, tile):
                d_tile = dirs[i:i + tile]
                bg = bg_const
                if use_envmap_background:
                    # the envmap over the constant colour, premultiplied
                    env = read_envmap(self.envmap.params, d_tile)
                    bg = env[:, :3] + bg_const * (1.0 - env[:, 3:4])
                out = fn(origins[i:i + tile], d_tile, bg, extra_dims,
                         corner_gen)
                acc[i:i + tile, :3] += out["rgb"]
                acc[i:i + tile, 3] += out["alpha"]
                self.last_frame_n_samples += int(out["n_samples"])
        return (acc / spp).reshape(height, width, 4).cpu().numpy()

    def render_training_view(self, img_idx: int, spp: int = 1,
                             width: Optional[int] = None,
                             height: Optional[int] = None,
                             min_transmittance: float = 1e-4,
                             background_color=(0.0, 0.0, 0.0),
                             render_mode: str = "Shade") -> np.ndarray:
        """Render from a training camera, through its own focal length,
        principal point and lens, with its own latent code."""
        self._require_training()
        w0, h0 = (int(v) for v in self.data.resolutions[img_idx].tolist())
        width, height = width or w0, height or h0
        fl = self.data.focal_lengths[img_idx].cpu().numpy() \
            * np.array([width / w0, height / h0], np.float32)
        extra = None if self.data.extra_dims is None \
            else self.data.extra_dims[img_idx]
        return self.render_frame(
            width, height, self.effective_xform(img_idx), fl, spp=spp,
            min_transmittance=min_transmittance,
            background_color=background_color, render_mode=render_mode,
            lens_mode=self.scene.lens_mode,
            lens_params=self.data.lens_params[img_idx],
            screen_center=self.data.principal_points[img_idx].tolist(),
            extra_dims=extra)

    def _gt_srgb(self, img_idx: int, w: int, h: int, downscale: int
                 ) -> np.ndarray:
        """A training image as sRGB over black, (h, w, 3), area-averaged
        by `downscale`. uint8 images are sRGB with straight alpha; float
        (HDR) images are linear, premultiplied."""
        w0, h0 = (int(v) for v in self.data.resolutions[img_idx].tolist())
        gt_raw = self.data.pixels[img_idx, :h0, :w0].cpu().numpy()
        if gt_raw.dtype == np.uint8:
            gt = gt_raw.astype(np.float32) / 255.0
            gt_srgb = gt[..., :3] * gt[..., 3:4]
        else:
            gt_srgb = linear_to_srgb(gt_raw[..., :3].astype(np.float32))
        if downscale != 1:
            # area average: rendered pixel i spans source block
            # [i*ds, (i+1)*ds) and its ray passes through the block centre
            ds = downscale
            gt_srgb = gt_srgb[:h * ds, :w * ds] \
                .reshape(h, ds, w, ds, 3).mean(axis=(1, 3))
        return gt_srgb

    def eval_psnr(self, img_idx: int, spp: int = 1, downscale: int = 1
                  ) -> float:
        """PSNR of a rendered training view against its image, in sRGB over
        a black background. The network trains in sRGB, so the rendered
        values are sRGB already; an HDR image is linear and is converted."""
        self._require_training()
        w0, h0 = (int(v) for v in self.data.resolutions[img_idx].tolist())
        w, h = w0 // downscale, h0 // downscale
        render = self.render_training_view(img_idx, spp=spp, width=w,
                                           height=h)
        return psnr(mse(np.clip(render[..., :3], 0.0, 1.0),
                        self._gt_srgb(img_idx, w, h, downscale)))

    def find_closest_training_view(self, camera_matrix) -> int:
        """The training camera nearest in position and view direction."""
        self._require_training()
        cam = np.asarray(camera_matrix, np.float32)
        xforms = self.data.xforms_start.cpu().numpy()
        pos_d = np.linalg.norm(xforms[:, :3, 3] - cam[:3, 3], axis=-1)
        dir_d = np.linalg.norm(xforms[:, :3, 2] - cam[:3, 2], axis=-1)
        return int(np.argmin(pos_d + dir_d))

    # ------------------------------------------------------------------
    # the density field
    # ------------------------------------------------------------------
    @torch.no_grad()
    def _raw_density(self, pos_world: torch.Tensor) -> torch.Tensor:
        """Raw density of the inference network at world positions (n, 3),
        in calls of at most the query budget."""
        step = self.render_query_budget
        span = self.aabb_max - self.aabb_min
        return torch.cat([self.inference_model.density(
            (pos_world[i:i + step] - self.aabb_min) / span)
            for i in range(0, pos_world.shape[0], step)])

    def _unit_steps(self, n: int) -> torch.Tensor:
        """n steps over [0, 1] as numpy spaces them (torch.linspace rounds
        some of them the other way, and a hash grid's density is steep)."""
        return torch.from_numpy(np.linspace(0, 1, n, dtype=np.float32)).to(
            self.device)

    def render_density_slice(self, resolution: int = 256,
                             plane_z: float = 0.5) -> np.ndarray:
        """The Slice render mode -> (resolution, resolution, 3): the raw
        density on the plane z = plane_z of the aabb (x right, y down), in
        false colour."""
        from ..geom.marching import density_slice_image

        lin = self._unit_steps(resolution)
        xx, yy = torch.meshgrid(lin, lin, indexing="xy")
        pos = torch.stack([xx, yy, torch.full_like(xx, plane_z)],
                          dim=-1).reshape(-1, 3) \
            * (self.aabb_max - self.aabb_min) + self.aabb_min
        raw = self._raw_density(pos).cpu().numpy()
        return density_slice_image(raw.reshape(resolution, resolution, 1),
                                   axis=2, index=0)

    @torch.no_grad()
    def density_on_grid(self, resolution=128, aabb=None) -> np.ndarray:
        """Raw (pre-activation) density on a regular grid over `aabb`
        (default the scene's) -> (rx, ry, rz); where the occupancy grid's
        density is under its threshold the value is -10000. `resolution` is
        one number or three."""
        lo, hi = (self.aabb_min, self.aabb_max) if aabb is None else (
            torch.as_tensor(np.asarray(a, np.float32), device=self.device)
            for a in aabb)
        rx, ry, rz = (resolution,) * 3 if np.isscalar(resolution) \
            else (int(v) for v in resolution)
        lin = [self._unit_steps(r) for r in (rx, ry, rz)]
        out = np.empty((rx, ry, rz), np.float32)
        for ix in range(rx):
            pos = torch.stack(torch.meshgrid(lin[0][ix:ix + 1], lin[1],
                                             lin[2], indexing="ij"),
                              dim=-1).reshape(-1, 3) * (hi - lo) + lo
            mip = mip_from_pos(pos, self.scene.max_cascade)
            idx, inside = cascaded_grid_idx_at(pos, mip)
            grid_d = torch.where(
                inside, self.density_grid[idx + mip * NERF_GRID_N_CELLS],
                0.0)
            raw = torch.where(grid_d < NERF_MIN_OPTICAL_THICKNESS, -10000.0,
                              self._raw_density(pos))
            out[ix] = raw.reshape(ry, rz).cpu().numpy()
        return out

    def compute_and_save_png_slices(self, filename: str,
                                    resolution: int = 256, aabb=None,
                                    thresh: float = 2.5,
                                    density_range: float = 4.0,
                                    flip_y_and_z_axes: bool = False):
        """Write the raw density's slice atlas to
        `<filename>.density_slices_<X>x<Y>x<Z>.png` (needs PIL) -> the
        per-axis grid resolution in that name."""
        from ..geom.marching import (marching_cubes_res,
                                     save_density_slices_png)

        lo = np.asarray(aabb[0] if aabb else self.scene.aabb_min)
        hi = np.asarray(aabb[1] if aabb else self.scene.aabb_max)
        res3d = marching_cubes_res(resolution, lo, hi)
        field = self.density_on_grid(res3d, aabb=(lo, hi))
        save_density_slices_png(
            f"{filename}.density_slices_{res3d[0]}x{res3d[1]}x{res3d[2]}"
            f".png", field, float(thresh), density_range, flip_y_and_z_axes)
        return res3d

    def compute_marching_cubes_mesh(self, resolution: int = 128,
                                    thresh: float = 2.5, aabb=None):
        """The iso-surface raw density = thresh over `aabb` (default the
        scene's) at `resolution`^3 samples -> (verts (V, 3) in world units,
        faces (F, 3), colours (V, 3) from the inference network, viewed
        along the inward vertex normal)."""
        from ..geom.marching import marching_tetrahedra, vertex_normals
        from ..geom.marching_cubes import marching_cubes

        aabb_min = np.asarray(aabb[0] if aabb else self.scene.aabb_min)
        aabb_max = np.asarray(aabb[1] if aabb else self.scene.aabb_max)
        field = self.density_on_grid(resolution, aabb=(aabb_min, aabb_max))
        spacing = (aabb_max - aabb_min) / max(resolution - 1, 1)
        if self.mesh_algorithm == "tets":
            verts, faces = marching_tetrahedra(
                field, iso=thresh, origin=aabb_min, spacing=spacing)
        else:
            # the table's inside is field < iso; here it is density > thresh
            verts, faces = marching_cubes(-field, iso=-thresh,
                                          origin=aabb_min, spacing=spacing)
        if len(verts) == 0:
            return verts, faces, np.zeros((0, 3), np.float32)
        dirs = warp_direction(-vertex_normals(verts, faces))
        return verts, faces, self._vertex_colors(verts, dirs)

    @torch.no_grad()
    def _vertex_colors(self, verts: np.ndarray, dirs_warped: np.ndarray
                       ) -> np.ndarray:
        """RGB of the inference network at world positions (n, 3) seen
        along warped directions (n, 3), in calls of at most the query
        budget (with the rendering latent code where the scene has one)."""
        pos = warp_position(torch.from_numpy(verts).to(self.device),
                            self.aabb_min, self.aabb_max)
        dirs = torch.from_numpy(np.asarray(dirs_warped, np.float32)).to(
            self.device)
        extra = self.get_rendering_extra_dims()
        step = self.render_query_budget
        out = []
        for i in range(0, pos.shape[0], step):
            n = min(step, pos.shape[0] - i)
            raw = self.inference_model.apply_components(
                pos[i:i + n], dirs[i:i + n],
                None if extra is None else extra[None].expand(n, -1))
            out.append(network_to_rgb(raw[:, :3], self.scene.rgb_activation))
        return torch.cat(out).cpu().numpy()

    def _density_and_input_grad(self, verts: np.ndarray
                                ) -> Tuple[np.ndarray, np.ndarray]:
        """Raw density of the inference network at world positions (n, 3)
        and its gradient with respect to them, under autograd (the MLPs
        take plain matmuls), in calls of at most the query budget."""
        step = self.render_query_budget
        raws, grads = [], []
        for i in range(0, verts.shape[0], step):
            pos = torch.from_numpy(verts[i:i + step]).to(
                self.device).requires_grad_(True)
            with torch.enable_grad():
                raw = self.inference_model.density(
                    warp_position(pos, self.aabb_min, self.aabb_max))
                grad, = torch.autograd.grad(raw.sum(), pos)
            raws.append(raw.detach())
            grads.append(grad)
        return torch.cat(raws).cpu().numpy(), torch.cat(grads).cpu().numpy()

    def optimise_mesh_step(self, verts: np.ndarray, faces: np.ndarray,
                           n_steps: int = 1, thresh: float = 2.5,
                           smooth_amount: float = 0.002,
                           density_amount: float = 0.001,
                           inflate_amount: float = 0.0,
                           learning_rate: float = 1e-4) -> np.ndarray:
        """n_steps of Adam on the vertex positions -> the new vertices. The
        gradient of a vertex: density_amount * (raw density - thresh)
        along the density's normalised input gradient, plus smooth_amount
        * (vertex - the mean of its neighbours), plus inflate_amount along
        its normal."""
        from ..geom.marching import smooth_mesh, vertex_normals

        adam = HostAdam(learning_rate)
        v = np.asarray(verts, np.float32).copy()
        if len(v) == 0:
            return v
        for _ in range(n_steps):
            raw, grad = self._density_and_input_grad(v)
            n_hat = grad / np.maximum(
                np.linalg.norm(grad, axis=-1, keepdims=True), 1e-9)
            centroid = smooth_mesh(v, faces, iterations=1, lam=1.0)
            normals = vertex_normals(v, faces)
            g = (density_amount * (raw - thresh)[:, None] * n_hat
                 + smooth_amount * (v - centroid)
                 + inflate_amount * normals)
            v = adam.step(v, g)
        return v

    # ------------------------------------------------------------------
    # snapshots
    # ------------------------------------------------------------------
    def save_snapshot(self, path: str) -> None:
        """A snapshot in the JAX package's format, with the config
        embedded: parameters, optimizer state, density grid, step counts,
        the per-image camera state, the latent codes with their optimizer
        state, the envmap and the distortion map."""
        from ..data.snapshot import save_snapshot

        self._require_training()
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
                "pos_offset": self.cam_pos_offset,
                "rot_offset": self.cam_rot_offset,
                "focal_offset": self.cam_focal_offset,
                "exposures": self.data.exposures,
            },
            "extra_dims": None if self._extra_dims_buf is None
            else buffer_state_to_jax(self._extra_dims_buf.state),
            "envmap": self.envmap.params,
            "distortion_map": self.distortion_map.params,
        })

    def load_snapshot_state(self, snapshot: Dict[str, Any]) -> None:
        """Restore from `data.snapshot.load_snapshot`'s dict."""
        trainer = snapshot["trainer"]
        self.load_state(trainer["params"], trainer.get("opt"))
        self.set_density_grid(snapshot["density_grid"])
        self.training_step = int(snapshot.get("training_step", 0))
        self.density_grid_ema_step = int(
            snapshot.get("density_grid_ema_step", 0))
        cam = snapshot.get("camera")
        # per-image state is restored only for the same dataset; the host
        # Adams' moments are not part of the format and start afresh
        if cam is not None and self.data is not None and \
                snapshot.get("dataset_paths") == list(self.dataset.paths):
            self.cam_pos_offset = np.array(cam["pos_offset"], np.float32)
            self.cam_rot_offset = np.array(cam["rot_offset"], np.float32)
            self.cam_focal_offset = np.array(cam["focal_offset"],
                                             np.float32)
            self.data.exposures = torch.as_tensor(
                np.array(cam["exposures"], np.float32), device=self.device)
            extra = snapshot.get("extra_dims")
            if extra is not None and self._extra_dims_buf is not None:
                self._extra_dims_buf.load_state(extra)
        # the two maps come without their optimizers' moments
        for key, buf in (("envmap", self.envmap),
                         ("distortion_map", self.distortion_map)):
            if snapshot.get(key) is not None:
                buf.state["params"].copy_(torch.as_tensor(
                    snapshot[key]["params"], dtype=torch.float32))
