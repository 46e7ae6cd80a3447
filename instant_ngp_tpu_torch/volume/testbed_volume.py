"""Volume mode: fit the emission and density of a scattering volume
(counterpart of instant_ngp_tpu/volume/testbed_volume.py; instant-ngp's
src/testbed_volume.cu).

- The ground-truth medium is a dense (X, Y, Z) float32 density grid on
  the device (a `.nvdb` NanoVDB file is decoded on the host by
  `volume/nanovdb.py`), mapped to world space by instant-ngp's transform
  (load_volume :617-625), with a 128^3 Morton occupancy bitgrid of the
  cells whose density exceeds 1e-3, built on the host.
- A train step traces delta-tracked multi-scatter paths through the GT
  medium from random points outside toward the box (32 events of up to 32
  free-flight tries each at the global majorant). The first
  MAX_TRAIN_VERTICES real collisions of a path become samples: target RGB
  = the radiance of the procedural sun/sky the path escapes into (0 if
  absorbed), target density = the GT density there. The loss is a masked
  sum of squares over the prediction's size, through `Trainer`.
- The network maps a position to RGB emission and density (3 -> 4, ReLU
  output: configs/volume/base.json; the grid's finest level is the
  volume's world-to-index scale).
- A frame is wavefront delta tracking: 32 event rounds, one network
  evaluation of every ray a round (under no_grad, so the MLP runs the
  fused kernel on the card), composited with alpha = min(density /
  majorant, 1), the sun/sky behind; with `use_gt` the same walk against
  the GT grid (an absorb-only, black medium).

Everything lives on one device: the CUDA device unless `device` names
another (it raises where there is none).

Random numbers: every draw of a train step or a frame is taken from a
`VolumeTrainDraws` / `VolumeRenderDraws`, filled on the device by the
testbed's generator (a frame's from a generator seeded with 0, so a frame
is a function of the parameters) unless supplied: `draws(step, n_paths)
-> (VolumeTrainDraws or None, CornerDraws or None)` for training,
`render_frame(..., draws=)` for a frame. Tests feed the JAX package's
draws through them.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..common import TestbedMode
from ..convert import network_params_to_jax, opt_state_to_jax
from ..nerf.march import aabb_contains, morton3d, ray_intersect_aabb
from ..ops.factory import create_network_with_encoding
from ..ops.optimizers import create_optimizer
from ..ops.trainer import Trainer

MAX_TRAIN_VERTICES = 4
#: event rounds of a training path and of a frame
N_EVENTS = 32
#: free-flight tries of one walk to the next event
N_TRIES = 32
SUN_COLOR = np.array([255.0, 215.0, 195.0], np.float32) / 255.0
BITGRID_RES = 128


def load_nanovdb_header(path: str) -> Dict[str, Any]:
    """The NanoVDB file header and the first grid's metadata (instant-ngp's
    struct layout, testbed_volume.cu:545-571); raises ValueError on a file
    that is not an uncompressed NanoVDB."""
    with open(path, "rb") as f:
        head = f.read(16)
        if len(head) < 16:
            raise ValueError("not a NanoVDB file")
        magic, version, grid_count, codec = struct.unpack("<QIHH", head)
        if magic != 0x304244566F6E614E:
            raise ValueError("not a NanoVDB file")
        if codec != 0:
            raise ValueError("compressed NanoVDB files unsupported")
        meta_raw = f.read(176)
        (grid_size, file_size, name_key, voxel_count, grid_type, grid_class
         ) = struct.unpack("<QQQQII", meta_raw[:40])
        world_bbox = struct.unpack("<6d", meta_raw[40:88])
        index_bbox = struct.unpack("<6i", meta_raw[88:112])
        voxel_size = struct.unpack("<3d", meta_raw[112:136])
        (name_size,) = struct.unpack("<I", meta_raw[136:140])
        name = f.read(name_size).rstrip(b"\0").decode()
        return {
            "version": version, "grid_count": grid_count,
            "grid_size": grid_size, "voxel_count": voxel_count,
            "grid_type": grid_type, "grid_class": grid_class,
            "index_bbox": np.asarray(index_bbox).reshape(2, 3),
            "world_bbox": np.asarray(world_bbox).reshape(2, 3),
            "voxel_size": np.asarray(voxel_size),
            "name": name, "data_offset": 16 + 176 + name_size,
        }


def load_volume_grid(path: str) -> np.ndarray:
    """A GT density grid from a `.nvdb` file (the first FloatGrid, made
    dense over its index box) or a dense `.npy` array."""
    if path.endswith(".npy"):
        return np.load(path)
    from .nanovdb import read_nanovdb_dense

    dense, _ = read_nanovdb_dense(path)
    return dense


def _pow128(x: torch.Tensor) -> torch.Tensor:
    """x ** 128 by seven squarings, as XLA expands an integer power."""
    for _ in range(7):
        x = x * x
    return x


def proc_envmap(dirs: torch.Tensor, up_dir: torch.Tensor,
                sun_dir: torch.Tensor, sky_col: torch.Tensor
                ) -> torch.Tensor:
    """The procedural sun and sky (proc_envmap, testbed_volume.cu:44-58):
    directions (N, 3) -> radiance (N, 3)."""
    skyam = (dirs * up_dir).sum(-1, keepdim=True) * 0.5 + 0.5
    sunam = _pow128((dirs * sun_dir).sum(-1, keepdim=True).clamp(min=0.0))
    sun = torch.as_tensor(SUN_COLOR, device=dirs.device)
    return sky_col * skyam + sun * (20.0 * sunam)


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.sqrt((v * v).sum(-1, keepdim=True))


@dataclasses.dataclass
class VolumeTrainDraws:
    """The random numbers of one batch of n training paths."""

    start: torch.Tensor     # (n, 3) standard normals: start points
    target: torch.Tensor    # (n, 3) uniforms: aim points in the box
    walk: torch.Tensor      # (E, T, n) uniforms: free flights of each try
    dither: torch.Tensor    # (E, n, 3) uniforms: GT density lookup dither
    zeta: torch.Tensor      # (E, n) uniforms: scatter / absorb decision
    scatter: torch.Tensor   # (E, n, 3) standard normals: new directions

    @staticmethod
    def draw(generator: torch.Generator, n: int, n_events: int = N_EVENTS,
             n_tries: int = N_TRIES) -> "VolumeTrainDraws":
        dev = generator.device
        return VolumeTrainDraws(
            torch.randn(n, 3, generator=generator, device=dev),
            torch.rand(n, 3, generator=generator, device=dev),
            torch.rand(n_events, n_tries, n, generator=generator,
                       device=dev),
            torch.rand(n_events, n, 3, generator=generator, device=dev),
            torch.rand(n_events, n, generator=generator, device=dev),
            torch.randn(n_events, n, 3, generator=generator, device=dev))


@dataclasses.dataclass
class VolumeRenderDraws:
    """The random numbers of one frame of n rays."""

    walk0: torch.Tensor     # (T, n): the walk to the first event
    walk: torch.Tensor      # (E, T, n): the walk after each event
    dither: Optional[torch.Tensor]  # (E, n, 3): GT lookups (use_gt only)

    @staticmethod
    def draw(generator: torch.Generator, n: int, n_events: int = N_EVENTS,
             n_tries: int = N_TRIES, use_gt: bool = True
             ) -> "VolumeRenderDraws":
        dev = generator.device
        walk0 = torch.rand(n_tries, n, generator=generator, device=dev)
        walk = torch.rand(n_events, n_tries, n, generator=generator,
                          device=dev)
        dither = torch.rand(n_events, n, 3, generator=generator,
                            device=dev) if use_gt else None
        return VolumeRenderDraws(walk0, walk, dither)


def _masked_l2(pred: torch.Tensor, targets: Tuple[torch.Tensor,
                                                  torch.Tensor]
               ) -> torch.Tensor:
    """Sum of squares over the valid samples, over the prediction's size
    (the Volume step's loss; not `create_loss`)."""
    target, valid = targets
    per = (pred - target) ** 2
    return torch.where(valid[:, None], per, 0.0).sum() / pred.numel()


class VolumeTestbed:
    mode = TestbedMode.Volume

    def __init__(self, density_grid: np.ndarray,
                 network_config: Dict[str, Any], seed: int = 1337,
                 compute_dtype=torch.bfloat16, device=None,
                 generator: Optional[torch.Generator] = None,
                 draws: Optional[Callable] = None):
        """density_grid: dense (X, Y, Z) float32 GT density (index space)."""
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("a CUDA device was asked for but none is "
                               "available")
        density_grid = np.asarray(density_grid, np.float32)
        self.gt_grid = torch.from_numpy(density_grid.copy()).to(self.device)
        sizes = np.asarray(density_grid.shape, np.float32)
        maxsize = float(sizes.max())
        half = sizes / maxsize * 0.5
        self.aabb_min = (0.5 - half).astype(np.float32)
        self.aabb_max = (0.5 + half).astype(np.float32)
        # world pos * scale + offset = index (load_volume :617-625)
        self.world2index_scale = maxsize
        self.world2index_offset = (sizes * 0.5 - 0.5 * maxsize).astype(
            np.float32)
        self.global_majorant = float(density_grid.max())

        # 128^3 Morton occupancy bitgrid of density > 1e-3 (:631-645)
        xs, ys, zs = np.nonzero(density_grid > 1e-3)
        coords = [(((c + 0.5) - self.world2index_offset[k]) / maxsize
                   * BITGRID_RES + 0.5).astype(np.int32)
                  for k, c in enumerate((xs, ys, zs))]
        bi = morton3d(*(torch.from_numpy(c) for c in coords)).numpy()
        bitgrid = np.zeros(BITGRID_RES ** 3 // 8, np.uint8)
        valid = (bi >= 0) & (bi < BITGRID_RES ** 3)
        np.bitwise_or.at(bitgrid, bi[valid] // 8,
                         (1 << (bi[valid] % 8)).astype(np.uint8))
        self.bitgrid = torch.from_numpy(bitgrid).to(self.device)
        # the same bits in (x, y, z) order, one byte a cell: a lookup is one
        # gather instead of a Morton code
        axis = torch.arange(BITGRID_RES)
        gx, gy, gz = torch.meshgrid(axis, axis, axis, indexing="ij")
        bits = np.unpackbits(bitgrid, bitorder="little")
        self.occupancy = torch.from_numpy(
            bits[morton3d(gx, gy, gz).numpy()].astype(bool)).to(self.device)

        self.config = network_config
        self.model, self.resolved_config = create_network_with_encoding(
            3, 4, network_config, desired_resolution=self.world2index_scale,
            compute_dtype=compute_dtype)
        self.model.to(self.device)
        self.optimizer = create_optimizer(network_config["optimizer"])
        # the config's "loss" is not used: the step's loss is `_masked_l2`
        self.trainer = Trainer(self.model, self.optimizer, _masked_l2,
                               seed=seed)
        self.state = self.trainer.init_state()
        self.training_step = 0
        self.seed = seed
        self.loss_scalar = float("nan")

        # instant-ngp's knobs (testbed.h:891-911)
        self.albedo = 0.95
        self.scattering = 0.0
        self.inv_distance_scale = 1.0
        self.up_dir = np.array([0.0, 1.0, 0.0], np.float32)
        self.sun_dir = np.array([0.577, 0.577, 0.577], np.float32)
        self.sky_col = np.array([0.35, 0.45, 0.65], np.float32)

        self.stochastic_corners = True
        self.stochastic_corners_until: Optional[int] = network_config.get(
            "encoding", {}).get("stochastic_corners_until", 256)
        self.generator = generator if generator is not None else \
            torch.Generator(device=self.device).manual_seed(seed)
        self.draws = draws

    def _vec(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    # ------------------------------------------------------------------
    # the GT medium
    # ------------------------------------------------------------------
    def _gt_density(self, pos: torch.Tensor, dither: torch.Tensor
                    ) -> torch.Tensor:
        """Nearest GT density at world positions (N, 3) after adding the
        dither (N, 3) in index space (acc.getValue with +rand(), :127); 0
        outside the grid."""
        idx = pos * self.world2index_scale + self._vec(self.world2index_offset)
        ii = torch.floor(idx + dither).long()
        shape = torch.tensor(self.gt_grid.shape, device=pos.device)
        inb = ((ii >= 0) & (ii < shape)).all(dim=-1)
        ii = torch.minimum(ii.clamp(min=0), shape - 1)
        val = self.gt_grid[ii[:, 0], ii[:, 1], ii[:, 2]]
        return torch.where(inb, val, 0.0)

    def _bit_occupied(self, pos: torch.Tensor) -> torch.Tensor:
        """Whether world positions (N, 3) fall in an occupied bitgrid cell.
        The cell index truncates toward zero as instant-ngp's int() does,
        so a coordinate in (-1, 0) counts as -1: outside."""
        v = pos * float(BITGRID_RES) + 0.5
        i = torch.where(v < 0, -1, v.to(torch.int32))
        ok = ((i >= 0) & (i < BITGRID_RES)).all(dim=-1)
        i = i.clamp(0, BITGRID_RES - 1).long()
        return ok & self.occupancy[i[:, 0], i[:, 1], i[:, 2]]

    def _walk_to_next_event(self, pos: torch.Tensor, dirs: torch.Tensor,
                            alive: torch.Tensor, uniforms: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """walk_to_next_event (:70-82): free flights at the global majorant,
        one a try (`uniforms` (T, N)), until a lane lands in an occupied
        cell or leaves the box -> (positions, alive and landed). Lanes
        still walking after the last try count as escaped."""
        scale = (1.0 / max(self.inv_distance_scale, 0.01)) \
            / self.global_majorant
        aabb_min, aabb_max = self._vec(self.aabb_min), self._vec(self.aabb_max)
        dts = -torch.log(1.0 - uniforms) * scale
        walking = alive
        escaped = torch.zeros_like(alive)
        for dt in dts:
            new_pos = pos + dirs * dt[:, None]
            inside = aabb_contains(new_pos, aabb_min, aabb_max)
            hit = self._bit_occupied(new_pos)
            pos = torch.where(walking[:, None], new_pos, pos)
            escaped = escaped | (walking & ~inside)
            walking = walking & inside & ~hit
        return pos, alive & ~(escaped | walking)

    def _envmap(self, dirs: torch.Tensor) -> torch.Tensor:
        return proc_envmap(dirs, self._vec(self.up_dir),
                           self._vec(self.sun_dir), self._vec(self.sky_col))

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------
    @torch.no_grad()
    def _generate_training_data(self, draws: VolumeTrainDraws
                                ) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
        """One batch of delta-tracked paths -> (positions (n * 4, 3),
        targets (n * 4, 4), valid (n * 4,)): every path has
        MAX_TRAIN_VERTICES slots, the unused ones masked
        (volume_generate_training_data_kernel :85-154)."""
        n = draws.start.shape[0]
        dev = self.device
        aabb_min, aabb_max = self._vec(self.aabb_min), self._vec(self.aabb_max)
        start = _normalize(draws.start) * 2.0 + 0.5
        target = draws.target * (aabb_max - aabb_min) + aabb_min
        dirs = _normalize(target - start)
        tmin, _ = ray_intersect_aabb(start, dirs, aabb_min, aabb_max)
        pos = start + (tmin.clamp(min=0.0) + 1e-6)[:, None] * dirs

        vert_pos = torch.zeros(n, MAX_TRAIN_VERTICES, 3, device=dev)
        vert_density = torch.zeros(n, MAX_TRAIN_VERTICES, device=dev)
        n_out = torch.zeros(n, dtype=torch.int64, device=dev)
        throughput = torch.ones(n, device=dev)
        alive = torch.ones(n, dtype=torch.bool, device=dev)
        rows = torch.arange(n, device=dev)
        for e in range(draws.walk.shape[0]):
            pos, still = self._walk_to_next_event(pos, dirs, alive,
                                                  draws.walk[e])
            # an escaped lane is done (its throughput stays 1: the envmap)
            density = self._gt_density(pos, draws.dither[e])
            record = still & (n_out < MAX_TRAIN_VERTICES)
            slot = n_out.clamp(max=MAX_TRAIN_VERTICES - 1)
            vert_pos[rows, slot] = torch.where(record[:, None], pos,
                                               vert_pos[rows, slot])
            vert_density[rows, slot] = torch.where(
                record, density, vert_density[rows, slot])
            n_out = n_out + record.long()

            ext_prob = density / self.global_majorant
            scat_prob = ext_prob * self.albedo
            zeta = draws.zeta[e]
            scatter = still & (zeta < scat_prob)
            absorb = still & (zeta >= scat_prob) & (zeta < ext_prob)
            new_dir = _normalize(dirs * self.scattering + draws.scatter[e])
            dirs = torch.where(scatter[:, None], new_dir, dirs)
            throughput = torch.where(absorb, 0.0, throughput)
            alive = still & ~absorb

        radiance = self._envmap(dirs) * throughput[:, None]
        targets = torch.cat(
            [radiance[:, None, :].expand(n, MAX_TRAIN_VERTICES, 3),
             vert_density[..., None]], dim=-1)
        valid = torch.arange(MAX_TRAIN_VERTICES, device=dev)[None, :] \
            < n_out[:, None]
        return (vert_pos.reshape(-1, 3), targets.reshape(-1, 4),
                valid.reshape(-1))

    def _stoch_now(self) -> bool:
        """Whether this step encodes stochastically: until
        `stochastic_corners_until` (None: always), then exactly."""
        if not self.stochastic_corners:
            return False
        until = self.stochastic_corners_until
        return until is None or self.training_step < until

    def train_step(self, batch_size: int = 1 << 18) -> torch.Tensor:
        """One step of batch_size // MAX_TRAIN_VERTICES paths -> the loss
        (a 0-dim tensor on the device)."""
        n_paths = batch_size // MAX_TRAIN_VERTICES
        stoch = self._stoch_now()
        train_draws = corners = None
        if self.draws is not None:
            train_draws, corners = self.draws(self.training_step, n_paths)
        if train_draws is None:
            train_draws = VolumeTrainDraws.draw(self.generator, n_paths)
        pos, targets, valid = self._generate_training_data(train_draws)
        encode = {}
        if stoch:
            encode = {"draws": corners} if corners is not None \
                else {"generator": self.generator}
        self.state, loss = self.trainer.train_step(
            self.state, pos, (targets, valid), **encode)
        self.training_step += 1
        return loss

    def train(self, n_steps: int, batch_size: int = 1 << 18) -> float:
        """n_steps train steps -> the last loss (read once, at the end)."""
        loss = None
        for _ in range(n_steps):
            loss = self.train_step(batch_size)
        if loss is not None:
            self.loss_scalar = float(loss)
        return self.loss_scalar

    # ------------------------------------------------------------------
    # rendering: wavefront delta tracking with the model (or the GT)
    # ------------------------------------------------------------------
    @torch.no_grad()
    def _render_rays(self, origins: torch.Tensor, dirs: torch.Tensor,
                     use_gt: bool, draws: VolumeRenderDraws
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (colour (N, 3), opacity (N,)); one network evaluation of every
        ray per event round (volume_render_kernel_step :351-409)."""
        model = self.trainer.inference_model
        aabb_min, aabb_max = self._vec(self.aabb_min), self._vec(self.aabb_max)
        tmin, tmax = ray_intersect_aabb(origins, dirs, aabb_min, aabb_max)
        t0 = tmin.clamp(min=0.0)
        enters = tmax > t0
        pos = origins + (t0 + 1e-6)[:, None] * dirs

        col = torch.zeros(origins.shape[0], 3, device=self.device)
        opacity = torch.zeros(origins.shape[0], device=self.device)
        pos, alive = self._walk_to_next_event(pos, dirs, enters, draws.walk0)
        for e in range(draws.walk.shape[0]):
            if use_gt:
                density = self._gt_density(pos, draws.dither[e])
            else:
                out = model(pos)
                emission, density = out[:, :3], out[:, 3]
            ext_prob = (density / self.global_majorant).clamp(max=1.0)
            alpha = torch.where(alive, ext_prob * (1.0 - opacity), 0.0)
            if not use_gt:      # the GT medium absorbs only: black
                col = col + emission * alpha[:, None]
            opacity = opacity + alpha
            pos, still = self._walk_to_next_event(pos, dirs, alive,
                                                  draws.walk[e])
            alive = still & ~(opacity > 0.99)
        col = col + (1.0 - opacity)[:, None] * self._envmap(dirs)
        return col, opacity

    def render_frame(self, width: int, height: int, camera_matrix,
                     focal_length: Optional[float] = None,
                     use_gt: bool = False, n_events: int = N_EVENTS,
                     draws: Optional[VolumeRenderDraws] = None
                     ) -> np.ndarray:
        """A frame (height, width, 4) linear float32: RGB and opacity."""
        from ..nerf.render import camera_rays_for_frame

        fl = focal_length or width * 1.1
        origins, dirs = camera_rays_for_frame(
            width, height, (fl, fl), np.asarray(camera_matrix, np.float32),
            device=self.device)
        if draws is None:
            gen = torch.Generator(device=self.device).manual_seed(0)
            draws = VolumeRenderDraws.draw(gen, origins.shape[0], n_events,
                                           use_gt=use_gt)
        col, opacity = self._render_rays(origins, dirs, use_gt, draws)
        rgba = torch.cat([col, opacity[:, None]], dim=-1)
        return rgba.reshape(height, width, 4).cpu().numpy()

    # ------------------------------------------------------------------
    # snapshots
    # ------------------------------------------------------------------
    def save_snapshot(self, path: str) -> None:
        """A snapshot in the JAX package's format (config embedded)."""
        from ..data.snapshot import save_snapshot

        save_snapshot(path, {
            "mode": self.mode.value,
            "config": self.config,
            "grid_layout": "interleaved",
            "trainer": {
                "params": network_params_to_jax(self.state["params"]),
                "opt": opt_state_to_jax(self.state["opt"],
                                        network_params_to_jax)},
            "training_step": self.training_step,
            "global_majorant": self.global_majorant,
        })

    def load_snapshot_state(self, snapshot: Dict[str, Any]) -> None:
        """Restore from `data.snapshot.load_snapshot`'s dict."""
        trainer = snapshot["trainer"]
        self.trainer.load_state(self.state, trainer["params"],
                                trainer.get("opt"))
        self.training_step = int(snapshot.get("training_step", 0))
