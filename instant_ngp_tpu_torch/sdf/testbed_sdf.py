"""SDF mode: fit a neural signed distance function to a mesh, render it by
sphere tracing (counterpart of instant_ngp_tpu/sdf/testbed_sdf.py;
instant-ngp's src/testbed_sdf.cu).

- Training samples (generate_training_samples_sdf :1186-1274), made on
  the host from `np.random.RandomState(seed)`, the same stream as the JAX
  package's, so the two make the same samples: 4/8 on the surface
  (area-weighted triangles, distance 0), 3/8 on the surface plus a
  logistic offset of scale bounding_radius / 1024 * surface_offset_scale,
  1/8 uniform in the box; labels from the BVH's signed distance
  (`mesh_sdf_mode`, Raystab by default).
- A train step is `Trainer.train_step` with the config's loss (MAPE). A
  grid encoding takes the stochastic-corner encode until
  `stochastic_corners_until`, then the exact one; the Takikawa octree
  encoding (configs/sdf/takikawa.json) is always exact.
- A frame: a fixed 96-round sphere trace of every ray (advance_pos_kernel_
  sdf :147-217: step (d - zero_offset) * distance_scale, converged where
  the step is no longer larger than maximum_distance), normals by
  autograd through the network (or central differences), Disney BRDF
  shading (`sdf/brdf.py`), optionally a 64-round soft-shadow trace toward
  the light. The network runs under no_grad in the traces, so its MLP
  goes through the fused kernel on the card. Ground-truth oracles: the
  BVH's ray trace (RaytracedMesh), a sphere trace of the BVH's exact
  distance on the host (SpheretracedMesh), a sphere trace of the brick
  cache on the device (SDFBricks).
- `calculate_iou` (calculate_iou :1363-1399): agreement of the network's
  sign with the BVH's at uniform samples.

Everything but the BVH and the sample generation lives on one device: the
CUDA device unless `device` names another (it raises where there is none).
The corner draws of the stochastic encode come from `generator` (default:
one on the device seeded with `seed`), or from `draws(step, n) ->
CornerDraws or None` where given (tests feed the JAX package's through it).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..common import TestbedMode
from ..convert import network_params_to_jax, opt_state_to_jax
from ..geom.triangle_bvh import (TriangleBvh, load_obj,
                                 normalize_mesh_to_unit_cube)
from ..nerf.march import aabb_contains, ray_intersect_aabb
from ..ops.factory import create_network_with_encoding
from ..ops.losses import create_loss
from ..ops.optimizers import create_optimizer
from ..ops.trainer import Trainer
from .brdf import BRDFParams, evaluate_shading


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((v * v).sum(-1, keepdim=True))


def _unit(g: torch.Tensor) -> torch.Tensor:
    return g / _norm(g).clamp(min=1e-9)


class SdfTestbed:
    mode = TestbedMode.Sdf

    def __init__(self, mesh_or_path, network_config: Dict[str, Any],
                 seed: int = 1337, compute_dtype=torch.bfloat16, device=None,
                 generator: Optional[torch.Generator] = None,
                 draws: Optional[Callable] = None):
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("a CUDA device was asked for but none is "
                               "available")
        if isinstance(mesh_or_path, str):
            triangles = load_obj(mesh_or_path)
        else:
            triangles = np.asarray(mesh_or_path, np.float32)
        self.triangles, self.mesh_scale, self.mesh_offset = \
            normalize_mesh_to_unit_cube(triangles)
        self.bvh = TriangleBvh(self.triangles)

        # area-weighted triangle CDF for surface sampling
        a, b, c = (self.triangles[:, 0], self.triangles[:, 1],
                   self.triangles[:, 2])
        areas = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=-1)
        cdf = np.cumsum(areas)
        self.triangle_cdf = (cdf / cdf[-1]).astype(np.float64)
        center = self.triangles.reshape(-1, 3).mean(0)
        self.bounding_radius = float(np.linalg.norm(
            self.triangles.reshape(-1, 3) - center, axis=-1).max())

        self.config = network_config
        enc_cfg = network_config.get("encoding", {})
        self.stochastic_corners = True
        self.stochastic_corners_until: Optional[int] = enc_cfg.get(
            "stochastic_corners_until", 256)
        self.triangle_octree = None
        if enc_cfg.get("otype") == "Takikawa":
            # the octree encoding over the mesh's surface (reset_network's
            # Takikawa branch, testbed.cu:3805-3824)
            from ..geom.triangle_octree import TriangleOctree
            from ..ops.mlp import MLP, NetworkWithInputEncoding
            from ..ops.takikawa import TakikawaEncoding

            self.triangle_octree = TriangleOctree(
                self.triangles, int(enc_cfg.get("n_levels", 8)))
            encoding = TakikawaEncoding(
                self.triangle_octree,
                starting_level=int(enc_cfg.get("starting_level", 4)),
                sum_instead_of_concat=bool(
                    enc_cfg.get("sum_instead_of_concat", False)))
            net = MLP.from_config(encoding.n_output_dims, 1,
                                  network_config.get("network", {}),
                                  compute_dtype=compute_dtype)
            self.model = NetworkWithInputEncoding(encoding, net)
            self.resolved_config = network_config
        else:
            self.model, self.resolved_config = create_network_with_encoding(
                3, 1, network_config, desired_resolution=2048.0,
                compute_dtype=compute_dtype)
        self.model.to(self.device)
        self.optimizer = create_optimizer(network_config["optimizer"])
        self.loss_fn = create_loss(network_config.get("loss",
                                                      {"otype": "MAPE"}))
        self.trainer = Trainer(self.model, self.optimizer, self.loss_fn,
                               seed=seed)
        self.state = self.trainer.init_state()
        self.training_step = 0
        self.seed = seed
        self.loss_scalar = float("nan")
        #: host seconds spent making training samples in `train`
        self.sample_seconds = 0.0

        # instant-ngp's defaults (testbed.h:789-858)
        self.zero_offset = 0.0
        self.distance_scale = 0.95
        self.maximum_distance = 5e-5
        self.surface_offset_scale = 1.0
        self.mesh_sdf_mode = "Raystab"
        self.shadow_sharpness = 16.0
        self.render_with_shadows = False
        # the GT oracle of `render_frame(use_gt=True)` (ESDFGroundTruthMode,
        # common.h:146-150): RaytracedMesh | SpheretracedMesh | SDFBricks
        self.groundtruth_mode = "RaytracedMesh"
        self.brick_res = 5          # testbed.cu:4392
        self.brick_level = 10       # testbed.h:816
        self._bricks = None
        self.brdf = BRDFParams()
        self.aabb_min = np.zeros(3, np.float32)
        self.aabb_max = np.ones(3, np.float32)

        self._np_rng = np.random.RandomState(seed)
        self._override_data: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self.generator = generator if generator is not None else \
            torch.Generator(device=self.device).manual_seed(seed)
        self.draws = draws

    def _vec(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    # ------------------------------------------------------------------
    # training data (generate_training_samples_sdf), on the host
    # ------------------------------------------------------------------
    def sample_surface(self, n: int) -> np.ndarray:
        """n area-weighted uniform points on the mesh's surface."""
        tri_idx = np.searchsorted(self.triangle_cdf, self._np_rng.rand(n))
        tri_idx = np.minimum(tri_idx, len(self.triangles) - 1)
        t = self.triangles[tri_idx]
        u = self._np_rng.rand(n, 1).astype(np.float32)
        v = self._np_rng.rand(n, 1).astype(np.float32)
        flip = (u + v) > 1
        u = np.where(flip, 1 - u, u)
        v = np.where(flip, 1 - v, v)
        return t[:, 0] + u * (t[:, 1] - t[:, 0]) + v * (t[:, 2] - t[:, 0])

    def generate_training_samples(self, n: int, uniform_only: bool = False
                                  ) -> Tuple[np.ndarray, np.ndarray]:
        """-> (positions (n, 3), signed distances (n,)), numpy float32."""
        if uniform_only:
            pos = self._np_rng.rand(n, 3).astype(np.float32) \
                * (self.aabb_max - self.aabb_min) + self.aabb_min
            d = self.bvh.signed_distance(pos, self.mesh_sdf_mode,
                                         tuple(self._np_rng.rand(2)))
            return pos, d

        n_base = n // 8
        n_exact = n_base * 4
        n_offset = n_base * 3
        n_uniform = n - n_exact - n_offset

        surf = self.sample_surface(n_exact + n_offset).astype(np.float32)
        exact = surf[:n_exact]
        stddev = self.bounding_radius / 1024.0 * self.surface_offset_scale
        # logistic perturbation (generate_random_logistic)
        u = np.clip(self._np_rng.rand(n_offset, 3), 1e-7, 1 - 1e-7)
        perturb = (stddev * np.log(u / (1 - u))).astype(np.float32)
        offset = surf[n_exact:] + perturb
        uniform = self._np_rng.rand(n_uniform, 3).astype(np.float32) \
            * (self.aabb_max - self.aabb_min) + self.aabb_min

        labeled = np.concatenate([offset, uniform])
        d = self.bvh.signed_distance(labeled, self.mesh_sdf_mode,
                                     tuple(self._np_rng.rand(2)))
        positions = np.concatenate([exact, labeled])
        distances = np.concatenate([np.zeros(n_exact, np.float32), d])
        return positions, distances

    def override_training_data(self, positions: np.ndarray,
                               distances: np.ndarray) -> None:
        """Train on these samples (a random permutation of them a step)
        instead of generating new ones (override_sdf_training_data,
        testbed.h:608)."""
        self._override_data = (np.asarray(positions, np.float32),
                               np.asarray(distances, np.float32))

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------
    def _stoch_now(self) -> bool:
        """Whether this step encodes stochastically (a grid encoding only):
        until `stochastic_corners_until` (None: always), then exactly."""
        if not self.stochastic_corners:
            return False
        until = self.stochastic_corners_until
        return until is None or self.training_step < until

    def _batch(self, batch_size: int) -> Tuple[np.ndarray, np.ndarray]:
        t0 = time.perf_counter()
        if self._override_data is not None:
            pos, dist = self._override_data
            perm = self._np_rng.permutation(len(pos))[:batch_size]
            pos, dist = pos[perm], dist[perm]
        else:
            pos, dist = self.generate_training_samples(batch_size)
        self.sample_seconds += time.perf_counter() - t0
        return pos, dist

    def train_step_on(self, positions: np.ndarray, distances: np.ndarray
                      ) -> torch.Tensor:
        """One train step on given samples -> the loss (a 0-dim tensor on
        the device)."""
        encode = {}
        if self._stoch_now() and self.triangle_octree is None:
            corners = None if self.draws is None else \
                self.draws(self.training_step, len(positions))
            encode = {"draws": corners} if corners is not None \
                else {"generator": self.generator}
        pos = torch.from_numpy(np.ascontiguousarray(positions)).to(
            self.device)
        dist = torch.from_numpy(np.ascontiguousarray(distances)).to(
            self.device)[:, None]
        self.state, loss = self.trainer.train_step(self.state, pos, dist,
                                                   **encode)
        self.training_step += 1
        return loss

    def train(self, n_steps: int, batch_size: int = 1 << 18) -> float:
        """n_steps train steps -> the last loss (read once, at the end)."""
        loss = None
        for _ in range(n_steps):
            loss = self.train_step_on(*self._batch(batch_size))
        if loss is not None:
            self.loss_scalar = float(loss)
        return self.loss_scalar

    # ------------------------------------------------------------------
    # the network as a distance
    # ------------------------------------------------------------------
    def distance(self, pos: torch.Tensor) -> torch.Tensor:
        """The network's signed distance at positions (N, 3) -> (N,), by
        the inference model (the EMA weights where the optimizer keeps
        them). Under no_grad its MLP runs the fused kernel on the card."""
        return self.trainer.inference_model(pos)[..., 0]

    def normals(self, pos: torch.Tensor, finite_differences: bool = False,
                eps: float = 1e-3) -> torch.Tensor:
        """Unit gradients of the distance at (N, 3): by autograd through
        the encode's input gradient and the MLP, or by central
        differences of step eps."""
        if finite_differences:
            with torch.no_grad():
                offs = torch.eye(3, device=pos.device) * eps
                d_plus = torch.stack([self.distance(pos + offs[i])
                                      for i in range(3)], -1)
                d_minus = torch.stack([self.distance(pos - offs[i])
                                       for i in range(3)], -1)
                g = (d_plus - d_minus) / (2 * eps)
        else:
            with torch.enable_grad():
                p = pos.detach().requires_grad_(True)
                (g,) = torch.autograd.grad(self.distance(p).sum(), p)
        return _unit(g)

    # ------------------------------------------------------------------
    # sphere tracing
    # ------------------------------------------------------------------
    @torch.no_grad()
    def _sphere_trace(self, origins: torch.Tensor, dirs: torch.Tensor,
                      n_iters: int = 96, use_gt: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """A fixed number of rounds over every ray, dead lanes masked ->
        (positions (N, 3), hit (N,)). `use_gt`: march the brick cache."""
        aabb_min, aabb_max = self._vec(self.aabb_min), self._vec(self.aabb_max)
        tmin, tmax = ray_intersect_aabb(origins, dirs, aabb_min, aabb_max)
        tmin = tmin.clamp(min=0.0)
        alive = tmax >= tmin
        pos = origins + (tmin[:, None] + 1e-4) * dirs
        hit = torch.zeros_like(alive)
        for _ in range(n_iters):
            raw = self._bricks.distance(pos) if use_gt \
                else self.distance(pos)
            step = (raw - self.zero_offset) * self.distance_scale
            new_pos = pos + step[:, None] * dirs
            inside = aabb_contains(new_pos, aabb_min, aabb_max)
            # the stop rule (advance_pos_kernel_sdf :207): converged where
            # the step is no longer meaningfully larger than max distance
            converged = ~((step > self.maximum_distance)
                          & ((step / 2).abs() > 3 * self.maximum_distance))
            hit = hit | (alive & converged)
            pos = torch.where(alive[:, None], new_pos, pos)
            alive = alive & ~converged & inside
        return pos, hit

    @torch.no_grad()
    def _shadow_trace(self, origins: torch.Tensor, light_dir: torch.Tensor,
                      n_iters: int = 64) -> torch.Tensor:
        """Soft-shadow visibility (N,) in [0, 1] along rays toward the
        light (prepare_shadow_rays testbed_sdf.cu:231, min_visibility in
        advance_pos_kernel_sdf :196-203: v = min over the march of
        k * d / max(t - y, 0))."""
        aabb_min, aabb_max = self._vec(self.aabb_min), self._vec(self.aabb_max)
        k = self.shadow_sharpness
        dirs = light_dir.expand_as(origins)
        n = origins.shape[0]
        pos = origins + 2e-3 * dirs
        t_total = torch.zeros(n, device=origins.device)
        prev_d = torch.full((n,), 1e10, device=origins.device)
        min_vis = torch.ones(n, device=origins.device)
        alive = torch.ones(n, dtype=torch.bool, device=origins.device)
        for _ in range(n_iters):
            d = self.distance(pos) - self.zero_offset
            step = (d * self.distance_scale).clamp(min=0.0)
            y = step * step / (2.0 * prev_d).clamp(min=1e-9)
            dd = (step * step - y * y).clamp(min=0.0).sqrt()
            vis = k * dd / (t_total - y).clamp(min=1e-9)
            min_vis = torch.where(alive & (t_total > 0),
                                  torch.minimum(min_vis, vis), min_vis)
            hit = d < self.maximum_distance * 4
            new_pos = pos + (step + 1e-4)[:, None] * dirs
            inside = aabb_contains(new_pos, aabb_min, aabb_max)
            pos = torch.where(alive[:, None], new_pos, pos)
            t_total = torch.where(alive, t_total + step + 1e-4, t_total)
            min_vis = torch.where(alive & hit, 0.0, min_vis)
            alive = alive & inside & ~hit
            prev_d = step.clamp(min=1e-9)
        return min_vis.clamp(0.0, 1.0)

    # ------------------------------------------------------------------
    # ground truth
    # ------------------------------------------------------------------
    def _ensure_bricks(self) -> None:
        """Build the brick cache once (testbed.cu:4390-4406)."""
        if self._bricks is None:
            from ..geom.triangle_octree import TriangleOctree
            from .bricks import SdfBricks

            octree = self.triangle_octree
            if octree is None or octree.depth - 1 > self.brick_level:
                octree = TriangleOctree(self.triangles,
                                        min(self.brick_level + 1, 7))
            self._bricks = SdfBricks(octree, self.bvh,
                                     brick_res=self.brick_res,
                                     brick_level=self.brick_level,
                                     device=self.device)

    @torch.no_grad()
    def _brick_normals(self, pos: torch.Tensor, eps: float) -> torch.Tensor:
        """Central differences of the brick SDF, taps eps apart
        (brick_smooth_normals, testbed_sdf.cu:980-981)."""
        offs = torch.eye(3, device=pos.device) * eps
        g = torch.stack([self._bricks.distance(pos + offs[i])
                         - self._bricks.distance(pos - offs[i])
                         for i in range(3)], -1)
        return _unit(g)

    def _spheretrace_mesh(self, origins: np.ndarray, dirs: np.ndarray
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Sphere trace of the BVH's exact distance on the host ->
        (positions, hit, normals)."""
        pos = origins.copy()
        alive = np.ones(len(pos), bool)
        for _ in range(48):
            d = self.bvh.signed_distance(pos[alive], mode="Watertight")
            pos[alive] += (d * self.distance_scale)[:, None] * dirs[alive]
            alive[alive.nonzero()[0]] = np.abs(d) > 5e-4
            if not alive.any():
                break
        d_final = self.bvh.signed_distance(pos, mode="Watertight")
        hit = np.abs(d_final) < 5e-3
        eps = 1e-3
        g = np.stack([
            self.bvh.signed_distance(pos + off, mode="Watertight")
            - self.bvh.signed_distance(pos - off, mode="Watertight")
            for off in (np.eye(3, dtype=np.float32) * eps)], -1)
        n = g / np.maximum(np.linalg.norm(g, axis=-1, keepdims=True), 1e-9)
        return pos, hit, n

    def _raytrace_mesh(self, origins: np.ndarray, dirs: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        t, idx = self.bvh.ray_trace(origins, dirs)
        hit = idx >= 0
        pos = origins + t[:, None] * dirs
        n = np.zeros_like(pos)
        n[hit] = self.bvh.triangle_normals()[idx[hit]]
        return pos, hit, n

    # ------------------------------------------------------------------
    # frames
    # ------------------------------------------------------------------
    def render_frame(self, width: int, height: int, camera_matrix,
                     focal_length: Optional[float] = None,
                     render_mode: str = "Shade",
                     light_dir=(0.577, -0.577, 0.577),
                     background_color=(1.0, 1.0, 1.0),
                     use_gt: bool = False) -> np.ndarray:
        """A sphere-traced frame (height, width, 4) linear float32: RGB by
        `render_mode` (Shade, Normals, Depth, Positions) and the hit mask;
        `use_gt` renders the `groundtruth_mode` oracle instead."""
        from ..nerf.render import camera_rays_for_frame

        fl = focal_length or width * 1.1
        origins, dirs = camera_rays_for_frame(
            width, height, (fl, fl), np.asarray(camera_matrix, np.float32),
            device=self.device)

        if use_gt and self.groundtruth_mode == "SDFBricks":
            self._ensure_bricks()
            pos, hit = self._sphere_trace(origins, dirs, 96, True)
            eps = (2.0 ** -(self._bricks.level + 1)) / (self.brick_res - 1)
            n = self._brick_normals(pos, eps)
        elif use_gt:
            oracle = self._spheretrace_mesh \
                if self.groundtruth_mode == "SpheretracedMesh" \
                else self._raytrace_mesh
            pos, hit, n = (torch.from_numpy(np.ascontiguousarray(a)).to(
                self.device) for a in oracle(origins.cpu().numpy(),
                                             dirs.cpu().numpy()))
        else:
            pos, hit = self._sphere_trace(origins, dirs)
            n = self.normals(pos)

        with torch.no_grad():
            if render_mode == "Normals":
                rgb = n * 0.5 + 0.5
            elif render_mode == "Depth":
                rgb = _norm(pos - origins).expand(-1, 3)
            elif render_mode == "Positions":
                rgb = pos
            else:
                L = self._vec(light_dir)
                L = L / torch.sqrt((L * L).sum())
                rgb = evaluate_shading(
                    self._vec(self.brdf.basecolor),
                    self._vec(self.brdf.ambientcolor),
                    torch.ones(3, device=self.device), self.brdf, L, -dirs, n)
                if self.render_with_shadows and not use_gt:
                    rgb = rgb * self._shadow_trace(pos, L)[:, None]
            bg = self._vec(background_color)
            rgb = torch.where(hit[:, None], rgb, bg)
            rgba = torch.cat([rgb, hit[:, None].float()], dim=-1)
        return rgba.reshape(height, width, 4).cpu().numpy()

    # ------------------------------------------------------------------
    # metrics and exports
    # ------------------------------------------------------------------
    @torch.no_grad()
    def calculate_iou(self, n_samples: int = 128 * 128 * 128,
                      scale_existing: float = 0.0) -> float:
        """Monte Carlo intersection over union of the network's inside
        (distance < zero_offset) and the BVH's (calculate_iou,
        testbed_sdf.cu:1363; compare_signs_kernel :472)."""
        pos, gt_d = self.generate_training_samples(n_samples,
                                                   uniform_only=True)
        chunk = 1 << 18
        pred_inside = np.concatenate([
            (self.distance(torch.from_numpy(pos[i:i + chunk]).to(
                self.device)) < self.zero_offset).cpu().numpy()
            for i in range(0, len(pos), chunk)])
        gt_inside = gt_d < 0
        intersection = np.sum(pred_inside & gt_inside)
        union = np.sum(pred_inside | gt_inside)
        return float(intersection) / max(float(union), 1.0)

    @torch.no_grad()
    def compute_and_save_png_slices(self, filename: str,
                                    resolution: int = 256, aabb=None,
                                    thresh: Optional[float] = None,
                                    density_range: float = 4.0,
                                    flip_y_and_z_axes: bool = False,
                                    ground_truth: bool = False):
        """The signed-distance slice atlas as a PNG (the SDF branch of
        compute_and_save_png_slices, testbed.cu:534-558): the box inflated
        by `density_range` output voxels, the range in voxel units and
        negated, so black is outside and white inside; `ground_truth`
        samples the BVH instead of the network. -> the per-axis
        resolution."""
        from ..geom.marching import marching_cubes_res, save_density_slices_png

        aabb_min = np.asarray(aabb[0] if aabb else self.aabb_min,
                              np.float64).copy()
        aabb_max = np.asarray(aabb[1] if aabb else self.aabb_max,
                              np.float64).copy()
        if thresh is None:
            thresh = 0.0          # SDF mode's m_mesh.thresh (:1145)
        res3d = marching_cubes_res(resolution, aabb_min, aabb_max)
        inflate = density_range * (aabb_max[0] - aabb_min[0]) / res3d[0]
        aabb_min -= inflate
        aabb_max += inflate
        res3d = marching_cubes_res(resolution, aabb_min, aabb_max)
        rng = -density_range * (aabb_max[0] - aabb_min[0]) / res3d[0]

        lins = [np.linspace(lo, hi, r, dtype=np.float32)
                for lo, hi, r in zip(aabb_min, aabb_max, res3d)]
        field = np.empty(res3d, np.float32)
        for ix in range(res3d[0]):
            pos = np.stack(np.meshgrid(lins[0][ix:ix + 1], lins[1],
                                       lins[2], indexing="ij"),
                           -1).reshape(-1, 3)
            if ground_truth:
                d = self.bvh.signed_distance(pos, self.mesh_sdf_mode)
            else:
                d = self.distance(torch.from_numpy(pos).to(
                    self.device)).cpu().numpy()
            field[ix] = d.reshape(res3d[1], res3d[2])
        out = (f"{filename}.density_slices_"
               f"{res3d[0]}x{res3d[1]}x{res3d[2]}.png")
        save_density_slices_png(out, field, float(thresh), rng,
                                flip_y_and_z_axes)
        return res3d

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
            "mesh_scale": self.mesh_scale,
            "mesh_offset": np.asarray(self.mesh_offset, np.float32),
        })

    def load_snapshot_state(self, snapshot: Dict[str, Any]) -> None:
        """Restore from `data.snapshot.load_snapshot`'s dict."""
        trainer = snapshot["trainer"]
        self.trainer.load_state(self.state, trainer["params"],
                                trainer.get("opt"))
        self.training_step = int(snapshot.get("training_step", 0))
