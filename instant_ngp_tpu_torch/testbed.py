"""The `Testbed` facade: one entry point for every mode (counterpart of
instant_ngp_tpu/testbed.py; instant-ngp's Testbed and its pybind surface).

`load_file` / `load_training_data` infer the mode from the path
(`mode_from_scene`) and build that mode's testbed of the port (NeRF, Image,
SDF, Volume or Geometry); `train` and `frame` advance training, `render`
returns frames, snapshots round-trip with the config embedded, and the
mode-specific calls pass through. Everything runs on the CUDA device unless
the caller passes `device="cpu"` (it raises where there is no card).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from .common import TestbedMode
from .config import find_network_config, load_network_config, loads_json


def mode_from_scene(path: str) -> TestbedMode:
    """The mode a scene path asks for: a directory or transforms.json is
    NeRF, a mesh SDF, an image Image, a NanoVDB or .npy grid Volume, a JSON
    with a "geometry" key Geometry (one with "frames" NeRF)."""
    if os.path.isdir(path) or path.endswith("transforms.json"):
        return TestbedMode.Nerf
    ext = os.path.splitext(path)[1].lower()
    if ext in (".obj", ".stl"):
        return TestbedMode.Sdf
    if ext in (".exr", ".png", ".jpg", ".jpeg", ".bmp", ".tga", ".bin"):
        return TestbedMode.Image
    if ext in (".nvdb", ".npy"):
        return TestbedMode.Volume
    if ext == ".json":
        try:
            with open(path) as f:
                data = loads_json(f.read())
        except (OSError, ValueError):
            return TestbedMode.NONE
        if isinstance(data, dict):
            if any("geometry" in k for k in data):
                return TestbedMode.Geometry
            if "frames" in data:
                return TestbedMode.Nerf
    return TestbedMode.NONE


class Testbed:
    # the dynamic-resolution render heartbeat of `frame` (instant-ngp's
    # m_dynamic_res / m_dynamic_res_target_fps)
    shall_render = False
    full_resolution = (1920, 1080)
    dynamic_res_target_fps = 30.0
    last_frame = None

    def __init__(self, mode: TestbedMode = TestbedMode.NONE,
                 seed: int = 1337, device=None):
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("a CUDA device was asked for but none is "
                               "available")
        self.mode = mode
        self.seed = seed
        self.impl = None
        self.network_config: Optional[Dict[str, Any]] = None
        self.network_config_path: Optional[str] = None
        self.data_path: Optional[str] = None
        self.shall_train = True
        self.background_color = np.array([1.0, 1.0, 1.0, 1.0], np.float32)
        self.training_batch_size = 1 << 18
        self._pending_snapshot = None
        self._dynres = None

    # -- loading --------------------------------------------------------
    def load_file(self, path: str) -> None:
        """A snapshot (.ingp / .msgpack), a network config (a JSON that is
        no scene) or a scene."""
        path = str(path)
        if path.endswith((".ingp", ".msgpack")):
            self.load_snapshot(path)
            return
        mode = mode_from_scene(path)
        if mode == TestbedMode.NONE and path.endswith(".json"):
            self.reload_network_from_file(path)
            return
        self.load_training_data(path)

    def load_training_data(self, path: str,
                           mode: Optional[TestbedMode] = None) -> None:
        """Load a scene; `mode` forces the mode instead of inferring it."""
        path = str(path)
        self.mode = mode or mode_from_scene(path)
        if self.mode == TestbedMode.NONE:
            raise ValueError(f"cannot infer testbed mode from {path!r}")
        self.data_path = path
        self._maybe_create_impl()

    def reload_network_from_file(self, path: str = "") -> None:
        if path:
            path = find_network_config(
                path, mode=self.mode.value if self.mode else None)
            self.network_config_path = path
        if self.network_config_path:
            self.network_config = load_network_config(
                self.network_config_path)
        self._maybe_create_impl(reset=True)

    def reload_network_from_json(self, config: Dict[str, Any]) -> None:
        self.network_config = config
        self._maybe_create_impl(reset=True)

    def _default_config(self) -> Dict[str, Any]:
        if self.mode == TestbedMode.Geometry:
            # nothing is trained in Geometry mode, and configs/ has no
            # geometry/ (the JAX facade raises here)
            return {}
        return load_network_config(
            find_network_config("base.json", mode=self.mode.value))

    def _maybe_create_impl(self, reset: bool = False) -> None:
        if self.data_path is None or self.mode == TestbedMode.NONE:
            return
        if self.impl is not None and not reset:
            return
        if self.network_config is None:
            self.network_config = self._default_config()
        cfg, seed, dev = self.network_config, self.seed, self.device
        if self.mode == TestbedMode.Image:
            from .data.images import read_image
            from .image.testbed_image import ImageTestbed

            self.impl = ImageTestbed(read_image(self.data_path), cfg,
                                     seed=seed, device=dev)
        elif self.mode == TestbedMode.Nerf:
            from .data.nerf_loader import load_nerf
            from .nerf.testbed_nerf import NerfTestbed

            p = self.data_path
            if os.path.isdir(p):
                p = os.path.join(p, "transforms.json")
            self.impl = NerfTestbed(load_nerf(p), cfg, device=dev, seed=seed)
        elif self.mode == TestbedMode.Sdf:
            from .sdf.testbed_sdf import SdfTestbed

            self.impl = SdfTestbed(self.data_path, cfg, seed=seed,
                                   device=dev)
        elif self.mode == TestbedMode.Volume:
            from .volume.testbed_volume import (VolumeTestbed,
                                                load_volume_grid)

            self.impl = VolumeTestbed(load_volume_grid(self.data_path), cfg,
                                      seed=seed, device=dev)
        elif self.mode == TestbedMode.Geometry:
            from .geometry.testbed_geometry import GeometryTestbed

            self.impl = GeometryTestbed(self.data_path, cfg, seed=seed,
                                        device=dev)
        else:
            raise ValueError(f"unsupported mode {self.mode}")

    # -- training / rendering ------------------------------------------
    @property
    def training_step(self) -> int:
        return self.impl.training_step if self.impl else 0

    @property
    def loss(self) -> float:
        return self.impl.loss_scalar if self.impl else float("nan")

    def train_stats(self) -> dict:
        """The testbed's rate and phase meters, where it keeps them."""
        if self.impl is not None and hasattr(self.impl,
                                             "performance_stats"):
            return self.impl.performance_stats()
        return {}

    def profile_trace(self, logdir: str):
        """Context manager: a `torch.profiler` trace of everything run
        inside it (the host and, on the card, the device's kernels),
        written to `logdir` as a Chrome trace when the block ends."""
        from torch.profiler import (ProfilerActivity, profile,
                                    tensorboard_trace_handler)

        os.makedirs(logdir, exist_ok=True)
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        return profile(activities=activities,
                       on_trace_ready=tensorboard_trace_handler(logdir))

    def frame(self) -> bool:
        """One training step when training is on and, with `shall_render`,
        one frame at the resolution the dynamic-resolution controller
        picks from the smoothed render time; it lands in `last_frame`."""
        if self.impl is None:
            return False
        if self.shall_train:
            self.train(1)
        if self.shall_render:
            import time

            from .render_buffer import DynamicResolution
            from .utils import Ema

            if self._dynres is None:
                self._dynres = DynamicResolution(
                    self.full_resolution, self.dynamic_res_target_fps)
                self._render_ms = Ema(half_life_s=1.0)
            w, h = self._dynres.update(self._render_ms.value)
            t0 = time.perf_counter()
            self.last_frame = self.render(w, h)
            self._render_ms.update((time.perf_counter() - t0) * 1e3)
        return True

    def train(self, n_steps: int = 1) -> float:
        if self.mode == TestbedMode.Nerf:
            return self.impl.train(n_steps)
        return self.impl.train(n_steps, batch_size=self.training_batch_size)

    def render(self, width: int, height: int, spp: int = 1,
               linear: bool = True, camera_matrix=None) -> np.ndarray:
        """A frame (H, W, 4) float32, linear or (`linear=False`) sRGB."""
        if self.mode == TestbedMode.Image:
            img = self.impl.render(width, height)
        elif self.mode == TestbedMode.Nerf:
            if camera_matrix is None:
                camera_matrix = self.impl.data.xforms_start[0].cpu().numpy()
            img = self.impl.render_frame(
                width, height, camera_matrix, spp=spp,
                background_color=self.background_color[:3])
        elif self.mode in (TestbedMode.Sdf, TestbedMode.Geometry,
                           TestbedMode.Volume):
            if camera_matrix is None:
                camera_matrix = np.array(
                    [[1, 0, 0, 0.5], [0, -1, 0, 0.5], [0, 0, -1, 2.5]],
                    np.float32)
            img = self.impl.render_frame(width, height, camera_matrix)
        else:
            raise ValueError("no scene loaded")
        if not linear:
            from .common import linear_to_srgb

            img = img.copy()
            img[..., :3] = linear_to_srgb(np.maximum(img[..., :3], 0.0))
        return img

    # -- mode-specific passthroughs --------------------------------------
    def calculate_iou(self, n_samples: int = 128 * 128 * 128,
                      scale_existing_results_factor: float = 0.0,
                      blocking: bool = True, force_use_octree: bool = True
                      ) -> float:
        """SDF mode's IoU of the network against the mesh."""
        return self.impl.calculate_iou(n_samples)

    def compute_marching_cubes_mesh(self, resolution: int = 128,
                                    thresh: float = 2.5):
        """(verts, faces, colors) of the NeRF density's iso-surface."""
        return self.impl.compute_marching_cubes_mesh(resolution, thresh)

    def compute_and_save_png_slices(self, filename: str,
                                    resolution: int = 256, aabb=None,
                                    thresh=None, density_range: float = 4.0,
                                    flip_y_and_z_axes: bool = False):
        """The slice atlas PNG of the density or distance field, beside
        `filename`; returns the grid's (x, y, z) resolution."""
        kw = {} if thresh is None else {"thresh": thresh}
        return self.impl.compute_and_save_png_slices(
            filename, resolution=resolution, aabb=aabb,
            density_range=density_range,
            flip_y_and_z_axes=flip_y_and_z_axes, **kw)

    def save_mesh(self, path: str, resolution: int = 128,
                  thresh: float = 2.5) -> None:
        from .geom.marching import save_mesh, vertex_normals

        verts, faces, colors = self.compute_marching_cubes_mesh(
            resolution, thresh)
        save_mesh(path, verts, faces, colors=colors,
                  normals=vertex_normals(verts, faces) if len(verts)
                  else None)

    def screenshot(self, path: str, width: int = 1920, height: int = 1080,
                   spp: int = 16) -> None:
        from .data.images import write_image

        write_image(path, self.render(width, height, spp=spp)
                    .astype(np.float32))

    def override_sdf_training_data(self, positions, distances) -> None:
        self.impl.override_training_data(positions, distances)

    @property
    def nerf(self):
        """The mode's testbed (pyngp's `testbed.nerf.<...>`)."""
        return self.impl

    # -- snapshots ------------------------------------------------------
    def save_snapshot(self, path: str,
                      serialize_optimizer: bool = True) -> None:
        self.impl.save_snapshot(path)

    def load_snapshot(self, path: str) -> None:
        """A snapshot of the loaded mode's testbed, or a Geometry snapshot,
        which needs no scene (its objects are embedded). Without a scene
        the snapshot waits for one (`apply_pending_snapshot`)."""
        from .data.snapshot import load_snapshot

        snap = load_snapshot(path)
        self.mode = TestbedMode(snap.get("mode", "none"))
        self.network_config = snap.get("config")
        if self.mode == TestbedMode.Geometry and self.impl is None:
            from .geometry.testbed_geometry import GeometryTestbed

            self.impl = GeometryTestbed.from_snapshot(snap, self.device)
            return
        if self.impl is None and self.data_path:
            self._maybe_create_impl(reset=True)
        if self.impl is not None:
            self.impl.load_snapshot_state(snap)
        else:
            self._pending_snapshot = snap

    def apply_pending_snapshot(self) -> None:
        if self._pending_snapshot is not None and self.impl is not None:
            self.impl.load_snapshot_state(self._pending_snapshot)
            self._pending_snapshot = None
