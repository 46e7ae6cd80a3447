"""Render-only NeRF testbed (counterpart of the render half of
instant_ngp_tpu/nerf/testbed_nerf.py::NerfTestbed).

It holds a network, its occupancy grid and bitfield on one device (the
CUDA device unless `device` names another; it raises where there is none), and
renders frames through the wavefront renderer in Shade mode. Parameters
come from a seed (`torch.Generator`), from `load_params` (the JAX layout,
e.g. a converted snapshot), and the grid from `set_density_grid` or from
one full density pass, `update_density_grid_full`. Training is not ported
yet.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..common import NERF_GRID_N_CELLS
from ..ops.sampling import ld_pixel_offset
from .dataset import NerfSceneConfig
from .model import NerfNetwork, network_to_density
from .occupancy import (cell_densities, density_grid_mean, init_bitfield,
                        init_density_grid, splat_and_ema, update_bitfield)
from .render import RenderConfig, WavefrontRenderer, camera_rays_for_frame


class NerfTestbed:
    def __init__(self, scene: NerfSceneConfig,
                 network_config: Dict[str, Any], device=None,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 seed: int = 1337):
        if scene.n_extra_dims:
            raise NotImplementedError("rendering with per-image latent "
                                      "dims is not ported yet")
        self.scene = scene
        # the card unless the caller names another device; never the CPU
        # by itself
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("a CUDA device was asked for but none is "
                               "available")
        self.model = NerfNetwork(
            n_pos_dims=3, n_dir_dims=3, n_extra_dims=scene.n_extra_dims,
            encoding_config=network_config["encoding"],
            dir_encoding_config=network_config.get(
                "dir_encoding", {"otype": "SphericalHarmonics", "degree": 4}),
            network_config=network_config["network"],
            rgb_network_config=network_config.get(
                "rgb_network", network_config["network"]),
            desired_resolution=2048.0, aabb_scale=scene.aabb_scale,
            compute_dtype=compute_dtype)
        # seeded on the CPU, so a seed gives the same weights on any device
        self._generator = torch.Generator().manual_seed(seed)
        self.model.init_params(self._generator)
        self.model.to(self.device)
        self.aabb_min = torch.as_tensor(scene.aabb_min, device=self.device)
        self.aabb_max = torch.as_tensor(scene.aabb_max, device=self.device)

        self.density_grid = init_density_grid(scene.max_cascade + 1,
                                              self.device)
        self.bitfield = init_bitfield(self.device)
        self.mean_density = torch.zeros((), device=self.device)

        # march candidates per ray: the JAX testbed derives this from its
        # training cameras; without cameras it takes the cap, as here
        self.n_march = 1024
        self.max_samples_per_ray = 1024
        # per-ray candidate cap at render time (None = min(march cap, 512))
        self.render_max_samples_per_ray: Optional[int] = None
        # most network queries per call (the reference's target_n_queries)
        self.render_query_budget = 2 << 20
        # network evaluations of the last render_frame
        self.last_frame_n_samples = 0

    @torch.no_grad()
    def load_params(self, params: Dict[str, Any]) -> None:
        """Load parameters in the JAX layout (numpy arrays or tensors)."""
        self.model.load_params(params)

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
        """Query the density at a point of each cell in `indices`, offset
        by `jitter` (n, 3) in [0, 1), max-EMA merge it into the grid and
        rebuild the bitfield."""
        idx = indices.to(self.device, torch.long)
        act = self.scene.density_activation
        dens = cell_densities(
            lambda pos: network_to_density(self.model.density(pos), act),
            idx, jitter.to(self.device, torch.float32), self.aabb_min,
            self.aabb_max)
        self.density_grid = splat_and_ema(self.density_grid, idx, dens,
                                          decay)
        self.bitfield = update_bitfield(self.density_grid,
                                        self.scene.max_cascade)
        self.mean_density = density_grid_mean(self.density_grid)

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
        return WavefrontRenderer(self.model, cfg, self.aabb_min,
                                 self.aabb_max)

    @torch.no_grad()
    def render_frame(self, width: int, height: int, camera_matrix,
                     focal_length=None, spp: int = 1,
                     background_color=(0.0, 0.0, 0.0),
                     min_transmittance: float = 1e-2,
                     tile: Optional[int] = None) -> np.ndarray:
        """Render a Shade frame -> (H, W, 4) linear float32 (rgb, alpha).

        camera_matrix: (3, 4) NGP-space camera. focal_length: pixels, a
        scalar or (fx, fy); a render-only testbed has no training camera
        to default it from. spp > 1 averages jittered subpixel samples.
        tile bounds the rays rendered together (default 2^19)."""
        if focal_length is None:
            raise ValueError("focal_length is required: a render-only "
                             "testbed has no training camera")
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
                jitter=jitter, device=self.device)
            for i in range(0, n_pixels, tile):
                out = renderer.render(origins[i:i + tile], dirs[i:i + tile],
                                      self.bitfield, bg)
                acc[i:i + tile, :3] += out["rgb"]
                acc[i:i + tile, 3] += out["alpha"]
                self.last_frame_n_samples += out["n_samples"]
        return (acc / spp).reshape(height, width, 4).cpu().numpy()
