"""Data-parallel NeRF: rays, grid cells and pixel tiles sharded over the
ranks of a mesh axis (counterpart of instant_ngp_tpu/nerf/parallel.py).

The parameters, the occupancy grid and its bitfield are replicated: every
rank holds them whole and runs the same arithmetic on the same reduced
numbers, so they stay the same bits on every rank (which needs that
arithmetic to be deterministic on the card: the table gradient is, see
ops/grid_encoding.py). Each rank makes its own random numbers (its own
generator stream, or draws handed in: the tests hand each rank the JAX
package's draws of its chip).

- `make_sharded_train_step`: the same `nerf_train_step`, given the axis's
  process group; `cfg.n_rays` rays per rank.
- `make_sharded_density_update`: each rank samples and evaluates
  1/n of the cells (through the fused MLP kernel on the card); the cell
  indices and densities are all-gathered and the max-EMA merge, the
  bitfield and the mean are computed on every rank alike.
- `make_sharded_render`: each rank renders a contiguous block of the
  frame's pixel tiles through `render_tile`; the tiles are all-gathered.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..parallel.mesh import Mesh, all_gather
from .occupancy import (density_grid_mean, sample_cells, splat_and_ema,
                        update_bitfield)
from .render import RenderConfig, render_tile
from .training import NerfTrainStepConfig, nerf_train_step


def make_sharded_train_step(model, optimizer, cfg: NerfTrainStepConfig,
                            aabb_min: torch.Tensor, aabb_max: torch.Tensor,
                            mesh: Mesh, axis: str = "data") -> Callable:
    """-> step(opt_state, data, bitfield, mean_density, draws, cam=None,
    error_cdfs=None, error_map=None, envmap=None, distortion=None), the
    stats of `nerf_train_step` reduced over the axis; `draws` are this
    rank's. The effective batch is cfg.n_rays times the axis's size."""
    group = mesh.group(axis)

    def step(opt_state, data, bitfield, mean_density, draws, cam=None,
             error_cdfs=None, error_map=None, envmap=None, distortion=None):
        return nerf_train_step(
            model, optimizer, cfg, aabb_min, aabb_max, opt_state, data,
            bitfield, mean_density, draws, cam=cam, error_cdfs=error_cdfs,
            error_map=error_map, envmap=envmap, distortion=distortion,
            group=group)

    return step


def shard_counts(n_uniform: int, n_nonuniform: int, n_shards: int
                 ) -> Tuple[int, int]:
    """The cells each of `n_shards` ranks samples (rounded up)."""
    return -(-n_uniform // n_shards), -(-n_nonuniform // n_shards)


def make_sharded_density_update(testbed, mesh: Mesh, axis: str = "data",
                                n_uniform: int = 0, n_nonuniform: int = 0
                                ) -> Callable:
    """-> update(density_grid, cell_draws, jitter, corners, decay) ->
    (grid, bitfield, mean). The arguments after the grid are this rank's
    draws for `shard_counts(n_uniform, n_nonuniform, axis size)` cells, as
    the testbed's `_prep_draws` makes them; the densities come from the
    testbed's inference network (`evaluate_density`)."""
    group = mesh.group(axis)
    n_uni, n_non = shard_counts(n_uniform, n_nonuniform, mesh.size(axis))
    n_cascades = testbed.scene.max_cascade + 1

    @torch.no_grad()
    def update(density_grid, cell_draws, jitter, corners, decay=0.95):
        idx = sample_cells(cell_draws, density_grid, n_uni, n_non,
                           n_cascades)
        dens = testbed.evaluate_density(idx, jitter, corners)
        idx, dens = all_gather(idx, group), all_gather(dens, group)
        grid = splat_and_ema(density_grid, idx, dens, decay)
        return (grid, update_bitfield(grid, testbed.scene.max_cascade),
                density_grid_mean(grid))

    return update


def make_sharded_render(model, render_cfg: RenderConfig,
                        aabb_min: torch.Tensor, aabb_max: torch.Tensor,
                        mesh: Mesh, axis: str = "data") -> Callable:
    """-> render(origins, dirs, bitfield, bg_color, extra_dims=None): the
    frame's rays as (n_tiles, tile, 3) on every rank, n_tiles a multiple
    of the axis's size; rank i renders tiles i*k .. (i+1)*k - 1 -> {"rgb"
    (n_tiles, tile, 3), "alpha", "depth" (n_tiles, tile), "n_samples"},
    the same on every rank. Call it under `torch.no_grad()`."""
    group = mesh.group(axis)
    n, i = mesh.size(axis), mesh.index(axis)

    def render(origins: torch.Tensor, dirs: torch.Tensor,
               bitfield: torch.Tensor, bg_color: torch.Tensor,
               extra_dims: Optional[torch.Tensor] = None
               ) -> Dict[str, Any]:
        n_tiles = origins.shape[0]
        if n_tiles % n:
            raise ValueError(f"{n_tiles} tiles do not split over {n} ranks")
        k = n_tiles // n
        tiles = [render_tile(model, render_cfg, origins[t], dirs[t],
                             bitfield, aabb_min, aabb_max, bg_color,
                             extra_dims)
                 for t in range(i * k, (i + 1) * k)]
        out = {key: all_gather(torch.stack([t[key] for t in tiles]), group)
               for key in ("rgb", "alpha", "depth")}
        out["n_samples"] = all_gather(
            torch.stack([t["n_samples"] for t in tiles]), group).sum()
        return out

    return render
