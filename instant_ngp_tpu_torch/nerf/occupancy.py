"""Cascaded occupancy grid: density max-EMA, bitfield, mip max-pooling, and
the density query over grid cells (counterpart of
instant_ngp_tpu/nerf/occupancy.py and of the exact-encode density query in
instant_ngp_tpu/nerf/testbed_nerf.py::_density_update_body).

- `density_grid`: (n_cascades * 128^3,) float32, Morton order per cascade.
  Negative values mark untrained cells.
- an update samples candidate cells (`sample_cells`: every cell in a full
  sweep, else some cells regardless of state plus some occupied ones, each
  by 10 rejection probes), splats `density * MIN_CONE_STEPSIZE` into them
  with a max, then keeps max(old * decay, new) per cell;
- bitfield bit = density > min(0.01, mean density of cascade 0); mip m >= 1
  ORs in the 2x2x2 max-pool of the centre 64^3 of mip m-1.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..common import (MIN_CONE_STEPSIZE, NERF_CASCADES, NERF_GRID_N_CELLS,
                      NERF_GRIDSIZE, NERF_MIN_OPTICAL_THICKNESS)
from .march import morton3d, morton3d_coords

N_BITFIELD_BYTES = NERF_GRID_N_CELLS // 8 * NERF_CASCADES


def init_density_grid(n_cascades: int, device) -> torch.Tensor:
    return torch.zeros(NERF_GRID_N_CELLS * n_cascades, device=device)


def init_bitfield(device) -> torch.Tensor:
    return torch.zeros(N_BITFIELD_BYTES, dtype=torch.uint8, device=device)


N_PROBES = 10


class CellDraws(NamedTuple):
    """The random numbers of one `sample_cells` call: per slot, N_PROBES
    candidate cells of one cascade."""

    uniform_idx: torch.Tensor     # (N_PROBES, n_uniform) in [0, 128^3)
    uniform_level: torch.Tensor   # (n_uniform,) in [0, n_cascades)
    occupied_idx: torch.Tensor    # (N_PROBES, n_nonuniform)
    occupied_level: torch.Tensor  # (n_nonuniform,)


def draw_cell_randoms(generator: torch.Generator, n_uniform: int,
                      n_nonuniform: int, n_cascades: int) -> CellDraws:
    dev = generator.device

    def ints(high, *shape):
        return torch.randint(0, high, shape, generator=generator, device=dev)

    return CellDraws(ints(NERF_GRID_N_CELLS, N_PROBES, n_uniform),
                     ints(n_cascades, n_uniform),
                     ints(NERF_GRID_N_CELLS, N_PROBES, n_nonuniform),
                     ints(n_cascades, n_nonuniform))


def sample_cells(draws: Optional[CellDraws], density_grid: torch.Tensor,
                 n_uniform: int, n_nonuniform: int, n_cascades: int
                 ) -> torch.Tensor:
    """Candidate cell indices: `n_uniform` cells regardless of state (the
    threshold -0.01 skips only untrained cells) and `n_nonuniform`
    occupied ones. Each slot keeps the first of its probes whose density
    is above the threshold, else its last probe. Asking for every cell and
    no occupied one is the full sweep: an exact enumeration, no draws."""
    if n_uniform == n_cascades * NERF_GRID_N_CELLS and n_nonuniform == 0:
        return torch.arange(n_uniform, device=density_grid.device)

    def probe(idx, level, thresh):
        flat = idx.long() + level.long()[None, :] * NERF_GRID_N_CELLS
        ok = density_grid[flat] > thresh                     # (N_PROBES, n)
        # leading failures = index of the first success
        first = (torch.cumsum(ok, dim=0) == 0).sum(dim=0)
        pick = first.clamp(max=N_PROBES - 1)
        return flat.gather(0, pick[None, :])[0]

    return torch.cat([
        probe(draws.uniform_idx, draws.uniform_level, -0.01),
        probe(draws.occupied_idx, draws.occupied_level,
              NERF_MIN_OPTICAL_THICKNESS)])


def mark_untrained_cells(density_grid: torch.Tensor, visible: torch.Tensor
                         ) -> torch.Tensor:
    """visible (C * 128^3,) bool: cells no training camera sees go to -1,
    the rest are clamped to >= 0."""
    return torch.where(visible, density_grid.clamp(min=0.0), -1.0)


def cell_positions(indices: torch.Tensor, jitter: torch.Tensor
                   ) -> torch.Tensor:
    """World position inside each cell: indices (N,) flat grid indices
    (cascade * 128^3 + Morton), jitter (N, 3) in [0, 1) -> (N, 3)."""
    level = indices // NERF_GRID_N_CELLS
    coords = torch.stack(morton3d_coords(indices % NERF_GRID_N_CELLS), -1)
    mip_scale = torch.exp2(level.float())[:, None]
    p = (coords.float() + jitter) / NERF_GRIDSIZE - 0.5
    return p * mip_scale + 0.5


def cell_densities(density_fn: Callable[[torch.Tensor, int], torch.Tensor],
                   indices: torch.Tensor, jitter: torch.Tensor,
                   aabb_min: torch.Tensor, aabb_max: torch.Tensor,
                   chunk: int = 1 << 19) -> torch.Tensor:
    """Raw density at a jittered position in each cell, in chunks of cells.
    density_fn(pos, start) maps the warped positions (n, 3) in [0,1]^3 of
    cells start..start + n to (n,)."""
    out = torch.empty(indices.shape[0], device=indices.device)
    span = aabb_max - aabb_min
    for i in range(0, indices.shape[0], chunk):
        pos = cell_positions(indices[i:i + chunk], jitter[i:i + chunk])
        out[i:i + chunk] = density_fn((pos - aabb_min) / span, i)
    return out


def splat_and_ema(density_grid: torch.Tensor, indices: torch.Tensor,
                  densities: torch.Tensor, decay: float = 0.95
                  ) -> torch.Tensor:
    """Max-splat optical thickness into cells, then the max-EMA merge;
    untrained (negative) cells stay as they are."""
    tmp = torch.zeros_like(density_grid).scatter_reduce_(
        0, indices, densities * MIN_CONE_STEPSIZE, reduce="amax")
    return torch.where(density_grid < 0.0, density_grid,
                       torch.maximum(density_grid * decay, tmp))


def density_grid_mean(density_grid: torch.Tensor) -> torch.Tensor:
    """Mean clamped density over the first cascade only."""
    return density_grid[:NERF_GRID_N_CELLS].clamp(min=0.0).mean()


def _pooled_centre_index(device) -> torch.Tensor:
    """Morton index, in mip m, of the cell that max-pools child block i of
    mip m-1's centre 64^3 (the pooled block sits at coordinates +32)."""
    x, y, z = morton3d_coords(torch.arange(64 ** 3, device=device))
    q = NERF_GRIDSIZE // 4
    return morton3d(x + q, y + q, z + q)


def update_bitfield(density_grid: torch.Tensor, max_cascade: int
                    ) -> torch.Tensor:
    """Density grid -> packed bitfield of all NERF_CASCADES mips (cascades
    above max_cascade hold only the pooled bits of the one below)."""
    thresh = torch.clamp(density_grid_mean(density_grid),
                         max=NERF_MIN_OPTICAL_THICKNESS)
    n = NERF_GRID_N_CELLS
    occupied = density_grid > thresh
    n_present = density_grid.shape[0] // n
    centre = _pooled_centre_index(density_grid.device)
    levels = [occupied[:n]]
    for m in range(1, NERF_CASCADES):
        if m < n_present and m <= max_cascade:
            level = occupied[m * n:(m + 1) * n].clone()
        else:
            level = torch.zeros(n, dtype=torch.bool,
                                device=density_grid.device)
        # the 8 children of a cell are Morton-contiguous
        level[centre] |= levels[-1].view(-1, 8).any(dim=-1)
        levels.append(level)
    return pack_bitfield(torch.cat(levels))


def pack_bitfield(occupied: torch.Tensor) -> torch.Tensor:
    """(n,) bool occupancy in Morton order, n a multiple of 8 -> (n / 8,)
    uint8 bitfield, cell i at bit i % 8 of byte i // 8."""
    bits = occupied.view(-1, 8).to(torch.uint8)
    shifts = torch.arange(8, dtype=torch.uint8, device=bits.device)
    return (bits << shifts).sum(dim=-1, dtype=torch.uint8)


def shell_bitfield(device, radius: float = 0.22, cells: float = 2.0
                   ) -> torch.Tensor:
    """The bitfield of a spherical shell: in cascade 0, the cells whose
    centre lies within `cells` cell widths of the sphere of `radius` about
    the unit box's centre; the other cascades empty. It is the occupancy
    of the render benchmark's orbit scene, an unterminated shell."""
    c = torch.arange(NERF_GRIDSIZE, device=device)
    x, y, z = torch.meshgrid(c, c, c, indexing="ij")
    centre = (torch.stack([x, y, z], -1).float() + 0.5) / NERF_GRIDSIZE
    near = (torch.linalg.norm(centre - 0.5, dim=-1) - radius).abs() \
        <= cells / NERF_GRIDSIZE
    occupied = torch.zeros(NERF_CASCADES * NERF_GRID_N_CELLS,
                           dtype=torch.bool, device=device)
    occupied[morton3d(x, y, z).reshape(-1)] = near.reshape(-1)
    return pack_bitfield(occupied)
