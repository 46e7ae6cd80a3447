"""Ray-marching math: Morton order, cascaded occupancy lookup, cone
stepping, AABB intersection (counterpart of instant_ngp_tpu/nerf/march.py).

- Morton (z-order) indices of the 128^3 cells of each cascade; the uint32
  arithmetic runs in int64 under 32-bit masks.
- Cascade m covers the cube of side 2^m centred at 0.5; a position's mip is
  the smallest cascade containing it, raised to the one whose cell size
  matches the step.
- The network's inputs are warped: positions into the unit cube of the
  aabb, directions from [-1, 1] to [0, 1] (and back).
- Cone stepping goes through the "stepping space" bijection: step k of a
  ray sits at from_stepping_space(s0 + k), so dt = calc_dt(t) is exact.

All functions are elementwise over tensors; vectors carry their xyz in a
trailing dimension of 3.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..common import (MAX_CONE_STEPSIZE, MIN_CONE_STEPSIZE, NERF_CASCADES,
                      NERF_GRID_N_CELLS, NERF_GRIDSIZE)

_M32 = 0xFFFFFFFF


def _expand_bits(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of v so consecutive bits are 3 apart."""
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton3d(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor
             ) -> torch.Tensor:
    """Interleave three 10-bit coordinates into a 30-bit Morton index."""
    xx = _expand_bits(x.long() & _M32)
    yy = _expand_bits(y.long() & _M32)
    zz = _expand_bits(z.long() & _M32)
    return xx | (yy << 1) | (zz << 2)


def morton3d_invert(i: torch.Tensor) -> torch.Tensor:
    """Gather every third bit of i (one axis of a Morton index)."""
    x = i.long() & 0x49249249
    x = (x | (x >> 2)) & 0xC30C30C3
    x = (x | (x >> 4)) & 0x0F00F00F
    x = (x | (x >> 8)) & 0xFF0000FF
    x = (x | (x >> 16)) & 0x000003FF
    return x


def morton3d_coords(idx: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return (morton3d_invert(idx), morton3d_invert(idx >> 1),
            morton3d_invert(idx >> 2))


def warp_position(pos, aabb_min, aabb_max):
    return (pos - aabb_min) / (aabb_max - aabb_min)


def unwarp_position(pos, aabb_min, aabb_max):
    return aabb_min + pos * (aabb_max - aabb_min)


def warp_direction(d):
    return (d + 1.0) * 0.5


def unwarp_direction(d):
    return d * 2.0 - 1.0


def cascaded_grid_idx_at(pos: torch.Tensor, mip: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """pos (..., 3), mip (...,) -> (Morton index within the mip, valid)."""
    mip_scale = torch.exp2(-mip.float())[..., None]
    p = (pos - 0.5) * mip_scale + 0.5
    i = torch.floor(p * NERF_GRIDSIZE).long()
    valid = ((i >= 0) & (i < NERF_GRIDSIZE)).all(dim=-1)
    i = i.clamp(0, NERF_GRIDSIZE - 1)
    return morton3d(i[..., 0], i[..., 1], i[..., 2]), valid


def density_grid_occupied_at(pos: torch.Tensor, bitfield: torch.Tensor,
                             mip: torch.Tensor) -> torch.Tensor:
    """bitfield: (NERF_CASCADES * 128^3 / 8,) uint8 -> occupied (...,)."""
    idx, valid = cascaded_grid_idx_at(pos, mip)
    byte = bitfield[idx // 8 + mip.long() * (NERF_GRID_N_CELLS // 8)]
    bit = (byte.long() >> (idx % 8)) & 1
    return valid & (bit != 0)


def mip_from_pos(pos: torch.Tensor, max_cascade: int) -> torch.Tensor:
    """Smallest cascade whose cube [0.5 +- 2^(m-1)] contains pos."""
    maxval = (pos - 0.5).abs().amax(dim=-1)
    _, exponent = torch.frexp(maxval)
    return (exponent + 1).clamp(0, max_cascade)


def mip_from_dt(dt: torch.Tensor, pos: torch.Tensor, max_cascade: int
                ) -> torch.Tensor:
    """At least the mip whose cell size matches the step dt."""
    mip = mip_from_pos(pos, max_cascade)
    d = dt * 2 * NERF_GRIDSIZE
    _, exponent = torch.frexp(d)
    return torch.where(d < 1.0, mip,
                       torch.maximum(mip, exponent).clamp(max=max_cascade))


def _stepping_constants(cone_angle: float, device) -> Tuple[torch.Tensor, ...]:
    """(log1p(c), a, b, at, bt) in float32, computed like the JAX package
    computes them (f32 scalars on the device)."""
    f32 = dict(dtype=torch.float32, device=device)
    log1p_c = torch.log1p(torch.tensor(cone_angle, **f32))
    a = (torch.log(torch.tensor(MIN_CONE_STEPSIZE, **f32))
         - torch.log(log1p_c)) / log1p_c
    b = (torch.log(torch.tensor(MAX_CONE_STEPSIZE, **f32))
         - torch.log(log1p_c)) / log1p_c
    return log1p_c, a, b, torch.exp(a * log1p_c), torch.exp(b * log1p_c)


def to_stepping_space(t: torch.Tensor, cone_angle: float) -> torch.Tensor:
    if cone_angle <= 1e-5:
        return t / MIN_CONE_STEPSIZE
    log1p_c, a, b, at, bt = _stepping_constants(cone_angle, t.device)
    exp_region = torch.log(t.clamp(min=1e-30)) / log1p_c
    return torch.where(
        t <= at, (t - at) / MIN_CONE_STEPSIZE + a,
        torch.where(t <= bt, exp_region, (t - bt) / MAX_CONE_STEPSIZE + b))


def from_stepping_space(n: torch.Tensor, cone_angle: float) -> torch.Tensor:
    if cone_angle <= 1e-5:
        return n * MIN_CONE_STEPSIZE
    log1p_c, a, b, at, bt = _stepping_constants(cone_angle, n.device)
    return torch.where(
        n <= a, (n - a) * MIN_CONE_STEPSIZE + at,
        torch.where(n <= b, torch.exp(torch.minimum(torch.maximum(n, a), b)
                                      * log1p_c),
                    (n - b) * MAX_CONE_STEPSIZE + bt))


def advance_n_steps(t: torch.Tensor, cone_angle: float, n) -> torch.Tensor:
    return from_stepping_space(to_stepping_space(t, cone_angle) + n,
                               cone_angle)


def calc_dt(t: torch.Tensor, cone_angle: float) -> torch.Tensor:
    return advance_n_steps(t, cone_angle, 1.0) - t


def warp_dt(dt: torch.Tensor) -> torch.Tensor:
    """Step size -> [0, 1] over the range of cone step sizes."""
    max_stepsize = MIN_CONE_STEPSIZE * (1 << (NERF_CASCADES - 1))
    return (dt - MIN_CONE_STEPSIZE) / (max_stepsize - MIN_CONE_STEPSIZE)


def ray_intersect_aabb(o: torch.Tensor, d: torch.Tensor,
                       aabb_min: torch.Tensor, aabb_max: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(tmin, tmax) of rays (..., 3) against a box; tmin > tmax is a miss."""
    tiny = torch.where(d < 0, -1e-12, 1e-12)
    idir = 1.0 / torch.where(d.abs() < 1e-12, tiny, d)
    t1 = (aabb_min - o) * idir
    t2 = (aabb_max - o) * idir
    tmin = torch.minimum(t1, t2).amax(dim=-1)
    tmax = torch.maximum(t1, t2).amin(dim=-1)
    return tmin, tmax


def aabb_contains(pos: torch.Tensor, aabb_min: torch.Tensor,
                  aabb_max: torch.Tensor) -> torch.Tensor:
    """Whether each position (..., 3) lies in the closed box."""
    return ((pos >= aabb_min) & (pos <= aabb_max)).all(dim=-1)
