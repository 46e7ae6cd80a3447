"""The benchmark's inputs, made on the device from the seed.

- The orbit scene: a lambertian sphere (r = 0.22 at the unit box's
  centre) with an octant-checker albedo and a smooth band, lit from the
  camera, seen by pinhole cameras on an orbit of radius 0.85 that look at
  the centre (the scene of the repository's smoke test, ray-traced here in
  torch). The seed turns the orbit and permutes the elevations; the
  palette is fixed: every seed gets the same set of views and colours, so
  the work and the attainable quality stay the same.
- The orbit path of a viewer and the held-out views: cameras between the
  training ones.
- The procedural image: smooth gradients, a zone plate, hard-edged
  rectangles and stripes, flat discs (the smoke test's, in torch).
"""

from __future__ import annotations

import math
from typing import List, NamedTuple

import torch

CENTRE = 0.5
RADIUS = 0.22
PALETTE = ((0.9, 0.2, 0.2), (0.2, 0.9, 0.2), (0.2, 0.2, 0.9),
           (0.9, 0.9, 0.2), (0.9, 0.2, 0.9), (0.2, 0.9, 0.9),
           (0.95, 0.6, 0.2), (0.85, 0.85, 0.85))


def look_at(eye: torch.Tensor) -> torch.Tensor:
    """(3, 4) camera at `eye` looking at the box's centre, y up."""
    c = torch.full((3,), CENTRE, dtype=torch.float32, device=eye.device)
    up = torch.tensor([0.0, 1.0, 0.0], device=eye.device)
    f = c - eye
    f = f / torch.linalg.norm(f)
    r = torch.linalg.cross(f, up)
    r = r / torch.linalg.norm(r)
    u = torch.linalg.cross(f, r)
    return torch.stack([r, u, f, eye], dim=1)


def orbit(azimuths: torch.Tensor, elevations: torch.Tensor,
          radius: float) -> torch.Tensor:
    """(n, 3, 4) cameras on an orbit around the centre."""
    eye = CENTRE + radius * torch.stack(
        [torch.cos(azimuths) * torch.cos(elevations), torch.sin(elevations),
         torch.sin(azimuths) * torch.cos(elevations)], dim=-1)
    return torch.stack([look_at(e) for e in eye])


class Orbit(NamedTuple):
    cams: torch.Tensor         # (n, 3, 4) float32
    palette: torch.Tensor      # (8, 3)


def scene_orbit(n: int, radius: float, elevation: List[float],
                seed: int, device) -> Orbit:
    """The training cameras: evenly spaced azimuths turned by a seeded
    angle, elevations from a fixed evenly spaced set in a seeded order;
    the fixed palette."""
    gen = torch.Generator().manual_seed(seed)
    turn = float(torch.rand(1, generator=gen)) * 2 * math.pi / n
    order = torch.randperm(n, generator=gen)
    lo, hi = elevation
    elev = lo + (hi - lo) * (order.double() + 0.5) / n
    az = torch.arange(n, dtype=torch.float64) * 2 * math.pi / n + turn
    palette = torch.tensor(PALETTE)
    return Orbit(orbit(az.float().to(device), elev.float().to(device),
                       radius), palette.to(device))


def between(scene: Orbit, n: int, radius: float,
            elevation: List[float]) -> torch.Tensor:
    """n cameras on the orbit (held-out views, a viewer's path), the first
    half a step of n past the first training camera, so none sits on a
    training camera; elevations sweep the range once up and down."""
    dev = scene.cams.device
    first = scene.cams[0, :3, 3] - CENTRE
    turn = math.atan2(float(first[2]), float(first[0]))
    k = torch.arange(n, dtype=torch.float64)
    az = turn + (k + 0.5) * 2 * math.pi / n
    lo, hi = elevation
    elev = lo + (hi - lo) * 0.5 * (1.0 - torch.cos(2 * math.pi * k / n))
    return orbit(az.float().to(dev), elev.float().to(dev), radius)


@torch.no_grad()
def trace_sphere(cam: torch.Tensor, size: int, focal: float,
                 palette: torch.Tensor):
    """-> (hit (H, W) bool, linear shade (H, W, 3)) through a pinhole."""
    dev = cam.device
    yy, xx = torch.meshgrid(torch.arange(size, device=dev, dtype=torch.float32)
                            + 0.5, torch.arange(size, device=dev,
                                                dtype=torch.float32) + 0.5,
                            indexing="ij")
    px, py = (xx - size / 2) / focal, (yy - size / 2) / focal
    dirs = torch.stack([px, py, torch.ones_like(xx)], -1) @ cam[:3, :3].T
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    oc = cam[:3, 3] - CENTRE
    b = dirs @ oc
    disc = b * b - (oc @ oc - RADIUS * RADIUS)
    t = -b - torch.sqrt(disc.clamp(min=0.0))
    hit = (disc > 0) & (t > 0)
    n = (cam[:3, 3] + dirs * t[..., None] - CENTRE) / RADIUS
    octant = ((n[..., 0] > 0).long() + (n[..., 1] > 0).long() * 2
              + (n[..., 2] > 0).long() * 4)
    band = 0.5 + 0.5 * torch.sin(12.0 * torch.arcsin(n[..., 1].clamp(-1, 1)))
    albedo = palette[octant] * (0.6 + 0.4 * band[..., None])
    lam = (-(n * dirs).sum(-1)).clamp(0.0, 1.0)
    return hit, albedo * (0.25 + 0.75 * lam[..., None])


def srgb(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x <= 0.0031308, x * 12.92,
                       1.055 * x.clamp(min=1e-12) ** (1 / 2.4) - 0.055)


@torch.no_grad()
def views_rgba8(scene: Orbit, size: int, focal: float) -> torch.Tensor:
    """(n, H, W, 4) uint8 sRGB views over transparent black."""
    out = torch.empty(scene.cams.shape[0], size, size, 4, dtype=torch.uint8,
                      device=scene.cams.device)
    for i, cam in enumerate(scene.cams):
        hit, shade = trace_sphere(cam, size, focal, scene.palette)
        img = torch.zeros(size, size, 4, device=cam.device)
        img[..., :3] = torch.where(hit[..., None], srgb(shade), 0.0)
        img[..., 3] = hit.float()
        out[i] = (img.clamp(0, 1) * 255).to(torch.uint8)
    return out


@torch.no_grad()
def ground_truth_srgb(cam: torch.Tensor, size: int, focal: float,
                      palette: torch.Tensor) -> torch.Tensor:
    """A held-out view in sRGB over black, (H, W, 3)."""
    hit, shade = trace_sphere(cam, size, focal, palette)
    return torch.where(hit[..., None], srgb(shade), 0.0).clamp(0, 1)


@torch.no_grad()
def shell_grid(cells: float, device) -> torch.Tensor:
    """(128^3,) occupancy values in Morton order: 1 for the cells whose
    centre lies within `cells` cell widths of the sphere's surface, else
    0."""
    from ..reference.nerf import GRIDSIZE, morton3d

    dev = device
    c = torch.arange(GRIDSIZE, device=dev)
    x, y, z = torch.meshgrid(c, c, c, indexing="ij")
    centre = (torch.stack([x, y, z], -1).float() + 0.5) / GRIDSIZE
    dist = (torch.linalg.norm(centre - CENTRE, dim=-1) - RADIUS).abs()
    near = dist <= cells / GRIDSIZE
    grid = torch.zeros(GRIDSIZE ** 3, device=dev)
    grid[morton3d(x, y, z).reshape(-1)] = near.reshape(-1).float()
    return grid


@torch.no_grad()
def procedural_image(side: int, seed: int, device) -> torch.Tensor:
    """(side, side, 3) linear float32 on `device`: one fixed picture, which
    the seed turns and mirrors (one of its eight symmetries), so every seed
    gets the same detail to fit."""
    fixed = torch.Generator().manual_seed(0)

    def uni(lo, hi, n=1):
        return (lo + (hi - lo) * torch.rand(n, generator=fixed,
                                            dtype=torch.float64)).tolist()

    ax = (torch.arange(side, device=device, dtype=torch.float32) + 0.5) / side
    v, u = torch.meshgrid(ax, ax, indexing="ij")
    img = torch.stack([0.15 + 0.7 * u, 0.15 + 0.7 * v,
                       0.5 + 0.35 * torch.sin(3.0 * u + 2.0 * v)], -1)
    r2 = (u - 0.75) ** 2 + (v - 0.25) ** 2
    zone = (0.5 + 0.45 * torch.cos(float(side) * 2.0 * r2))[..., None]
    img = torch.where((r2 < 0.22 ** 2)[..., None], zone, img)
    low_left = (u < 0.5) & (v > 0.5)
    for _ in range(40):
        x0, = uni(0.0, 0.45)
        y0, = uni(0.5, 0.95)
        w, h = uni(0.01, 0.1, 2)
        box = low_left & (u >= x0) & (u < x0 + w) & (v >= y0) & (v < y0 + h)
        img = torch.where(box[..., None],
                          torch.tensor(uni(0.0, 1.0, 3), device=device), img)
    stripes = (u > 0.5) & (v > 0.5) & ((torch.floor(u * side / 6) % 2) == 0)
    img = torch.where(stripes[..., None], img * 0.3, img)
    for _ in range(12):
        cx, cy = uni(0.05, 0.95, 2)
        rad, = uni(0.01, 0.05)
        disc = (u - cx) ** 2 + (v - cy) ** 2 < rad ** 2
        img = torch.where(disc[..., None],
                          torch.tensor(uni(0.0, 1.2, 3), device=device), img)
    turn = seed % 8
    img = torch.rot90(img, turn % 4, dims=(0, 1))
    if turn >= 4:
        img = torch.flip(img, dims=(1,))
    return img.contiguous()
