"""Foveated-rendering warp and motion vectors as pure functions
(counterpart of instant_ngp_tpu/foveation.py; instant-ngp's
common_device.cuh):
- `PiecewiseQuadratic`: a warp of [0, 1] that is linear (slope `am`) in a
  centre band and quadratic towards the edges, solved by the same 20-step
  bisection; `Foveation` one per axis;
- `motion_vectors`: the displacement to the previous frame of the point
  each pixel sees at a given depth (perspective lens);
- `to_ndc_depth`: reverse-z hyperbolic depth.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass
class PiecewiseQuadratic:
    al: float = 0.0
    bl: float = 0.0
    cl: float = 0.0
    am: float = 1.0
    bm: float = 0.0
    ar: float = 0.0
    br: float = 0.0
    cr: float = 0.0
    switch_left: float = 0.0
    switch_right: float = 1.0
    inv_switch_left: float = 0.0
    inv_switch_right: float = 1.0

    @classmethod
    def solve(cls, center_pixel_steepness: float,
              center_inverse_piecewise_y: float, center_radius: float
              ) -> "PiecewiseQuadratic":
        am = center_pixel_steepness
        center_inv_radius = center_radius * center_pixel_steepness
        left_sw = max(center_inverse_piecewise_y - center_inv_radius, 0.0)
        right_sw = min(center_inverse_piecewise_y + center_inv_radius, 1.0)
        d = (right_sw - left_sw) / am / 2

        m_min, m_max = 0.0, 1.0
        bm = 0.0
        for _ in range(20):
            m = (m_min + m_max) / 2
            l = m - d
            r = m + d
            bm = -((am - 1) * l * l) / (r * r - 2 * r + l * l + 1)
            l_actual = (left_sw - bm) / am
            r_actual = (right_sw - bm) / am
            if (l_actual + r_actual) / 2 > m:
                m_min = m
            else:
                m_max = m

        l = (left_sw - bm) / am
        r = (right_sw - bm) / am
        if (l == 0.0 and r == 1.0) or am == 1.0:
            return cls()
        denom = r * r - 2 * r + l * l + 1
        out = cls(
            al=(am - 1) / denom,
            bl=(am * (r * r - 2 * r + 1) + am * l * l
                + (2 - 2 * am) * l) / denom,
            cl=0.0,
            am=am,
            bm=-((am - 1) * l * l) / denom,
            ar=-(am - 1) / denom,
            br=(am * (r * r + 1) - 2 * r + am * l * l) / denom,
            cr=-(am * r * r - r * r + (am - 1) * l * l) / denom,
            switch_left=l,
            switch_right=r,
        )
        out.inv_switch_left = out.am * l + out.bm
        out.inv_switch_right = out.am * r + out.bm
        return out

    def warp(self, x):
        x = np.clip(x, 0.0, 1.0)
        return np.where(
            x < self.switch_left,
            self.al * x * x + self.bl * x + self.cl,
            np.where(x > self.switch_right,
                     self.ar * x * x + self.br * x + self.cr,
                     self.am * x + self.bm))

    def unwarp(self, y):
        y = np.clip(y, 0.0, 1.0)
        def inv_quad(a, b, c):
            with np.errstate(invalid="ignore", divide="ignore"):
                return (np.sqrt(np.maximum(
                    -4 * a * c + 4 * a * y + b * b, 0.0)) - b) \
                    / np.where(a == 0, 1.0, 2 * a)
        return np.where(
            y < self.inv_switch_left, inv_quad(self.al, self.bl, self.cl),
            np.where(y > self.inv_switch_right,
                     inv_quad(self.ar, self.br, self.cr),
                     (y - self.bm) / self.am))

    def density(self, x):
        x = np.clip(x, 0.0, 1.0)
        return np.where(x < self.switch_left, 2 * self.al * x + self.bl,
                        np.where(x > self.switch_right,
                                 2 * self.ar * x + self.br, self.am))


@dataclasses.dataclass
class Foveation:
    warp_x: PiecewiseQuadratic = dataclasses.field(
        default_factory=PiecewiseQuadratic)
    warp_y: PiecewiseQuadratic = dataclasses.field(
        default_factory=PiecewiseQuadratic)

    @classmethod
    def make(cls, steepness: Tuple[float, float],
             inverse_y: Tuple[float, float], radius: Tuple[float, float]
             ) -> "Foveation":
        return cls(PiecewiseQuadratic.solve(steepness[0], inverse_y[0],
                                            radius[0]),
                   PiecewiseQuadratic.solve(steepness[1], inverse_y[1],
                                            radius[1]))

    def warp(self, uv: np.ndarray) -> np.ndarray:
        return np.stack([self.warp_x.warp(uv[..., 0]),
                         self.warp_y.warp(uv[..., 1])], -1)

    def unwarp(self, uv: np.ndarray) -> np.ndarray:
        return np.stack([self.warp_x.unwarp(uv[..., 0]),
                         self.warp_y.unwarp(uv[..., 1])], -1)

    def density(self, uv: np.ndarray) -> np.ndarray:
        return self.warp_x.density(uv[..., 0]) \
            * self.warp_y.density(uv[..., 1])


def to_ndc_depth(z, n: float, f: float):
    """Reverse-z hyperbolic depth in [1, 0] (common_device.cuh:594-606)."""
    z = np.clip(z, n, f)
    scale = n / (n - f)
    bias = -f * scale
    return np.clip((z * scale + bias) / z, 0.0, 1.0)


def motion_vectors(pixels: np.ndarray, depths: np.ndarray, resolution,
                   focal_length, camera: np.ndarray,
                   prev_camera: np.ndarray, screen_center=(0.5, 0.5)
                   ) -> np.ndarray:
    """Per-pixel displacement to the previous frame at the given depths
    (instant-ngp's motion_vector), perspective lens; on the host."""
    import torch

    from .camera import pos_to_uv, uv_to_ray

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32))

    res = np.asarray(resolution, np.float32)
    pxf = np.asarray(pixels, np.float32) + 0.5
    uv = pxf / res
    origins, dirs, _ = uv_to_ray(f32(uv), resolution, f32(focal_length),
                                 f32(camera), screen_center)
    pos = origins.numpy() + np.asarray(depths)[..., None] * dirs.numpy()
    prev_uv, _ = pos_to_uv(f32(pos), resolution, f32(focal_length),
                           f32(prev_camera), screen_center)
    return prev_uv.numpy() * res - pxf
