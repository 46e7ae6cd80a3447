"""Render buffer: progressive accumulation, tonemapping, overlays, and the
dynamic-resolution controller (counterpart of
instant_ngp_tpu/render_buffer.py; instant-ngp's src/render_buffer.cu and
testbed.cu's resolution loop).

Host-side numpy: float32 accumulation of jittered samples, the Identity,
ACES, Hable and Reinhard tonemap curves as one rational polynomial, sRGB or
linear output, ground-truth and false-colour error overlays.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .common import TonemapCurve, linear_to_srgb


def tonemap_curve(x: np.ndarray, curve: TonemapCurve) -> np.ndarray:
    """Rational-polynomial tonemap (render_buffer.cu:268-325)."""
    if curve == TonemapCurve.Identity:
        return x
    x = np.maximum(x, 0.0)
    if curve == TonemapCurve.ACES:
        k0 = 0.6 * 0.6 * 2.51
        k1 = 0.6 * 0.03
        k2 = 0.0
        k3 = 0.6 * 0.6 * 2.43
        k4 = 0.6 * 0.59
        k5 = 0.14
    elif curve == TonemapCurve.Hable:
        A, B, C, D, E, F = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30
        k0 = A * F - A * E
        k1 = C * B * F - B * E
        k2 = 0.0
        k3 = A * F
        k4 = B * F
        k5 = D * F * F
        W = 11.2
        white_scale = (k3 * W * W + k4 * W + k5) / (k0 * W * W + k1 * W + k2)
        k0 = 4.0 * k0 * white_scale
        k1 = 2.0 * k1 * white_scale
        k2 = k2 * white_scale
        k3 = 4.0 * k3
        k4 = 2.0 * k4
    else:  # Reinhard: luminance-normalized
        lum = np.array([0.2126, 0.7152, 0.0722])
        y = np.einsum("...c,c->...", x, lum)[..., None]
        return x / (1.0 + y)
    nom = x * (k0 * x + k1) + k2
    denom = x * (k3 * x + k4) + k5
    return nom / denom


class RenderBuffer:
    """Accumulating frame buffer with spp tracking."""

    def __init__(self, width: int, height: int):
        self.resize(width, height)
        self.tonemap = TonemapCurve.Identity
        self.exposure = 0.0

    def resize(self, width: int, height: int) -> None:
        self.width = width
        self.height = height
        self.accumulation = np.zeros((height, width, 4), np.float32)
        self.depth = np.zeros((height, width), np.float32)
        self.spp = 0

    def reset_accumulation(self) -> None:
        self.accumulation[:] = 0
        self.depth[:] = 0
        self.spp = 0

    def accumulate(self, frame: np.ndarray,
                   depth: Optional[np.ndarray] = None) -> None:
        """Running mean over samples (accumulate_kernel semantics)."""
        n = self.spp
        self.accumulation = (self.accumulation * n + frame) / (n + 1)
        if depth is not None:
            self.depth = (self.depth * n + depth) / (n + 1)
        self.spp = n + 1

    def framebuffer(self, srgb: bool = True) -> np.ndarray:
        """Tonemapped output (H, W, 4)."""
        out = self.accumulation.copy()
        scale = 2.0 ** self.exposure
        out[..., :3] = tonemap_curve(out[..., :3] * scale, self.tonemap)
        if srgb:
            out[..., :3] = linear_to_srgb(np.clip(out[..., :3], 0, 1))
        return out

    # -- overlays (render_buffer.cu overlay_* kernels) ------------------
    def overlay_image(self, gt: np.ndarray, alpha: float = 1.0,
                      split_x: Optional[int] = None) -> np.ndarray:
        """Ground-truth overlay: left half GT, right half render (or
        alpha blend when split_x is None)."""
        out = self.framebuffer()
        gt = np.asarray(gt, np.float32)
        if gt.shape[-1] == 3:
            gt = np.concatenate([gt, np.ones((*gt.shape[:2], 1))], -1)
        gt_srgb = gt.copy()
        gt_srgb[..., :3] = linear_to_srgb(np.clip(gt[..., :3], 0, 1))
        if split_x is not None:
            out[:, :split_x] = gt_srgb[:, :split_x]
        else:
            out = out * (1 - alpha) + gt_srgb * alpha
        return out

    def overlay_false_color(self, gt: np.ndarray, scale: float = 10.0
                            ) -> np.ndarray:
        """False-color |render - gt| error visualization."""
        err = np.abs(self.accumulation[..., :3]
                     - np.asarray(gt, np.float32)[..., :3]).mean(-1)
        v = np.clip(err * scale, 0, 1)
        rgb = np.stack([v, 1.0 - np.abs(2 * v - 1), 1.0 - v], -1)
        return np.concatenate([rgb, np.ones((*v.shape, 1))], -1)

    def overlay_depth(self, scale: float = 1.0) -> np.ndarray:
        v = np.clip(self.depth * scale, 0, 1)
        return np.stack([v, v, v, np.ones_like(v)], -1)


class DynamicResolution:
    """Render-resolution controller (testbed.cu:2884-2924).

    Scales the render resolution so the measured render time tracks a
    target frame rate: factor = sqrt(pixel_ratio / render_ms * 1000 /
    target_fps), clamped to [1/16, 1], with the reference's hysteresis
    (only apply a change when the linear resolution ratio leaves
    [0.8, 1.2], or when back at full res). Feed it the EMA-smoothed
    render time of the last frame; it returns the (w, h) to render next.
    """

    def __init__(self, full_resolution: Tuple[int, int],
                 target_fps: float = 30.0, enabled: bool = True,
                 fixed_res_factor: int = 8):
        self.full_resolution = tuple(full_resolution)
        self.target_fps = float(target_fps)
        self.enabled = enabled
        self.fixed_res_factor = fixed_res_factor  # 8/factor when disabled
        self._res = (max(full_resolution[0] // 16, 1),
                     max(full_resolution[1] // 16, 1))  # warmup: 1/256 px

    @property
    def resolution(self) -> Tuple[int, int]:
        return self._res

    def update(self, render_ms: Optional[float]) -> Tuple[int, int]:
        fw, fh = self.full_resolution
        n_pixels = self._res[0] * self._res[1]
        pixel_ratio = (1.0 / 256.0 if not render_ms or n_pixels == 0
                       else n_pixels / float(fw * fh))
        if self.enabled and render_ms:
            factor = float(np.sqrt(
                pixel_ratio / render_ms * 1000.0 / self.target_fps))
        else:
            factor = 8.0 / max(self.fixed_res_factor, 1)
        factor = float(np.clip(factor, 1.0 / 16.0, 1.0))

        new_res = (int(np.clip(fw * factor, fw // 16, fw)),
                   int(np.clip(fh * factor, fh // 16, fh)))
        ratio = np.sqrt(n_pixels / max(new_res[0] * new_res[1], 1))
        if ratio > 1.2 or ratio < 0.8 or factor == 1.0 or not self.enabled:
            self._res = new_res
        return self._res
