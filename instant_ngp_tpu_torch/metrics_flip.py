"""LDR-FLIP perceptual image metric [Andersson et al., HPG 2020] (own copy
of instant_ngp_tpu/metrics_flip.py; numpy, and scipy's convolve2d imported
where a channel is filtered).

Opponent-space CSF filtering, Hunt-adjusted L*a*b* HyAB colour difference
with error redistribution, and edge/point feature differences, combined as
c^(1-f). Every filter pads its channel by edge replication and then
convolves the valid part, so the output has the input's size. The default
viewing conditions are 0.7 m from a 0.7 m wide 4K monitor.
"""

from __future__ import annotations

import numpy as np

from .common import linear_to_srgb

_QC, _QF = 0.7, 0.5
_PC, _PT = 0.4, 0.95

# sRGB D65 linear-RGB -> XYZ (same rational coefficients as the paper code)
_RGB2XYZ = np.array([
    [10135552 / 24577794, 8788810 / 24577794, 4435075 / 24577794],
    [2613072 / 12288897, 8788810 / 12288897, 887015 / 12288897],
    [1425312 / 73733382, 8788810 / 73733382, 70074185 / 73733382],
])
_XYZ2RGB = np.linalg.inv(_RGB2XYZ)
_REF_ILLUMINANT = _RGB2XYZ @ np.ones(3)


def default_pixels_per_degree(monitor_distance=0.7, monitor_width=0.7,
                              monitor_resolution_x=3840) -> float:
    return monitor_distance * (monitor_resolution_x / monitor_width) \
        * (np.pi / 180)


def srgb_to_linear(x):
    return np.where(x > 0.04045, ((x + 0.055) / 1.055) ** 2.4, x / 12.92)


def linear_to_xyz(rgb):
    return np.einsum("ij,...j->...i", _RGB2XYZ, rgb)


def xyz_to_linear(xyz):
    return np.einsum("ij,...j->...i", _XYZ2RGB, xyz)


def xyz_to_ycxcz(xyz):
    n = xyz / _REF_ILLUMINANT
    y = 116 * n[..., 1] - 16
    cx = 500 * (n[..., 0] - n[..., 1])
    cz = 200 * (n[..., 1] - n[..., 2])
    return np.stack([y, cx, cz], axis=-1)


def ycxcz_to_xyz(ycc):
    y = (ycc[..., 0] + 16) / 116
    x = y + ycc[..., 1] / 500
    z = y - ycc[..., 2] / 200
    return np.stack([x, y, z], axis=-1) * _REF_ILLUMINANT


def xyz_to_lab(xyz):
    n = xyz / _REF_ILLUMINANT
    delta = 6 / 29
    f = np.where(n > 0.00885, np.cbrt(np.maximum(n, 0)),
                 n / (3 * delta * delta) + 4 / 29)
    l = 116 * f[..., 1] - 16
    a = 500 * (f[..., 0] - f[..., 1])
    b = 200 * (f[..., 1] - f[..., 2])
    return np.stack([l, a, b], axis=-1)


def _csf_filter(ppd: float, a1, b1, a2, b2, radius: int):
    dx = 1.0 / ppd
    x, y = np.meshgrid(np.arange(-radius, radius + 1),
                       np.arange(-radius, radius + 1))
    z = (x * dx) ** 2 + (y * dx) ** 2
    g = a1 * np.sqrt(np.pi / b1) * np.exp(-np.pi ** 2 * z / b1) \
        + a2 * np.sqrt(np.pi / b2) * np.exp(-np.pi ** 2 * z / b2)
    return g / g.sum()


def _filter_channel(img, kernel, radius):
    from scipy.signal import convolve2d

    pad = np.pad(img, radius, mode="edge")
    return convolve2d(pad, kernel, mode="valid")


def _spatially_filter(ycc, ppd: float):
    """CSF filtering in YCxCz; returns clamped linear RGB."""
    b_max = 0.04
    radius = int(np.ceil(3 * np.sqrt(b_max / (2 * np.pi ** 2)) * ppd))
    s_a = _csf_filter(ppd, 1, 0.0047, 0, 1e-5, radius)
    s_rg = _csf_filter(ppd, 1, 0.0053, 0, 1e-5, radius)
    s_by = _csf_filter(ppd, 34.1, 0.04, 13.5, 0.025, radius)
    filtered = np.stack([
        _filter_channel(ycc[..., 0], s_a, radius),
        _filter_channel(ycc[..., 1], s_rg, radius),
        _filter_channel(ycc[..., 2], s_by, radius)], axis=-1)
    rgb = xyz_to_linear(ycxcz_to_xyz(filtered))
    return np.clip(rgb, 0.0, 1.0)


def _hunt(lab):
    out = lab.copy()
    out[..., 1] *= 0.01 * lab[..., 0]
    out[..., 2] *= 0.01 * lab[..., 0]
    return out


def _hyab(a, b):
    d = a - b
    return np.abs(d[..., 0]) + np.linalg.norm(d[..., 1:], axis=-1)


def _features(y_norm, ppd: float, kind: str):
    sd = 0.5 * 0.082 * ppd
    radius = int(np.ceil(3 * sd))
    x, y = np.meshgrid(np.arange(-radius, radius + 1),
                       np.arange(-radius, radius + 1))
    g = np.exp(-(x ** 2 + y ** 2) / (2 * sd * sd))
    gx = (-x * g) if kind == "edge" else (x ** 2 / (sd * sd) - 1) * g
    gx = np.where(gx < 0, gx / -gx[gx < 0].sum(), gx / gx[gx > 0].sum())
    fx = _filter_channel(y_norm, gx, radius)
    fy = _filter_channel(y_norm, gx.T, radius)
    return np.stack([fx, fy], axis=-1)


def compute_flip(reference_srgb: np.ndarray, test_srgb: np.ndarray,
                 pixels_per_degree: float = None) -> np.ndarray:
    """Per-pixel FLIP error in [0, 1]; inputs are (H, W, 3) sRGB."""
    ppd = pixels_per_degree or default_pixels_per_degree()
    ref = xyz_to_ycxcz(linear_to_xyz(srgb_to_linear(reference_srgb)))
    tst = xyz_to_ycxcz(linear_to_xyz(srgb_to_linear(test_srgb)))

    # color pipeline
    ref_lab = _hunt(xyz_to_lab(linear_to_xyz(_spatially_filter(ref, ppd))))
    tst_lab = _hunt(xyz_to_lab(linear_to_xyz(_spatially_filter(tst, ppd))))
    de_hyab = _hyab(ref_lab, tst_lab)
    green = _hunt(xyz_to_lab(linear_to_xyz(np.array([[[0.0, 1.0, 0.0]]]))))
    blue = _hunt(xyz_to_lab(linear_to_xyz(np.array([[[0.0, 0.0, 1.0]]]))))
    cmax = float((_hyab(green, blue) ** _QC)[0, 0])
    power_de = de_hyab ** _QC
    pccmax = _PC * cmax
    de_c = np.where(power_de < pccmax, (_PT / pccmax) * power_de,
                    _PT + ((power_de - pccmax) / (cmax - pccmax))
                    * (1.0 - _PT))

    # feature pipeline
    ref_y = (ref[..., 0] + 16) / 116
    tst_y = (tst[..., 0] + 16) / 116
    de_f = np.maximum(
        np.abs(np.linalg.norm(_features(ref_y, ppd, "edge"), axis=-1)
               - np.linalg.norm(_features(tst_y, ppd, "edge"), axis=-1)),
        np.abs(np.linalg.norm(_features(tst_y, ppd, "point"), axis=-1)
               - np.linalg.norm(_features(ref_y, ppd, "point"), axis=-1)))
    de_f = ((1 / np.sqrt(2)) * de_f) ** _QF

    return de_c ** (1 - de_f)


def compute_flip_error_map(img_linear: np.ndarray, ref_linear: np.ndarray
                           ) -> np.ndarray:
    """FLIP of two linear-RGB images (H, W, >= 3): each converted to sRGB
    after clamping at 0, clipped to [0, 1]."""
    ref = np.clip(linear_to_srgb(np.maximum(ref_linear[..., :3], 0)), 0, 1)
    img = np.clip(linear_to_srgb(np.maximum(img_linear[..., :3], 0)), 0, 1)
    return compute_flip(ref, img)
