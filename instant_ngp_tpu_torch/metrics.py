"""Image quality metrics: MSE / PSNR, SSIM and the L1 / APE / SAPE / RSE
families (own copy of instant_ngp_tpu/metrics.py, value for value): the
same luminance weights, 5-tap SSIM blur, 1e-2 relative-error epsilons and
trim fraction. scipy is imported only inside the blur. The FLIP metric
lives in metrics_flip.py.
"""

from __future__ import annotations

import numpy as np


def luminance(a: np.ndarray) -> np.ndarray:
    return 0.2126 * a[..., 0] + 0.7152 * a[..., 1] + 0.0722 * a[..., 2]


def _blur5(a: np.ndarray) -> np.ndarray:
    """Separable 5-tap Gaussian blur."""
    from scipy.ndimage import convolve1d

    k = np.array([0.120078, 0.233881, 0.292082, 0.233881, 0.120078])
    return convolve1d(convolve1d(a, k, axis=0), k, axis=1)


def ssim(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Per-pixel SSIM map on luminance."""
    a = luminance(np.clip(a, 0.0, 1.0))
    b = luminance(np.clip(b, 0.0, 1.0))
    m_a, m_b = _blur5(a), _blur5(b)
    s_a = _blur5(a * a) - m_a ** 2
    s_b = _blur5(b * b) - m_b ** 2
    s_ab = _blur5(a * b) - m_a * m_b
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    p1 = (2.0 * m_a * m_b + c1) / (m_a * m_a + m_b * m_b + c1)
    p2 = (2.0 * s_ab + c2) / (s_a + s_b + c2)
    return p1 * p2


def l1(img, ref):
    return np.abs(img - ref)


def ape(img, ref):
    return l1(img, ref) / (1e-2 + ref)


def sape(img, ref):
    return l1(img, ref) / (1e-2 + (ref + img) / 2.0)


def l2(img, ref):
    return (img - ref) ** 2


def rse(img, ref):
    return l2(img, ref) / (1e-2 + ref ** 2)


def trim(error: np.ndarray, skip: float = 0.000001) -> float:
    error = np.sort(error.flatten())
    n_skip = int(skip * error.size)
    return float(error[n_skip:error.size - n_skip].mean())


def mse(img, ref) -> float:
    return float(np.mean(l2(img, ref)))


def psnr(img_mse: float) -> float:
    """PSNR of [0,1]-range images from their MSE."""
    return float(-10.0 * np.log10(max(img_mse, 1e-20)))


def compute_error_img(metric: str, img: np.ndarray, ref: np.ndarray
                      ) -> np.ndarray:
    """Per-pixel error map by metric name."""
    img = np.array(img, np.float32, copy=True)
    img[~np.isfinite(img)] = 0
    img = np.maximum(img, 0.0)
    if metric == "MAE":
        return l1(img, ref)
    if metric == "MAPE":
        return ape(img, ref)
    if metric == "SMAPE":
        return sape(img, ref)
    if metric == "MSE":
        return l2(img, ref)
    if metric == "MScE":
        return l2(np.clip(img, 0.0, 1.0), np.clip(ref, 0.0, 1.0))
    if metric == "MRSE":
        return rse(img, ref)
    if metric == "MRScE":
        return rse(np.clip(img, 0, 100), np.clip(ref, 0, 100))
    if metric == "SSIM":
        return ssim(img, ref)
    if metric == "FLIP":
        from .metrics_flip import compute_flip_error_map

        return compute_flip_error_map(img, ref)
    raise ValueError(f"unknown metric: {metric}")


def compute_error(metric: str, img: np.ndarray, ref: np.ndarray) -> float:
    error_map = np.asarray(compute_error_img(metric, img, ref))
    error_map = np.array(error_map, copy=True)
    error_map[~np.isfinite(error_map)] = 0
    if error_map.ndim == 3:
        error_map = np.mean(error_map, axis=2)
    return float(np.mean(error_map))
