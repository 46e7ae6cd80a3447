"""Image metrics (counterpart of instant_ngp_tpu/metrics.py::mse, psnr)."""

from __future__ import annotations

import numpy as np


def mse(img, ref) -> float:
    return float(np.mean((np.asarray(img) - np.asarray(ref)) ** 2))


def psnr(img_mse: float) -> float:
    """PSNR of [0,1]-range images from their MSE."""
    return float(-10.0 * np.log10(max(img_mse, 1e-20)))
