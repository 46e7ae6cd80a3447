"""Image I/O with the reference's colour conventions (own copy of
instant_ngp_tpu/data/images.py; `.bin` and float EXR files written by
either package read bit for bit in the other):
- LDR images (png/jpg/...) are sRGB; converted to linear, alpha premultiplied.
- EXR images are linear (the HDR path), loaded natively.
- `.bin` is the raw gigapixel format: int32 h, int32 w, h*w*4 float16.
PIL is imported only inside the functions that read or write an LDR file.
"""

from __future__ import annotations

import os
import struct
from typing import Tuple

import numpy as np

from ..common import linear_to_srgb, srgb_to_linear
from .exr import read_exr, write_exr


def read_bin_image(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        raw = f.read()
    h, w = struct.unpack("ii", raw[:8])
    return np.frombuffer(raw, dtype=np.float16, count=h * w * 4, offset=8) \
        .astype(np.float32).reshape(h, w, 4)


def write_bin_image(path: str, img: np.ndarray) -> None:
    img = np.asarray(img, np.float32)
    if img.shape[2] < 4:
        pad = np.ones((*img.shape[:2], 4 - img.shape[2]), np.float32)
        img = np.concatenate([img, pad], axis=-1)
    with open(path, "wb") as f:
        f.write(struct.pack("ii", img.shape[0], img.shape[1]))
        f.write(img.astype(np.float16).tobytes())


def read_ldr_image(path: str) -> np.ndarray:
    """Read an 8/16-bit image to float32 in [0,1], keeping channel count."""
    from PIL import Image

    Image.MAX_IMAGE_PIXELS = 10_000_000_000
    with Image.open(path) as im:
        arr = np.asarray(im)
    if arr.dtype == np.uint8:
        img = arr.astype(np.float32) / 255.0
    elif arr.dtype == np.uint16:
        img = arr.astype(np.float32) / 65535.0
    else:
        img = arr.astype(np.float32)
    if img.ndim == 2:
        img = img[:, :, None]
    return img


def read_image(path: str, *, linearize: bool = True) -> np.ndarray:
    """Read any supported image to linear float32 (H, W, C).

    Matches scripts/common.py:read_image: LDR inputs are sRGB→linear
    converted and alpha-premultiplied; EXR/.bin are already linear.
    """
    ext = os.path.splitext(path)[1].lower()
    if ext == ".bin":
        return read_bin_image(path)
    if ext == ".exr":
        img, _ = read_exr(path)
        return img
    img = read_ldr_image(path)
    if linearize:
        if img.shape[2] == 4:
            img = img.copy()
            img[..., :3] = srgb_to_linear(img[..., :3]) * img[..., 3:4]
        else:
            img = srgb_to_linear(img).astype(np.float32)
    return np.ascontiguousarray(img, np.float32)


def write_image(path: str, img: np.ndarray, quality: int = 95) -> None:
    """Write a linear float image; LDR outputs get alpha-unmultiply + sRGB."""
    ext = os.path.splitext(path)[1].lower()
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = img[:, :, None]
    if ext == ".bin":
        write_bin_image(path, img)
        return
    if ext == ".exr":
        write_exr(path, img)
        return
    out = img
    if out.shape[2] == 4:
        out = out.copy()
        alpha = out[..., 3:4]
        with np.errstate(divide="ignore", invalid="ignore"):
            rgb = np.where(alpha != 0, out[..., :3] / alpha, 0.0)
        out[..., :3] = linear_to_srgb(rgb)
    else:
        out = linear_to_srgb(out).astype(np.float32)
    arr = (np.clip(out, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    from PIL import Image

    if arr.shape[2] == 1:
        arr = arr[:, :, 0]
    kwargs = {}
    if ext in (".jpg", ".jpeg"):
        if arr.ndim == 3 and arr.shape[2] > 3:
            arr = arr[:, :, :3]
        kwargs = {"quality": quality, "subsampling": 0}
    Image.fromarray(arr).save(path, **kwargs)


def image_mse(a: np.ndarray, b: np.ndarray, quantize: bool = False) -> float:
    """MSE between two images; `quantize` mimics compute_image_mse's byte
    quantization option (testbed.h:649)."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    if quantize:
        a = np.floor(np.clip(a, 0, 1) * 255.0 + 0.5) / 255.0
        b = np.floor(np.clip(b, 0, 1) * 255.0 + 0.5) / 255.0
    return float(np.mean((a - b) ** 2))
