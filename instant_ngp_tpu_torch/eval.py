"""NeRF eval harness: the `--test_transforms` loop of the reference's run
script as a library function (counterpart of instant_ngp_tpu/eval.py).

- the GIVEN transforms file is loaded, its cameras AND its images;
- each view renders at spp 8 over BLACK with minimum transmittance 1e-4,
  through the view's own lens and principal point;
- the metrics are taken in sRGB on the image composited onto black:
  per-view and aggregate PSNR (average, minimum, maximum) and SSIM. The
  FLIP metric is not ported.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import numpy as np


def gt_srgb_on_black(gt_raw: np.ndarray) -> np.ndarray:
    """(H, W, 4) uint8|float -> (H, W, 3) sRGB composited onto black.

    uint8 images are sRGB with straight alpha; float (HDR) images are
    linear, premultiplied."""
    from .common import linear_to_srgb

    if gt_raw.dtype == np.uint8:
        rgb = gt_raw[..., :3].astype(np.float32) / 255.0
        alpha = gt_raw[..., 3:4].astype(np.float32) / 255.0
        return rgb * alpha
    rgb = np.asarray(gt_raw[..., :3], np.float32)
    return linear_to_srgb(np.clip(rgb, 0.0, 1.0))


def eval_nerf_views(testbed, data=None, indices: Optional[List[int]] = None,
                    spp: int = 8, downscale: int = 1,
                    min_transmittance: float = 1e-4,
                    verbose: bool = True) -> Dict[str, Any]:
    """Render each view of `data` (a NerfTrainingData; by default the
    testbed's own training data) through its camera and lens and compare it
    with its image.

    -> {"psnr": [...], "ssim": [...], "psnr_avg", "psnr_min", "psnr_max",
    "ssim_avg"}."""
    from .metrics import ssim as ssim_map

    if data is None:
        data = testbed.data
    if indices is None:
        indices = list(range(data.n_images))

    psnrs, ssims = [], []
    for i in indices:
        w0, h0 = (int(v) for v in data.resolutions[i].tolist())
        w, h = w0 // downscale, h0 // downscale
        fl = data.focal_lengths[i].cpu().numpy() * np.array(
            [w / w0, h / h0], np.float32)
        cam = data.xforms_start[i].cpu().numpy()
        render = testbed.render_frame(
            w, h, cam, fl, spp=spp,
            min_transmittance=min_transmittance,
            background_color=(0.0, 0.0, 0.0),
            lens_mode=testbed.scene.lens_mode,
            lens_params=data.lens_params[i],
            screen_center=data.principal_points[i].tolist())
        pred = np.clip(render[..., :3], 0.0, 1.0)

        gt = gt_srgb_on_black(data.pixels[i, :h0, :w0].cpu().numpy())
        if downscale != 1:
            # area-average (not decimation): rendered pixel i spans the
            # source block [i*ds,(i+1)*ds), ray through the block center
            ds = downscale
            gt = gt[:h * ds, :w * ds].reshape(h, ds, w, ds, 3) \
                .mean(axis=(1, 3))

        mse = float(np.mean((pred - gt) ** 2))
        p = -10.0 * math.log10(max(mse, 1e-20))
        s = float(np.mean(ssim_map(gt, pred)))
        psnrs.append(p)
        ssims.append(s)
        if verbose:
            print(f"  view {i}: PSNR {p:.2f} SSIM {s:.4f}", flush=True)

    return {
        "psnr": psnrs, "ssim": ssims,
        "psnr_avg": float(np.mean(psnrs)), "psnr_min": float(np.min(psnrs)),
        "psnr_max": float(np.max(psnrs)), "ssim_avg": float(np.mean(ssims)),
    }


def eval_test_transforms(testbed, transforms_path: str, spp: int = 8,
                         limit: int = 0, downscale: int = 1,
                         verbose: bool = True) -> Dict[str, Any]:
    """Load `transforms_path` as an eval dataset (its cameras and its
    images, not the training dataset's) and score every view of it with
    `eval_nerf_views` (the first `limit` views where limit > 0)."""
    from .data.nerf_loader import load_nerf
    from .nerf.dataset import pack_training_data

    ds = load_nerf(transforms_path)
    data = pack_training_data(ds, testbed.device)
    indices = list(range(data.n_images if not limit
                         else min(limit, data.n_images)))
    return eval_nerf_views(testbed, data, indices, spp=spp,
                           downscale=downscale, verbose=verbose)
