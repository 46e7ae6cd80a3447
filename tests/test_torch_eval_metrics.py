"""The port's `eval.py` and `metrics.py` against the JAX package's: every
metric of `compute_error_img` value for value (FLIP to 1e-5: numpy and
scipy on both sides), the ground truth over black, `eval_nerf_views` and
`eval_test_transforms` on a test split written to disk (PNG or EXR), and
`eval_psnr` of an HDR dataset, on the tiny testbeds of
tests/test_torch_nerf_extras.py (tests/torch_parity.py's `make_pair`;
scores to rtol 1e-3)."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from torch_parity import (MODES_CFG, feed_jax_draws,  # noqa: E402
                          lens_dataset, make_pair, port_lens_dataset,
                          set_knobs, sync_port)

from instant_ngp_tpu import eval as jeval
from instant_ngp_tpu import metrics as jmetrics
from instant_ngp_tpu.nerf.testbed_nerf import NerfTestbed as JaxTestbed
from instant_ngp_tpu_torch import eval as port_eval
from instant_ngp_tpu_torch import metrics
from instant_ngp_tpu_torch.nerf.testbed_nerf import NerfTestbed


# -- eval.py and metrics.py --------------------------------------------------
def test_metrics_match_jax_value_for_value():
    rng = np.random.default_rng(4)
    img = rng.uniform(-0.1, 1.3, (24, 20, 3)).astype(np.float32)
    ref = rng.uniform(0.0, 1.0, (24, 20, 3)).astype(np.float32)
    img[0, 0], img[1, 1] = np.nan, np.inf
    for name in ("luminance", "l1", "ape", "sape", "l2", "rse"):
        args = (ref,) if name == "luminance" else (ref * 0.9, ref)
        np.testing.assert_array_equal(getattr(metrics, name)(*args),
                                      getattr(jmetrics, name)(*args), name)
    np.testing.assert_array_equal(metrics.ssim(ref * 0.9, ref),
                                  jmetrics.ssim(ref * 0.9, ref))
    assert metrics.trim(ref, 0.01) == jmetrics.trim(ref, 0.01)
    assert metrics.mse(ref * 0.9, ref) == jmetrics.mse(ref * 0.9, ref)
    assert metrics.psnr(0.01) == jmetrics.psnr(0.01) == pytest.approx(20.0)
    for metric in ("MAE", "MAPE", "SMAPE", "MSE", "MScE", "MRSE", "MRScE",
                   "SSIM"):
        np.testing.assert_array_equal(
            metrics.compute_error_img(metric, img, ref),
            jmetrics.compute_error_img(metric, img, ref), metric)
        assert metrics.compute_error(metric, img, ref) == \
            jmetrics.compute_error(metric, img, ref), metric
    with pytest.raises(ValueError):
        metrics.compute_error("PSNR", img, ref)
    np.testing.assert_allclose(metrics.compute_error_img("FLIP", img, ref),
                               jmetrics.compute_error_img("FLIP", img, ref),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(metrics.compute_error("FLIP", img, ref),
                               jmetrics.compute_error("FLIP", img, ref),
                               rtol=1e-5)


def test_gt_srgb_on_black_matches_jax():
    rng = np.random.default_rng(5)
    ldr = rng.integers(0, 256, (6, 5, 4), dtype=np.uint8)
    hdr = rng.uniform(0, 2, (6, 5, 4)).astype(np.float16)
    for raw in (ldr, hdr):
        np.testing.assert_array_equal(port_eval.gt_srgb_on_black(raw),
                                      jeval.gt_srgb_on_black(raw))


@pytest.fixture(scope="module")
def trained_pair():
    jtb, tb = make_pair("extra_dims")
    jtb.train(6)
    sync_port(tb, jtb)
    return jtb, tb


def test_eval_nerf_views_matches_jax(trained_pair):
    jtb, tb = trained_pair
    kw = dict(indices=[0, 2], spp=1, downscale=2, verbose=False)
    ours, ref = port_eval.eval_nerf_views(tb, **kw), \
        jeval.eval_nerf_views(jtb, **kw)
    assert set(ours) == set(ref) and len(ours["psnr"]) == 2
    for k, v in ref.items():
        np.testing.assert_allclose(ours[k], v, rtol=1e-3, err_msg=k)
    assert 5.0 < ours["psnr_avg"] < 60.0 and 0.0 < ours["ssim_avg"] <= 1.0
    assert ours["psnr_min"] <= ours["psnr_avg"] <= ours["psnr_max"]


@pytest.mark.parametrize("hdr", [False, True], ids=["ldr", "hdr"])
def test_eval_test_transforms_and_hdr_psnr_match_jax(trained_pair, tmp_path,
                                                     hdr):
    """A test split written to disk (PNG or EXR frames) and scored by both
    packages through `load_nerf`; and `eval_psnr` on an HDR dataset."""
    import json

    from instant_ngp_tpu_torch.data.images import write_image

    jtb, tb = trained_pair
    rng = np.random.default_rng(6)
    frames = []
    for i in range(2):
        img = rng.uniform(0, 1, (16, 16, 4)).astype(np.float32)
        img[..., 3] = 1.0
        name = f"view_{i}" + (".exr" if hdr else ".png")
        write_image(str(tmp_path / name), img)
        m = np.eye(4)
        m[:3, 3] = [0.3 * i, 0.2, 2.0]
        frames.append({"file_path": name, "transform_matrix": m.tolist()})
    path = str(tmp_path / "transforms_test.json")
    with open(path, "w") as f:
        json.dump({"camera_angle_x": 0.8, "frames": frames, "k1": 0.02,
                   "k2": 0.001, "cx": 8.5, "cy": 7.5, "w": 16, "h": 16}, f)
    kw = dict(spp=1, limit=2, verbose=False)
    ours = port_eval.eval_test_transforms(tb, path, **kw)
    ref = jeval.eval_test_transforms(jtb, path, **kw)
    for k, v in ref.items():
        np.testing.assert_allclose(ours[k], v, rtol=1e-3, err_msg=k)
    assert len(ours["psnr"]) == 2
    if not hdr:
        return
    # an HDR dataset: float16 pixels, Exponential RGB, linear ground truth
    jds = lens_dataset("Perspective", 0)
    jds.images = [(im.astype(np.float32) / 255.0 * 1.5).astype(np.float16)
                  for im in jds.images]
    jds.is_hdr = True
    jhdr = JaxTestbed(jds, MODES_CFG, compute_dtype=jnp.float32)
    pds = port_lens_dataset(jds)
    pds.is_hdr = True
    thdr = NerfTestbed(pds, MODES_CFG, device="cpu",
                       compute_dtype=torch.float32)
    assert thdr.scene.rgb_activation == jhdr.scene.rgb_activation \
        == "Exponential"
    assert thdr.data.pixels.dtype == torch.float16
    for t in (jhdr, thdr):
        set_knobs(t)
    sync_port(thdr, jhdr)
    feed_jax_draws(thdr)
    np.testing.assert_allclose(thdr.train(1), jhdr.train(1), rtol=2e-3)
    np.testing.assert_allclose(thdr.eval_psnr(1, downscale=2),
                               jhdr.eval_psnr(1, downscale=2), rtol=1e-3)
