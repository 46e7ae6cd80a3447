"""The port's Image mode against the JAX package's `ImageTestbed`, on a
small procedural image (32 x 24, linear RGB with values past 1 and at 0)
and a small network of configs/image/base.json's form (HashGrid 2D, L=4,
F=2, 2^10 entries a level, 32-wide MLP), loaded with the JAX testbed's
seeded weights (the image and the configuration: tests/torch_parity.py's
`image` and `IMAGE_CFG`).

JAX's random numbers (threefry) are not torch's: the port's testbed takes
the reference's own draws through its `draws` hook, the uniform positions
each step draws from `fold_in(PRNGKey(seed), step)` and the corner draws
of the stochastic encode from `fold_in(key, 0x5C)`. Halton and Sobol
positions are a function of the step and must match exactly.

Tolerances:
- `_fetch_targets`: a few float32 operations, rtol/atol 1e-6;
- the 2D grid encode (exact and stochastic, hashed levels): 1e-6 forward,
  1e-5 for the table gradient (sums of up to a few hundred deposits);
- 4 train steps at bf16 compute across `stochastic_corners_until` = 2:
  losses at rtol 2e-3 (bf16 rounding of operands that differ in their last
  float32 bit, amplified by Adam's eps of 1e-15 in near-zero gradients);
- renders and `compute_mse` of identical weights at float32 compute:
  1e-5; a 64 x 64 render after a snapshot crosses packages: 2e-3 (bf16).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import IMAGE_CFG, image, jax_corner_draws

from instant_ngp_tpu.data.snapshot import load_snapshot as jax_load_snapshot
from instant_ngp_tpu.image import ImageTestbed as JaxImageTestbed
from instant_ngp_tpu.ops.grid_encoding import GridEncoding as JaxGrid
from instant_ngp_tpu_torch.data.snapshot import load_snapshot
from instant_ngp_tpu_torch.image.testbed_image import ImageTestbed
from instant_ngp_tpu_torch.ops.grid_encoding import GridEncoding

BATCH = 256


def pair(compute="bf16", cfg=IMAGE_CFG, img=None):
    """(JAX testbed, port testbed with its weights and its draws)."""
    img = image() if img is None else img
    jtb = JaxImageTestbed(img, cfg, compute_dtype=jnp.float32
                          if compute == "f32" else jnp.bfloat16)

    def draws(step, n):
        key = jax.random.fold_in(jax.random.PRNGKey(jtb.seed), step)
        u = torch.from_numpy(np.asarray(jax.random.uniform(key, (n, 2)))
                             .copy())
        corners = jax_corner_draws(jax.random.fold_in(key, 0x5C), n, 2,
                                   tb.model.encoding.n_levels) \
            if tb._stoch_now() else None
        return u, corners

    tb = ImageTestbed(img, cfg, compute_dtype=torch.float32
                      if compute == "f32" else torch.bfloat16,
                      device="cpu", draws=draws)
    tb.trainer.load_state(tb.state, jax.tree_util.tree_map(
        np.asarray, jtb.state["params"]))
    return jtb, tb


def _positions(rng, n):
    x = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    x[:6] = [[0, 0], [1, 1], [1 - 1e-7, 0.5], [0.5, 1 - 1e-7], [0, 1],
             [1, 0]]
    return x


# -- targets ------------------------------------------------------------------
@pytest.mark.parametrize("snap", [True, False], ids=["snapped", "bilinear"])
def test_fetch_targets_matches_jax(snap):
    jtb, tb = pair("f32")
    x = _positions(np.random.default_rng(2), 2000)
    for linear in (False, True):
        jtb.snap_to_pixel_centers = tb.snap_to_pixel_centers = snap
        jtb.linear_colors = tb.linear_colors = linear
        ref_p, ref_t = jtb._fetch_targets(jtb.image, jnp.asarray(x))
        pos, targets = tb._fetch_targets(torch.from_numpy(x))
        np.testing.assert_allclose(pos.numpy(), np.asarray(ref_p),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(targets.numpy(), np.asarray(ref_t),
                                   rtol=1e-6, atol=1e-6)


def test_2d_grid_with_hashed_levels_matches_jax():
    """configs/image/base.json's grid (L=16, F=2, base 16) for a 256^2
    image at a small table: the upper levels are hashed. Exact encode and
    its table gradient, and the stochastic one (one sampled corner a
    level, no exact axis) from the reference's corner draws."""
    cfg = dict(IMAGE_CFG["encoding"], n_levels=16, base_resolution=16,
               per_level_scale=float(np.exp(np.log(128 / 16) / 15)))
    kw = dict(n_dims=2, n_levels=16, n_features_per_level=2,
              log2_hashmap_size=10, base_resolution=16,
              per_level_scale=cfg["per_level_scale"])
    jenc, enc = JaxGrid(**kw), GridEncoding(**kw)
    hashed = [lvl[4] for lvl in enc.levels]
    assert any(hashed) and not all(hashed)
    rng = np.random.default_rng(3)
    table = rng.uniform(-1, 1, enc.n_params).astype(np.float32)
    with torch.no_grad():
        enc.params.copy_(torch.from_numpy(table))
    n = 500
    x = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    cot = rng.normal(size=(n, 32)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    draws = jax_corner_draws(key, n, 2, 16)
    comps = [jnp.asarray(x[:, 0]), jnp.asarray(x[:, 1])]
    enc.params.requires_grad_(True)
    for rng_key, d in ((None, None), (key, draws)):
        def f(t):
            return jenc.apply_components(t, comps, rng=rng_key)
        ref = np.asarray(f(jnp.asarray(table)))
        ref_g = np.asarray(jax.grad(lambda t: jnp.sum(
            f(t) * jnp.asarray(cot)))(jnp.asarray(table)))
        out = enc(torch.from_numpy(x), draws=d)
        (grad,) = torch.autograd.grad((out * torch.from_numpy(cot)).sum(),
                                      enc.params)
        np.testing.assert_allclose(out.detach().numpy(), ref, rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(grad.numpy(), ref_g, rtol=1e-5,
                                   atol=1e-5)


# -- training -----------------------------------------------------------------
@pytest.mark.parametrize("mode", ["Random", "Halton", "Sobol",
                                  "Stratified"])
def test_training_across_the_stochastic_switch_matches_jax(mode):
    jtb, tb = pair("bf16")
    jtb.random_mode = tb.random_mode = mode
    assert tb.stochastic_corners_until == 2 and tb._stoch_now()
    jl = [jtb.train(1, BATCH) for _ in range(4)]
    tl = [tb.train(1, BATCH) for _ in range(4)]
    np.testing.assert_allclose(tl, jl, rtol=2e-3)
    assert tb.training_step == jtb.training_step == 4
    assert not tb._stoch_now() and not jtb._stoch_now()
    assert tl[-1] < tl[0]


def test_train_never_crosses_the_switch_in_one_chunk():
    _, tb = pair("f32")
    chunks = []
    run = tb._train_chunk
    tb._train_chunk = lambda n, b: (chunks.append((tb._stoch_now(), n)),
                                    run(n, b))[1]
    loss = tb.train(5, 64)
    assert chunks == [(True, 2), (False, 3)] and tb.training_step == 5
    assert np.isfinite(loss) and loss == tb.loss_scalar
    tb.steps_per_dispatch = 4
    with pytest.raises(NotImplementedError, match="steps_per_dispatch"):
        tb.train(1, 64)


def test_the_default_device_is_the_card():
    if torch.cuda.is_available():
        tb = ImageTestbed(image(), IMAGE_CFG)
        assert tb.device.type == "cuda" and tb.image.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            ImageTestbed(image(), IMAGE_CFG)


# -- rendering and snapshots --------------------------------------------------
@pytest.mark.parametrize("linear", [False, True],
                         ids=["srgb", "linear_colors"])
def test_render_and_mse_match_jax(linear):
    jtb, tb = pair("f32")
    # set before the JAX testbed's first render: its jitted render is
    # specialised on the testbed object
    jtb.linear_colors = tb.linear_colors = linear
    tb.render_chunk = 100          # several chunks, rows of 32 pixels
    for w, h in ((20, 16), (32, 24)):
        ours, ref = tb.render(w, h), jtb.render(w, h)
        assert ours.shape == ref.shape == (h, w, 4)
        np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5)
    for quantize in (False, True):
        np.testing.assert_allclose(tb.compute_mse(quantize=quantize),
                                   jtb.compute_mse(quantize=quantize),
                                   rtol=1e-5)
    np.testing.assert_allclose(tb.psnr(), jtb.psnr(), rtol=1e-5)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_snapshot_crosses_packages(direction, tmp_path):
    """A snapshot written by one package loads in the other, and both
    render the same 64 x 64 image; optimizer state and step come along."""
    jtb, tb = pair("bf16")
    path = os.path.join(tmp_path, "image.ingp")
    if direction == "jax_to_port":
        jtb.train(3, BATCH)
        jtb.save_snapshot(path)
        tb.load_snapshot_state(load_snapshot(path))
    else:
        tb.train(3, BATCH)
        tb.save_snapshot(path)
        jtb.load_snapshot_state(jax_load_snapshot(path))
    assert tb.training_step == jtb.training_step == 3
    assert int(tb.state["opt"]["step"]) == int(jtb.state["opt"]["step"]) == 3
    np.testing.assert_allclose(tb.render(64, 64), jtb.render(64, 64),
                               atol=2e-3)
    np.testing.assert_allclose(
        tb.state["opt"]["v"]["net"][0].detach().numpy(),
        np.asarray(jtb.state["opt"]["v"]["net"][0]), rtol=1e-6, atol=1e-12)
