"""The port's NeRF training slice against the JAX package, on the tiny
synthetic dataset of tests/test_nerf_training.py (4 cameras of 32x32, L=4
hash grid with 2^12 entries, 32-wide MLPs, 256-1024 rays).

Both testbeds run with the JAX testbed's defaults unless a test says
otherwise: the stochastic-corner encode with base.json's keys (one exact
axis, one-corner backward) and error-map sampling; the cases named "exact"
switch both off on both sides. The JAX testbed runs its eager loop
(`steps_per_dispatch = 1`). Where JAX draws random numbers the port is
fed the same draws (tests/torch_parity.py makes them from the step's own
key splits), the sampled corners included, so a step is compared value
for value and not in expectation. The testbeds, their knobs and the step
assertion are tests/torch_parity.py's.

Tolerances, by what differs between the two sides:
- the composite alone (same raw inputs): summation order and ulps of
  exp/pow: rtol 2e-4 / atol 1e-7 on losses, rtol 2e-4 / atol 1e-8 on
  gradients, as the JAX package holds its own composite to the
  hand-derived backward;
- a full train step at float32: the same, through two MLPs and the
  scatter into the hash table: `m` and the loss to rtol 1e-3 (atol 1e-6 of
  values of order 1e-3), `v` to rtol 2e-3, the parameters and the EMA
  (steps of order 1e-2) to rtol 1e-3 / atol 2e-5 where the second moment
  is within 400x of the leaf's largest (see
  `torch_parity._assert_step_close`);
- at bf16 compute the backward rounds at different points (XLA rounds
  cotangents of bf16 operands to bf16, autograd keeps them float32): loss
  to 2 %, `m` to 5 % of its largest entry.
The training switches are in tests/test_torch_training_switches.py, the
testbed's loop in tests/test_torch_testbed_train.py, its snapshots and
`eval_psnr` in tests/test_torch_testbed_snapshots.py."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_gradient_parity import (identity_samples, make_case,  # noqa: E402
                                  reference_backward)
from torch_parity import (DTYPES, TRAIN_CFG, _assert_step_close,  # noqa: E402
                          _port_case, _t, feed_jax_draws, jax_step,
                          make_jax_tb, make_port_tb)

from instant_ngp_tpu.common import LossType as JaxLossType
from instant_ngp_tpu.nerf import training as jtraining
from instant_ngp_tpu_torch.nerf import training
from instant_ngp_tpu_torch.nerf.dataset import scene_config
from instant_ngp_tpu_torch.nerf.sampler import RayBatch
from instant_ngp_tpu_torch.nerf.testbed_nerf import NerfTestbed
from instant_ngp_tpu_torch.ops import mlp as mlp_module
from instant_ngp_tpu_torch.ops.losses import LossType
from instant_ngp_tpu_torch.ops.mlp import MLP
from instant_ngp_tpu_torch.ops.optimizers import tree_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- the composite ---------------------------------------------------------
@pytest.mark.parametrize("loss_name", ["L2", "Huber"])
@pytest.mark.parametrize("rgb_act", ["Logistic", "Exponential"])
def test_composite_loss_matches_jax(rgb_act, loss_name):
    case = make_case(n_rays=6, k=8, seed=1)
    raw, mask, _, t_padded, jrays, bg, exposure, dts, rgba = case
    raw = raw.copy()
    raw[3, 2] += 8.0       # an opaque ray: the T < 1e-4 early-out cuts it
    raw[3, 4] -= 4.0       # a thin one: negative raw densities, L1 reg
    near, mean_density = 0.03, 0.001     # both regularizers on
    js = identity_samples(mask)

    def jax_loss(raw_flat):
        res = jtraining.composite_loss(
            tuple(raw_flat[i].reshape(-1) for i in range(4)), js,
            jnp.asarray(t_padded), jnp.asarray(dts), jrays, jnp.asarray(bg),
            jnp.asarray(exposure), rgb_act, "Exponential",
            JaxLossType[loss_name], jnp.asarray(mean_density), near)
        return res.loss_for_grad, res

    (ref_loss, ref), ref_grad = jax.value_and_grad(jax_loss, has_aux=True)(
        jnp.asarray(raw))

    samples, rays = _port_case(case, mask)
    raw_t = _t(raw.reshape(4, -1).T.copy()).requires_grad_(True)   # (S, 4)
    res = training.composite_loss(
        raw_t, samples, _t(t_padded), _t(dts), rays, _t(bg), _t(exposure),
        rgb_act, "Exponential", LossType[loss_name],
        torch.tensor(mean_density), near)
    (grad,) = torch.autograd.grad(res.loss_for_grad, raw_t)
    assert int(res.measured_compacted) == int(ref.measured_compacted) \
        < int(mask.sum())                       # the early-out did cut
    np.testing.assert_allclose(res.loss_for_grad.item(), float(ref_loss),
                               rtol=2e-4, atol=1e-7)
    np.testing.assert_allclose(res.per_ray_loss.detach().numpy(),
                               np.asarray(ref.per_ray_loss), rtol=2e-4,
                               atol=1e-7)
    np.testing.assert_allclose(res.rgb_rays.detach().numpy(),
                               np.stack([np.asarray(c)
                                         for c in ref.rgb_rays], -1),
                               rtol=2e-4, atol=1e-7)
    np.testing.assert_allclose(res.depth_rays.detach().numpy(),
                               np.asarray(ref.depth_rays), rtol=2e-4,
                               atol=1e-7)
    np.testing.assert_allclose(grad.numpy().T.reshape(raw.shape),
                               np.asarray(ref_grad), rtol=2e-4, atol=1e-8)
    # masked-off candidates and samples past the cutoff get no gradient
    assert (grad.numpy().T.reshape(raw.shape)[:, ~mask] == 0).all()


def test_composite_gradient_matches_hand_derived_backward():
    """The float64 backward of tests/test_gradient_parity.py (L2, Logistic
    colours, all rays finish, no regularizer)."""
    case = make_case()
    raw, mask, _, t_padded, _, bg, exposure, dts, rgba = case
    samples, rays = _port_case(case, mask)
    raw_t = _t(raw.reshape(4, -1).T.copy()).requires_grad_(True)
    res = training.composite_loss(
        raw_t, samples, _t(t_padded), _t(dts), rays, _t(bg), _t(exposure),
        "Logistic", "Exponential", LossType.L2, torch.tensor(1.0), 0.0)
    (grad,) = torch.autograd.grad(res.loss_for_grad, raw_t)
    g = grad.numpy().T.reshape(raw.shape)
    g_rgb_ref, g_sigma_ref = reference_backward(raw, mask, dts, rgba, bg)
    np.testing.assert_allclose(g[:3], g_rgb_ref, rtol=2e-4, atol=1e-8)
    np.testing.assert_allclose(g[3], g_sigma_ref, rtol=2e-4, atol=1e-8)


def test_composite_masking_and_guards():
    """Lanes without samples carry no loss, normalisation is by lanes, and
    no guard leaks a NaN: alpha 0 targets, a black background and an
    invalid lane give finite losses and gradients."""
    case = make_case(n_rays=5, k=6, seed=3)
    raw, mask, _, t_padded, _, bg, exposure, dts, rgba = case
    mask = mask.copy()
    mask[3] = False                       # a lane without samples
    rgba = rgba.copy()
    rgba[0] = 0.0                         # alpha 0: pure background target
    rgba[2, :3] = 0.0                     # a black, opaque target
    bg = bg.copy()
    bg[:3] = 0.0                          # black background
    samples, rays = _port_case(case, mask)
    valid = torch.ones(5, dtype=torch.bool)
    valid[4] = False
    rays = rays._replace(rgba=_t(rgba), valid=valid)
    raw_t = _t(raw.reshape(4, -1).T.copy()).requires_grad_(True)
    bg_t = _t(bg).requires_grad_(True)
    res = training.composite_loss(
        raw_t, samples, _t(t_padded), _t(dts), rays, bg_t, _t(exposure),
        "Logistic", "Exponential", LossType.Huber, torch.tensor(0.0), 0.0)
    g_raw, g_bg = torch.autograd.grad(res.loss_for_grad, (raw_t, bg_t))
    assert torch.isfinite(res.per_ray_loss).all()
    assert torch.isfinite(g_raw).all() and torch.isfinite(g_bg).all()
    assert res.per_ray_loss[3] == 0 and res.per_ray_loss[4] == 0
    assert (res.per_ray_loss[:3] > 0).all()
    # normalised by the 5 lanes, not the 3 that carry loss; the L1
    # density term (mean density 0 switches it on) is what is left
    main = res.per_ray_loss.sum() / 5
    l1 = 1e-4 * torch.where(_t(mask), (-_t(raw[3])).clamp(min=0.0),
                            0.0).sum() / 5
    np.testing.assert_allclose(res.loss_for_grad.item(), (main + l1).item(),
                               rtol=1e-6)
    # the colour-space guards alone, at their edges
    x = torch.tensor([0.0, 0.0031308, 1e-9, 0.5], requires_grad=True)
    (g,) = torch.autograd.grad(training._linear_to_srgb(x).sum(), x)
    assert torch.isfinite(g).all() and g[0] == pytest.approx(12.92)
    y = torch.tensor([0.0, -0.1, 0.04045, 0.5], requires_grad=True)
    (g,) = torch.autograd.grad(training._srgb_to_linear(y).sum(), y)
    assert torch.isfinite(g).all()


# -- one train step --------------------------------------------------------
@pytest.mark.parametrize("mode", ["exact", "default"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_train_step_matches_jax(dtype, mode):
    """default: the stochastic-corner encode (j = 1, one-corner backward)
    with the JAX step's own corner draws, and the error map's deposit."""
    jdt, tdt = DTYPES[dtype]
    exact = mode == "exact"
    jtb = make_jax_tb(jdt, exact=exact)
    jtb.train(3)                  # a state with moments, an EMA and a grid
    tb = make_port_tb(tdt, jax_tb=jtb, exact=exact)
    feed_jax_draws(tb)
    if not exact:
        assert jtb._error_map is not None
        tb._maybe_init_error_map()
        tb._error_map = _t(jtb._error_map)
        tb._n_steps_since_error_update = jtb._n_steps_since_error_update
    for _ in range(2):
        jstats = jax_step(jtb)
        stats = tb.train_step()
        scalars = {k: v for k, v in stats.items() if k != "error_map"}
        _assert_step_close(tb, jtb.state, jstats, scalars, dtype)
        assert ("error_map" in stats) == (not exact)
        if not exact and dtype == "f32":
            em, ref = stats["error_map"].numpy(), np.asarray(
                jstats["error_map"])
            assert em.shape == ref.shape == (4, 32 * 32) and ref.max() > 0
            np.testing.assert_allclose(em, ref, rtol=1e-3, atol=1e-8)
    assert tb.training_step == jtb.training_step == 5


def test_error_map_deposit_matches_jax():
    """The bilinear deposit alone, exactly the JAX step's arithmetic on
    the same rays and losses: pixels at the map's edges (clipped to
    cw - 1.001) included."""
    rng = np.random.default_rng(2)
    n, n_img, res = 500, 3, (16, 8)
    uv = rng.uniform(size=(n, 2)).astype(np.float32)
    uv[:6] = [[0, 0], [1, 1], [0.999, 0.001], [0.03, 0.97], [0.5, 0.5],
              [1 - 1e-7, 0.5]]
    img = rng.integers(0, n_img, n)
    loss = rng.uniform(size=n).astype(np.float32)
    em0 = rng.uniform(size=(n_img, res[0] * res[1])).astype(np.float32)
    rays = RayBatch(None, None, None, None, img_idx=_t(img), uv=_t(uv))
    out = training.deposit_error_map(_t(em0), rays, _t(loss), res).numpy()
    # the reference, with numpy in float32 as nerf_train_step writes it
    cw, ch = res
    pos = np.clip(uv * np.array([cw, ch], np.float32) - np.float32(0.5),
                  0.0, np.array([cw - 1.001, ch - 1.001], np.float32))
    p0 = pos.astype(np.int32)
    w = pos - p0
    ref = np.zeros(em0.size, np.float32)
    for dx, dy, wt in ((0, 0, (1 - w[:, 0]) * (1 - w[:, 1])),
                       (1, 0, w[:, 0] * (1 - w[:, 1])),
                       (0, 1, (1 - w[:, 0]) * w[:, 1]),
                       (1, 1, w[:, 0] * w[:, 1])):
        np.add.at(ref, img * (cw * ch) + (p0[:, 1] + dy) * cw
                  + (p0[:, 0] + dx), wt * loss)
    np.testing.assert_allclose(out, em0 + ref.reshape(em0.shape),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out.sum() - em0.sum(), loss.sum(),
                               rtol=1e-4)         # the weights sum to 1


def test_error_map_delta_is_repeatable_and_matches_jax_and_float64():
    """`error_map_delta` against JAX's deposit (the four `.at[idx].add`
    lines of its train step, run by jnp on the same numpy-seeded rays and
    losses) and against a float64 sum: 4000 rays on a 12x10 map of 2
    images, so that every cell takes dozens of deposits (sums up to
    ~14). The same bits on
    every call; rtol 1e-5 / atol 1e-6 against both (float32 sums of ~100
    terms of order 1 in another order)."""
    rng = np.random.default_rng(5)
    n, n_img, res = 4000, 2, (12, 10)
    uv = rng.uniform(size=(n, 2)).astype(np.float32)
    img = rng.integers(0, n_img, n)
    loss = rng.uniform(size=n).astype(np.float32)
    em = np.zeros((n_img, res[0] * res[1]), np.float32)
    rays = RayBatch(None, None, None, None, img_idx=_t(img), uv=_t(uv))
    got = [training.error_map_delta(_t(em), rays, _t(loss), res)
           for _ in range(2)]
    assert torch.equal(got[0], got[1])
    cw, ch = res
    ju, jimg, jloss = jnp.asarray(uv), jnp.asarray(img), jnp.asarray(loss)
    pos = jnp.clip(ju * jnp.asarray([cw, ch], jnp.float32) - 0.5, 0.0,
                   jnp.asarray([cw - 1.001, ch - 1.001]))
    p0 = pos.astype(jnp.int32)
    w = pos - p0
    flat_img = jimg * (cw * ch)
    ref = jnp.zeros(em.size, jnp.float32)
    exact = np.zeros(em.size, np.float64)
    for dx, dy, wt in ((0, 0, (1 - w[:, 0]) * (1 - w[:, 1])),
                       (1, 0, w[:, 0] * (1 - w[:, 1])),
                       (0, 1, (1 - w[:, 0]) * w[:, 1]),
                       (1, 1, w[:, 0] * w[:, 1])):
        idx = flat_img + (p0[:, 1] + dy) * cw + (p0[:, 0] + dx)
        ref = ref.at[idx].add(wt * jloss)
        np.add.at(exact, np.asarray(idx),
                  np.asarray(wt, np.float64) * loss.astype(np.float64))
    assert (exact > 0).all() and exact.max() > 5
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got[0].numpy(), exact, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("switches", [
    ("optimize_extrinsics",), ("optimize_focal_length",),
    ("optimize_exposure",),
    ("optimize_extrinsics", "optimize_focal_length", "optimize_exposure")],
    ids=["extrinsics", "focal", "exposure", "all"])
def test_camera_and_exposure_gradients_match_jax(switches):
    """A full step from converted state with `cam_grad_interval = 1`: the
    rays are rebuilt from the offsets, the encode is the exact one although
    stochastic corners are on, and the three camera gradients and the
    exposure gradient agree with JAX's (rtol 2e-3 of each gradient's
    largest entry: float32 sums over ~4000 samples of terms of both
    signs). Non-zero offsets and exposures, so that the offsets' own path
    (rotation on the left, the focal factor) is exercised."""
    jtb = make_jax_tb(jnp.float32)
    jtb.train(3)
    tb = make_port_tb(torch.float32, jax_tb=jtb)
    feed_jax_draws(tb)
    rng = np.random.default_rng(6)
    pos = rng.normal(0, 0.01, (4, 3)).astype(np.float32)
    rot = rng.normal(0, 0.01, (4, 3)).astype(np.float32)
    focal = rng.normal(0, 0.01, 2).astype(np.float32)
    exposures = rng.normal(0, 0.2, (4, 3)).astype(np.float32)
    for t in (jtb, tb):
        for name in switches:
            setattr(t, name, True)
        t.cam_grad_interval = 1
        t.cam_pos_offset, t.cam_rot_offset = pos.copy(), rot.copy()
        t.cam_focal_offset = focal.copy()
    jtb.data.exposures = jnp.asarray(exposures)
    tb.data.exposures = _t(exposures)
    tb._maybe_init_error_map()
    tb._error_map = _t(jtb._error_map)
    tb._n_steps_since_error_update = jtb._n_steps_since_error_update

    jstats = jax_step(jtb)
    stats = tb.train_step()
    cam_on = "optimize_exposure" != switches[0] or len(switches) > 1
    assert ("cam_gradient" in jstats) == ("cam_gradient" in stats) == cam_on
    assert ("exposure_gradient" in jstats) == \
        ("exposure_gradient" in stats) == ("optimize_exposure" in switches)
    if cam_on:
        assert tb._cam_grad_accum is not None
        for k in ("pos", "rot", "focal"):
            ours = stats["cam_gradient"][k].numpy()
            ref = np.asarray(jstats["cam_gradient"][k])
            assert ours.shape == ref.shape and np.abs(ref).max() > 1e-8, k
            np.testing.assert_allclose(ours, ref, rtol=2e-3,
                                       atol=2e-3 * np.abs(ref).max(),
                                       err_msg=k)
    if "optimize_exposure" in switches:
        ours = stats["exposure_gradient"].numpy()
        ref = np.asarray(jstats["exposure_gradient"])
        assert np.abs(ref).max() > 1e-6
        np.testing.assert_allclose(ours, ref, rtol=2e-3,
                                   atol=2e-3 * np.abs(ref).max())
    scalars = {k: v for k, v in stats.items()
               if k in ("loss", "measured_batch_size", "n_rays", "fused",
                        "measured_batch_size_before_compaction")}
    _assert_step_close(tb, jtb.state, jstats, scalars, "f32")


def test_camera_step_uses_the_exact_encode_and_others_the_estimator():
    """The rule `stochastic and not rebuild`: with extrinsics on and an
    interval of 2, the step that takes the camera gradient encodes exactly
    (its corner draws go unused), the other one stochastically."""
    tb = make_port_tb(torch.float32)
    tb.optimize_extrinsics = True
    tb.cam_grad_interval = 2
    tb.training_step = 5                      # no prep needed
    tb.set_density_grid(np.full(128 ** 3, 0.02, np.float32))
    seen = []
    enc = tb.model.pos_encoding
    real = enc.forward

    def spy(x, max_level=None, draws=None, generator=None, exact_axes=None):
        seen.append((draws is not None or generator is not None,
                     x.requires_grad))
        return real(x, max_level, draws, generator, exact_axes)

    enc.forward = spy
    s0, s1 = tb.train_step(), tb.train_step()
    assert seen == [(True, False), (False, True)]
    assert "cam_gradient" not in s0 and "cam_gradient" in s1
    g = s1["cam_gradient"]
    assert all(float(v.abs().max()) > 0 for v in g.values())
    # the sampled gradient stands for the interval's two steps
    np.testing.assert_allclose(tb._cam_grad_accum["pos"].numpy(),
                               2.0 * g["pos"].numpy())


# -- which path the MLP takes ---------------------------------------------
def test_mlp_takes_the_kernel_only_without_grad(monkeypatch):
    calls = []
    real = mlp_module.mlp_kernels.fused_mlp_forward

    def counting(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(mlp_module.mlp_kernels, "fused_mlp_forward", counting)
    net = MLP(8, 4, n_neurons=16, n_hidden_layers=2,
              compute_dtype=torch.bfloat16)
    net.init_params(torch.Generator().manual_seed(0))
    x = torch.randn(50, 8, generator=torch.Generator().manual_seed(1))
    ref = net(x)                              # inference: the wrapper
    assert len(calls) == 1 and ref.grad_fn is None
    net.requires_grad_(True)
    out = net(x)                              # weights want gradients
    assert len(calls) == 1 and out.grad_fn is not None
    assert torch.equal(out.detach(), ref)     # the same function
    grads = torch.autograd.grad(out.sum(), list(net.weights))
    assert all(g.abs().sum() > 0 for g in grads)
    with torch.no_grad():
        assert net(x).grad_fn is None
    assert len(calls) == 2                    # no_grad: the wrapper again
    net.requires_grad_(False)
    out = net(x.clone().requires_grad_(True))  # the input wants gradients
    assert len(calls) == 2 and out.grad_fn is not None


def test_train_step_never_calls_the_kernel_wrapper_but_prep_does(
        monkeypatch):
    calls = []
    real = mlp_module.mlp_kernels.fused_mlp_forward
    monkeypatch.setattr(
        mlp_module.mlp_kernels, "fused_mlp_forward",
        lambda *a, **k: (calls.append(a[1].dims), real(*a, **k))[1])
    tb = make_port_tb(torch.bfloat16)
    tb.training_prep()
    n_prep = len(calls)
    assert n_prep > 0 and all(d[-1] == 16 for d in calls)   # density net
    before = [w.clone() for w in tb.model.rgb_net.weights]
    tb.train_step()
    assert len(calls) == n_prep
    # and the step's gradients reached both networks and the table
    assert all(not torch.equal(a, b) for a, b in
               zip(before, tb.model.rgb_net.weights))
    assert all(float(m.abs().sum()) > 0
               for m in tree_leaves(tb.opt_state["m"]))
    tb.set_density_grid(np.full(128 ** 3, 0.02, np.float32))
    tb.render_frame(4, 4, tb.data.xforms_start[0].numpy())
    assert len(calls) > n_prep


# -- EMA parameters at inference ---------------------------------------------
def test_inference_uses_ema_and_repacks_after_a_step():
    tb = make_port_tb(torch.bfloat16)
    feed_jax_draws(tb)
    ema = tb.opt_state["ema"]
    inf = tb.inference_params()
    for a, b in zip(tree_leaves(ema), tree_leaves(inf)):
        assert a is b                          # no copy: the same tensors
    assert tb.inference_model is not tb.model
    packed0 = tb.inference_model.density_net.kernel_weights()
    tb.train(3)
    raw_w = tb.model.density_net.weights[0]
    ema_w = tb.inference_model.density_net.weights[0]
    assert not torch.equal(raw_w, ema_w)
    # the pack follows the in-place EMA update
    packed = tb.inference_model.density_net.kernel_weights()
    assert packed is not packed0
    assert torch.equal(packed.layers[0].float(),
                       ema_w.detach().to(torch.bfloat16).float())
    # prep and render see the EMA values: a render-only testbed loaded
    # with the EMA tree does the same, one loaded with the raw tree not
    def render_only(tree):
        other = NerfTestbed(scene_config(1), TRAIN_CFG, device="cpu",
                            compute_dtype=torch.bfloat16)
        other.n_march, other.max_samples_per_ray = 96, 32
        other.load_params(tree)
        other.set_density_grid(tb.density_grid)
        return other

    cam = tb.data.xforms_start[1].numpy()
    kw = dict(focal_length=40.0, min_transmittance=1e-4)
    frame = tb.render_frame(16, 16, cam, **kw)
    on_ema = render_only(ema)
    on_raw = render_only(tb.model.param_tree())
    np.testing.assert_array_equal(frame, on_ema.render_frame(16, 16, cam,
                                                             **kw))
    assert np.abs(frame - on_raw.render_frame(16, 16, cam, **kw)).max() > 0
    idx = torch.arange(0, 128 ** 3, 64)
    jitter = torch.full((idx.shape[0], 3), 0.5)
    grid0 = tb.density_grid.clone()
    tb.update_density_grid(idx, jitter)
    on_ema.set_density_grid(grid0)
    on_ema.update_density_grid(idx, jitter)
    on_raw.set_density_grid(grid0)
    on_raw.update_density_grid(idx, jitter)
    assert torch.equal(tb.density_grid, on_ema.density_grid)
    assert not torch.equal(tb.density_grid, on_raw.density_grid)
    # the train step differentiates the raw parameters, not the EMA
    before = [t.clone() for t in tree_leaves(tb.model.param_tree())]
    stats = tb.train_step()
    assert np.isfinite(float(stats["loss"]))
    assert all(not torch.equal(a, b) for a, b in
               zip(before, tree_leaves(tb.model.param_tree())))
    assert all(not t.requires_grad for t in tree_leaves(ema))
    assert all(t.requires_grad
               for t in tree_leaves(tb.model.param_tree()))


def test_training_modules_import_without_jax():
    """The training slice imports, trains a step and saves nothing it
    cannot without jax, msgpack and the JAX package."""
    code = r"""
import importlib, importlib.abc, pkgutil, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "msgpack",
                                  "instant_ngp_tpu"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import numpy as np
import instant_ngp_tpu_torch.nerf.training, instant_ngp_tpu_torch.ops.optimizers
import instant_ngp_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                               pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
for wanted in ("ops.losses", "ops.optimizers", "ops.trainer", "nerf.training",
               "nerf.visibility", "data.nerf_loader", "utils", "metrics",
               "volume.testbed_volume", "volume.nanovdb", "sdf.testbed_sdf",
               "sdf.bricks", "sdf.brdf", "geom.triangle_bvh",
               "geom.triangle_octree", "ops.takikawa",
               "geometry.geometry_bvh", "geometry.testbed_geometry",
               "testbed", "render_buffer", "foveation", "camera_path",
               "pyngp_compat", "__main__", "data.msgpack_codec"):
    assert pkg.__name__ + "." + wanted in names, wanted
from instant_ngp_tpu_torch.config import (find_network_config,
                                          load_network_config)
from instant_ngp_tpu_torch.data.nerf_loader import (FrameMetadata, Lens,
                                                    NerfDataset)
from instant_ngp_tpu_torch.nerf.testbed_nerf import NerfTestbed
cfg = load_network_config(find_network_config("base", "nerf"))
cfg["encoding"]["log2_hashmap_size"] = 12
cam = np.array([[1, 0, 0, 0.5], [0, 1, 0, 0.5], [0, 0, 1, -0.6]], np.float32)
img = np.full((8, 8, 4), 200, np.uint8)
meta = FrameMetadata((8, 8), np.array([8.0, 8.0], np.float32),
                     np.array([0.5, 0.5], np.float32),
                     np.zeros(4, np.float32), Lens())
ds = NerfDataset(paths=["a"], images=[img], depths=[None], rays=[None],
                 metadata=[meta], xforms_start=cam[None], xforms_end=cam[None])
tb = NerfTestbed(ds, cfg, device="cpu", seed=0)
tb.target_batch_size = 1 << 10
tb.rays_per_batch = 64
tb.density_samples_override = 1 << 10
loss = tb.train(2)
assert np.isfinite(loss) and tb.measured_batch_size > 0
# snapshots go through the port's own msgpack codec
import os, tempfile
from instant_ngp_tpu_torch.data.snapshot import load_snapshot
path = os.path.join(tempfile.mkdtemp(), "snap.ingp")
tb.save_snapshot(path)
assert load_snapshot(path)["training_step"] == 2
assert not any(m.split(".")[0] in ("jax", "msgpack", "instant_ngp_tpu")
               for m in sys.modules)
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
