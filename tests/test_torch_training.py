"""The port's NeRF training slice against the JAX package, on the tiny
synthetic dataset of tests/test_nerf_training.py (4 cameras of 32x32, L=4
hash grid with 2^12 entries, 32-wide MLPs, 256-1024 rays).

The JAX testbed runs with `stochastic_corners = False` (the port's default
until that estimator is ported), without error-map sampling and through
its eager loop (`steps_per_dispatch = 1`). Where JAX draws random numbers
the port is fed the same draws (tests/test_torch_sampler.py makes them
from the step's own key splits).

Tolerances, by what differs between the two sides:
- the composite alone (same raw inputs): summation order and ulps of
  exp/pow: rtol 2e-4 / atol 1e-7 on losses, rtol 2e-4 / atol 1e-8 on
  gradients, as the JAX package holds its own composite to the
  hand-derived backward;
- a full train step at float32: the same, through two MLPs and the
  scatter into the hash table: `m` and the loss to rtol 1e-3 (atol 1e-6 of
  values of order 1e-3), `v` to rtol 2e-3, the parameters and the EMA
  (steps of order 1e-2) to rtol 1e-3 / atol 2e-5 where the second moment
  is within 400x of the leaf's largest (see `_assert_step_close`);
- at bf16 compute the backward rounds at different points (XLA rounds
  cotangents of bf16 operands to bf16, autograd keeps them float32): loss
  to 2 %, `m` to 5 % of its largest entry.
The testbed's loop, snapshots and `eval_psnr` are in
tests/test_torch_testbed_train.py."""

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
from test_nerf_training import CFG, make_dataset  # noqa: E402
from test_torch_sampler import (jax_cell_draws, jax_cell_jitter,  # noqa: E402
                                jax_train_draws, port_dataset)

from instant_ngp_tpu.common import LossType as JaxLossType
from instant_ngp_tpu.nerf import training as jtraining
from instant_ngp_tpu.nerf.testbed_nerf import NerfTestbed as JaxTestbed
from instant_ngp_tpu_torch.convert import (opt_state_from_jax,
                                           params_from_jax)
from instant_ngp_tpu_torch.data.nerf_loader import NerfDataset
from instant_ngp_tpu_torch.nerf import training
from instant_ngp_tpu_torch.nerf.dataset import scene_config
from instant_ngp_tpu_torch.nerf.sampler import RayBatch, SampleBatch
from instant_ngp_tpu_torch.nerf.testbed_nerf import NerfTestbed
from instant_ngp_tpu_torch.ops import mlp as mlp_module
from instant_ngp_tpu_torch.ops.losses import LossType
from instant_ngp_tpu_torch.ops.mlp import MLP
from instant_ngp_tpu_torch.ops.optimizers import tree_leaves

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_CFG = dict(CFG, encoding=dict(CFG["encoding"],
                                    n_features_per_level=4))
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
N_RAYS = 512


def _t(a):
    return torch.from_numpy(np.array(a))


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _set_knobs(tb, prep_every=16):
    tb.target_batch_size = 1 << 12
    tb.rays_per_batch = N_RAYS
    tb.adapt_ray_batch = False
    tb.n_march = 96
    tb.max_samples_per_ray = 32
    tb.density_samples_override = 1 << 12
    tb.prep_every = prep_every
    tb.steps_per_dispatch = 1


def make_jax_tb(dtype, prep_every=16):
    tb = JaxTestbed(make_dataset(), TRAIN_CFG, compute_dtype=dtype)
    _set_knobs(tb, prep_every)
    tb.stochastic_corners = False
    tb.use_error_map_sampling = False
    return tb


def make_port_tb(dtype, prep_every=16, jax_tb=None):
    tb = NerfTestbed(port_dataset(make_dataset()), TRAIN_CFG, device="cpu",
                     compute_dtype=dtype)
    _set_knobs(tb, prep_every)
    if jax_tb is not None:
        state = _numpy_tree(jax_tb.state)
        tb.load_state(params_from_jax(state["params"]),
                      opt_state_from_jax(state["opt"]))
        tb.set_density_grid(np.asarray(jax_tb.density_grid))
        tb.training_step = jax_tb.training_step
        tb.density_grid_ema_step = jax_tb.density_grid_ema_step
    return tb


def feed_jax_draws(tb, seed=1337):
    """Make a port testbed draw what the JAX testbed of the same seed
    draws at the same step counts."""
    def train_draws(n_rays):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), tb.training_step)
        return jax_train_draws(key, n_rays, tb.data.n_images)

    def prep_draws(n_uniform, n_nonuniform):
        rng = jax.random.fold_in(jax.random.PRNGKey(seed ^ 0xD3),
                                 tb.density_grid_ema_step)
        k_cells, k_pos, _ = jax.random.split(rng, 3)
        return (jax_cell_draws(k_cells, n_uniform, n_nonuniform,
                               tb.scene.max_cascade + 1),
                jax_cell_jitter(k_pos, n_uniform + n_nonuniform))

    tb._train_draws = train_draws
    tb._prep_draws = prep_draws


# -- the composite ---------------------------------------------------------
def _port_case(case, mask):
    raw, _, _, t_padded, jrays, bg, exposure, dts, rgba = case
    r, k = mask.shape
    js = identity_samples(mask)
    samples = SampleBatch(*([None] * 4), _t(js.ray_id).long(),
                          _t(js.ray_base).long(), _t(js.ray_count).long(),
                          _t(js.n_samples).long(), _t(js.cand_slot).long(),
                          _t(js.cand_src).long())
    rays = RayBatch(torch.zeros(r, 3), torch.zeros(r, 3), torch.zeros(r),
                    torch.ones(r, dtype=torch.bool), rgba=_t(rgba))
    return samples, rays


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
def _assert_step_close(tb, jstate, jstats, stats, dtype):
    jstate = _numpy_tree(jstate)
    ours = {k: float(v) for k, v in stats.items() if k != "fused"}
    ref = {k: float(np.asarray(jstats[k])) for k in ours}
    for k in ("measured_batch_size",
              "measured_batch_size_before_compaction", "n_rays"):
        assert ours[k] == ref[k] > 0, k
    np.testing.assert_array_equal(
        stats["fused"].numpy(),
        np.array([ours[k] for k in ("loss", "measured_batch_size",
                                    "measured_batch_size_before_compaction",
                                    "n_rays")], np.float32))
    assert int(tb.opt_state["step"]) == int(jstate["opt"]["step"])
    keys = sorted(jstate["params"])
    for name in ("m", "v", "ema", "params"):
        tree = tb.model.param_tree() if name == "params" \
            else tb.opt_state[name]
        jtree = jstate["params"] if name == "params" \
            else jstate["opt"][name]
        ours_l = [t.detach().numpy().ravel() for t in tree_leaves(
            {k: tree[k] for k in keys})]
        ref_l = [a.ravel() for a in jax.tree_util.tree_leaves(jtree)]
        v_l = [a.ravel() for a in
               jax.tree_util.tree_leaves(jstate["opt"]["v"])]
        for a, b, v in zip(ours_l, ref_l, v_l):
            assert a.shape == b.shape
            if dtype == "f32" and name in ("m", "v"):
                np.testing.assert_allclose(
                    a, b, rtol=1e-3 if name == "m" else 2e-3,
                    atol=1e-6 if name == "m" else 1e-10, err_msg=name)
            elif dtype == "f32":
                # Adam divides by sqrt(v): where the second moment is at
                # the level of float32 noise of the gradient, a rounding
                # difference is a full-size step. Compare where it is
                # well above that.
                sure = np.sqrt(v) > 0.05 * np.sqrt(v).max()
                assert sure.sum() >= 10, name
                np.testing.assert_allclose(a[sure], b[sure], rtol=1e-3,
                                           atol=2e-5, err_msg=name)
            elif name == "m":
                assert np.abs(a - b).max() <= 0.05 * np.abs(b).max(), name
    if dtype == "f32":
        np.testing.assert_allclose(ours["loss"], ref["loss"], rtol=1e-3)
    else:
        np.testing.assert_allclose(ours["loss"], ref["loss"], rtol=2e-2)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_train_step_matches_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    jtb = make_jax_tb(jdt)
    jtb.train(3)                  # a state with moments, an EMA and a grid
    tb = make_port_tb(tdt, jax_tb=jtb)
    feed_jax_draws(tb)
    for _ in range(2):
        key = jax.random.fold_in(jax.random.PRNGKey(jtb.seed),
                                 jtb.training_step)
        fn = jtb._get_train_fn(N_RAYS, jtb._bucket_k(N_RAYS))
        jtb.state, jstats = fn(jtb.state, jtb.data, jtb.bitfield,
                               jtb.mean_density, key, None, None, None, None,
                               None)
        jtb.training_step += 1
        stats = tb.train_step()
        _assert_step_close(tb, jtb.state, jstats, stats, dtype)
    assert tb.training_step == jtb.training_step == 5


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


# -- what is not ported raises -------------------------------------------------
@pytest.mark.parametrize("switch, value", [
    ("stochastic_corners", True), ("optimize_extrinsics", True),
    ("optimize_focal_length", True), ("optimize_exposure", True),
    ("optimize_extra_dims", True), ("train_envmap", True),
    ("optimize_distortion", True), ("use_error_map_sampling", True),
    ("steps_per_dispatch", 16)])
def test_out_of_scope_switch_raises(switch, value):
    tb = make_port_tb(torch.float32)
    tb.training_step = 5                      # no prep needed
    setattr(tb, switch, value)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tb.train(1)


def test_out_of_scope_datasets_and_mesh_raise():
    with pytest.raises(NotImplementedError, match="mesh"):
        NerfTestbed(port_dataset(make_dataset()), TRAIN_CFG, device="cpu",
                    mesh=object())
    ds = port_dataset(make_dataset())
    ds.n_extra_learnable_dims = 2
    with pytest.raises(NotImplementedError, match="extra dims"):
        NerfTestbed(ds, TRAIN_CFG, device="cpu")
    ds = port_dataset(make_dataset())
    ds.depths = [np.ones((32, 32), np.float32)] * 4
    with pytest.raises(NotImplementedError, match="depth"):
        NerfTestbed(ds, TRAIN_CFG, device="cpu")
    cfg = training.NerfTrainStepConfig(
        8, 8, 8, 8, 0, 0.0, 0, "Logistic", "Exponential", LossType.L2, 0.0,
        depth_supervision_lambda=1.0)
    with pytest.raises(NotImplementedError, match="depth"):
        training.check_ported(cfg)
    assert isinstance(ds, NerfDataset)


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
               "nerf.visibility", "data.nerf_loader", "utils", "metrics"):
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
assert not any(m.split(".")[0] in ("jax", "msgpack", "instant_ngp_tpu")
               for m in sys.modules)
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
