"""The per-scene training switches of the port's `NerfTestbed` against the
JAX package's, on the tiny dataset of tests/torch_parity.py's
`lens_dataset` (4 views of 32x32 through an OpenCV lens, an L=4 hash grid with F=4,
32-wide MLPs, float32 compute): per-image latent codes
(`optimize_extra_dims`), the environment map (`train_envmap`), the
distortion map (`optimize_distortion`) and depth supervision
(`depth_supervision_lambda`), each alone and all four together; then the
buffers in snapshots (`eval.py` and `metrics.py` are in
tests/test_torch_eval_metrics.py).

One train step starts from the JAX testbed's state after 3 steps,
converted, with the JAX step's own random draws handed to the port.
Tolerances: the loss to rtol 1e-3 and the optimizer state as
tests/test_torch_training.py holds a step; each buffer's gradient to 2e-3
of its largest entry (float32 sums over thousands of samples, terms of
both signs); a buffer's Adam moment `m` the same; the stepped buffer
itself where its gradient is not at the level of float32 noise (Adam's
first step has size lr whatever the gradient's size). What 8 steps of
`train` can be held to is said at that test."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_gradient_parity import identity_samples, make_case  # noqa: E402
from torch_parity import (LENS, MODES_CFG, SWITCH_CASES,  # noqa: E402
                          _assert_step_close, _numpy_tree, _port_case, _t,
                          feed_jax_draws, jax_step, lens_dataset, make_pair,
                          port_lens_dataset, sync_port)

from instant_ngp_tpu.data.snapshot import load_snapshot as jax_load_snapshot
from instant_ngp_tpu.nerf import training as jtraining
from instant_ngp_tpu.nerf.testbed_nerf import NerfTestbed as JaxTestbed
from instant_ngp_tpu_torch.convert import (buffer_state_from_jax,
                                           buffer_state_to_jax)
from instant_ngp_tpu_torch.data.snapshot import load_snapshot
from instant_ngp_tpu_torch.nerf import training
from instant_ngp_tpu_torch.nerf.testbed_nerf import NerfTestbed
from instant_ngp_tpu_torch.ops.losses import LossType
from instant_ngp_tpu_torch.ops.trainable_buffer import TrainableBuffer

GRAD_REL = 2e-3
GRADIENTS = {"extra_dims": ("extra_dims_gradient",),
             "envmap": ("envmap_gradient",),
             "distortion": ("distortion_gradient",),
             "depth": (),
             "all": ("extra_dims_gradient", "envmap_gradient",
                     "distortion_gradient")}


def _assert_close_to_top(ours, ref, what, rel=GRAD_REL):
    ref = np.asarray(ref)
    top = np.abs(ref).max()
    assert ours.shape == ref.shape and top > 0, what
    np.testing.assert_allclose(ours, ref, rtol=rel, atol=rel * top,
                               err_msg=what)


@pytest.mark.parametrize("case", sorted(SWITCH_CASES))
def test_train_step_with_each_switch_matches_jax(case):
    jtb, tb = make_pair(case)
    jtb.train(3)                    # moments, an EMA, a grid, moved buffers
    sync_port(tb, jtb)
    feed_jax_draws(tb)
    assert jtb._error_map is not None
    tb._maybe_init_error_map()
    tb._error_map = _t(jtb._error_map)
    tb._n_steps_since_error_update = jtb._n_steps_since_error_update
    assert tb.optimize_extra_dims == jtb.optimize_extra_dims \
        == (SWITCH_CASES[case][1] > 0)
    buffers = {"extra_dims_gradient": (tb._extra_dims_buf,
                                       jtb._extra_dims_buf),
               "envmap_gradient": (tb.envmap, jtb.envmap),
               "distortion_gradient": (tb.distortion_map,
                                       jtb.distortion_map)}
    before = {k: b[0].params.clone() for k, b in buffers.items()
              if b[0] is not None}

    jstats = jax_step(jtb)
    # what the JAX loop does with the gradients after its step
    for name, (_, theirs) in buffers.items():
        if name in jstats:
            theirs.step(jstats[name])
    stats = tb.train_step()

    scalar_keys = ("loss", "measured_batch_size", "n_rays", "fused",
                   "measured_batch_size_before_compaction")
    _assert_step_close(tb, jtb.state, jstats,
                       {k: stats[k] for k in scalar_keys}, "f32")
    wanted = set(GRADIENTS[case])
    assert {k for k in stats if k.endswith("_gradient")} == wanted \
        == {k for k in jstats if k.endswith("_gradient")}
    for name in wanted:
        ours, theirs = buffers[name]
        g, ref = stats[name].numpy(), np.asarray(jstats[name])
        _assert_close_to_top(g, ref, name)
        # the buffer took its optimizer's step, as the JAX loop's did
        jstate = _numpy_tree(theirs.state)
        assert int(ours.state["opt"]["step"]) == int(jstate["opt"]["step"])
        _assert_close_to_top(ours.state["opt"]["m"].numpy(),
                             jstate["opt"]["m"], name + " m")
        sure = np.abs(ref) > 0.05 * np.abs(ref).max()
        assert sure.sum() >= 4, name
        np.testing.assert_allclose(ours.params.numpy()[sure],
                                   jstate["params"][sure], rtol=1e-3,
                                   atol=2e-5, err_msg=name)
        assert not torch.equal(ours.params, before[name])
    for name in set(before) - wanted:         # and no other buffer moved
        assert torch.equal(buffers[name][0].params, before[name]), name
    if "extra_dims_gradient" in wanted:
        assert tb.data.extra_dims is tb._extra_dims_buf.params
        # a segment sum: an image no ray came from has a zero gradient row
        assert stats["extra_dims_gradient"].shape == (4, 2)


def test_depth_term_of_composite_loss_matches_jax():
    """The depth term alone, on the composite's own test case: L1 between
    the composited depth and the target where the target is > 0."""
    case = make_case(n_rays=6, k=8, seed=2)
    raw, mask, _, t_padded, jrays, bg, exposure, dts, rgba = case
    depth = np.array([0.0, 0.5, 1.5, 0.0, 3.0, 0.2], np.float32)
    js = identity_samples(mask)

    def jax_loss(raw_flat, lam):
        return jtraining.composite_loss(
            tuple(raw_flat[i].reshape(-1) for i in range(4)), js,
            jnp.asarray(t_padded), jnp.asarray(dts), jrays, jnp.asarray(bg),
            jnp.asarray(exposure), "Logistic", "Exponential",
            jtraining.LossType.L2, jnp.asarray(1.0), 0.0, False,
            jnp.asarray(depth), lam).loss_for_grad

    samples, rays = _port_case(case, mask)

    def port_loss(raw_t, lam, target=depth):
        return training.composite_loss(
            raw_t, samples, _t(t_padded), _t(dts), rays, _t(bg),
            _t(exposure), "Logistic", "Exponential", LossType.L2,
            torch.tensor(1.0), 0.0, depth_target=None if target is None
            else _t(target), depth_supervision_lambda=lam).loss_for_grad

    raw_t = _t(raw.reshape(4, -1).T.copy()).requires_grad_(True)
    ref, ref_grad = jax.value_and_grad(jax_loss)(jnp.asarray(raw), 0.7)
    loss = port_loss(raw_t, 0.7)
    (grad,) = torch.autograd.grad(loss, raw_t)
    np.testing.assert_allclose(loss.item(), float(ref), rtol=2e-4)
    np.testing.assert_allclose(grad.numpy().T.reshape(raw.shape),
                               np.asarray(ref_grad), rtol=2e-4, atol=1e-8)
    # the term is there, scales with its weight, and needs a target
    plain = port_loss(raw_t, 0.0).item()
    assert loss.item() > plain
    np.testing.assert_allclose(port_loss(raw_t, 1.4).item() - plain,
                               2 * (loss.item() - plain), rtol=1e-4)
    assert port_loss(raw_t, 0.7, target=None).item() == plain
    assert port_loss(raw_t, 0.7, target=np.zeros(6, np.float32)).item() \
        == plain


@pytest.fixture(scope="module")
def all_pair():
    """The two testbeds of the "all" case after 8 steps of `train` each,
    the port fed the JAX loop's draws -> (jtb, tb, the buffers before, the
    JAX losses, the port's, the generated samples per step on each side)."""
    jtb, tb = make_pair("all", prep_every=4)
    sync_port(tb, jtb)
    feed_jax_draws(tb)
    start = {"envmap": tb.envmap.params.clone(),
             "distortion": tb.distortion_map.params.clone(),
             "extra": tb.data.extra_dims.clone()}
    ref, ours, counts = [], [], []
    for _ in range(8):
        ref.append(jtb.train(1))
        ours.append(tb.train(1))
        counts.append((tb.measured_batch_size_before_compaction,
                       jtb.measured_batch_size_before_compaction))
    return jtb, tb, start, ref, ours, counts


def test_eight_steps_of_train_with_all_switches_match_jax(all_pair):
    """`train` itself with the four switches on. The distortion map's Adam
    (eps 1e-15) turns float32 noise in a texel's near-zero gradient into a
    full step of either sign, and the map bends the next step's rays: the
    two sides stay together (losses to 2e-3, the same sample counts) for
    the first 5 steps and are then two runs of the same training, whose
    buffers must have moved as far."""
    jtb, tb, start, ref, ours, counts = all_pair
    for step, (n, n_ref) in enumerate(counts):
        assert n_ref > 0 and (n == n_ref if step < 5
                              else abs(n - n_ref) <= n_ref // 10)
    np.testing.assert_allclose(ours[:5], ref[:5], rtol=2e-3)
    np.testing.assert_allclose(ours[5:], ref[5:], rtol=0.25)
    assert tb.training_step == jtb.training_step == 8
    moved = {"envmap": tb.envmap.params, "distortion":
             tb.distortion_map.params, "extra": tb.data.extra_dims}
    theirs = {"envmap": jtb.envmap.params, "distortion":
              jtb.distortion_map.params, "extra": jtb.data.extra_dims}
    for k, v in moved.items():
        step = (v - start[k]).abs().max().item()
        assert step > 1e-3, k                      # 8 Adam steps of 1e-2
        ref_step = np.abs(np.asarray(theirs[k]) - start[k].numpy()).max()
        np.testing.assert_allclose(step, ref_step, rtol=0.2, err_msg=k)
        assert int(tb.envmap.state["opt"]["step"]) == 8
    # renders use the trained buffers: the envmap behind the scene, the
    # distortion map in the rays (while it is optimised), view 0's latent
    assert tb.has_dataset_envmap and tb.train_envmap
    cam = tb.data.xforms_start[0].numpy()
    kw = dict(focal_length=20.0, lens_mode=1, lens_params=LENS)
    frame = tb.render_frame(12, 12, cam, **kw)
    np.testing.assert_allclose(frame, jtb.render_frame(12, 12, cam, **kw),
                               rtol=2e-2, atol=2e-2)
    tb.optimize_distortion = False
    assert np.abs(tb.render_frame(12, 12, cam, **kw) - frame).max() > 1e-5
    tb.optimize_distortion = True
    assert np.abs(tb.render_frame(12, 12, cam, use_envmap_background=False,
                                  **kw) - frame).max() > 1e-3


def test_switches_default_as_in_the_jax_testbed():
    jtb, tb = make_pair("extra_dims")
    for name in ("train_envmap", "optimize_distortion",
                 "optimize_extra_dims", "has_dataset_envmap",
                 "render_wavefront", "render_query_budget",
                 "rendering_extra_dims_from_training_view"):
        assert getattr(tb, name) == getattr(jtb, name), name
    assert tb.depth_supervision_lambda == 0.0
    assert tb.envmap.shape == jtb.envmap.shape == (8, 16, 4)
    assert tb.distortion_map.shape == jtb.distortion_map.shape == (32, 32, 2)
    assert not tb.envmap.params.any() and not tb.distortion_map.params.any()
    # the buffers' own configuration
    cfg = dict(MODES_CFG, envmap={"optimizer": {"otype": "Adam",
                                                "learning_rate": 0.5}},
               distortion_map={"resolution": [8, 4]})
    other = NerfTestbed(port_lens_dataset(lens_dataset()), cfg, device="cpu")
    ref = JaxTestbed(lens_dataset(), cfg)
    assert other.distortion_map.shape == ref.distortion_map.shape == (4, 8, 2)
    g = torch.ones(8, 16, 4)
    other.envmap.step(g)
    ref.envmap.step(jnp.ones((8, 16, 4)))
    np.testing.assert_allclose(other.envmap.params.numpy(),
                               np.asarray(ref.envmap.params), rtol=1e-5)
    assert float(other.envmap.params.abs().max()) == pytest.approx(0.5,
                                                                   rel=1e-3)
    # an envmap in the dataset sizes and seeds the buffer
    jtb2, tb2 = make_pair("all")
    assert tb2.envmap.shape == (6, 12, 4) and tb2.has_dataset_envmap
    np.testing.assert_array_equal(tb2.envmap.params.numpy(),
                                  np.asarray(jtb2.envmap.params))


def test_trainable_buffer_steps_like_the_jax_packages():
    opt = MODES_CFG["optimizer"]
    rng = np.random.default_rng(3)
    init = rng.normal(size=(5, 7, 2)).astype(np.float32)
    from instant_ngp_tpu.ops.trainable_buffer import \
        TrainableBuffer as JaxBuffer
    ours, ref = TrainableBuffer((5, 7, 2), opt, init), JaxBuffer((5, 7, 2),
                                                                 opt, init)
    for _ in range(5):
        g = rng.normal(size=(5, 7, 2)).astype(np.float32)
        ours.step(_t(g))
        ref.step(jnp.asarray(g))
    np.testing.assert_allclose(ours.params.numpy(), np.asarray(ref.params),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ours.inference_params().numpy(),
                               np.asarray(ref.inference_params()),
                               rtol=1e-5, atol=1e-6)
    # the state both ways
    state = buffer_state_to_jax(ours.state)
    jstate = _numpy_tree(ref.state)
    assert set(state["opt"]) == set(jstate["opt"])
    for k in ("m", "v", "ema"):
        np.testing.assert_allclose(state["opt"][k], jstate["opt"][k],
                                   rtol=1e-5, atol=1e-7)
    other = TrainableBuffer((5, 7, 2), opt)
    other.load_state(buffer_state_from_jax(jstate))
    g = rng.normal(size=(5, 7, 2)).astype(np.float32)
    other.step(_t(g))
    ref.step(jnp.asarray(g))
    np.testing.assert_allclose(other.params.numpy(), np.asarray(ref.params),
                               rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):
        TrainableBuffer((2, 2), opt, np.zeros((3, 2), np.float32))


def test_snapshots_carry_the_buffers_both_ways(all_pair, tmp_path):
    jtb, tb = all_pair[:2]
    path = str(tmp_path / "port.ingp")
    tb.save_snapshot(path)
    # the port's snapshot in the JAX package and in another port testbed
    jother, other = make_pair("all")
    jother.load_snapshot_state(jax_load_snapshot(path))
    other.load_snapshot_state(load_snapshot(path))
    for name, buf in (("envmap", tb.envmap),
                      ("distortion_map", tb.distortion_map),
                      ("_extra_dims_buf", tb._extra_dims_buf)):
        assert buf.params.abs().max() > 0
        np.testing.assert_array_equal(
            np.asarray(getattr(jother, name).params), buf.params.numpy(),
            err_msg=name)
        np.testing.assert_array_equal(getattr(other, name).params.numpy(),
                                      buf.params.numpy(), err_msg=name)
    np.testing.assert_array_equal(np.asarray(jother.data.extra_dims),
                                  tb.data.extra_dims.numpy())
    assert other.data.extra_dims is other._extra_dims_buf.params
    for k in ("m", "v"):
        np.testing.assert_array_equal(
            other._extra_dims_buf.state["opt"][k].numpy(),
            tb._extra_dims_buf.state["opt"][k].numpy())
        np.testing.assert_array_equal(
            np.asarray(jother._extra_dims_buf.state["opt"][k]),
            tb._extra_dims_buf.state["opt"][k].numpy())
    assert int(other._extra_dims_buf.state["opt"]["step"]) == 8
    # and the JAX package's snapshot in the port
    jtb.train(1)
    path = str(tmp_path / "jax.ingp")
    jtb.save_snapshot(path)
    other.load_snapshot_state(load_snapshot(path))
    for name in ("envmap", "distortion_map", "_extra_dims_buf"):
        np.testing.assert_array_equal(
            getattr(other, name).params.numpy(),
            np.asarray(getattr(jtb, name).params), err_msg=name)
    cam = np.asarray(jtb.data.xforms_start[1])
    kw = dict(focal_length=20.0, min_transmittance=1e-4)
    np.testing.assert_allclose(other.render_frame(12, 12, cam, **kw),
                               jtb.render_frame(12, 12, cam, **kw),
                               rtol=1e-4, atol=1e-4)
    # another dataset's latents are not restored; the maps are
    snap = load_snapshot(path)
    snap["dataset_paths"] = ["elsewhere"]
    _, fresh = make_pair("all")
    codes = fresh.data.extra_dims.clone()
    fresh.load_snapshot_state(snap)
    assert torch.equal(fresh.data.extra_dims, codes)
    np.testing.assert_array_equal(fresh.envmap.params.numpy(),
                                  np.asarray(jtb.envmap.params))
