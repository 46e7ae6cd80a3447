"""Camera, focal-length and exposure optimisation, the error map's
bookkeeping and the stochastic-corner schedule of the port's `NerfTestbed`
against the JAX package's, piece by piece and without a train step (those
are in tests/test_torch_training.py and tests/test_torch_testbed_train.py):

- `ops/host_adam.py`: `HostAdam` and `RotationHostAdam` over 20 steps on
  the same gradients, and the two rotation conversions: rtol/atol 1e-6
  (float64 moments on both sides, a float32 result);
- `_apply_camera_updates` from the same accumulated gradients on both
  sides, three rounds, all switches: offsets and exposures to 1e-6;
- `effective_xform`, `_cam_grad_interval_eff`, `_stoch_now`, the error
  map's side rule and the CDFs' rebuild (exactly the JAX arithmetic: float64
  on the host, so rtol 1e-6), the snapshot's camera block both ways;
- the density update's one-corner encode with the JAX update's own draws:
  grid to rtol 1e-3 / atol 1e-7, as the 8-step loop test holds it.
The tiny dataset and configuration are those of
tests/test_torch_training.py."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_training import (_numpy_tree, feed_jax_draws,  # noqa: E402
                                 make_jax_tb, make_port_tb)

from instant_ngp_tpu.data.snapshot import load_snapshot as jax_load_snapshot
from instant_ngp_tpu.ops import host_adam as jhost
from instant_ngp_tpu_torch.convert import params_from_jax
from instant_ngp_tpu_torch.data.snapshot import load_snapshot
from instant_ngp_tpu_torch.ops import host_adam as host

torch.set_num_threads(2)

TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind", ["HostAdam", "RotationHostAdam"])
def test_host_adam_matches_jax_package_over_20_steps(kind):
    rng = np.random.default_rng(3)
    ours, ref = getattr(host, kind)(2e-3), getattr(jhost, kind)(2e-3)
    assert (ours.beta1, ours.beta2, ours.epsilon) == (0.9, 0.99, 1e-8)
    a = b = rng.normal(0, 0.3, (7, 3)).astype(np.float32)
    for step in range(20):
        g = rng.normal(size=(7, 3)) * (10.0 ** rng.integers(-6, 1))
        if step == 10:                # the testbed sets the rate per step
            ours.learning_rate = ref.learning_rate = 5e-4
        a, b = ours.step(a, g), ref.step(b, g)
        assert a.dtype == np.float32 and ours.m.dtype == np.float64
        np.testing.assert_allclose(a, b, **TOL)
    assert ours.t == ref.t == 20
    np.testing.assert_allclose(ours.m, ref.m, rtol=1e-12)
    np.testing.assert_allclose(ours.v, ref.v, rtol=1e-12)
    ours.reset()
    assert ours.m is None and ours.t == 0


def test_rotation_conversions_match_jax_package():
    rng = np.random.default_rng(4)
    r = rng.normal(0, 0.8, (50, 3))
    r[:3] = 0.0
    r[3:6] *= 1e-9
    m = host.rotvec_to_matrix(r)
    np.testing.assert_allclose(m, jhost.rotvec_to_matrix(r), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(m @ np.swapaxes(m, -1, -2),
                               np.broadcast_to(np.eye(3), m.shape),
                               atol=1e-12)
    back = host.matrix_to_rotvec(m)
    np.testing.assert_allclose(back, jhost.matrix_to_rotvec(m), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(back[6:], r[6:], atol=1e-9)


@pytest.fixture(scope="module")
def pair():
    """A JAX testbed and a port testbed of the same (untrained) state."""
    jtb = make_jax_tb(jnp.float32)
    tb = make_port_tb(torch.float32)
    tb.load_state(params_from_jax(_numpy_tree(jtb.state)["params"]))
    return jtb, tb


def test_defaults_are_the_jax_testbeds(pair):
    jtb, tb = pair
    for name in ("stochastic_corners", "stochastic_corners_until",
                 "use_error_map_sampling",
                 "n_steps_between_error_map_updates",
                 "optimize_extrinsics", "optimize_focal_length",
                 "optimize_exposure", "extrinsic_learning_rate",
                 "extrinsic_l2_reg", "intrinsic_l2_reg", "exposure_l2_reg",
                 "n_steps_between_cam_updates", "cam_grad_interval",
                 "render_stochastic_corners"):
        assert getattr(tb, name) == getattr(jtb, name), name
    assert tb.stochastic_corners is True
    assert tb.use_error_map_sampling is True
    for name in ("_cam_pos_adam", "_cam_rot_adam", "_focal_adam",
                 "_exposure_adam"):
        assert getattr(tb, name).learning_rate == \
            getattr(jtb, name).learning_rate, name
        assert type(getattr(tb, name)).__name__ == \
            type(getattr(jtb, name)).__name__
    assert tb._cam_dict() is None and jtb._cam_dict() is None
    # the schedule: from the encoding's config, and by the step
    from test_torch_training import TRAIN_CFG, port_dataset
    from test_nerf_training import make_dataset
    from instant_ngp_tpu_torch.nerf.testbed_nerf import NerfTestbed
    cfg = dict(TRAIN_CFG, encoding=dict(TRAIN_CFG["encoding"],
                                        stochastic_corners_until=7))
    other = NerfTestbed(port_dataset(make_dataset()), cfg, device="cpu")
    assert other.stochastic_corners_until == 7 and other._stoch_now()
    other.training_step = 7
    assert not other._stoch_now()
    other.stochastic_corners_until = None
    assert other._stoch_now()
    other.stochastic_corners = False
    assert not other._stoch_now()
    ds = port_dataset(make_dataset())
    ds.wants_importance_sampling = False
    assert NerfTestbed(ds, cfg, device="cpu").use_error_map_sampling is False


@pytest.mark.parametrize("interval, window", [(16, 16), (1, 16), (32, 16),
                                              (4, 2), (0, 16)])
def test_cam_grad_interval_is_clamped_to_the_window(pair, interval, window):
    jtb, tb = pair
    for t in (jtb, tb):
        t.cam_grad_interval, t.n_steps_between_cam_updates = interval, window
    assert tb._cam_grad_interval_eff() == jtb._cam_grad_interval_eff() \
        == max(1, min(interval, window))
    for t in (jtb, tb):
        t.cam_grad_interval, t.n_steps_between_cam_updates = 16, 16


def test_apply_camera_updates_matches_jax(pair):
    """Three updates from the same accumulated gradients: the n / window
    scale, the L2 terms, the decaying extrinsics rate, the composed
    rotation step, the exposures' zero mean; then the device copy of the
    offsets follows the host arrays."""
    jtb, tb = pair
    rng = np.random.default_rng(9)
    for t in (jtb, tb):
        t.optimize_extrinsics = t.optimize_focal_length = True
        t.optimize_exposure = True
        t.exposure_l2_reg = 1e-3
    syncs0 = tb.host_syncs["camera_updates"]
    try:
        for _ in range(3):
            g = {"pos": rng.normal(size=(4, 3)).astype(np.float32),
                 "rot": rng.normal(size=(4, 3)).astype(np.float32),
                 "focal": rng.normal(size=2).astype(np.float32)}
            ge = rng.normal(size=(4, 3)).astype(np.float32)
            jtb._cam_grad_accum = {k: jnp.asarray(v) for k, v in g.items()}
            jtb._exposure_grad_accum = jnp.asarray(ge)
            tb._cam_grad_accum = {k: torch.from_numpy(v)
                                  for k, v in g.items()}
            tb._exposure_grad_accum = torch.from_numpy(ge)
            jtb._apply_camera_updates()
            tb._apply_camera_updates()
            assert tb._cam_grad_accum is None
            assert tb._exposure_grad_accum is None
            for name in ("cam_pos_offset", "cam_rot_offset",
                         "cam_focal_offset"):
                a, b = getattr(tb, name), getattr(jtb, name)
                assert a.dtype == np.float32 and np.abs(b).max() > 0
                np.testing.assert_allclose(a, b, err_msg=name, **TOL)
            np.testing.assert_allclose(tb.data.exposures.numpy(),
                                       np.asarray(jtb.data.exposures), **TOL)
            np.testing.assert_allclose(
                tb.data.exposures.numpy().mean(0), 0.0, atol=1e-7)
            cam = tb._cam_dict()
            assert cam is tb._cam_dict()            # cached between updates
            np.testing.assert_array_equal(cam["pos"].numpy(),
                                          tb.cam_pos_offset)
            np.testing.assert_array_equal(cam["focal"].numpy(),
                                          tb.cam_focal_offset)
        assert tb._cam_pos_adam.t == 3
        assert tb._cam_pos_adam.learning_rate == pytest.approx(
            1e-3 * 0.33 ** (2 / 128))
        assert tb.host_syncs["camera_updates"] == syncs0 + 3
        tb._apply_camera_updates()                  # nothing accumulated
        assert tb.host_syncs["camera_updates"] == syncs0 + 3
        for i in range(4):
            np.testing.assert_allclose(tb.effective_xform(i),
                                       jtb.effective_xform(i), rtol=1e-6,
                                       atol=1e-6)
        assert np.abs(tb.effective_xform(1)
                      - tb.data.xforms_start[1].numpy()).max() > 1e-4
        tb.optimize_extrinsics = False              # raw cameras again
        np.testing.assert_array_equal(tb.effective_xform(1),
                                      tb.data.xforms_start[1].numpy())
    finally:
        for t in (jtb, tb):
            t.optimize_extrinsics = t.optimize_focal_length = False
            t.optimize_exposure = False
            t.exposure_l2_reg = 0.0


def test_snapshot_carries_the_camera_block_both_ways(pair, tmp_path):
    jtb, tb = pair
    rng = np.random.default_rng(10)
    tb.cam_pos_offset = rng.normal(0, 0.01, (4, 3)).astype(np.float32)
    tb.cam_rot_offset = rng.normal(0, 0.01, (4, 3)).astype(np.float32)
    tb.cam_focal_offset = rng.normal(0, 0.01, 2).astype(np.float32)
    tb.data.exposures = torch.from_numpy(
        rng.normal(0, 0.1, (4, 3)).astype(np.float32))
    path = str(tmp_path / "port.ingp")
    tb.save_snapshot(path)
    jtb.load_snapshot_state(jax_load_snapshot(path))
    other = make_port_tb(torch.float32)
    other.load_snapshot_state(load_snapshot(path))
    for t in (jtb, other):
        for name in ("cam_pos_offset", "cam_rot_offset",
                     "cam_focal_offset"):
            np.testing.assert_array_equal(np.asarray(getattr(t, name)),
                                          getattr(tb, name), name)
    np.testing.assert_array_equal(np.asarray(jtb.data.exposures),
                                  tb.data.exposures.numpy())
    np.testing.assert_array_equal(other.data.exposures.numpy(),
                                  tb.data.exposures.numpy())
    # and the JAX testbed's snapshot in the port
    jtb.cam_pos_offset = jtb.cam_pos_offset * 2
    path = str(tmp_path / "jax.ingp")
    jtb.save_snapshot(path)
    other.load_snapshot_state(load_snapshot(path))
    np.testing.assert_array_equal(other.cam_pos_offset,
                                  2 * tb.cam_pos_offset)
    # another dataset's per-image state is not restored
    snap = load_snapshot(path)
    snap["dataset_paths"] = ["elsewhere"]
    fresh = make_port_tb(torch.float32)
    fresh.load_snapshot_state(snap)
    assert not fresh.cam_pos_offset.any()
    # clean up the shared pair
    for t in (jtb, tb):
        t.cam_pos_offset = np.zeros((4, 3), np.float32)
        t.cam_rot_offset = np.zeros((4, 3), np.float32)
        t.cam_focal_offset = np.zeros(2, np.float32)
    jtb.data.exposures = jnp.zeros((4, 3))
    tb.data.exposures = torch.zeros(4, 3)


@pytest.mark.parametrize("rays, window", [(512, 128), (4096, 128), (256, 16),
                                          (1 << 14, 128), (7, 1)])
def test_error_map_side_rule_matches_jax(pair, rays, window):
    jtb, tb = pair
    for t in (jtb, tb):
        t._error_map, t._error_map_res = None, (0, 0)
        t._n_steps_since_error_update = 0
        t.rays_per_batch = rays
        t.n_steps_between_error_map_updates = window
        t._maybe_init_error_map()
    assert tb._error_map_res == jtb._error_map_res
    side = max((int((window * rays // 4) ** 0.25 * 3.5) + 7) // 8 * 8, 8)
    assert tb._error_map_res == (min(side, 32), min(side, 32))
    assert tuple(tb._error_map.shape) == tuple(jtb._error_map.shape)
    assert not tb._error_map.any()
    # mid-window the map is kept whatever the rays per batch became
    em = tb._error_map
    tb._n_steps_since_error_update = 3
    tb.rays_per_batch = rays * 16
    tb._maybe_init_error_map()
    assert tb._error_map is em
    # switched off, there is none
    tb._error_map, tb.use_error_map_sampling = None, False
    tb._maybe_init_error_map()
    assert tb._error_map is None
    tb.use_error_map_sampling = True
    for t in (jtb, tb):
        t._error_map, t._error_map_res = None, (0, 0)
        t._n_steps_since_error_update = 0
        t.rays_per_batch, t.n_steps_between_error_map_updates = 512, 128


def test_rebuild_error_cdfs_matches_jax(pair):
    jtb, tb = pair
    rng = np.random.default_rng(12)
    res = (16, 8)
    em = (rng.uniform(size=(4, 16 * 8)) ** 6).astype(np.float32)
    em[1] = 0.0                               # an image at the floor
    em[:, 40:60] = 0.0
    jtb._error_map_res = tb._error_map_res = res
    jtb._error_map, tb._error_map = jnp.asarray(em), torch.from_numpy(em)
    n0 = tb.host_syncs["error_cdfs"]
    jtb._rebuild_error_cdfs()
    tb._rebuild_error_cdfs()
    assert tb.host_syncs["error_cdfs"] == n0 + 1
    assert set(tb._error_cdfs) == set(jtb._error_cdfs)
    for k, ref in jtb._error_cdfs.items():
        ours = tb._error_cdfs[k]
        assert ours.dtype == torch.float32
        assert tuple(ours.shape) == tuple(ref.shape)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6,
                                   atol=1e-9, err_msg=k)
    assert not tb._error_map.any() and tb._error_map.shape == (4, 128)
    np.testing.assert_allclose(tb._error_cdfs["cdf_img"][-1].item(), 1.0)
    for t in (jtb, tb):
        t._error_map, t._error_cdfs, t._error_map_res = None, None, (0, 0)


def test_density_update_with_one_corner_matches_jax():
    """`training_prep` while the stochastic encode is on: one sampled
    corner per cell and level (exact_axes = 0 on an encoding configured
    with 1), with the draws of the JAX update's own key; and the exact
    encode once the schedule says so."""
    jtb = make_jax_tb(jnp.float32)
    tb = make_port_tb(torch.float32)
    tb.load_state(params_from_jax(_numpy_tree(jtb.state)["params"]))
    # a table large enough for densities to depend on the corner
    rng = np.random.default_rng(1)
    table = rng.uniform(-1, 1, tb.model.pos_encoding.n_params).astype(
        np.float32)
    state = _numpy_tree(jtb.state)
    state["params"]["pos_encoding"] = table
    state["opt"]["ema"]["pos_encoding"] = table
    jtb.state = jax.tree_util.tree_map(jnp.asarray, state)
    tb.load_state(params_from_jax(state["params"]))
    feed_jax_draws(tb)
    seen = []
    enc = tb.inference_model.pos_encoding
    real = enc.forward

    def spy(x, max_level=None, draws=None, generator=None, exact_axes=None):
        seen.append((draws is not None, exact_axes))
        return real(x, max_level, draws, generator, exact_axes)

    enc.forward = spy
    for step in (0, 5):             # a full sweep, then uniform + occupied
        jtb.training_step = tb.training_step = step
        jtb.training_prep()
        tb.training_prep()
        np.testing.assert_allclose(tb.density_grid.numpy(),
                                   np.asarray(jtb.density_grid), rtol=1e-3,
                                   atol=1e-7)
        np.testing.assert_array_equal(tb.bitfield.numpy(),
                                      np.asarray(jtb.bitfield))
    assert seen and all(s == (True, 0) for s in seen)
    stoch_grid = tb.density_grid.clone()
    # past the schedule's end: the exact encode, on both sides
    del seen[:]
    for t in (jtb, tb):
        t.stochastic_corners_until = 5
    jtb.training_prep()
    tb.training_prep()
    assert seen and all(s == (False, None) for s in seen)
    np.testing.assert_allclose(tb.density_grid.numpy(),
                               np.asarray(jtb.density_grid), rtol=1e-3,
                               atol=1e-7)
    assert not torch.equal(tb.density_grid, stoch_grid)


def test_render_with_stochastic_corners():
    """Off by default and then the exact frame; on, another frame: fresh
    draws in every network call, the same frame from the same seed. (The
    estimator is unbiased in the features, not through the network's
    nonlinearities, so the frames are not compared in the mean.)"""
    from instant_ngp_tpu_torch.nerf.render import RenderConfig

    assert RenderConfig(8, 8, 0.0, 0, "Logistic",
                        "Exponential").stochastic_corners is False
    tb = make_port_tb(torch.float32)
    rng = np.random.default_rng(2)
    table = rng.uniform(-1, 1, tb.model.pos_encoding.n_params).astype(
        np.float32)
    with torch.no_grad():
        tb.inference_model.pos_encoding.params.copy_(
            torch.from_numpy(table))
    tb.set_density_grid(np.full(128 ** 3, 0.02, np.float32))
    cam = tb.data.xforms_start[0].numpy()
    kw = dict(focal_length=40.0)
    assert tb.render_stochastic_corners is False
    exact = tb.render_frame(16, 16, cam, **kw)
    calls = []
    enc = tb.inference_model.pos_encoding
    real = enc.forward

    def spy(x, max_level=None, draws=None, generator=None, exact_axes=None):
        calls.append(generator)
        return real(x, max_level, draws, generator, exact_axes)

    enc.forward = spy
    tb.render_stochastic_corners = True
    one = tb.render_frame(16, 16, cam, tile=128, **kw)
    assert len(calls) >= 2 and all(g is not None for g in calls)
    assert all(g is calls[0] for g in calls)     # one stream for the frame
    again = tb.render_frame(16, 16, cam, tile=128, **kw)
    assert np.isfinite(one).all() and one.shape == exact.shape
    np.testing.assert_array_equal(one, again)
    assert np.abs(one - exact).mean() > 1e-4
    # the two tiles hold the same pixels' neighbours but other draws: a
    # frame in one tile differs from the frame in two
    whole = tb.render_frame(16, 16, cam, **kw)
    assert np.abs(whole - one).max() > 0
    del calls[:]
    tb.render_stochastic_corners = False
    np.testing.assert_array_equal(tb.render_frame(16, 16, cam, **kw), exact)
    assert calls and all(g is None for g in calls)
