"""The port's `NerfTestbed` as a trainer against the JAX package's: the
`train` loop with its density-update cadence, the adaptation of the rays
per batch and the abort on an empty batch (snapshots in both directions
and `eval_psnr`: tests/test_torch_testbed_snapshots.py). Sizes, draws and
tolerances are those of tests/test_torch_training.py; tests/torch_parity.py
builds the two testbeds with the JAX testbed's defaults (stochastic-corner
encode, error-map sampling) or, in the cases named "exact", with both off:
8 steps of the loop at float32 hold each loss to rtol 2e-3 (which holds
while both sides march the same sample sets); 48 steps with the defaults,
CDF rebuilds every 16 steps and camera, focal and exposure updates at
steps 16, 32 and 48 hold each loss to 2e-3 as well."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(__file__))
from torch_parity import (N_RAYS, TRAIN_CFG, _numpy_tree,  # noqa: E402
                          assert_host_adam_close, feed_jax_draws,
                          make_jax_tb, make_port_tb)

from instant_ngp_tpu_torch.convert import params_from_jax
from instant_ngp_tpu_torch.nerf.dataset import scene_config
from instant_ngp_tpu_torch.nerf.testbed_nerf import NerfTestbed
from instant_ngp_tpu_torch.utils import clear_spans, span_ms

MODES = pytest.mark.parametrize("exact", [True, False],
                                ids=["exact", "default"])


@MODES
def test_eight_steps_of_the_loop_match_jax(exact):
    """train() itself: a prep at steps 0-3 (the warm-up cadence) and a
    mixed uniform + occupied one at step 4, 8 steps, float32. The default
    cadence is the subject: 4 full sweeps."""
    jtb = make_jax_tb(jnp.float32, prep_every=4, exact=exact, full_preps=4)
    tb = make_port_tb(torch.float32, prep_every=4, exact=exact,
                      full_preps=4)
    state = _numpy_tree(jtb.state)
    tb.load_state(params_from_jax(state["params"]))
    feed_jax_draws(tb)
    ref, ours = [], []
    for _ in range(8):
        ref.append(jtb.train(1))
        ours.append(tb.train(1))
        assert tb.measured_batch_size == jtb.measured_batch_size > 0
        assert tb.measured_batch_size_before_compaction == \
            jtb.measured_batch_size_before_compaction
    assert tb.density_grid_ema_step == jtb.density_grid_ema_step == 5
    assert tb.training_step == 8
    np.testing.assert_allclose(ours, ref, rtol=2e-3)
    np.testing.assert_array_equal(
        np.unpackbits(tb.bitfield.numpy()).sum(),
        np.unpackbits(np.asarray(jtb.bitfield)).sum())
    np.testing.assert_allclose(tb.density_grid.numpy(),
                               np.asarray(jtb.density_grid), rtol=1e-3,
                               atol=1e-7)
    # untrained cells were marked at step 0
    assert (tb.density_grid < 0).any()
    assert (tb._error_map is None) == exact
    if not exact:
        np.testing.assert_allclose(tb._error_map.numpy(),
                                   np.asarray(jtb._error_map), rtol=2e-3,
                                   atol=1e-8)
        assert tb._error_map.sum() > 0 and tb._error_cdfs is None


def _run_48(jtb, tb, after_16=None):
    """6 x 8 steps of `train` on both sides -> (port losses, JAX losses);
    both must march the same rays and, but for a sample at the edge of
    the transmittance cutoff or of an occupancy threshold, the same
    samples."""
    ref, ours = [], []
    for i in range(6):
        ref.append(jtb.train(8))
        ours.append(tb.train(8))
        for name in ("measured_batch_size",
                     "measured_batch_size_before_compaction"):
            a, b = getattr(tb, name), getattr(jtb, name)
            assert b > 0 and abs(a - b) <= max(2, 0.005 * b), name
        if after_16 is not None and i % 2 == 1:
            after_16()
    assert tb.training_step == jtb.training_step == 48
    return ours, ref


def _make_48(full_preps=1, **switches):
    jtb = make_jax_tb(jnp.float32, prep_every=16, full_preps=full_preps)
    tb = make_port_tb(torch.float32, prep_every=16, full_preps=full_preps)
    tb.load_state(params_from_jax(_numpy_tree(jtb.state)["params"]))
    feed_jax_draws(tb)
    for t in (jtb, tb):
        t.n_steps_between_error_map_updates = 16
        for name, value in switches.items():
            setattr(t, name, value)
        assert t.cam_grad_interval == t.n_steps_between_cam_updates == 16
    return jtb, tb


def test_48_steps_with_the_jax_defaults_match_jax():
    """`train` as the JAX testbed ships it: stochastic corners (j = 1,
    one-corner backward; one corner in the density updates) and the error
    map, its CDFs rebuilt every 16 steps so that the picks of steps 16-47
    follow them; besides, exposure optimisation with the host Adam's
    updates at steps 16, 32 and 48. Every loss to rtol 2e-3, the last CDFs
    to 5e-3, the exposures as `assert_host_adam_close` states. The
    testbeds' own cadence: 4 full sweeps."""
    jtb, tb = _make_48(full_preps=4, optimize_exposure=True)
    ours, ref = _run_48(jtb, tb)
    np.testing.assert_allclose(ours, ref, rtol=2e-3)
    assert tb.host_syncs == {"camera_updates": 3, "error_cdfs": 3}
    assert tb._exposure_adam.t == jtb._exposure_adam.t == 3
    assert tb._error_map_res == jtb._error_map_res
    # a row's conditional CDF is a ratio of a few rays' losses after 48
    # steps of drift: 5e-3 of the CDFs' range
    for k, v in jtb._error_cdfs.items():
        np.testing.assert_allclose(tb._error_cdfs[k].numpy(), np.asarray(v),
                                   rtol=0, atol=5e-3, err_msg=k)
    assert_host_adam_close(tb.data.exposures.numpy(), jtb.data.exposures,
                           "exposures", 3)
    assert not tb.cam_pos_offset.any() and tb._cam_grad_accum is None
    np.testing.assert_array_equal(
        np.unpackbits(tb.bitfield.numpy()).sum(),
        np.unpackbits(np.asarray(jtb.bitfield)).sum())


def test_48_steps_with_camera_optimisation_match_jax():
    """The same 48 steps with pose, focal and exposure optimisation: the
    camera gradient is taken on steps 15, 31 and 47 alone (`cam_grad_
    interval` at its default 16, the exact encode on those steps), scaled
    by 16, and applied at steps 16, 32 and 48.

    Two runs whose network parameters differ where Adam (eps 1e-15) steps
    on noise-level gradients agree in the loss, but not closely in a pose
    gradient; the first host-Adam step then turns a small entry of either
    sign into a full-size step, and from there the two sides would march
    other rays. So the accumulated gradients are recorded before each
    update and held to 10 % of their largest entry (one step's gradients
    from the same state are held to 2e-3 in tests/test_torch_training.py,
    the update itself to 1e-6 in tests/test_torch_camera_opt.py), and after
    each update the port takes the JAX testbed's pose and focal offsets;
    the exposures are left alone. With that every loss holds to 2e-3,
    through 32 steps of rays built from non-zero offsets. 4 full sweeps:
    after 1 a pose gradient drifts past the 10 %."""
    jtb, tb = _make_48(full_preps=4, optimize_extrinsics=True,
                       optimize_focal_length=True, optimize_exposure=True)
    recorded = {"jax": [], "port": []}

    def record(t, store):
        real = t._apply_camera_updates

        def wrapper():
            store.append({k: np.asarray(v).copy()
                          for k, v in t._cam_grad_accum.items()})
            real()
        t._apply_camera_updates = wrapper

    record(jtb, recorded["jax"])
    record(tb, recorded["port"])
    own = []

    def take_jax_offsets():
        own.append({k: getattr(tb, k).copy() for k in (
            "cam_pos_offset", "cam_rot_offset", "cam_focal_offset")})
        tb.cam_pos_offset = np.array(jtb.cam_pos_offset, np.float32)
        tb.cam_rot_offset = np.array(jtb.cam_rot_offset, np.float32)
        tb.cam_focal_offset = np.array(jtb.cam_focal_offset, np.float32)

    ours, ref = _run_48(jtb, tb, after_16=take_jax_offsets)
    np.testing.assert_allclose(ours, ref, rtol=2e-3)
    assert tb.host_syncs == {"camera_updates": 3, "error_cdfs": 3}
    assert len(recorded["jax"]) == len(recorded["port"]) == 3
    for a, b in zip(recorded["port"], recorded["jax"]):
        for k in ("pos", "rot", "focal"):
            top = np.abs(b[k]).max()
            assert top > 0
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=0.1 * top,
                                       err_msg=k)
    # the port's own updates moved every offset by about a learning rate
    for k, lr in (("cam_pos_offset", 1e-3), ("cam_rot_offset", 1e-3),
                  ("cam_focal_offset", 1e-5)):
        first = np.abs(own[0][k])
        assert 0.5 * lr < first.max() <= 1.001 * lr, k
    assert_host_adam_close(tb.data.exposures.numpy(), jtb.data.exposures,
                           "exposures", 3)
    # the device copy followed the host arrays
    np.testing.assert_array_equal(tb._cam_dict()["pos"].numpy(),
                                  tb.cam_pos_offset)
    np.testing.assert_allclose(tb.effective_xform(2),
                               jtb.effective_xform(2), rtol=1e-6, atol=1e-6)


def test_train_adapts_rays_and_aborts_on_zero_samples():
    # step 3 preps: 4 full sweeps, the default
    tb = make_port_tb(torch.float32, full_preps=4)
    tb.adapt_ray_batch = True
    loss = tb.train(3)
    assert np.isfinite(loss) and loss == tb.loss_scalar
    # towards target / measured, capped by the generated samples
    assert tb.rays_per_batch != N_RAYS
    assert 256 <= tb.rays_per_batch <= 1 << 14
    perf = tb.performance_stats()
    assert perf["measured_batch_size"] == tb.measured_batch_size > 0
    # the loop's phases are spans, recorded only under a profiler
    assert "phase_ms" not in perf
    clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        tb.train(1)
    for name in ("nerf.prep", "nerf.step", "nerf.sync"):
        assert len(span_ms(name)) == 1, name
    clear_spans()
    # an empty occupancy grid generates no samples: the loop aborts
    tb.warmup_full_grid_preps = 0
    tb.training_step = 1
    tb.bitfield.zero_()
    with pytest.raises(RuntimeError, match="0 samples"):
        tb.train(1)
    # a render-only testbed does not train
    with pytest.raises(RuntimeError, match="only renders"):
        NerfTestbed(scene_config(1), TRAIN_CFG, device="cpu").train(1)
