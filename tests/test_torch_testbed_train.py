"""The port's `NerfTestbed` as a trainer against the JAX package's: the
`train` loop with its density-update cadence, the adaptation of the rays
per batch and the abort on an empty batch, snapshots in both directions,
and `eval_psnr`. Sizes, draws and tolerances are those of
tests/test_torch_training.py, whose helpers build the two testbeds with
the JAX testbed's defaults (stochastic-corner encode, error-map sampling)
or, in the cases named "exact", with both off: 8 steps of the loop at
float32 hold each loss to rtol 2e-3 (which holds while both sides march
the same sample sets); 48 steps with the defaults, CDF rebuilds every 16
steps and camera, focal and exposure updates at steps 16, 32 and 48 hold
each loss to 2e-3 as well; frames rendered from a snapshot loaded by the
other package agree to rtol/atol 1e-4."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_training import (N_RAYS, TRAIN_CFG, _numpy_tree,  # noqa: E402
                                 assert_host_adam_close, feed_jax_draws,
                                 make_jax_tb, make_port_tb)

from instant_ngp_tpu.data.snapshot import load_snapshot as jax_load_snapshot
from instant_ngp_tpu_torch.convert import params_from_jax
from instant_ngp_tpu_torch.data.snapshot import load_snapshot
from instant_ngp_tpu_torch.nerf.dataset import scene_config
from instant_ngp_tpu_torch.nerf.testbed_nerf import NerfTestbed

torch.set_num_threads(2)


MODES = pytest.mark.parametrize("exact", [True, False],
                                ids=["exact", "default"])


@MODES
def test_eight_steps_of_the_loop_match_jax(exact):
    """train() itself: a prep at steps 0-3 (the warm-up cadence) and a
    mixed uniform + occupied one at step 4, 8 steps, float32."""
    jtb = make_jax_tb(jnp.float32, prep_every=4, exact=exact)
    tb = make_port_tb(torch.float32, prep_every=4, exact=exact)
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


def _make_48(**switches):
    jtb = make_jax_tb(jnp.float32, prep_every=16)
    tb = make_port_tb(torch.float32, prep_every=16)
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
    to 5e-3, the exposures as `assert_host_adam_close` states."""
    jtb, tb = _make_48(optimize_exposure=True)
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
    through 32 steps of rays built from non-zero offsets."""
    jtb, tb = _make_48(optimize_extrinsics=True, optimize_focal_length=True,
                       optimize_exposure=True)
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
    tb = make_port_tb(torch.float32)
    tb.adapt_ray_batch = True
    loss = tb.train(3)
    assert np.isfinite(loss) and loss == tb.loss_scalar
    # towards target / measured, capped by the generated samples
    assert tb.rays_per_batch != N_RAYS
    assert 256 <= tb.rays_per_batch <= 1 << 14
    perf = tb.performance_stats()
    assert perf["measured_batch_size"] == tb.measured_batch_size > 0
    assert {"training_prep", "train_step", "train_sync"} <= set(
        perf["phase_ms"])
    # an empty occupancy grid generates no samples: the loop aborts
    tb.warmup_full_grid_preps = 0
    tb.training_step = 1
    tb.bitfield.zero_()
    with pytest.raises(RuntimeError, match="0 samples"):
        tb.train(1)
    # a render-only testbed does not train
    with pytest.raises(RuntimeError, match="only renders"):
        NerfTestbed(scene_config(1), TRAIN_CFG, device="cpu").train(1)


# -- snapshots, both ways -----------------------------------------------------
@MODES
def test_snapshot_cross_loads_both_ways(tmp_path, exact):
    jtb = make_jax_tb(jnp.float32, exact=exact)
    tb = make_port_tb(torch.float32, exact=exact)
    feed_jax_draws(tb)
    tb.train(3)
    cam = tb.data.xforms_start[2].numpy()
    kw = dict(focal_length=40.0, min_transmittance=1e-4,
              background_color=(0.1, 0.2, 0.3))

    # the port's snapshot in the JAX testbed
    path = str(tmp_path / "port.ingp")
    tb.save_snapshot(path)
    jtb.load_snapshot_state(jax_load_snapshot(path))
    assert jtb.training_step == 3 and jtb.density_grid_ema_step == 3
    assert int(jtb.state["opt"]["step"]) == 3
    np.testing.assert_array_equal(
        np.asarray(jtb.state["opt"]["ema"]["rgb_net"][1]),
        tb.opt_state["ema"]["rgb_net"][1].numpy())
    np.testing.assert_array_equal(np.asarray(jtb.bitfield),
                                  tb.bitfield.numpy())
    np.testing.assert_allclose(jtb.render_frame(16, 16, cam, tile=256, **kw),
                               tb.render_frame(16, 16, cam, **kw),
                               rtol=1e-4, atol=1e-4)
    # and it trains on from there like the port does (same draws)
    jloss, loss = jtb.train(1), tb.train(1)
    np.testing.assert_allclose(loss, jloss, rtol=2e-3)

    # the JAX testbed's snapshot in the port
    path = str(tmp_path / "jax.ingp")
    jtb.save_snapshot(path)
    other = make_port_tb(torch.float32, exact=exact)
    other.load_snapshot_state(load_snapshot(path))
    assert other.training_step == 4 and int(other.opt_state["step"]) == 4
    jstate = _numpy_tree(jtb.state)
    for name in ("m", "v", "ema"):
        np.testing.assert_array_equal(
            other.opt_state[name]["pos_encoding"].numpy(),
            jstate["opt"][name]["pos_encoding"])
    np.testing.assert_array_equal(
        other.model.density_net.weights[0].detach().numpy(),
        jstate["params"]["density_net"][0])
    # the loaded EMA leaves are still the inference network's tensors
    assert other.opt_state["ema"]["pos_encoding"] \
        is other.inference_model.pos_encoding.params
    np.testing.assert_allclose(other.render_frame(16, 16, cam, **kw),
                               jtb.render_frame(16, 16, cam, tile=256, **kw),
                               rtol=1e-4, atol=1e-4)


@MODES
def test_eval_psnr_matches_jax(exact):
    jtb = make_jax_tb(jnp.float32, exact=exact)
    jtb.train(4)
    tb = make_port_tb(torch.float32, jax_tb=jtb, exact=exact)
    for downscale in (1, 2):
        np.testing.assert_allclose(tb.eval_psnr(1, downscale=downscale),
                                   jtb.eval_psnr(1, downscale=downscale),
                                   rtol=1e-4)
    view = tb.render_training_view(0, width=16, height=16)
    np.testing.assert_allclose(
        view, jtb.render_training_view(0, width=16, height=16), rtol=1e-4,
        atol=1e-4)
    assert tb._derive_n_march() == jtb._derive_n_march()
    for n in (256, 1000, 4096, 1 << 14):
        assert tb._bucket_k(n) == jtb._bucket_k(n)


def test_chip_smoke_scene_is_the_jax_scripts_scene():
    """`chip_smoke.py` raytraces its own copy of the synthetic orbit scene
    (it may import nothing of the JAX package): the same images, cameras
    and intrinsics as scripts/time_to_30db_r5.py::make_scene."""
    import importlib.util

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def load(name, path):
        spec = importlib.util.spec_from_file_location(name, path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module

    ours = load("chip_smoke", os.path.join(repo, "chip_smoke.py")) \
        .make_scene(n_cams=3, size=24)
    ref = load("time_to_30db_r5", os.path.join(
        repo, "scripts", "time_to_30db_r5.py")).make_scene(n_cams=3, size=24)
    assert ours.n_images == ref.n_images == 3 and ours.aabb_scale == 1
    np.testing.assert_array_equal(ours.xforms_start, ref.xforms_start)
    np.testing.assert_array_equal(ours.xforms_end, ref.xforms_end)
    for a, b, ma, mb in zip(ours.images, ref.images, ours.metadata,
                            ref.metadata):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == np.uint8 and 0 < (a[..., 3] > 0).mean() < 1
        assert ma.resolution == mb.resolution
        np.testing.assert_array_equal(ma.focal_length, mb.focal_length)
        np.testing.assert_array_equal(ma.principal_point, mb.principal_point)
        assert ma.lens.mode == mb.lens.mode == "Perspective"
