"""The port's `NerfTestbed` snapshots in both directions and its
`eval_psnr` against the JAX package's, with the sizes, draws and helpers of
tests/test_torch_training.py (cases "exact": the stochastic-corner encode
and error-map sampling off on both sides): frames rendered from a snapshot
loaded by the other package agree to rtol/atol 1e-4, a step trained on from
it to 2e-3, PSNR to rtol 1e-4. Also: `chip_smoke.py`'s own copy of the
synthetic orbit scene equals the JAX package's script's."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_training import (_numpy_tree, feed_jax_draws,  # noqa: E402
                                 make_jax_tb, make_port_tb)

from instant_ngp_tpu.data.snapshot import load_snapshot as jax_load_snapshot
from instant_ngp_tpu_torch.data.snapshot import load_snapshot

torch.set_num_threads(2)


MODES = pytest.mark.parametrize("exact", [True, False],
                                ids=["exact", "default"])


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
