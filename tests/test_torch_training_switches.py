"""The training switches of the port's NeRF testbed against the JAX
package, on the tiny synthetic dataset of tests/test_torch_training.py
(its helpers and tolerances): each switch that used to raise, alone on
top of the exact uniform configuration, over 6 steps of `train`; the
buffers' switches; what is left to raise (the scanned multi-step block,
a device mesh); datasets with latent dims or depths; the mesh tools on a
training testbed."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_nerf_training import make_dataset  # noqa: E402
from test_torch_sampler import port_dataset  # noqa: E402
from test_torch_training import (TRAIN_CFG, _numpy_tree,  # noqa: E402
                                 assert_host_adam_close, feed_jax_draws,
                                 make_jax_tb, make_port_tb)

from instant_ngp_tpu_torch.convert import params_from_jax
from instant_ngp_tpu_torch.data.nerf_loader import NerfDataset
from instant_ngp_tpu_torch.nerf import training
from instant_ngp_tpu_torch.nerf.testbed_nerf import NerfTestbed

torch.set_num_threads(2)


# -- the switches of the remainder --------------------------------------------
@pytest.mark.parametrize("switch, value", [
    ("optimize_extra_dims", True), ("train_envmap", True),
    ("optimize_distortion", True), ("steps_per_dispatch", 16)])
def test_out_of_scope_switch_raises(switch, value):
    """Only the scanned multi-step block is left to raise. The three
    buffers' switches train: a step returns the buffer's gradient and the
    buffer moves (`optimize_extra_dims` on a dataset without extra dims
    has nothing to move and changes nothing). Their values against the JAX
    package are in tests/test_torch_nerf_extras.py."""
    tb = make_port_tb(torch.float32)
    tb.training_step = 5                      # no prep needed
    setattr(tb, switch, value)
    if switch == "steps_per_dispatch":
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tb.train(1)
        return
    buf = {"train_envmap": tb.envmap,
           "optimize_distortion": tb.distortion_map}.get(switch)
    before = None if buf is None else buf.params.clone()
    tb.update_density_grid_full()
    stats = tb.train_step()
    assert np.isfinite(float(stats["loss"]))
    if buf is None:
        assert tb._extra_dims_buf is None
        assert "extra_dims_gradient" not in stats
    else:
        name = {"train_envmap": "envmap_gradient",
                "optimize_distortion": "distortion_gradient"}[switch]
        assert stats[name].shape == buf.params.shape
        assert stats[name].abs().max() > 0
        assert not torch.equal(buf.params, before)


@pytest.mark.parametrize("switch", [
    "stochastic_corners", "use_error_map_sampling", "optimize_extrinsics",
    "optimize_focal_length", "optimize_exposure"])
def test_ported_switch_matches_jax(switch):
    """Each switch that used to raise, alone on top of the exact uniform
    configuration, over 6 steps of `train` on both sides with updates
    every 2 steps (camera, exposure) or CDFs after 3 (error map): losses to
    rtol 2e-3, and what the switch moves (offsets, exposures, the error
    CDFs) to the tolerance stated beside it."""
    jtb = make_jax_tb(jnp.float32, prep_every=4, exact=True)
    tb = make_port_tb(torch.float32, prep_every=4, exact=True)
    tb.load_state(params_from_jax(_numpy_tree(jtb.state)["params"]))
    feed_jax_draws(tb)
    for t in (jtb, tb):
        setattr(t, switch, True)
        t.cam_grad_interval = 1
        t.n_steps_between_cam_updates = 2
        t.n_steps_between_error_map_updates = 3
    ref = [jtb.train(1) for _ in range(6)]
    ours = [tb.train(1) for _ in range(6)]
    np.testing.assert_allclose(ours, ref, rtol=2e-3)
    assert tb.measured_batch_size == jtb.measured_batch_size > 0
    if switch == "use_error_map_sampling":
        assert tb.host_syncs == {"camera_updates": 0, "error_cdfs": 2}
        for k, v in jtb._error_cdfs.items():
            np.testing.assert_allclose(tb._error_cdfs[k].numpy(),
                                       np.asarray(v), rtol=2e-3, atol=1e-6,
                                       err_msg=k)
    elif switch.startswith("optimize"):
        assert tb.host_syncs == {"camera_updates": 3, "error_cdfs": 0}
        moved = {"optimize_extrinsics": ("cam_pos_offset",
                                         "cam_rot_offset"),
                 "optimize_focal_length": ("cam_focal_offset",),
                 "optimize_exposure": ("exposures",)}[switch]
        for name, adam in (("cam_pos_offset", "_cam_pos_adam"),
                           ("cam_rot_offset", "_cam_rot_adam"),
                           ("cam_focal_offset", "_focal_adam"),
                           ("exposures", "_exposure_adam")):
            a, b = (tb.data.exposures.numpy(), jtb.data.exposures) \
                if name == "exposures" \
                else (getattr(tb, name), getattr(jtb, name))
            if name in moved:
                assert getattr(tb, adam).t == getattr(jtb, adam).t == 3
                assert_host_adam_close(a, b, name, 3)
            else:
                assert not np.asarray(b).any() and not a.any(), name


def test_out_of_scope_datasets_and_mesh_raise():
    # a mesh trains data parallel (tests/test_torch_parallel*.py); what is
    # not a parallel.mesh.Mesh raises
    with pytest.raises(TypeError, match="mesh"):
        NerfTestbed(port_dataset(make_dataset()), TRAIN_CFG, device="cpu",
                    mesh=object())
    # datasets with latent dims or depth images no longer raise: they pack
    ds = port_dataset(make_dataset())
    ds.n_extra_learnable_dims = 2
    composite = dict(TRAIN_CFG, dir_encoding={"otype": "Composite", "nested": [
        {"n_dims_to_encode": 3, "otype": "SphericalHarmonics", "degree": 4},
        {"otype": "Identity"}]})
    tb = NerfTestbed(ds, composite, device="cpu")
    assert tb.data.extra_dims.shape == (4, 2) and tb.optimize_extra_dims
    assert tb.data.extra_dims is tb._extra_dims_buf.params
    assert tb.model.rgb_net.weights[0].shape[0] == 16 + 16 + 2
    ds = port_dataset(make_dataset())
    ds.depths = [np.ones((32, 32), np.float32)] * 4
    tb = NerfTestbed(ds, TRAIN_CFG, device="cpu")
    assert tb.data.depths.shape == (4, 32, 32)
    tb.depth_supervision_lambda = 1.0
    assert tb._train_cfg(8, 8).depth_supervision_lambda == 1.0
    assert not hasattr(training, "check_ported")
    # the mesh tools run on a training testbed (held against the JAX
    # package in tests/test_torch_mesh_flip.py), an empty mesh included
    raw = tb.density_on_grid(12)
    for thresh in (float(np.median(raw)), float(raw.max()) + 1.0):
        verts, faces, colors = tb.compute_marching_cubes_mesh(12, thresh)
        assert verts.shape == colors.shape and verts.shape[1:] == (3,)
        assert faces.shape[1:] == (3,) and (len(faces) > 0) == (
            thresh < raw.max())
        assert tb.optimise_mesh_step(verts, faces).shape == verts.shape
    assert isinstance(ds, NerfDataset)
