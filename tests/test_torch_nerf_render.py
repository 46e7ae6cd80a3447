"""The port's render slice against the JAX package on a tiny trained NeRF.

A JAX NerfTestbed (the synthetic scene and config of
tests/test_nerf_training.py, with base.json's F=4 features and Composite
direction encoding) trains a few steps; its Ema parameters and density
grid go into the port, and both render the same camera.

Tolerances: at float32 compute the two sides differ only in summation
order and in ulps of exp/log, so frames agree to rtol/atol 1e-4 (as the
JAX package holds its own two renderers to each other). At bf16 compute a
hidden activation near a bf16 rounding boundary can round the other way
(see test_torch_mlp_kernels.py), which moves a sample's colour or density
by up to ~1e-2 relative; composited frames agree to atol 5e-3."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_nerf_training import CFG, make_dataset  # noqa: E402

from instant_ngp_tpu.data.snapshot import load_snapshot as jax_load_snapshot
from instant_ngp_tpu.data.snapshot import save_snapshot as jax_save_snapshot
from instant_ngp_tpu.nerf import occupancy as jocc
from instant_ngp_tpu.nerf.model import NerfNetwork as JaxNerfNetwork
from instant_ngp_tpu.nerf.testbed_nerf import NerfTestbed as JaxTestbed
from instant_ngp_tpu.ops.sampling import \
    ld_pixel_offset as jax_ld_pixel_offset
from instant_ngp_tpu_torch.convert import params_from_jax
from instant_ngp_tpu_torch.data.snapshot import load_snapshot
from instant_ngp_tpu_torch.nerf.dataset import scene_config
from instant_ngp_tpu_torch.nerf.model import NerfNetwork
from instant_ngp_tpu_torch.nerf.render import WavefrontRenderer
from instant_ngp_tpu_torch.nerf.testbed_nerf import NerfTestbed
from instant_ngp_tpu_torch.ops.sampling import ld_pixel_offset

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLICE_CFG = dict(
    CFG,
    encoding=dict(CFG["encoding"], n_features_per_level=4),
    dir_encoding={"otype": "Composite", "nested": [
        {"n_dims_to_encode": 3, "otype": "SphericalHarmonics", "degree": 4},
        {"otype": "Identity"}]})
RENDER_KW = dict(focal_length=40.0, min_transmittance=1e-4,
                 background_color=(0.1, 0.2, 0.3))
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def jax_tb():
    tb = JaxTestbed(make_dataset(), SLICE_CFG, compute_dtype=jnp.float32)
    tb.target_batch_size = 1 << 12
    tb.rays_per_batch = 1 << 10
    tb.n_march = 96
    tb.max_samples_per_ray = 64
    tb.density_samples_override = 1 << 12
    tb.steps_per_dispatch = 1
    tb.train(6)
    return tb


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_testbed(jax_tb, dtype, params=None, grid=None):
    tb = NerfTestbed(scene_config(jax_tb.scene.aabb_scale), SLICE_CFG,
                     device="cpu", compute_dtype=dtype)
    tb.n_march = jax_tb.n_march
    tb.max_samples_per_ray = jax_tb.max_samples_per_ray
    tb.load_params(params if params is not None else
                   params_from_jax(_numpy_tree(jax_tb.inference_params())))
    tb.set_density_grid(np.asarray(jax_tb.density_grid) if grid is None
                        else grid)
    return tb


def _jax_frame(jax_tb, cam, dtype=jnp.float32, size=16, spp=1):
    """The JAX testbed's frame at compute dtype `dtype`."""
    nets = (jax_tb.model.density_net, jax_tb.model.rgb_net)
    for net in nets:
        net.compute_dtype = dtype
    jax_tb._render_fns = {}
    try:
        return jax_tb.render_frame(size, size, cam, tile=256, spp=spp,
                                   **RENDER_KW)
    finally:
        for net in nets:
            net.compute_dtype = jnp.float32
        jax_tb._render_fns = {}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_apply_components_matches_jax(jax_tb, dtype):
    jdt, tdt = DTYPES[dtype]
    params = _numpy_tree(jax_tb.inference_params())
    jax_net = JaxNerfNetwork(
        3, 3, 0, SLICE_CFG["encoding"], SLICE_CFG["dir_encoding"],
        SLICE_CFG["network"], SLICE_CFG["rgb_network"], compute_dtype=jdt)
    net = NerfNetwork(
        3, 3, 0, SLICE_CFG["encoding"], SLICE_CFG["dir_encoding"],
        SLICE_CFG["network"], SLICE_CFG["rgb_network"], compute_dtype=tdt)
    net.load_params(params_from_jax(params))
    rng = np.random.default_rng(11)
    pos = rng.uniform(0.2, 0.8, (2000, 3)).astype(np.float32)
    d = rng.normal(size=(2000, 3))
    dirs = ((d / np.linalg.norm(d, axis=-1, keepdims=True) + 1.0) * 0.5) \
        .astype(np.float32)
    ref = np.stack([np.asarray(c) for c in jax_net.apply_components(
        params, [jnp.asarray(pos[:, k]) for k in range(3)],
        [jnp.asarray(dirs[:, k]) for k in range(3)])], -1)
    with torch.no_grad():
        ours = net.apply_components(torch.from_numpy(pos),
                                    torch.from_numpy(dirs)).numpy()
    assert ours.shape == (2000, 4) and np.isfinite(ours).all()
    if dtype == "f32":
        np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(ours, ref, rtol=1e-2, atol=2e-3)
        assert np.isclose(ours, ref, rtol=1e-5, atol=1e-6).mean() >= 0.99


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_render_frame_matches_jax(jax_tb, dtype):
    jdt, tdt = DTYPES[dtype]
    tb = _port_testbed(jax_tb, tdt)
    np.testing.assert_array_equal(tb.bitfield.numpy(),
                                  np.asarray(jax_tb.bitfield))
    for view, spp in ((0, 1), (2, 2)):
        cam = np.asarray(jax_tb.data.xforms_start[view])
        ref = _jax_frame(jax_tb, cam, jdt, spp=spp)
        ours = tb.render_frame(16, 16, cam, spp=spp, tile=100, **RENDER_KW)
        assert ours.shape == (16, 16, 4) and np.isfinite(ours).all()
        assert ours[..., 3].max() > 0.005   # the scene is not empty
        assert tb.last_frame_n_samples > 0
        if dtype == "f32":
            np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-4)
        else:
            np.testing.assert_allclose(ours, ref, rtol=0, atol=5e-3)


@pytest.mark.parametrize("fmt", ["ingp", "planar_msgpack"])
def test_snapshot_round_trip_renders_like_jax(jax_tb, tmp_path, fmt):
    path = str(tmp_path / "snap.ingp")
    jax_tb.save_snapshot(path)
    if fmt == "planar_msgpack":
        # an older snapshot: the grid table stored feature-major
        snap = jax_load_snapshot(path)
        assert snap["grid_layout"] == "interleaved"
        ema = snap["trainer"]["opt"]["ema"]
        ema["pos_encoding"] = ema["pos_encoding"].reshape(-1, 4).T.reshape(-1)
        snap["grid_layout"] = "planar"
        path = str(tmp_path / "snap.msgpack")
        jax_save_snapshot(path, snap)
    snap = load_snapshot(path)
    assert snap["config"] == jax_tb.config
    tb = _port_testbed(jax_tb, torch.float32, snap["params"],
                       snap["density_grid"])
    cam = np.asarray(jax_tb.data.xforms_start[1])
    np.testing.assert_allclose(
        tb.render_frame(16, 16, cam, **RENDER_KW), _jax_frame(jax_tb, cam),
        rtol=1e-4, atol=1e-4)


def test_density_grid_pass_matches_jax(jax_tb):
    """One density pass (the JAX testbed's exact-encode density update)
    over 2^16 cells the JAX testbed samples, from the same grid, with the
    cells and jitter it drew handed to the port. Grid values hold to rtol
    1e-5; the bitfield thresholds at the grid mean, so a cell within an
    ulp of it may flip (<= 1e-5 of cells)."""
    n_query = 1 << 16
    rng_key = jax.random.PRNGKey(5)
    params = jax_tb.inference_params()
    stoch = jax_tb.stochastic_corners
    jax_tb.stochastic_corners = False
    try:
        # the evaluation half of the JAX update; the rest of that update
        # is exactly the three calls below
        idx, dens = jax.jit(jax_tb._density_update_body(
            n_query, 0, evaluate_only=True))(
                params, jax_tb.density_grid, rng_key, 0.95)
    finally:
        jax_tb.stochastic_corners = stoch
    ref_grid = jocc.splat_and_ema(jax_tb.density_grid, idx, dens, 0.95)
    ref_bits = jocc.update_bitfield(ref_grid, jax_tb.scene.max_cascade)
    ref_mean = jocc.density_grid_mean(ref_grid)
    k_pos = jax.random.split(rng_key, 3)[1]
    jitter = np.stack([np.asarray(jax.random.uniform(k, idx.shape,
                                                     jnp.float32))
                       for k in jax.random.split(k_pos, 3)], -1)

    tb = _port_testbed(jax_tb, torch.float32)
    tb.update_density_grid(torch.from_numpy(np.array(idx)),
                           torch.from_numpy(jitter), decay=0.95)
    np.testing.assert_allclose(tb.density_grid.numpy(),
                               np.asarray(ref_grid), rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(tb.mean_density.item(), float(ref_mean),
                               rtol=1e-5)
    bits = np.unpackbits(tb.bitfield.numpy())
    ref = np.unpackbits(np.asarray(ref_bits))
    assert ref.sum() > 0
    assert (bits != ref).mean() <= 1e-5


def test_chunked_march_and_network_calls_change_nothing(jax_tb,
                                                        monkeypatch):
    """Rays marched in several chunks, networks called on several slices
    of a round and frames cut into tiles give the frame of one piece each
    (float32 matmuls of other batch sizes may round differently: 1e-6)."""
    tb = _port_testbed(jax_tb, torch.float32)
    cam = np.asarray(jax_tb.data.xforms_start[3])
    whole = tb.render_frame(16, 16, cam, **RENDER_KW)
    monkeypatch.setattr(WavefrontRenderer, "march_chunk", 37)
    tb.render_query_budget = 777
    pieces = tb.render_frame(16, 16, cam, tile=100, **RENDER_KW)
    np.testing.assert_allclose(pieces, whole, rtol=1e-6, atol=1e-6)


def test_ld_pixel_offset_matches_jax():
    for s in range(9):
        np.testing.assert_array_equal(
            np.float32(ld_pixel_offset(s)),
            np.asarray(jax_ld_pixel_offset(s)))


def test_port_imports_without_jax():
    """The port imports and renders with jax, msgpack, PIL and the JAX
    package made unimportable, as on a machine that has none of them."""
    code = r"""
import importlib, importlib.abc, pkgutil, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "msgpack", "PIL",
                                  "instant_ngp_tpu"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import numpy as np
import instant_ngp_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
from instant_ngp_tpu_torch.config import (find_network_config,
                                          load_network_config)
from instant_ngp_tpu_torch.nerf.dataset import scene_config
from instant_ngp_tpu_torch.nerf.testbed_nerf import NerfTestbed
from instant_ngp_tpu_torch.ops.sampling import ld_pixel_offset
cfg = load_network_config(find_network_config("base", "nerf"))
cfg["encoding"]["log2_hashmap_size"] = 12
tb = NerfTestbed(scene_config(1), cfg, device="cpu", seed=0)
tb.set_density_grid(np.full(128 ** 3, 0.02, np.float32))
cam = np.array([[1, 0, 0, 0.5], [0, 1, 0, 0.5], [0, 0, 1, -1.0]], np.float32)
frame = tb.render_frame(4, 4, cam, focal_length=4.0)
assert frame.shape == (4, 4, 4) and np.isfinite(frame).all()
assert not any(m.split(".")[0] in ("jax", "msgpack", "PIL",
                                   "instant_ngp_tpu")
               for m in sys.modules)
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
