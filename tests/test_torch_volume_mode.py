"""The port's Volume mode against the JAX package's `VolumeTestbed`.

The medium: a procedural cloud on a 128 x 40 x 40 grid (a slab; 128 wide
on its long axis so that every cell of the 128^3 occupancy bitgrid under
the cloud is marked: on a 16^3-24^3 grid the bitgrid keeps only the cells
of voxel centres, one in 5^3-8^3, walks almost never land and the
comparisons would see nothing), peak density 30. The network: the form of
configs/volume/base.json at a small size (HashGrid L=6, F=2, 2^13 entries
a level; 32-wide MLP, ReLU output), loaded with the JAX testbed's weights.

JAX's random numbers (threefry) are not torch's: the port takes the JAX
testbed's own draws through `VolumeTrainDraws` / `VolumeRenderDraws` and
the `draws` hook, split as `_generate_training_data`, `_walk_to_next_event`
and `_render_rays` split their keys, and the corner draws of the
stochastic encode from the step's second key.

Tolerances (float32 compute unless said):
- `.nvdb` files: byte for byte both ways; the bitgrid: bit for bit;
  `_bit_occupied` and `_gt_density`: exactly (a few float32 operations,
  then integer lookups), with points placed on the cell boundaries and at
  -1e-3 to catch the truncation of negatives;
- a walk: XLA's `log` and torch's differ in the last bit for ~14 % of
  arguments, and XLA contracts `pos + dirs * dt` into one rounding for
  ~2 %, so positions agree to 1e-5 after 32 tries; the landing decisions
  on at least 99.9 % of the lanes;
- training data: a threshold (a landing, `zeta < scat_prob`) can flip on
  one ulp, so at least 99 % of the paths must agree exactly in their
  number of vertices and, where they do, positions and targets to 1e-5;
- 3 train steps across `stochastic_corners_until` = 2: losses at rtol
  1e-4 and every parameter to 1e-4 (bf16 compute: losses at 5e-3);
- frames (16 x 16), model and GT: at least 99 % of the pixels to 1e-4;
- a snapshot crosses the packages both ways: the inference network's
  outputs agree to 5e-3 (bf16 compute), the optimizer state to 1e-6.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import _t, jax_corner_draws

from instant_ngp_tpu.data.snapshot import load_snapshot as jax_load_snapshot
from instant_ngp_tpu.volume import VolumeTestbed as JaxVolumeTestbed
from instant_ngp_tpu.volume import load_nanovdb_header as jax_load_header
from instant_ngp_tpu.volume import nanovdb as jax_nanovdb
from instant_ngp_tpu.volume.testbed_volume import proc_envmap as jax_envmap
from instant_ngp_tpu_torch.data.snapshot import load_snapshot
from instant_ngp_tpu_torch.volume import VolumeTestbed, load_nanovdb_header
from instant_ngp_tpu_torch.volume import nanovdb
from instant_ngp_tpu_torch.volume.testbed_volume import (
    MAX_TRAIN_VERTICES, VolumeRenderDraws, VolumeTrainDraws,
    load_volume_grid, proc_envmap)


CFG = {
    "loss": {"otype": "L2"},
    "optimizer": {"otype": "Ema", "decay": 0.95, "nested": {
        "otype": "ExponentialDecay", "decay_start": 10000,
        "decay_interval": 5000, "decay_base": 0.33, "nested": {
            "otype": "Adam", "learning_rate": 1e-2, "beta1": 0.9,
            "beta2": 0.99, "epsilon": 1e-15, "l2_reg": 1e-6}}},
    "encoding": {"otype": "HashGrid", "n_levels": 6,
                 "n_features_per_level": 2, "log2_hashmap_size": 13,
                 "base_resolution": 4, "stochastic_corners_until": 2},
    "network": {"otype": "FullyFusedMLP", "activation": "ReLU",
                "output_activation": "ReLU", "n_neurons": 32,
                "n_hidden_layers": 2},
}
N_PATHS = 128
CAM = np.array([[1, 0, 0, 0.5], [0, -1, 0, 0.5], [0, 0, 1, -1.2]],
               np.float32)


def cloud(shape=(128, 40, 40), peak=30.0):
    g = [(np.arange(s, dtype=np.float32) + 0.5) / max(shape)
         - 0.5 * s / max(shape) for s in shape]
    x, y, z = np.meshgrid(*g, indexing="ij")
    r2 = x ** 2 / 0.04 + y ** 2 / 0.03 + z ** 2 / 0.05
    d = peak * np.exp(-3 * r2) * (1 + 0.5 * np.sin(20 * x) * np.cos(17 * y))
    d[d < 0.05] = 0
    return d.astype(np.float32)


# -- JAX's draws ------------------------------------------------------------
def _walk_uniforms(key, n, n_tries=32):
    return jax.vmap(lambda k: jax.random.uniform(k, (n,)))(
        jax.random.split(key, n_tries))


def _train_draws(key, n):
    k1, k2, _, keys_walk, _, _ = jax.random.split(key, 6)

    def event(k):
        kw, kd, kz, ks = jax.random.split(k, 4)
        return (_walk_uniforms(kw, n), jax.random.uniform(kd, (n, 3)),
                jax.random.uniform(kz, (n,)), jax.random.normal(ks, (n, 3)))
    walk, dither, zeta, scatter = jax.vmap(event)(
        jax.random.split(keys_walk, 32))
    return (jax.random.normal(k1, (n, 3)), jax.random.uniform(k2, (n, 3)),
            walk, dither, zeta, scatter)


def _render_draws(key, n, n_events):
    k0, kloop = jax.random.split(key)

    def event(k):
        kd, kw = jax.random.split(k)
        return _walk_uniforms(kw, n), jax.random.uniform(kd, (n, 3))
    walk, dither = jax.vmap(event)(jax.random.split(kloop, n_events))
    return _walk_uniforms(k0, n), walk, dither


_jit_train_draws = jax.jit(_train_draws, static_argnums=1)
_jit_render_draws = jax.jit(_render_draws, static_argnums=(1, 2))


def jax_train_draws(key, n) -> VolumeTrainDraws:
    """What `_generate_training_data(key, n)` draws."""
    return VolumeTrainDraws(*map(_t, _jit_train_draws(key, n)))


def jax_render_draws(n, n_events=32) -> VolumeRenderDraws:
    """What `render_frame` draws (from PRNGKey(0)) for n rays."""
    return VolumeRenderDraws(*map(_t, _jit_render_draws(
        jax.random.PRNGKey(0), n, n_events)))


def pair(compute="f32"):
    """(JAX testbed, port testbed with its weights and its draws)."""
    dens = cloud()
    jtb = JaxVolumeTestbed(dens, CFG, compute_dtype=jnp.float32
                           if compute == "f32" else jnp.bfloat16)

    def draws(step, n):
        key = jax.random.fold_in(jax.random.PRNGKey(jtb.seed), step)
        k_gen, k_enc = jax.random.split(key)
        corners = jax_corner_draws(k_enc, n * MAX_TRAIN_VERTICES, 3,
                                   tb.model.encoding.n_levels) \
            if tb._stoch_now() else None
        return jax_train_draws(k_gen, n), corners

    tb = VolumeTestbed(dens, CFG, compute_dtype=torch.float32
                       if compute == "f32" else torch.bfloat16,
                       device="cpu", draws=draws)
    tb.trainer.load_state(tb.state, jax.tree_util.tree_map(
        np.asarray, jtb.state["params"]))
    return jtb, tb


@pytest.fixture(scope="module")
def shared():
    return pair("f32")


# -- files ------------------------------------------------------------------
def test_nvdb_files_are_the_same_bytes_both_ways(tmp_path):
    dens = cloud((40, 24, 20))
    dens[3, 4, 5] = 7.0
    for bg, origin in ((0.0, (0, 0, 0)), (0.25, (4096, 0, -4096))):
        ours, ref = str(tmp_path / "p.nvdb"), str(tmp_path / "j.nvdb")
        nanovdb.write_nanovdb(ours, dens, origin=origin, background=bg)
        jax_nanovdb.write_nanovdb(ref, dens, origin=origin, background=bg)
        assert open(ours, "rb").read() == open(ref, "rb").read()
        a, meta = nanovdb.read_nanovdb_dense(ref)
        b, jmeta = jax_nanovdb.read_nanovdb_dense(ours)
        np.testing.assert_array_equal(a, dens)
        np.testing.assert_array_equal(b, dens)
        assert meta["background"] == jmeta["background"] == bg
        np.testing.assert_array_equal(load_volume_grid(ref), dens)
        for k, v in load_nanovdb_header(ours).items():
            np.testing.assert_array_equal(v, jax_load_header(ours)[k])


def test_nanovdb_header_rejects_garbage(tmp_path):
    for name, data in (("zeros", b"\x00" * 256), ("short", b"NanoV")):
        p = str(tmp_path / f"{name}.nvdb")
        with open(p, "wb") as f:
            f.write(data)
        with pytest.raises(ValueError, match="NanoVDB"):
            load_nanovdb_header(p)
        if name == "zeros":
            with pytest.raises(ValueError):
                jax_load_header(p)


# -- the medium ---------------------------------------------------------------
def test_testbed_setup_bitgrid_and_bit_occupied_match_jax(shared):
    jtb, tb = shared
    for k in ("aabb_min", "aabb_max", "world2index_offset"):
        np.testing.assert_array_equal(getattr(tb, k), getattr(jtb, k))
    assert tb.world2index_scale == jtb.world2index_scale == 128.0
    assert tb.global_majorant == jtb.global_majorant
    np.testing.assert_array_equal(tb.bitgrid.numpy(),
                                  np.asarray(jtb.bitgrid))
    assert np.unpackbits(tb.bitgrid.numpy()).sum() > 10000
    rng = np.random.default_rng(0)
    pos = rng.uniform(tb.aabb_min - 0.02, tb.aabb_max + 0.02,
                      (20000, 3)).astype(np.float32)
    # cell boundaries, and just below 0 (truncates to 0, counts as -1)
    pos[:2000] = (rng.integers(-2, 130, (2000, 3)) - 0.5) / 128.0
    pos[2000:2100, 0] = -1e-3
    ours = tb._bit_occupied(torch.from_numpy(pos)).numpy()
    ref = np.asarray(jtb._bit_occupied(jnp.asarray(pos)))
    np.testing.assert_array_equal(ours, ref)
    assert 2000 < ref.sum() < 18000


def test_gt_density_and_envmap_match_jax(shared):
    jtb, tb = shared
    rng = np.random.default_rng(1)
    pos = rng.uniform(tb.aabb_min - 0.01, tb.aabb_max + 0.01,
                      (5000, 3)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    dither = np.asarray(jax.random.uniform(key, pos.shape))
    ref = np.asarray(jtb._gt_density(jnp.asarray(pos), key))
    ours = tb._gt_density(torch.from_numpy(pos), _t(dither)).numpy()
    np.testing.assert_array_equal(ours, ref)
    assert (ref > 0).sum() > 500
    d = rng.normal(size=(4000, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[:10] = np.float32(0.577) / np.linalg.norm([0.577] * 3)
    args = [np.array(v, np.float32) for v in
            ((0, 1, 0), (0.577, 0.577, 0.577), (0.35, 0.45, 0.65))]
    ref = np.asarray(jax_envmap(jnp.asarray(d), *map(jnp.asarray, args)))
    ours = proc_envmap(torch.from_numpy(d), *map(torch.from_numpy, args))
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-5, atol=1e-6)


def test_walk_to_next_event_matches_jax(shared):
    jtb, tb = shared
    rng = np.random.default_rng(2)
    n = 3000
    pos = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    pos[:, 1:] = pos[:, 1:] * 0.3125 + 0.34375      # inside the slab
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    alive = rng.uniform(size=n) < 0.9
    key = jax.random.PRNGKey(5)
    ref_pos, ref_alive = jtb._walk_to_next_event(
        key, jnp.asarray(pos), jnp.asarray(d), jnp.asarray(alive))
    ours_pos, ours_alive = tb._walk_to_next_event(
        torch.from_numpy(pos), torch.from_numpy(d), torch.from_numpy(alive),
        _t(_walk_uniforms(key, n)))
    same = ours_alive.numpy() == np.asarray(ref_alive)
    assert same.mean() >= 0.999, same.mean()
    np.testing.assert_allclose(ours_pos.numpy()[same],
                               np.asarray(ref_pos)[same], atol=1e-5)
    assert 0.2 < np.asarray(ref_alive).mean() < 0.9


def test_generate_training_data_matches_jax(shared):
    jtb, tb = shared
    key = jax.random.PRNGKey(7)
    n = 512
    ref = [np.asarray(a) for a in jtb._generate_training_data(key, n)]
    ours = [a.numpy() for a in tb._generate_training_data(
        jax_train_draws(key, n))]
    n_ref = ref[2].reshape(n, -1).sum(1)
    n_ours = ours[2].reshape(n, -1).sum(1)
    same = n_ref == n_ours
    assert same.mean() >= 0.99, same.mean()
    assert (n_ref > 0).mean() > 0.3 and (n_ref > 1).any()
    rows = np.repeat(same, MAX_TRAIN_VERTICES)
    valid = ref[2] & rows
    np.testing.assert_array_equal(ours[2][rows], ref[2][rows])
    np.testing.assert_allclose(ours[0][valid], ref[0][valid], atol=1e-5)
    np.testing.assert_allclose(ours[1][rows], ref[1][rows], atol=1e-5,
                               rtol=1e-5)


# -- training -----------------------------------------------------------------
@pytest.mark.parametrize("compute", ["f32", "bf16"])
def test_training_across_the_stochastic_switch_matches_jax(compute):
    jtb, tb = pair(compute)
    assert tb.stochastic_corners_until == 2 and tb._stoch_now()
    batch = N_PATHS * MAX_TRAIN_VERTICES
    jl = [jtb.train(1, batch) for _ in range(3)]
    tl = [tb.train(1, batch) for _ in range(3)]
    assert not tb._stoch_now() and tb.training_step == jtb.training_step == 3
    assert all(v > 0 for v in jl)
    np.testing.assert_allclose(tl, jl, rtol=1e-4 if compute == "f32"
                               else 5e-3)
    if compute == "f32":
        ref = jtb.state["params"]
        ours = tb.state["params"]
        np.testing.assert_allclose(ours["encoding"].detach().numpy(),
                                   np.asarray(ref["encoding"]), atol=1e-4)
        for a, b in zip(ours["net"], ref["net"]):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       atol=1e-4)


# -- frames -------------------------------------------------------------------
def visible_params(jtb, seed=11):
    """The JAX testbed's weights with the table from U(-1, 1) and the
    density output scaled to the majorant's order, so a frame shows the
    network (tcnn's 1e-4 table leaves it transparent)."""
    params = jax.tree_util.tree_map(np.array, jtb.state["params"])
    rng = np.random.default_rng(seed)
    params["encoding"] = rng.uniform(-1, 1, params["encoding"].shape) \
        .astype(np.float32)
    params["net"][-1][:, 3] *= 40.0
    return params


def load_params(jtb, tb, params):
    jtb.state["params"] = jax.tree_util.tree_map(jnp.asarray, params)
    jtb.state["opt"]["ema"] = jax.tree_util.tree_map(jnp.asarray, params)
    tb.trainer.load_state(tb.state, params)


@pytest.mark.parametrize("use_gt", [False, True], ids=["model", "gt"])
def test_frame_matches_jax(shared, use_gt):
    jtb, tb = shared
    load_params(jtb, tb, visible_params(jtb))
    w = h = 16
    ref = jtb.render_frame(w, h, CAM, use_gt=use_gt)
    ours = tb.render_frame(w, h, CAM, use_gt=use_gt,
                           draws=jax_render_draws(w * h))
    assert ours.shape == ref.shape == (h, w, 4)
    close = (np.abs(ours - ref) <= 1e-4).all(-1)
    assert close.mean() >= 0.99, close.mean()
    assert ref[..., 3].max() > 0.3
    # the port's own draws give a frame of the same medium
    own = tb.render_frame(w, h, CAM, use_gt=use_gt)
    assert np.isfinite(own).all() and own[..., 3].max() > 0.3


def test_the_default_device_is_the_card():
    if torch.cuda.is_available():
        tb = VolumeTestbed(cloud((32, 16, 16)), CFG)
        assert tb.device.type == "cuda" and tb.gt_grid.is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            VolumeTestbed(cloud((32, 16, 16)), CFG)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_snapshot_crosses_packages(direction, tmp_path):
    jtb, tb = pair("bf16")
    load_params(jtb, tb, visible_params(jtb))
    path = os.path.join(tmp_path, "volume.ingp")
    batch = 64 * MAX_TRAIN_VERTICES
    if direction == "jax_to_port":
        jtb.train(2, batch)
        jtb.save_snapshot(path)
        tb.load_snapshot_state(load_snapshot(path))
    else:
        tb.train(2, batch)
        tb.save_snapshot(path)
        jtb.load_snapshot_state(jax_load_snapshot(path))
    assert tb.training_step == jtb.training_step == 2
    assert load_snapshot(path)["global_majorant"] == tb.global_majorant
    x = np.random.default_rng(8).uniform(tb.aabb_min, tb.aabb_max,
                                         (2000, 3)).astype(np.float32)
    ref = np.asarray(jtb.model.apply(jtb.trainer.inference_params(
        jtb.state), jnp.asarray(x)))
    with torch.no_grad():
        ours = tb.trainer.inference_model(torch.from_numpy(x)).numpy()
    assert np.abs(ref).max() > 1.0
    np.testing.assert_allclose(ours, ref, rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(
        tb.state["opt"]["v"]["net"][0].detach().numpy(),
        np.asarray(jtb.state["opt"]["v"]["net"][0]), rtol=1e-6, atol=1e-12)
