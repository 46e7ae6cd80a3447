"""The port's level-sharded grid and tensor-parallel step against the JAX
package's (instant_ngp_tpu/parallel/tp.py), the port in 4 spawned gloo
ranks (tests/test_torch_parallel_ranks.py has the rank-side jobs), JAX on
the 8 virtual CPU devices of tests/conftest.py.

- (a) `pack` / `unpack` bit for bit against JAX's on the same flat table;
  the 4-rank level-sharded features against the port's plain encode and
  JAX's tensor-parallel features (rtol 1e-5, atol 1e-7: the same d-linear
  sums in float32, in another order of operations), and their gradient
  with respect to a rank's block against the plain encode's table
  gradient (the same tolerance; one loss, so no factor of 4).
- (c) one hybrid (data=1, model=4) step against JAX's data-parallel step
  on one device and JAX's tensor-parallel step, from the same state and
  rays: the loss to rtol 1e-5; the parameters to rtol 1e-4 / atol 1e-7 on
  at least 99 % of the entries and within one Adam step (lr 1e-2) on the
  rest (Adam's eps of 1e-15 turns float32 noise in a near-zero gradient
  into a full step of either sign), the MLPs to rtol 1e-4 / atol 1e-7; the
  table's first moment equal to JAX's data-parallel one, and to JAX's
  tensor-parallel one divided by 4 (rtol 1e-4, atol 1e-7): the JAX step's
  table gradient is 4 times too large (ROADMAP fault 9), the port's is
  the data-parallel one. JAX's packed state, carried across by
  `convert.packed_params_from_jax` / `packed_opt_state_from_jax`, equals
  JAX's own unpacking bit for bit.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from __graft_entry__ import _NERF_CFG, _tiny_dataset  # noqa: E402
from test_torch_parallel_ranks import (N_RANKS, NERF_CFG,  # noqa: E402
                                       features_job, tp_step_job)
from torch_parity import jax_train_draws, port_dataset  # noqa: E402

from instant_ngp_tpu.ops.grid_encoding import GridEncoding as JaxGrid
from instant_ngp_tpu.parallel.tp import LevelShardedGrid as JaxSharded
from instant_ngp_tpu_torch.convert import jax_grid_layout
from instant_ngp_tpu_torch.parallel.ranks import RankPool

ENC_CFG = {"otype": "HashGrid", "n_levels": 8, "n_features_per_level": 2,
           "log2_hashmap_size": 10, "base_resolution": 4}
STEP = dict(n_rays=128, n_march=32, max_samples_per_ray=8,
            sample_capacity=1024, lens_mode=0, cone_angle=0.0, max_mip=0,
            rgb_activation="Logistic", density_activation="Exponential",
            near_distance=0.0)


@pytest.fixture(scope="module")
def pool():
    with RankPool(N_RANKS) as p:
        yield p


def test_level_sharded_features_match_jax_and_the_plain_encode(pool):
    assert jax_grid_layout(ENC_CFG["n_features_per_level"]) == "interleaved"
    enc = JaxGrid.from_config(3, ENC_CFG, dtype=jnp.float32)
    enc.packed = False
    flat = np.asarray(enc.init(jax.random.PRNGKey(1)))
    sh = JaxSharded(enc, N_RANKS)
    jax_table = sh.pack(flat)
    x = np.asarray(jax.random.uniform(jax.random.PRNGKey(2), (64, 3)))
    g_out = np.random.default_rng(5).standard_normal(
        (64, 8 * 2)).astype(np.float32)

    mesh = Mesh(np.array(jax.devices()[:N_RANKS]), ("model",))
    jax_feats = np.asarray(jax.jit(shard_map(
        lambda t, a, b, c: sh.local_features(t, [a, b, c]),
        mesh=mesh, in_specs=(P("model"), P(), P(), P()),
        out_specs=P(), check_rep=False))(jax_table, x[:, 0], x[:, 1],
                                         x[:, 2]))

    res = pool.run(features_job, ENC_CFG, flat, x, g_out)
    np.testing.assert_array_equal(res[0]["packed"], np.asarray(jax_table))
    np.testing.assert_array_equal(res[0]["unpacked"],
                                  np.asarray(sh.unpack(jax_table)))
    np.testing.assert_array_equal(res[0]["unpacked"], flat)
    for r in res:
        np.testing.assert_allclose(r["feats"], r["plain"], rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(r["feats"], jax_feats, rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(r["grad"], r["plain_grad"], rtol=1e-5,
                                   atol=1e-7)
    assert np.abs(res[0]["grad"]).max() > 0


def _close_by_adam_rule(got, ref):
    diff = np.abs(got - ref)
    close = diff <= 1e-7 + 1e-4 * np.abs(ref)
    assert close.mean() > 0.99, f"only {close.mean():.4f} entries match"
    assert diff.max() <= 2e-2, "differences exceed one Adam step"


def test_tp_step_matches_jax_dp_step_and_not_its_tp_gradient(pool):
    from instant_ngp_tpu.nerf.occupancy import init_bitfield
    from instant_ngp_tpu.nerf.parallel import make_sharded_train_step
    from instant_ngp_tpu.nerf.testbed_nerf import NerfTestbed
    from instant_ngp_tpu.nerf.training import NerfTrainStepConfig
    from instant_ngp_tpu.ops.losses import LossType
    from instant_ngp_tpu.parallel import replicate
    from instant_ngp_tpu.parallel.tp import make_tp_train_step

    assert NERF_CFG == _NERF_CFG
    tb = NerfTestbed(_tiny_dataset(), _NERF_CFG, compute_dtype=jnp.float32)
    cfg = NerfTrainStepConfig(loss_type=LossType.Huber, **STEP)
    lo, hi = jnp.zeros(3), jnp.ones(3)
    bitfield = jnp.full_like(init_bitfield(), 255)
    keys = jax.random.split(jax.random.PRNGKey(0), 1)
    init = jax.tree_util.tree_map(np.asarray, tb.state)

    mesh1 = Mesh(np.array(jax.devices()[:1]), ("data",))
    dp_state, dp_stats = make_sharded_train_step(
        tb.model, tb.optimizer, cfg, lo, hi, mesh1)(
        replicate(mesh1, jax.tree_util.tree_map(jnp.asarray, init)),
        replicate(mesh1, tb.data), replicate(mesh1, bitfield),
        replicate(mesh1, jnp.zeros(())),
        jax.device_put(keys, NamedSharding(mesh1, P("data"))))

    mesh = Mesh(np.array(jax.devices()[:N_RANKS]).reshape(1, N_RANKS),
                ("data", "model"))
    build, sh = make_tp_train_step(tb.model, tb.optimizer, cfg, lo, hi,
                                   mesh)
    packed = jax.tree_util.tree_map(jnp.asarray, dict(init["params"]))
    packed["pos_encoding"] = sh.pack(init["params"]["pos_encoding"])
    packed_state = {"params": packed, "opt": tb.optimizer.init(packed)}
    step, specs = build(packed_state)
    tp_state, tp_stats = step(
        jax.tree_util.tree_map(
            lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
            packed_state, specs),
        replicate(mesh, tb.data), replicate(mesh, bitfield),
        replicate(mesh, jnp.zeros(())),
        jax.device_put(keys, NamedSharding(mesh, P("data"))))

    draws = jax_train_draws(keys[0], STEP["n_rays"], tb.data.n_images)
    res = pool.run(tp_step_job, port_dataset(_tiny_dataset()), init, draws)

    def table(key):
        return res[0][key]["pos_encoding"]

    np.testing.assert_allclose(res[0]["stats"]["loss"],
                               float(dp_stats["loss"]), rtol=1e-5)
    assert res[0]["stats"]["measured_batch_size"] == \
        int(dp_stats["measured_batch_size"])
    _close_by_adam_rule(table("params"),
                        np.asarray(dp_state["params"]["pos_encoding"]))
    for k in ("density_net", "rgb_net"):
        for r in res:
            for a, b in zip(r["params"][k], dp_state["params"][k]):
                np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4,
                                           atol=1e-7)
            for a, b in zip(r["m"][k], dp_state["opt"]["m"][k]):
                np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4,
                                           atol=1e-7)
    # JAX's packed state carried across: the flat layout of the port
    from instant_ngp_tpu_torch.convert import (packed_opt_state_from_jax,
                                               packed_params_from_jax)
    from instant_ngp_tpu_torch.parallel.tp import LevelShardedGrid
    from test_torch_parallel_ranks import _testbed

    grid = LevelShardedGrid(
        _testbed(port_dataset(_tiny_dataset())).model.pos_encoding, N_RANKS)
    tp_np = jax.tree_util.tree_map(np.asarray, tp_state)
    carried = packed_params_from_jax(tp_np["params"], grid)
    carried_opt = packed_opt_state_from_jax(tp_np["opt"], grid)
    np.testing.assert_array_equal(
        carried["pos_encoding"].numpy(),
        np.asarray(sh.unpack(tp_np["params"]["pos_encoding"])))
    np.testing.assert_array_equal(
        carried_opt["m"]["pos_encoding"].numpy(),
        np.asarray(sh.unpack(tp_np["opt"]["m"]["pos_encoding"])))
    np.testing.assert_array_equal(carried["rgb_net"][0].numpy(),
                                  tp_np["params"]["rgb_net"][0])

    m_port = table("m")
    np.testing.assert_allclose(
        m_port, np.asarray(dp_state["opt"]["m"]["pos_encoding"]),
        rtol=1e-4, atol=1e-7)
    m_jax_tp = np.asarray(sh.unpack(tp_state["opt"]["m"]["pos_encoding"]))
    np.testing.assert_allclose(m_port, m_jax_tp / N_RANKS, rtol=1e-4,
                               atol=1e-7)
    assert np.abs(m_port).max() > 0
