"""The port's data-parallel NeRF train step and density update against the
JAX package's (instant_ngp_tpu/nerf/parallel.py), the port in 4 spawned
gloo ranks (the rank-side jobs are in tests/test_torch_parallel_ranks.py),
JAX on 4 of the 8 virtual CPU devices of tests/conftest.py, each rank fed
the draws of its chip (JAX folds its key with the chip index; the port's
ranks take the same numbers). The network is tests/test_nerf_training.py's
(L=4 hash grid of 2^12 entries, 32-wide MLPs).

- (b) one `make_sharded_train_step`: the loss to rtol 1e-5, the counts of
  the stats equal, the Adam moments and the MLP weights to rtol 1e-4 /
  atol 1e-7, the table to the same on at least 99 % of its entries and
  within one Adam step (lr 1e-2) on the rest (Adam's eps of 1e-15 turns
  float32 noise in a near-zero gradient into a full step of either sign);
  and every rank's parameters and moments the same bits.
- (d) one `make_sharded_density_update` with the stochastic-corner encode:
  the grid to rtol 1e-5 / atol 1e-9 (the densities are exp of float32 MLP
  outputs summed in another order), the bitfield equal, the mean to rtol
  1e-5; every rank the same bits. JAX's sharded update is its
  `_density_update_body(..., evaluate_only=True)` on each chip, an
  all-gather of (cells, densities) and the merge; the reference runs
  exactly that, the body one chip at a time, because the body pads every
  chip's cells to a 2^19 chunk and four of them at once take ~13 GB on the
  CPU.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from __graft_entry__ import _tiny_dataset  # noqa: E402
from test_nerf_training import CFG  # noqa: E402
from test_torch_parallel_ranks import (N_RANKS, density_job,  # noqa: E402
                                       dp_step_job)
from test_torch_sampler import (jax_cell_draws, jax_cell_jitter,  # noqa: E402
                                jax_train_draws, port_dataset)

from instant_ngp_tpu.nerf.testbed_nerf import NerfTestbed
from instant_ngp_tpu.parallel import replicate
from instant_ngp_tpu_torch.ops.grid_encoding import CornerDraws
from instant_ngp_tpu_torch.ops.optimizers import tree_leaves
from instant_ngp_tpu_torch.parallel.ranks import RankPool


@pytest.fixture(scope="module")
def pool():
    with RankPool(N_RANKS) as p:
        yield p


@pytest.fixture(scope="module")
def jax_tb():
    return NerfTestbed(_tiny_dataset(), CFG, compute_dtype=jnp.float32)


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:N_RANKS]), ("data",))


def test_sharded_train_step_matches_jax(pool, jax_tb, mesh):
    from instant_ngp_tpu.nerf.occupancy import init_bitfield
    from instant_ngp_tpu.nerf.parallel import make_sharded_train_step
    from instant_ngp_tpu.nerf.training import NerfTrainStepConfig
    from instant_ngp_tpu.ops.losses import LossType

    tb = jax_tb
    cfg = NerfTrainStepConfig(
        n_rays=128, n_march=32, max_samples_per_ray=8, sample_capacity=1024,
        lens_mode=0, cone_angle=0.0, max_mip=0, rgb_activation="Logistic",
        density_activation="Exponential", loss_type=LossType.Huber,
        near_distance=0.0)
    keys = jax.random.split(jax.random.PRNGKey(0), N_RANKS)
    init = jax.tree_util.tree_map(np.asarray, tb.state)
    state, stats = make_sharded_train_step(
        tb.model, tb.optimizer, cfg, jnp.zeros(3), jnp.ones(3), mesh)(
        replicate(mesh, jax.tree_util.tree_map(jnp.asarray, init)),
        replicate(mesh, tb.data),
        replicate(mesh, jnp.full_like(init_bitfield(), 255)),
        replicate(mesh, jnp.zeros(())),
        jax.device_put(keys, NamedSharding(mesh, P("data"))))
    ref = jax.tree_util.tree_map(np.asarray, state)

    draws = [jax_train_draws(k, cfg.n_rays, tb.data.n_images) for k in keys]
    res = pool.run(dp_step_job, port_dataset(_tiny_dataset()), init, draws,
                   CFG)
    got = res[0]
    np.testing.assert_allclose(got["stats"]["loss"], float(stats["loss"]),
                               rtol=1e-5)
    for k in ("measured_batch_size",
              "measured_batch_size_before_compaction", "n_rays"):
        assert got["stats"][k] == int(stats[k]), k
    assert got["stats"]["measured_batch_size"] > 0
    for key in ("m", "v"):
        for k in ("pos_encoding", "density_net", "rgb_net"):
            for a, b in zip(tree_leaves(got[key][k]),
                            tree_leaves(ref["opt"][key][k])):
                np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-7,
                                           err_msg=f"{key} {k}")
    table, ref_table = got["params"]["pos_encoding"], \
        ref["params"]["pos_encoding"]
    diff = np.abs(table - ref_table)
    assert (diff <= 1e-7 + 1e-4 * np.abs(ref_table)).mean() > 0.99
    assert diff.max() <= 2e-2
    for k in ("density_net", "rgb_net"):
        for a, b in zip(got["params"][k], ref["params"][k]):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-7)
    for r in res[1:]:
        assert r["stats"] == got["stats"]
        for a, b in zip(tree_leaves([r["params"], r["m"], r["v"]]),
                        tree_leaves([got["params"], got["m"], got["v"]])):
            np.testing.assert_array_equal(a, b)


def test_sharded_density_update_matches_jax(pool, jax_tb):
    from instant_ngp_tpu.nerf.occupancy import (density_grid_mean,
                                                splat_and_ema,
                                                update_bitfield)

    tb = jax_tb
    assert tb._stoch_now()
    n_uniform = n_nonuniform = 1 << 12
    n_cells = tb.density_grid.shape[0]
    grid = (np.random.default_rng(7).random(n_cells) * 0.02).astype(
        np.float32)
    init = jax.tree_util.tree_map(np.asarray, tb.state)
    params = tb.optimizer.inference_params(tb.state["opt"],
                                           tb.state["params"])
    # chip c's key, as the JAX testbed's training_prep and the sharded
    # update fold it: with c, and with c once more
    rng = jax.random.fold_in(jax.random.PRNGKey(tb.seed ^ 0xD3), 0)
    keys = [jax.random.fold_in(jax.random.fold_in(rng, c), c)
            for c in range(N_RANKS)]
    n_uni, n_non = n_uniform // N_RANKS, n_nonuniform // N_RANKS
    body = jax.jit(tb._density_update_body(n_uni, n_non, evaluate_only=True))
    evals = [body(params, jnp.asarray(grid), k, 0.95) for k in keys]
    new = splat_and_ema(jnp.asarray(grid),
                        jnp.concatenate([i for i, _ in evals]),
                        jnp.concatenate([d for _, d in evals]), 0.95)
    new, bits, mean = jax.tree_util.tree_map(np.asarray, (
        new, update_bitfield(new, tb.scene.max_cascade),
        density_grid_mean(new)))

    # the draws of chip c: its key split three ways, the corners of one
    # 2^19 chunk as the JAX update draws them
    n_levels = CFG["encoding"]["n_levels"]
    draws = []
    for key in keys:
        k_cells, k_pos, k_enc = jax.random.split(key, 3)
        # jax_corner_draws(k_enc, 1 << 19, ...).u without the unused axes
        u = np.stack([np.asarray(jax.random.uniform(
            k, (1 << 19, n_levels)))[:n_uni + n_non]
            for k in jax.random.split(k_enc, 4)[:3]])
        draws.append((jax_cell_draws(k_cells, n_uni, n_non, 1),
                      jax_cell_jitter(k_pos, n_uni + n_non),
                      CornerDraws(torch.from_numpy(u), None)))
    res = pool.run(density_job, port_dataset(_tiny_dataset()), init, grid,
                   (n_uniform, n_nonuniform), draws, CFG)
    got_grid, got_bits, got_mean = res[0]
    assert not np.array_equal(got_grid, grid * 0.95)   # cells were merged
    np.testing.assert_allclose(got_grid, new, rtol=1e-5, atol=1e-9)
    np.testing.assert_array_equal(got_bits, bits)
    np.testing.assert_allclose(got_mean, float(mean), rtol=1e-5)
    for g, b, m in res[1:]:
        np.testing.assert_array_equal(g, got_grid)
        np.testing.assert_array_equal(b, got_bits)
        assert m == got_mean
