"""The port's parallel modules in spawned ranks on the CPU (gloo), and the
rank-side halves of the JAX-parity tests in tests/test_torch_parallel.py
and tests/test_torch_parallel_train.py.

The functions named `*_job` run on every rank of a
`parallel.ranks.RankPool` (4 ranks joined through a FileStore in a
temporary directory, one pool per test file, ~4 s to start); this module
imports no JAX, so the spawned ranks import only torch and the port. The
tests here hold the port against itself:
- (e) `make_sharded_render` tile by tile against `render_tile` (rtol 1e-4,
  atol 1e-6: the same function on the same rays, the tiles split over the
  ranks);
- (f) a 1-rank `NerfTestbed(mesh=)` against the unsharded testbed over 16
  steps from the same draws (bit for bit: a sum over one rank is the
  value), and a 4-rank loop of 16 steps with `optimize_extrinsics` that
  stays finite, moves the camera offsets, draws other rays on every rank
  and keeps every rank's parameters, optimizer state and grid the same
  bits;
- (g) the sharded `Trainer` step against the unsharded step on the
  concatenated batch (the moments to rtol 1e-5 / atol 1e-9: the mean of
  four shards' gradients against the gradient of their mean, in float32;
  the parameters by the >= 99 % / one Adam step rule, since Adam's eps of
  1e-15 turns the sign of a near-zero gradient into a full step), and 30
  steps in which the loss falls below 0.3 of its first value, as in
  tests/test_parallel.py::test_sharded_image_training_loss_decreases;
- the mesh's collectives and placement helpers on a (2, 2) mesh.
"""

import numpy as np
import pytest
import torch

from instant_ngp_tpu_torch.data.nerf_loader import (FrameMetadata, Lens,
                                                    NerfDataset)
from instant_ngp_tpu_torch.parallel.mesh import Mesh
from instant_ngp_tpu_torch.parallel.ranks import RankPool

N_RANKS = 4
# __graft_entry__.py's network, as the JAX package's parallel tests use it
NERF_CFG = {
    "loss": {"otype": "Huber"},
    "optimizer": {"otype": "Ema", "decay": 0.95, "nested": {
        "otype": "ExponentialDecay", "decay_start": 20000,
        "decay_interval": 10000, "decay_base": 0.33, "nested": {
            "otype": "Adam", "learning_rate": 1e-2, "beta1": 0.9,
            "beta2": 0.99, "epsilon": 1e-15, "l2_reg": 1e-6}}},
    "encoding": {"otype": "HashGrid", "n_levels": 8,
                 "n_features_per_level": 4, "log2_hashmap_size": 15,
                 "base_resolution": 16},
    "network": {"otype": "FullyFusedMLP", "activation": "ReLU",
                "output_activation": "None", "n_neurons": 64,
                "n_hidden_layers": 1},
    "dir_encoding": {"otype": "SphericalHarmonics", "degree": 4},
    "rgb_network": {"otype": "FullyFusedMLP", "activation": "ReLU",
                    "output_activation": "None", "n_neurons": 64,
                    "n_hidden_layers": 2},
}


def step_config(**kw):
    """The train step of tests/test_parallel.py::test_tp_train_step_
    matches_dp: 128 rays, 32 candidates, 8 samples a ray."""
    from instant_ngp_tpu_torch.nerf.training import NerfTrainStepConfig
    from instant_ngp_tpu_torch.ops.losses import LossType

    cfg = dict(n_rays=128, n_march=32, max_samples_per_ray=8,
               sample_capacity=1024, lens_mode=0, cone_angle=0.0, max_mip=0,
               rgb_activation="Logistic", density_activation="Exponential",
               loss_type=LossType.Huber, near_distance=0.0)
    cfg.update(kw)
    return NerfTrainStepConfig(**cfg)


def tiny_dataset(n_cams=4, size=16) -> NerfDataset:
    """__graft_entry__.py::_tiny_dataset in the port's containers: 4
    cameras around a red square."""
    def look_at(eye, center):
        f = center - eye
        f /= np.linalg.norm(f)
        r = np.cross(f, [0, 1, 0])
        r /= np.linalg.norm(r)
        return np.stack([r, np.cross(f, r), f, eye], axis=1).astype(
            np.float32)

    imgs, xforms, metas = [], [], []
    for i in range(n_cams):
        ang = i / n_cams * 2 * np.pi
        eye = np.array([0.5 + 0.8 * np.cos(ang), 0.6,
                        0.5 + 0.8 * np.sin(ang)], np.float32)
        xforms.append(look_at(eye, np.array([0.5, 0.5, 0.5], np.float32)))
        img = np.zeros((size, size, 4), np.uint8)
        img[4:12, 4:12] = [170, 70, 50, 255]
        imgs.append(img)
        metas.append(FrameMetadata(
            (size, size), np.array([20.0, 20.0], np.float32),
            np.array([0.5, 0.5], np.float32), np.zeros(4, np.float32),
            Lens()))
    return NerfDataset(paths=[str(i) for i in range(n_cams)], images=imgs,
                       depths=[None] * n_cams, rays=[None] * n_cams,
                       metadata=metas, xforms_start=np.stack(xforms),
                       xforms_end=np.stack(xforms), aabb_scale=1)


def _np(tree):
    from instant_ngp_tpu_torch.ops.optimizers import tree_map

    return tree_map(lambda t: t.detach().cpu().numpy().copy(), tree)


def _testbed(dataset, state=None, mesh=None, config=NERF_CFG):
    """A float32 CPU testbed, its state (params and optimizer state in the
    JAX layout, as numpy arrays) loaded where given."""
    from instant_ngp_tpu_torch.convert import (opt_state_from_jax,
                                               params_from_jax)
    from instant_ngp_tpu_torch.nerf.testbed_nerf import NerfTestbed

    tb = NerfTestbed(dataset, config, device="cpu",
                     compute_dtype=torch.float32, mesh=mesh)
    if state is not None:
        tb.load_state(params_from_jax(state["params"]),
                      opt_state_from_jax(state["opt"]))
    return tb


def _full_bitfield():
    from instant_ngp_tpu_torch.nerf.occupancy import init_bitfield

    return torch.full_like(init_bitfield("cpu"), 255)


# -- rank-side jobs ---------------------------------------------------------
def features_job(enc_cfg, flat, x, g_out):
    """Level-sharded features over a 4-rank `model` axis and their
    gradient with respect to the rank's block, beside the plain encode's
    features and table gradient (packed, this rank's block)."""
    from instant_ngp_tpu_torch.ops.grid_encoding import GridEncoding
    from instant_ngp_tpu_torch.parallel.tp import LevelShardedGrid

    mesh = Mesh({"model": N_RANKS}, "cpu")
    index = mesh.index("model")
    enc = GridEncoding.from_config(3, enc_cfg)
    grid = LevelShardedGrid(enc, N_RANKS)
    flat, x, g_out = map(torch.from_numpy, (flat, x, g_out))
    block = grid.shard(grid.pack(flat), index).clone().requires_grad_(True)
    feats = grid.local_features(block, x, index, mesh.group("model"))
    grad, = torch.autograd.grad((feats * g_out).sum(), block)
    with torch.no_grad():
        enc.params.copy_(flat)
    plain = enc(x)
    plain_grad = grid.shard(grid.pack(enc._table_gradient(x, g_out, None)),
                            index)
    return {"feats": feats.detach().numpy(), "plain": plain.numpy(),
            "grad": grad.numpy(), "plain_grad": plain_grad.numpy(),
            "packed": grid.pack(flat).numpy(),
            "unpacked": grid.unpack(grid.pack(flat)).numpy()}


def tp_step_job(dataset, state, draws):
    """One hybrid (data=1, model=4) step from JAX's initial state and
    draws -> the parameters and moments (the table's blocks gathered and
    unpacked into the flat layout) and the stats."""
    from instant_ngp_tpu_torch.parallel.mesh import all_gather
    from instant_ngp_tpu_torch.parallel.tp import make_tp_train_step, tp_state

    mesh = Mesh({"data": 1, "model": N_RANKS}, "cpu")
    tb = _testbed(dataset, state)
    step, grid = make_tp_train_step(tb.model, tb.optimizer, step_config(),
                                    torch.zeros(3), torch.ones(3), mesh)
    st = tp_state(tb.model, tb.optimizer, grid, mesh.index("model"))
    stats = step(st, tb.data, _full_bitfield(), torch.zeros(()), draws)
    out = {"stats": {k: float(v) for k, v in stats.items()}}
    for name, tree in (("params", st["params"]), ("m", st["opt"]["m"]),
                       ("v", st["opt"]["v"])):
        tree = dict(tree, pos_encoding=grid.unpack(all_gather(
            tree["pos_encoding"].detach(), mesh.group("model"))))
        out[name] = _np(tree)
    return out


def dp_step_job(dataset, state, draws_by_rank, config=NERF_CFG):
    """One `make_sharded_train_step` over a 4-rank `data` axis, each rank
    from its chip's draws -> params, moments and stats (every rank's, so
    that the test sees them replicated)."""
    from instant_ngp_tpu_torch.nerf.parallel import make_sharded_train_step

    mesh = Mesh({"data": N_RANKS}, "cpu")
    tb = _testbed(dataset, state, config=config)
    step = make_sharded_train_step(tb.model, tb.optimizer, step_config(),
                                   torch.zeros(3), torch.ones(3), mesh)
    stats = step(tb.opt_state, tb.data, _full_bitfield(), torch.zeros(()),
                 draws_by_rank[mesh.index("data")])
    return {"params": _np(tb.model.param_tree()),
            "m": _np(tb.opt_state["m"]), "v": _np(tb.opt_state["v"]),
            "stats": {k: float(stats[k]) for k in (
                "loss", "measured_batch_size",
                "measured_batch_size_before_compaction", "n_rays")}}


def density_job(dataset, state, grid, counts, draws_by_rank,
                config=NERF_CFG):
    """One `make_sharded_density_update` over a 4-rank `data` axis, each
    rank from its chip's draws (cells, jitter, corners)."""
    from instant_ngp_tpu_torch.nerf.parallel import (
        make_sharded_density_update)

    mesh = Mesh({"data": N_RANKS}, "cpu")
    tb = _testbed(dataset, state, mesh=mesh, config=config)
    update = make_sharded_density_update(tb, mesh, "data", *counts)
    cells, jitter, corners = draws_by_rank[mesh.index("data")]
    new, bits, mean = update(torch.from_numpy(grid), cells, jitter, corners,
                             0.95)
    return new.numpy(), bits.numpy(), float(mean)


def render_job(origins, dirs, bitfield):
    """`make_sharded_render` over a 4-rank axis beside `render_tile` of
    every tile on one rank, the model from a seed."""
    from instant_ngp_tpu_torch.nerf.dataset import scene_config
    from instant_ngp_tpu_torch.nerf.parallel import make_sharded_render
    from instant_ngp_tpu_torch.nerf.render import RenderConfig, render_tile
    from instant_ngp_tpu_torch.nerf.testbed_nerf import NerfTestbed

    mesh = Mesh({"data": N_RANKS}, "cpu")
    tb = NerfTestbed(scene_config(aabb_scale=1), NERF_CFG, device="cpu",
                     compute_dtype=torch.float32, seed=3)
    with torch.no_grad():       # densities that the frame shows
        p = tb.model.pos_encoding.params
        p.copy_(torch.rand(p.shape, generator=torch.Generator()
                           .manual_seed(4)) * 2.0 - 1.0)
        tb.model.density_net.weights[-1].mul_(20.0)
    cfg = RenderConfig(n_march=32, max_samples_per_ray=32, cone_angle=0.0,
                       max_mip=0, rgb_activation="Logistic",
                       density_activation="Exponential",
                       sample_capacity=2048)
    lo, hi = torch.zeros(3), torch.ones(3)
    o, d, b = map(torch.from_numpy, (origins, dirs, bitfield))
    bg = torch.zeros(3)
    with torch.no_grad():
        out = make_sharded_render(tb.model, cfg, lo, hi, mesh)(o, d, b, bg)
        ref = [render_tile(tb.model, cfg, o[i], d[i], b, lo, hi, bg)
               for i in range(o.shape[0])]
    return ({k: out[k].numpy() for k in ("rgb", "alpha", "depth")},
            {k: np.stack([r[k].numpy() for r in ref])
             for k in ("rgb", "alpha", "depth")})


def _seeded_draws(tb, seed):
    """Hooks that hand a testbed draws from a CPU generator seeded by the
    step counters, the same for every testbed given the same seed."""
    from instant_ngp_tpu_torch.nerf.occupancy import draw_cell_randoms
    from instant_ngp_tpu_torch.nerf.sampler import draw_train_randoms
    from instant_ngp_tpu_torch.nerf.training import StepDraws

    def train(n_rays):
        g = torch.Generator().manual_seed(seed + 1000 * tb.training_step)
        return StepDraws(draw_train_randoms(
            g, n_rays, tb.data.n_images,
            with_cdf=tb.use_error_map_sampling and tb._error_cdfs is not None),
            g)

    def prep(n_uniform, n_nonuniform):
        g = torch.Generator().manual_seed(seed + 7 + 1000
                                          * tb.density_grid_ema_step)
        draws = None
        if (n_uniform, n_nonuniform) != (tb.density_grid.numel(), 0):
            draws = draw_cell_randoms(g, n_uniform, n_nonuniform,
                                      tb.scene.max_cascade + 1)
        return draws, torch.rand(n_uniform + n_nonuniform, 3, generator=g), g

    tb._train_draws, tb._prep_draws = train, prep


def _loop_knobs(tb, rays):
    tb.target_batch_size = 1 << 11
    tb.rays_per_batch = rays
    tb.n_march = 32
    tb.max_samples_per_ray = 8
    tb.density_samples_override = 1 << 10


def one_rank_loop_job(dataset):
    """16 steps of a 1-rank `NerfTestbed(mesh=)` and of the unsharded
    testbed from the same draws, camera optimisation off."""
    mesh = Mesh({"data": 1}, "cpu")
    out, visible = [], None
    for m in (mesh, None):
        tb = _testbed(dataset, mesh=m)
        _loop_knobs(tb, 256)
        _seeded_draws(tb, 11)
        tb._visible_cells = visible      # the same cameras: computed once
        losses = [tb.train(4) for _ in range(4)]
        visible = tb._visible_cells
        out.append({"losses": losses, "params": _np(tb.model.param_tree()),
                    "grid": tb.density_grid.numpy().copy(),
                    "rays_per_batch": tb.rays_per_batch})
    return out


def mesh_loop_job(dataset):
    """16 steps of a 4-rank `NerfTestbed(mesh=)` with
    `optimize_extrinsics`, from each rank's own generator stream."""
    mesh = Mesh({"data": N_RANKS}, "cpu")
    tb = _testbed(dataset, mesh=mesh)
    _loop_knobs(tb, 128 * N_RANKS)
    tb.optimize_extrinsics = True
    first = tb._train_draws(tb.rays_per_batch // N_RANKS).rays.uv.numpy()
    losses = [tb.train(4) for _ in range(4)]
    return {"losses": losses, "first_uv": first,
            "training_step": tb.training_step,
            "measured": tb.measured_batch_size,
            "cam_pos_offset": tb.cam_pos_offset.copy(),
            "params": _np(tb.model.param_tree()),
            "opt": _np({k: tb.opt_state[k] for k in ("m", "v", "ema")}),
            "grid": tb.density_grid.numpy().copy(),
            "bitfield": tb.bitfield.numpy().copy()}


TRAINER_CFG = {
    "loss": {"otype": "L2"},
    "optimizer": {"otype": "ExponentialDecay", "decay_start": 100,
                  "decay_interval": 50, "decay_base": 0.33, "nested": {
                      "otype": "Adam", "learning_rate": 1e-2,
                      "beta1": 0.9, "beta2": 0.99, "epsilon": 1e-15}},
    "encoding": {"otype": "HashGrid", "n_levels": 4,
                 "n_features_per_level": 2, "log2_hashmap_size": 10,
                 "base_resolution": 4},
    "network": {"n_neurons": 16, "n_hidden_layers": 1},
}


def trainer_job(x, y, n_steps):
    """The sharded `Trainer` step (each rank its quarter of the batch)
    and, on every rank, the unsharded step on the whole batch; then
    n_steps sharded steps -> their losses."""
    from instant_ngp_tpu_torch.ops.factory import (
        create_network_with_encoding)
    from instant_ngp_tpu_torch.ops.losses import create_loss
    from instant_ngp_tpu_torch.ops.optimizers import create_optimizer
    from instant_ngp_tpu_torch.ops.trainer import Trainer
    from instant_ngp_tpu_torch.parallel import shard_batch

    mesh = Mesh({"data": N_RANKS}, "cpu")
    out = {}
    for name, m in (("sharded", mesh), ("whole", None)):
        model, _ = create_network_with_encoding(
            2, 3, TRAINER_CFG, 64.0, compute_dtype=torch.float32)
        trainer = Trainer(model, create_optimizer(TRAINER_CFG["optimizer"]),
                          create_loss(TRAINER_CFG["loss"]), mesh=m)
        state = trainer.init_state()
        xs, ys = (torch.from_numpy(x), torch.from_numpy(y)) if m is None \
            else shard_batch(mesh, (x, y))
        losses = []
        for _ in range(1 if m is None else n_steps):
            state, loss = trainer.train_step(state, xs, ys)
            losses.append(float(loss))
            if len(losses) == 1:
                out[name] = {"params": _np(state["params"]),
                             "m": _np(state["opt"]["m"]), "loss": losses[0]}
        out[name]["losses"] = losses
    return out


def collectives_job():
    """The mesh's collectives and placement on a (data=2, model=2) mesh."""
    from instant_ngp_tpu_torch.parallel import mesh as pm

    mesh = Mesh({"data": 2, "model": 2}, "cpu")
    r = float(mesh.rank)
    out = {"index": (mesh.index("data"), mesh.index("model"))}
    for axis in ("data", "model"):
        g = mesh.group(axis)
        x = torch.tensor([r, 2.0 * r])
        out[axis] = {
            "psum": pm.psum(x, g).tolist(), "pmean": pm.pmean(x, g).tolist(),
            "many": [t.tolist() for t in pm.psum_many([x, x[:1]], g)],
            "gather": pm.all_gather(x[None], g, dim=1).tolist(),
            "scatter": pm.psum_scatter(torch.arange(4.0) + r, g).tolist()}
    out["replicate"] = pm.replicate(mesh, {"a": torch.tensor([r])})["a"]
    out["shard"] = pm.shard_along(mesh, np.arange(8.0).reshape(2, 4),
                                  "model", dim=1).tolist()
    return out


# -- the port against itself ------------------------------------------------
@pytest.fixture(scope="module")
def pool():
    with RankPool(N_RANKS) as p:
        yield p


def test_mesh_collectives_and_placement(pool):
    res = pool.run(collectives_job)
    for rank, out in enumerate(res):
        d, m = divmod(rank, 2)
        assert out["index"] == (d, m)
        peers = {"data": [m, 2 + m], "model": [2 * d, 2 * d + 1]}
        for axis, ranks in peers.items():
            got, s = out[axis], float(sum(ranks))
            assert got["psum"] == [s, 2 * s]
            assert got["pmean"] == [s / 2, s]
            assert got["many"] == [[s, 2 * s], [s]]
            assert got["gather"] == [[float(ranks[0]), 2.0 * ranks[0],
                                      float(ranks[1]), 2.0 * ranks[1]]]
            me = ranks.index(rank)
            assert got["scatter"] == [2 * (2 * me + k) + s
                                      for k in range(2)]
        assert out["replicate"].item() == 0.0
        assert out["shard"] == [[2.0 * m, 2.0 * m + 1],
                                [4 + 2.0 * m, 5 + 2.0 * m]]


def test_sharded_render_matches_render_tile_per_tile(pool):
    rng = np.random.default_rng(3)
    n_tiles, tile = 2 * N_RANKS, 64
    o = (-0.25 + 0.5 * rng.random((n_tiles, tile, 3))).astype(np.float32)
    d = np.full((n_tiles, tile, 3), 1.0 / np.sqrt(3.0), np.float32)
    bits = np.full(_full_bitfield().shape, 255, np.uint8)
    res = pool.run(render_job, o, d, bits)
    sharded, ref = res[0]
    assert ref["alpha"].max() > 0.1           # the tiles see the density
    for k in ("rgb", "alpha", "depth"):
        np.testing.assert_allclose(sharded[k], ref[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)
        for other, _ in res[1:]:
            np.testing.assert_array_equal(other[k], sharded[k])


def test_one_rank_mesh_testbed_equals_the_unsharded_one():
    with RankPool(1, n_threads=2) as one:
        (mesh_run, plain_run), = one.run(one_rank_loop_job, tiny_dataset())
    assert np.isfinite(mesh_run["losses"]).all()
    assert mesh_run["losses"] == plain_run["losses"]
    assert mesh_run["rays_per_batch"] == plain_run["rays_per_batch"]
    np.testing.assert_array_equal(mesh_run["grid"], plain_run["grid"])
    for a, b in zip(_leaves(mesh_run["params"]), _leaves(plain_run["params"])):
        np.testing.assert_array_equal(a, b)


def _leaves(tree):
    from instant_ngp_tpu_torch.ops.optimizers import tree_leaves

    return tree_leaves(tree)


def test_mesh_testbed_full_loop_with_camera_optimisation(pool):
    res = pool.run(mesh_loop_job, tiny_dataset())
    r0 = res[0]
    assert np.isfinite(r0["losses"]).all() and r0["losses"][-1] < 1.0
    assert r0["training_step"] == 16 and r0["measured"] > 0
    assert np.abs(r0["cam_pos_offset"]).max() > 0
    # each rank draws rays of its own
    firsts = [r["first_uv"] for r in res]
    assert all(not np.array_equal(firsts[0], f) for f in firsts[1:])
    # and the replicas stay the same bits
    for r in res[1:]:
        assert r["losses"] == r0["losses"]
        np.testing.assert_array_equal(r["cam_pos_offset"],
                                      r0["cam_pos_offset"])
        for key in ("grid", "bitfield"):
            np.testing.assert_array_equal(r[key], r0[key])
        for a, b in zip(_leaves([r["params"], r["opt"]]),
                        _leaves([r0["params"], r0["opt"]])):
            np.testing.assert_array_equal(a, b)


def test_sharded_trainer_step_is_the_whole_batch_step(pool):
    rng = np.random.default_rng(0)
    x = rng.random((1024, 2), np.float32)
    y = np.stack([x[:, 0], x[:, 1], x[:, 0] * x[:, 1]], -1)
    res = pool.run(trainer_job, x, y, 30)
    sharded, whole = res[0]["sharded"], res[0]["whole"]
    np.testing.assert_allclose(sharded["loss"], whole["loss"], rtol=1e-6)
    for a, b in zip(_leaves(sharded["m"]), _leaves(whole["m"])):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-9)
    for a, b in zip(_leaves(sharded["params"]), _leaves(whole["params"])):
        diff = np.abs(a - b)
        assert (diff <= 1e-7 + 1e-5 * np.abs(b)).mean() > 0.99
        assert diff.max() <= 2e-2        # one Adam step of lr 1e-2
    losses = sharded["losses"]
    assert losses[-1] < losses[0] * 0.3
    for r in res[1:]:
        assert r["sharded"]["losses"] == losses
