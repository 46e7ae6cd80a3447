"""What the port's parity tests against the JAX package share. pytest does
not collect this module (its name does not start with `test_`); the
`test_torch_*` files import their shared helpers from here, not from each
other. Two kinds stay where they are: the rank jobs of
tests/test_torch_parallel_ranks.py, which spawned ranks import by module
without jax, and the kernel cases of the card's own test files.

- Threads: importing the module sets torch's thread count to 2, once, so
  that every file that imports it runs at the same count whatever ran
  before it in the worker process. The module imports jax: a file that
  runs on the card under `--noconftest` does not import it.
- The tiny NeRF dataset of tests/test_nerf_training.py (4 cameras of 32x32,
  L=4 hash grid with 2^12 entries, 32-wide MLPs) and its port adapter.
- The training testbeds (`make_jax_tb`, `make_port_tb`), their knobs
  (`set_knobs`) and the JAX package's random draws handed to the port
  (`feed_jax_draws`), so that a step is compared value for value.
- The render-mode pair (an OpenCV lens, 2 latent dims, a steep density
  field) and the per-scene switches' pair (`make_pair`).
- The assertions more than one file makes.

`set_knobs` gives both testbeds one warm-up prep where they default to
four (`warmup_full_grid_preps`): step 0 still takes `training_prep`'s
warm-up branch (uniform cells alone) and every later prep the mixed one
(uniform and occupied cells), so both branches stay under test. A prep of
the JAX testbed costs seconds whatever its cell count (its update encodes
chunks of 2^19 cells, the last one padded). A test whose subject is the
default cadence, or that misses its tolerance with one warm-up prep,
passes `full_preps=4` and says so."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_gradient_parity import identity_samples  # noqa: E402
from test_nerf_training import CFG, make_dataset  # noqa: E402

from instant_ngp_tpu.nerf import occupancy as jocc
from instant_ngp_tpu.nerf.testbed_nerf import NerfTestbed as JaxTestbed
from instant_ngp_tpu_torch.common import NERF_GRID_N_CELLS
from instant_ngp_tpu_torch.convert import (buffer_state_from_jax,
                                           opt_state_from_jax,
                                           params_from_jax)
from instant_ngp_tpu_torch.data.nerf_loader import (FrameMetadata, Lens,
                                                    NerfDataset)
from instant_ngp_tpu_torch.nerf import training
from instant_ngp_tpu_torch.nerf.occupancy import CellDraws
from instant_ngp_tpu_torch.nerf.sampler import (RayBatch, SampleBatch,
                                                TrainDraws)
from instant_ngp_tpu_torch.nerf.testbed_nerf import NerfTestbed
from instant_ngp_tpu_torch.ops.grid_encoding import CornerDraws
from instant_ngp_tpu_torch.ops.optimizers import tree_leaves

torch.set_num_threads(2)

# base.json's stochastic keys on the tiny grid
TRAIN_CFG = dict(CFG, encoding=dict(CFG["encoding"],
                                    n_features_per_level=4,
                                    stochastic_exact_axes=1,
                                    stochastic_bwd=True))
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
N_RAYS = 512


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t.to(dtype) if dtype else t


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# -- the dataset -----------------------------------------------------------
def port_dataset(jds) -> NerfDataset:
    """The port's dataset container with a JAX-package dataset's arrays."""
    metas = [FrameMetadata(m.resolution, m.focal_length, m.principal_point,
                           m.rolling_shutter, Lens(m.lens.mode,
                                                   m.lens.params))
             for m in jds.metadata]
    return NerfDataset(paths=list(jds.paths), images=jds.images,
                       depths=jds.depths, rays=jds.rays, metadata=metas,
                       xforms_start=jds.xforms_start,
                       xforms_end=jds.xforms_end, aabb_scale=jds.aabb_scale)


# -- the JAX package's draws -------------------------------------------------
def jax_train_draws(key, n_rays: int, n_images: int,
                    with_cdf: bool = False) -> TrainDraws:
    """The numbers nerf_train_step(key) draws for its rays, by its own key
    splits; `with_cdf`: those of sample_rays' error-CDF branch."""
    k_rays, k_bg, _ = jax.random.split(key, 3)
    k_pick, k_t = jax.random.split(k_rays)
    k_img, k_uv, k_mb, k_mix = jax.random.split(k_pick, 4)
    common = dict(
        motionblur_time=_t(jax.random.uniform(k_mb, (n_rays,))),
        start_jitter=_t(jax.random.uniform(k_t, (n_rays,))),
        bg_color=_t(jax.random.uniform(k_bg, (n_rays, 3))))
    if with_cdf:
        return TrainDraws(
            img_idx=None, uv=None,
            u_img=_t(jax.random.uniform(k_img, (n_rays,))),
            use_cdf=_t(jax.random.uniform(k_mix, (n_rays,)) >= 0.5),
            u2=_t(jax.random.uniform(k_uv, (n_rays, 2))),
            u_mix=_t(jax.random.uniform(jax.random.fold_in(k_mix, 1),
                                        (n_rays, 2))),
            jitter=_t(jax.random.uniform(jax.random.fold_in(k_uv, 1),
                                         (n_rays, 2))), **common)
    return TrainDraws(
        img_idx=_t(jax.random.randint(k_img, (n_rays,), 0, n_images),
                   torch.long),
        uv=_t(jax.random.uniform(k_uv, (n_rays, 2))), **common)


def jax_corner_draws(key, n, n_dims, n_levels) -> CornerDraws:
    """What the JAX package's stochastic encode (`_build_stochastic_call`)
    draws from `key` for n points."""
    keys = jax.random.split(key, n_dims + 1)
    u = np.stack([np.asarray(jax.random.uniform(keys[k], (n, n_levels)))
                  for k in range(n_dims)])
    axis = np.asarray(jax.random.randint(keys[n_dims], (n, n_levels), 0,
                                         n_dims))
    return CornerDraws(torch.from_numpy(u.copy()),
                       torch.from_numpy(axis.copy()).long())


def jax_cell_draws(key, n_uniform: int, n_nonuniform: int, n_cascades: int
                   ) -> CellDraws:
    """The numbers occupancy.sample_cells(key, ...) draws."""
    out = []
    for k, n, salt in zip(jax.random.split(key), (n_uniform, n_nonuniform),
                          (0, 2)):
        keys = jax.random.fold_in(k, salt)
        out.append(_t(jax.random.randint(keys, (10, n), 0,
                                         NERF_GRID_N_CELLS), torch.long))
        out.append(_t(jax.random.randint(jax.random.fold_in(keys, 1), (n,),
                                         0, n_cascades), torch.long))
    return CellDraws(*out)


def jax_cell_jitter(key, n: int) -> torch.Tensor:
    """The (n, 3) jitter occupancy.cell_positions(idx, key) draws."""
    return _t(np.stack([np.asarray(jax.random.uniform(k, (n,), jnp.float32))
                        for k in jax.random.split(key, 3)], -1))


def random_bitfield(seed=0, fill=0.3):
    """A bitfield (numpy uint8) from a random density grid, by the JAX
    package's own update_bitfield."""
    rng = np.random.default_rng(seed)
    grid = np.where(rng.uniform(size=NERF_GRID_N_CELLS) < fill,
                    rng.uniform(0.02, 1.0, NERF_GRID_N_CELLS),
                    0.0).astype(np.float32)
    return grid, np.asarray(jocc.update_bitfield(jnp.asarray(grid), 0))


# -- the training testbeds ---------------------------------------------------
def set_knobs(tb, prep_every=16, full_preps=1):
    """The tiny sizes, on either package's testbed; `full_preps`: the
    warm-up preps, one before each of the first steps."""
    tb.target_batch_size = 1 << 12
    tb.rays_per_batch = N_RAYS
    tb.adapt_ray_batch = False
    tb.n_march = 96
    tb.max_samples_per_ray = 32
    tb.density_samples_override = 1 << 12
    tb.prep_every = prep_every
    tb.warmup_full_grid_preps = full_preps
    tb.steps_per_dispatch = 1


def _set_mode(tb, exact):
    """exact: the exact encode and uniform rays; else the defaults."""
    assert tb.stochastic_corners is True
    assert tb.use_error_map_sampling is True      # the dataset's default
    if exact:
        tb.stochastic_corners = False
        tb.use_error_map_sampling = False


def make_jax_tb(dtype, prep_every=16, exact=False, full_preps=1):
    tb = JaxTestbed(make_dataset(), TRAIN_CFG, compute_dtype=dtype)
    set_knobs(tb, prep_every=prep_every, full_preps=full_preps)
    _set_mode(tb, exact)
    return tb


def make_port_tb(dtype, prep_every=16, jax_tb=None, exact=False,
                 full_preps=1):
    tb = NerfTestbed(port_dataset(make_dataset()), TRAIN_CFG, device="cpu",
                     compute_dtype=dtype)
    set_knobs(tb, prep_every=prep_every, full_preps=full_preps)
    _set_mode(tb, exact)
    if jax_tb is not None:
        state = _numpy_tree(jax_tb.state)
        tb.load_state(params_from_jax(state["params"]),
                      opt_state_from_jax(state["opt"]))
        tb.set_density_grid(np.asarray(jax_tb.density_grid))
        tb.training_step = jax_tb.training_step
        tb.density_grid_ema_step = jax_tb.density_grid_ema_step
    return tb


def feed_jax_draws(tb, seed=1337):
    """Make a port testbed draw what the JAX testbed of the same seed
    draws at the same step counts."""
    enc = tb.model.pos_encoding

    def train_draws(n_rays):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), tb.training_step)
        k_enc = jax.random.split(key, 3)[2]
        capacity = tb.target_batch_size * tb.sample_capacity_multiplier
        return training.StepDraws(
            jax_train_draws(key, n_rays, tb.data.n_images,
                            with_cdf=tb._error_cdfs is not None),
            jax_corner_draws(k_enc, capacity, 3, enc.n_levels))

    def prep_draws(n_uniform, n_nonuniform):
        rng = jax.random.fold_in(jax.random.PRNGKey(seed ^ 0xD3),
                                 tb.density_grid_ema_step)
        k_cells, k_pos, k_enc = jax.random.split(rng, 3)
        n = n_uniform + n_nonuniform
        # the JAX update encodes chunks of 2^19 cells (the last one
        # padded), each with the draws of the same key
        chunk = 1 << 19
        one = jax_corner_draws(k_enc, chunk, 3, enc.n_levels)
        corners = CornerDraws(one.u.repeat(1, -(-n // chunk), 1)[:, :n],
                              None)
        return (jax_cell_draws(k_cells, n_uniform, n_nonuniform,
                               tb.scene.max_cascade + 1),
                jax_cell_jitter(k_pos, n), corners)

    tb._train_draws = train_draws
    tb._prep_draws = prep_draws


def jax_step(jtb):
    """One step of the JAX testbed's jitted train function, as its eager
    loop calls it (the buffers' parameters where their switches are on)
    -> the step's stats."""
    key = jax.random.fold_in(jax.random.PRNGKey(jtb.seed), jtb.training_step)
    jtb._maybe_init_error_map()
    fn = jtb._get_train_fn(N_RAYS, jtb._bucket_k(N_RAYS), True)
    jtb.state, jstats = fn(
        jtb.state, jtb.data, jtb.bitfield, jtb.mean_density, key,
        jtb._cam_dict(), jtb._error_cdfs, jtb._error_map,
        jtb.envmap.params if jtb.train_envmap else None,
        jtb.distortion_map.params if jtb.optimize_distortion else None)
    jtb.training_step += 1
    if "error_map" in jstats:
        jtb._error_map = jstats["error_map"]
    return jstats


# -- the render-mode pair ----------------------------------------------------
N_EXTRA = 2
LENS = np.array([0.06, -0.015, 0.002, -0.003, 0, 0, 0], np.float32)
MODES_CFG = dict(
    CFG,
    encoding=dict(CFG["encoding"], n_features_per_level=4,
                  stochastic_exact_axes=1, stochastic_bwd=True),
    dir_encoding={"otype": "Composite", "nested": [
        {"n_dims_to_encode": 3, "otype": "SphericalHarmonics", "degree": 4},
        {"otype": "Identity"}]})


def lens_dataset(lens="OpenCV", n_extra=N_EXTRA, depths=False, envmap=None):
    """The tiny dataset with a lens, latent dims, depth images and an
    environment map (as the JAX package's container)."""
    jds = make_dataset()
    for i, m in enumerate(jds.metadata):
        m.lens.mode = lens
        if lens != "Perspective":
            m.lens.params = LENS * (1.0 + 0.1 * i)
        m.principal_point = np.array([0.5 + 0.01 * i, 0.49], np.float32)
    jds.n_extra_learnable_dims = n_extra
    if depths:
        # the sphere of the images at its distance, nothing elsewhere
        jds.depths = [np.where(im[..., 3] > 0, 0.8 - 0.2 * (i % 2), 0.0)
                      .astype(np.float32) for i, im in enumerate(jds.images)]
    jds.envmap = envmap
    return jds


def port_lens_dataset(jds):
    pds = port_dataset(jds)
    pds.n_extra_learnable_dims = jds.n_extra_learnable_dims
    pds.envmap = jds.envmap
    return pds


def sync_port(tb, jtb):
    """The JAX testbed's whole training state into the port's: network,
    optimizer, occupancy, step counts and the three trainable buffers."""
    state = _numpy_tree(jtb.state)
    tb.load_state(params_from_jax(state["params"]),
                  opt_state_from_jax(state["opt"]))
    tb.set_density_grid(np.asarray(jtb.density_grid))
    tb.training_step = jtb.training_step
    tb.density_grid_ema_step = jtb.density_grid_ema_step
    for ours, theirs in ((tb._extra_dims_buf, jtb._extra_dims_buf),
                         (tb.envmap, jtb.envmap),
                         (tb.distortion_map, jtb.distortion_map)):
        if theirs is not None:
            ours.load_state(buffer_state_from_jax(_numpy_tree(theirs.state)))
    return tb


@pytest.fixture(scope="module")
def pair():
    """(JAX testbed with a steep density field, port testbed of the same
    state)."""
    jds = lens_dataset()
    jtb = JaxTestbed(jds, MODES_CFG, compute_dtype=jnp.float32)
    set_knobs(jtb, full_preps=2)      # step 1's prep below sweeps every cell
    jtb.max_samples_per_ray = 64
    # a table at a trained scale: densities that occlude, gradients that
    # have a direction
    rng = np.random.default_rng(1)
    state = _numpy_tree(jtb.state)
    table = state["params"]["pos_encoding"]
    table = table + rng.uniform(-1.0, 1.0, table.shape).astype(np.float32)
    out_layer = state["params"]["density_net"][-1].copy()
    out_layer[:, 0] *= 40.0          # raw densities of 4 +- 4
    for tree in (state["params"], state["opt"]["ema"]):
        tree["pos_encoding"] = table
        tree["density_net"] = list(tree["density_net"][:-1]) + [out_layer]
    jtb.state = jax.tree_util.tree_map(jnp.asarray, state)
    # the occupancy of that field: one full sweep with the exact encode
    jtb.stochastic_corners = False
    jtb.density_samples_override = None
    jtb.training_step = 1
    jtb.training_prep()
    jtb.density_samples_override = 1 << 12
    jtb.training_step = 256
    tb = NerfTestbed(port_lens_dataset(jds), MODES_CFG, device="cpu",
                     compute_dtype=torch.float32)
    set_knobs(tb)
    tb.max_samples_per_ray = 64
    sync_port(tb, jtb)
    return jtb, tb


# -- the per-scene switches' pair --------------------------------------------
SWITCH_CASES = {
    # name: (lens, latent dims, depth images, dataset envmap, switches)
    "extra_dims": ("Perspective", 2, False, False, {}),
    "envmap": ("Perspective", 0, False, False, {"train_envmap": True}),
    "distortion": ("OpenCV", 0, False, False, {"optimize_distortion": True}),
    "depth": ("Perspective", 0, True, False,
              {"depth_supervision_lambda": 0.5}),
    "all": ("OpenCV", 2, True, True,
            {"train_envmap": True, "optimize_distortion": True,
             "depth_supervision_lambda": 0.5}),
}


def make_pair(case, prep_every=16):
    """(JAX testbed, port testbed) of one of `SWITCH_CASES`, untrained,
    switches set."""
    lens, n_extra, depths, with_env, switches = SWITCH_CASES[case]
    env = None
    if with_env:
        env = np.random.default_rng(2).uniform(0, 0.5, (6, 12, 4)).astype(
            np.float32)
    jds = lens_dataset(lens, n_extra, depths, env)
    jtb = JaxTestbed(jds, MODES_CFG, compute_dtype=jnp.float32)
    tb = NerfTestbed(port_lens_dataset(jds), MODES_CFG, device="cpu",
                     compute_dtype=torch.float32)
    lam = switches.get("depth_supervision_lambda", 0.0)
    for t in (jtb, tb):
        set_knobs(t, prep_every=prep_every)
        for name, value in switches.items():
            setattr(t, name, value)
    if lam:
        # the JAX testbed has the weight in its step's configuration only
        make_cfg = jtb._train_cfg
        jtb._train_cfg = lambda *a: make_cfg(*a)._replace(
            depth_supervision_lambda=lam)
    return jtb, tb


# -- the Image-mode picture --------------------------------------------------
IMAGE_CFG = {
    "loss": {"otype": "L2"},
    "optimizer": {"otype": "ExponentialDecay", "decay_start": 20000,
                  "decay_interval": 10000, "decay_base": 0.33, "nested": {
                      "otype": "Adam", "learning_rate": 1e-2, "beta1": 0.9,
                      "beta2": 0.99, "epsilon": 1e-15, "l2_reg": 1e-6}},
    "encoding": {"otype": "HashGrid", "n_levels": 4,
                 "n_features_per_level": 2, "log2_hashmap_size": 10,
                 "base_resolution": 8, "stochastic_corners_until": 2},
    "network": {"otype": "FullyFusedMLP", "activation": "ReLU",
                "output_activation": "None", "n_neurons": 32,
                "n_hidden_layers": 2},
}


def image(h=24, w=32):
    """A small procedural linear RGB image, with values past 1 and at 0."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    r = 0.5 + 0.6 * np.sin(x / 4.0)
    g = 0.5 + 0.5 * np.cos(y / 3.0)
    b = ((x // 8 + y // 8) % 2).astype(np.float32) * 1.3
    return np.clip(np.stack([r, g, b], -1), 0.0, None).astype(np.float32)


# -- assertions --------------------------------------------------------------
def _port_case(case, mask):
    """tests/test_gradient_parity.py's composite case as the port's sample
    and ray batches."""
    raw, _, _, t_padded, jrays, bg, exposure, dts, rgba = case
    r, k = mask.shape
    js = identity_samples(mask)
    samples = SampleBatch(*([None] * 4), _t(js.ray_id).long(),
                          _t(js.ray_base).long(), _t(js.ray_count).long(),
                          _t(js.n_samples).long(), _t(js.cand_slot).long(),
                          _t(js.cand_src).long())
    rays = RayBatch(torch.zeros(r, 3), torch.zeros(r, 3), torch.zeros(r),
                    torch.ones(r, dtype=torch.bool), rgba=_t(rgba))
    return samples, rays


def _assert_step_close(tb, jstate, jstats, stats, dtype):
    jstate = _numpy_tree(jstate)
    ours = {k: float(v) for k, v in stats.items() if k != "fused"}
    ref = {k: float(np.asarray(jstats[k])) for k in ours}
    for k in ("measured_batch_size",
              "measured_batch_size_before_compaction", "n_rays"):
        assert ours[k] == ref[k] > 0, k
    np.testing.assert_array_equal(
        stats["fused"].numpy(),
        np.array([ours[k] for k in ("loss", "measured_batch_size",
                                    "measured_batch_size_before_compaction",
                                    "n_rays")], np.float32))
    assert int(tb.opt_state["step"]) == int(jstate["opt"]["step"])
    keys = sorted(jstate["params"])
    for name in ("m", "v", "ema", "params"):
        tree = tb.model.param_tree() if name == "params" \
            else tb.opt_state[name]
        jtree = jstate["params"] if name == "params" \
            else jstate["opt"][name]
        ours_l = [t.detach().numpy().ravel() for t in tree_leaves(
            {k: tree[k] for k in keys})]
        ref_l = [a.ravel() for a in jax.tree_util.tree_leaves(jtree)]
        v_l = [a.ravel() for a in
               jax.tree_util.tree_leaves(jstate["opt"]["v"])]
        for a, b, v in zip(ours_l, ref_l, v_l):
            assert a.shape == b.shape
            if dtype == "f32" and name in ("m", "v"):
                np.testing.assert_allclose(
                    a, b, rtol=1e-3 if name == "m" else 2e-3,
                    atol=1e-6 if name == "m" else 1e-10, err_msg=name)
            elif dtype == "f32":
                # Adam divides by sqrt(v): where the second moment is at
                # the level of float32 noise of the gradient, a rounding
                # difference is a full-size step. Compare where it is
                # well above that.
                sure = np.sqrt(v) > 0.05 * np.sqrt(v).max()
                assert sure.sum() >= 10, name
                np.testing.assert_allclose(a[sure], b[sure], rtol=1e-3,
                                           atol=2e-5, err_msg=name)
            elif name == "m":
                assert np.abs(a - b).max() <= 0.05 * np.abs(b).max(), name
    if dtype == "f32":
        np.testing.assert_allclose(ours["loss"], ref["loss"], rtol=1e-3)
    else:
        np.testing.assert_allclose(ours["loss"], ref["loss"], rtol=2e-2)


def assert_host_adam_close(ours, ref, what, n_updates):
    """A variable stepped by a host Adam over several train steps, on both
    sides. What each piece computes is held tightly elsewhere: one step's
    gradients (`test_camera_and_exposure_gradients_match_jax`, 2e-3), the
    update from given gradients and the Adams themselves
    (tests/test_torch_camera_opt.py, 1e-6). Over several steps the two
    runs' network parameters drift apart at the level the step tolerances
    allow (Adam's eps of 1e-15 on noise-level gradients), the losses stay
    within 2e-3, but a pose or focal gradient is a sum of terms of both
    signs over the rays and moves by several percent with that drift; Adam
    then normalises it to a full-size step. So: exposures (a gradient
    without such cancellation) to 2e-3 of their largest entry; pose and
    focal offsets to a quarter of their largest entry, with the same sign
    wherever an entry is larger than that, and never further apart than
    the steps Adam can have taken."""
    ours, ref = np.asarray(ours), np.asarray(ref)
    top = np.abs(ref).max()
    assert ours.shape == ref.shape and top > 0, what
    tol = 2e-3 if what == "exposures" else 0.25
    np.testing.assert_allclose(ours, ref, rtol=0, atol=tol * top,
                               err_msg=what)
    big = np.abs(ref) > tol * top
    assert big.any() and (np.sign(ours[big]) == np.sign(ref[big])).all()
    assert np.abs(ours - ref).max() <= 2 * n_updates * 1e-3, what
