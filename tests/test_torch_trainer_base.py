"""The port's shared trainer base against the JAX package: the vectorised
QMC samplers, `create_loss`, `NetworkWithInputEncoding` with every
encoding the Image, SDF and Volume configs name,
`create_network_with_encoding` and `Trainer`.

Tolerances:
- the samplers are integer arithmetic (uint32 wraparound) and one float32
  conversion or a few float32 products per value: bit for bit;
- `create_loss`, a network's forward and its gradients at float32
  compute: a few float32 operations in another order, rtol/atol 1e-6 for
  the losses and encodings, 1e-5 for the networks;
- `Trainer.train_step`, 3 steps from the same weights and inputs: float32
  compute holds parameters and optimizer state at 1e-5; bf16 compute
  rounds operands that differ in their last float32 bit the other way
  now and then, and Adam's eps of 1e-15 turns such differences in
  near-zero gradients into full-size steps, so bf16 is held at 2e-3 on
  the losses and on the parameters where the second moment is not tiny.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instant_ngp_tpu.common import LossType as JaxLossType
from instant_ngp_tpu.ops import sampling as jsampling
from instant_ngp_tpu.ops.factory import \
    create_network_with_encoding as jax_create_network
from instant_ngp_tpu.ops.losses import create_loss as jax_create_loss
from instant_ngp_tpu.ops.optimizers import create_optimizer as jax_optimizer
from instant_ngp_tpu.ops.trainer import Trainer as JaxTrainer
from instant_ngp_tpu_torch import common
from instant_ngp_tpu_torch.ops import sampling
from instant_ngp_tpu_torch.ops.factory import create_network_with_encoding
from instant_ngp_tpu_torch.ops.losses import create_loss
from instant_ngp_tpu_torch.ops.optimizers import create_optimizer, tree_map
from instant_ngp_tpu_torch.ops.trainer import Trainer

torch.set_num_threads(2)

NET = {"otype": "FullyFusedMLP", "activation": "ReLU",
       "output_activation": "None", "n_neurons": 32, "n_hidden_layers": 2}
ADAM = {"otype": "ExponentialDecay", "decay_start": 2,
        "decay_interval": 1, "decay_base": 0.5, "nested": {
            "otype": "Adam", "learning_rate": 1e-2, "beta1": 0.9,
            "beta2": 0.99, "epsilon": 1e-15, "l2_reg": 1e-3}}
ENCODINGS = {
    "HashGrid": {"otype": "HashGrid", "n_levels": 4,
                 "n_features_per_level": 2, "log2_hashmap_size": 8,
                 "base_resolution": 4},
    "DenseGrid": {"otype": "DenseGrid", "n_levels": 3,
                  "n_features_per_level": 2, "base_resolution": 4,
                  "per_level_scale": 1.5},
    "Frequency": {"otype": "Frequency", "n_frequencies": 6},
    "OneBlob": {"otype": "OneBlob", "n_bins": 8},
    "TriangleWave": {"otype": "TriangleWave", "n_frequencies": 6},
}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_tree(tree):
    return tree_map(lambda t: t.detach().numpy().copy(), tree)


def _networks(enc, compute, n_in=2, n_out=3, seed=5):
    """(JAX model, its params as numpy, port model with those params)."""
    cfg = {"encoding": ENCODINGS[enc], "network": NET}
    jdtype = jnp.float32 if compute == "f32" else jnp.bfloat16
    tdtype = torch.float32 if compute == "f32" else torch.bfloat16
    jmodel, jres = jax_create_network(n_in, n_out, cfg,
                                      desired_resolution=32.0,
                                      compute_dtype=jdtype)
    model, res = create_network_with_encoding(n_in, n_out, cfg,
                                              desired_resolution=32.0,
                                              compute_dtype=tdtype)
    assert res == jres
    params = _np_tree(jmodel.init(jax.random.PRNGKey(seed)))
    if params["encoding"] is not None:
        # a table at a trained scale, so the network's output depends on it
        params["encoding"] = np.random.default_rng(seed).uniform(
            -1, 1, params["encoding"].shape).astype(np.float32)
    model.load_params(params)
    return jmodel, params, model


# -- QMC samplers -------------------------------------------------------------
_IDX = np.concatenate([np.arange(4096), np.random.default_rng(0).integers(
    0, 2 ** 32, 60000, dtype=np.uint64), [2 ** 31 - 1, 2 ** 31,
                                          2 ** 32 - 1]]).astype(np.uint32)


def _words(a):
    """A JAX uint32 array -> int64 values in [0, 2^32)."""
    a = np.asarray(a)
    assert a.dtype == np.uint32
    return a.astype(np.int64)


def test_sobol_and_its_scrambles_match_jax_bit_for_bit():
    idx = jnp.asarray(_IDX)
    t = torch.from_numpy(_IDX.astype(np.int64))
    for d in range(5):
        np.testing.assert_array_equal(sampling.sobol(t, d).numpy(),
                                      _words(jsampling.sobol(idx, d)))
    rev = sampling._reverse_bits(t)
    np.testing.assert_array_equal(rev.numpy(),
                                  _words(jsampling._reverse_bits(idx)))
    assert [int(v) for v in rev[-3:]] == [
        int(f"{int(v):032b}"[::-1], 2) for v in _IDX[-3:]]
    np.testing.assert_array_equal(
        sampling._laine_karras_permutation(t, 0xDEADBEEF).numpy(),
        _words(jsampling._laine_karras_permutation(
            idx, np.uint32(0xDEADBEEF))))


@pytest.mark.parametrize("seed", [0, 1337, 0xDEADBEEF])
def test_ld_samples_match_jax_bit_for_bit_across_2_31(seed):
    ours = sampling.ld_samples(torch.from_numpy(_IDX.astype(np.int64)),
                               seed, 5).numpy()
    np.testing.assert_array_equal(
        ours, np.asarray(jsampling.ld_samples(jnp.asarray(_IDX), seed, 5)))
    for spp in (0, 1, 7, 1000):
        # the render's jitter is the vectorised sequence's 0.5 - ld(0) +
        # ld(spp), and the JAX package's
        pair = sampling.ld_samples(torch.tensor([0, spp]), seed).numpy()
        np.testing.assert_array_equal(
            np.float32(sampling.ld_pixel_offset(spp, seed)),
            np.float32(0.5) - pair[0] + pair[1])
        np.testing.assert_array_equal(
            np.float32(sampling.ld_pixel_offset(spp, seed)),
            np.asarray(jsampling.ld_pixel_offset(spp, seed)))


def test_halton_and_stratify2_match_jax_bit_for_bit():
    t = torch.from_numpy(_IDX.astype(np.int64))
    for base in (2, 3, 5):
        np.testing.assert_array_equal(
            sampling.halton(t, base).numpy(),
            np.asarray(jsampling.halton(jnp.asarray(_IDX), base)))
    np.testing.assert_array_equal(
        sampling.halton23(t).numpy(),
        np.asarray(jsampling.halton23(jnp.asarray(_IDX))))
    u = np.random.default_rng(1).uniform(size=(1 << 10, 2)) \
        .astype(np.float32)
    np.testing.assert_array_equal(
        sampling.stratify2(torch.from_numpy(u), 10).numpy(),
        np.asarray(jsampling.stratify2(jnp.asarray(u), 10)))


@pytest.mark.parametrize("mode", ["Random", "Halton", "Sobol",
                                  "Stratified"])
def test_generate_2d_samples_matches_jax(mode):
    n, step, seed = 1 << 8, 3, 42
    key = jax.random.PRNGKey(7)
    ref = np.asarray(jsampling.generate_2d_samples(mode, n, step, seed, key))
    u = torch.from_numpy(np.asarray(jax.random.uniform(
        key, (n, 2), jnp.float32)).copy())
    ours = sampling.generate_2d_samples(mode, n, step, seed, uniforms=u)
    np.testing.assert_array_equal(ours.numpy(), ref)
    # a step far along the sequence wraps its index like uint32
    if mode in ("Halton", "Sobol"):
        big = (1 << 32) // n + 5
        np.testing.assert_array_equal(
            sampling.generate_2d_samples(mode, n, big, seed).numpy(),
            np.asarray(jsampling.generate_2d_samples(mode, n, 5, seed)))


# -- losses -------------------------------------------------------------------
@pytest.mark.parametrize("name", [t.name for t in common.LossType])
def test_create_loss_matches_jax(name):
    assert common.LossType[name].value == JaxLossType[name].value
    cfg = {"otype": common.LossType[name].value}
    rng = np.random.default_rng(4)
    target = rng.uniform(0, 1, (500, 3)).astype(np.float32)
    pred = (target + rng.normal(0, 0.6, target.shape)).astype(np.float32)
    jfn = jax_create_loss(cfg)
    ref, ref_g = jax.value_and_grad(jfn)(jnp.asarray(pred),
                                         jnp.asarray(target))
    p = torch.from_numpy(pred).requires_grad_(True)
    fn = create_loss(cfg)
    loss = fn(p, torch.from_numpy(target))
    (grad,) = torch.autograd.grad(loss, p)
    assert fn.otype == jfn.otype and loss.dim() == 0
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-6)
    np.testing.assert_allclose(grad.numpy(), np.asarray(ref_g), rtol=1e-6,
                               atol=1e-8)
    with pytest.raises(ValueError):
        create_loss({"otype": "Nope"})


# -- networks -----------------------------------------------------------------
def test_common_enums_and_bounding_box_match_jax():
    from instant_ngp_tpu import common as jcommon

    for name in ("LossType", "Activation", "ColorSpace", "TonemapCurve",
                 "GroundTruthRenderMode", "SDFGroundTruthMode",
                 "MeshSdfMode", "LensMode"):
        assert [(m.name, m.value) for m in getattr(common, name)] == \
            [(m.name, m.value) for m in getattr(jcommon, name)], name
    assert common.DEFAULT_LOSS_SCALE == jcommon.DEFAULT_LOSS_SCALE
    pts = np.random.default_rng(2).normal(size=(50, 3)).astype(np.float32)
    ours, ref = common.BoundingBox.from_points(pts), \
        jcommon.BoundingBox.from_points(pts)
    for box in (ours, ref):
        box.enlarge(type(box)(pts[0] - 3, pts[0] - 2))
        box.inflate(0.25)
    np.testing.assert_array_equal(ours.min, ref.min)
    np.testing.assert_array_equal(ours.relative_pos(pts),
                                  ref.relative_pos(pts))
    np.testing.assert_array_equal(ours.contains(pts), ref.contains(pts))


@pytest.mark.parametrize("enc", list(ENCODINGS))
def test_network_with_input_encoding_matches_jax(enc):
    n_in = 3 if enc == "DenseGrid" else 2
    jmodel, params, model = _networks(enc, "f32", n_in=n_in)
    assert model.n_params == jmodel.n_params
    x = np.random.default_rng(8).uniform(0, 1, (300, n_in)) \
        .astype(np.float32)
    cot = np.random.default_rng(9).normal(size=(300, 3)).astype(np.float32)
    ref = np.asarray(jmodel.apply(jax.tree_util.tree_map(jnp.asarray,
                                                         params),
                                  jnp.asarray(x)))
    ref_g = _np_tree(jax.grad(lambda p: jnp.sum(
        jmodel.apply(p, jnp.asarray(x)) * cot))(
            jax.tree_util.tree_map(jnp.asarray, params)))
    with torch.no_grad():
        np.testing.assert_allclose(model(torch.from_numpy(x)).numpy(), ref,
                                   rtol=1e-5, atol=1e-5)
    model.requires_grad_(True)
    out = model(torch.from_numpy(x))
    tree = model.param_tree()
    leaves = [t for t in [tree["encoding"]] + tree["net"] if t is not None]
    grads = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), leaves)
    refs = [g for g in [ref_g["encoding"]] + ref_g["net"] if g is not None]
    for g, r in zip(grads, refs):
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["base", "frequency", "oneblob",
                                  "hashgrid"])
def test_create_network_with_encoding_resolves_configs_like_jax(name):
    from instant_ngp_tpu.config import load_network_config as jload
    from instant_ngp_tpu_torch.config import (find_network_config,
                                              load_network_config)

    cfg = load_network_config(find_network_config(name, "image"))
    assert cfg == jload(find_network_config(name, "image"))
    cfg["encoding"]["log2_hashmap_size"] = 10       # small tables
    jmodel, jres = jax_create_network(2, 3, cfg, desired_resolution=512.0)
    model, res = create_network_with_encoding(2, 3, cfg,
                                              desired_resolution=512.0)
    assert res == jres
    assert model.n_params == jmodel.n_params
    assert model.network.layer_dims == [tuple(d) for d in
                                        jmodel.network.layer_dims]


# -- the trainer --------------------------------------------------------------
def _trainers(compute, opt_cfg):
    jmodel, params, model = _networks("HashGrid", compute)
    loss_cfg = {"otype": "L2"}
    jtr = JaxTrainer(jmodel, jax_optimizer(opt_cfg),
                     jax_create_loss(loss_cfg))
    tr = Trainer(model, create_optimizer(opt_cfg), create_loss(loss_cfg))
    jstate = {"params": jax.tree_util.tree_map(jnp.asarray, params),
              "opt": jax_optimizer(opt_cfg).init(
                  jax.tree_util.tree_map(jnp.asarray, params))}
    state = tr.init_state()
    tr.load_state(state, params)
    return jtr, jstate, tr, state


def _assert_state_close(state, jstate, tol, v_floor=0.0):
    ref = _np_tree(jstate)
    ours = _port_tree(state["params"])
    assert int(state["opt"]["step"]) == int(ref["opt"]["step"])
    for key in ("m", "v"):
        for a, b in zip(jax.tree_util.tree_leaves(_port_tree(
                state["opt"][key])), jax.tree_util.tree_leaves(
                    ref["opt"][key])):
            np.testing.assert_allclose(a, b, rtol=tol, atol=tol * np.abs(
                b).max())
    for a, b, v in zip(jax.tree_util.tree_leaves(ours),
                       jax.tree_util.tree_leaves(ref["params"]),
                       jax.tree_util.tree_leaves(ref["opt"]["v"])):
        keep = v > v_floor * v.max()
        np.testing.assert_allclose(a[keep], b[keep], rtol=tol, atol=tol)


@pytest.mark.parametrize("compute, opt", [("f32", "adam"), ("bf16", "adam"),
                                          ("f32", "ema")])
def test_trainer_steps_match_jax(compute, opt):
    opt_cfg = ADAM if opt == "adam" else {"otype": "Ema", "decay": 0.9,
                                          "nested": ADAM}
    jtr, jstate, tr, state = _trainers(compute, opt_cfg)
    rng = np.random.default_rng(11)
    tol = 1e-5 if compute == "f32" else 2e-3
    for _ in range(3):
        x = rng.uniform(0, 1, (512, 2)).astype(np.float32)
        y = rng.uniform(0, 1, (512, 3)).astype(np.float32)
        jstate, jloss = jtr.train_step(jstate, jnp.asarray(x), jnp.asarray(y))
        state, loss = tr.train_step(state, torch.from_numpy(x),
                                    torch.from_numpy(y))
        assert loss.dim() == 0 and not loss.requires_grad
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=tol)
    _assert_state_close(state, jstate, tol,
                        v_floor=0.0 if compute == "f32" else 1e-4)
    ref_inf = _np_tree(jtr.inference_params(jstate))
    ours_inf = _port_tree(tr.inference_params(state))
    for a, b in zip(jax.tree_util.tree_leaves(ours_inf),
                    jax.tree_util.tree_leaves(ref_inf)):
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol)
    if opt == "ema":
        # the inference model's parameters ARE the EMA leaves
        assert tr.inference_model is not tr.model
        assert tr.inference_model.param_tree()["net"][0] is \
            state["opt"]["ema"]["net"][0]
    else:
        assert tr.inference_model is tr.model


def test_trainer_custom_gradient_step_matches_jax():
    jtr, jstate, tr, state = _trainers("f32", ADAM)
    jtr.loss_scale = tr.loss_scale = 128.0
    rng = np.random.default_rng(12)
    x = rng.uniform(0, 1, (256, 2)).astype(np.float32)
    dl = (128.0 * rng.normal(size=(256, 3)) / 256).astype(np.float32)
    jstate, jloss = jtr.train_step_custom_gradient(
        jstate, jnp.asarray(x), jnp.asarray(dl), jnp.float32(0.5))
    state, loss = tr.train_step_custom_gradient(
        state, torch.from_numpy(x), torch.from_numpy(dl), torch.tensor(0.5))
    assert float(loss) == float(jloss) == 0.5
    _assert_state_close(state, jstate, 1e-5)
    # a loss scale divides back out of a standard step too
    y = rng.uniform(0, 1, (256, 3)).astype(np.float32)
    jstate, jloss = jtr.train_step(jstate, jnp.asarray(x), jnp.asarray(y))
    state, loss = tr.train_step(state, torch.from_numpy(x),
                                torch.from_numpy(y))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    _assert_state_close(state, jstate, 1e-5)
