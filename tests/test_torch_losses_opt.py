"""The port's losses and optimizer against the JAX package.

Same inputs, made from a seed with numpy, go through both. Tolerances:
the losses are a few float32 operations each, held at rtol 1e-6 / atol
1e-7; 20 optimizer steps compound one-ulp differences of pow and of fused
multiply-adds, held at rtol 1e-6 with atol 1e-8 on values of order 1e-2
to 1 (`m`, `ema`, the parameters) and 1e-10 on `v` (of order 1e-4)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instant_ngp_tpu.common import LossType as JaxLossType
from instant_ngp_tpu.ops import losses as jlosses
from instant_ngp_tpu.ops.optimizers import Optimizer as JaxOptimizer
from instant_ngp_tpu.ops.trainer import default_l2_mask as jax_l2_mask
from instant_ngp_tpu_torch.ops import losses
from instant_ngp_tpu_torch.ops.losses import LossType, loss_type_from_string
from instant_ngp_tpu_torch.ops.optimizers import Optimizer, tree_map
from instant_ngp_tpu_torch.ops.trainer import default_l2_mask

torch.set_num_threads(2)

OPT_CFG = {"otype": "Ema", "decay": 0.95, "nested": {
    "otype": "ExponentialDecay", "decay_start": 8, "decay_interval": 4,
    "decay_base": 0.33, "nested": {
        "otype": "Adam", "learning_rate": 1e-2, "beta1": 0.9, "beta2": 0.99,
        "epsilon": 1e-15, "l2_reg": 1e-6}}}


@pytest.mark.parametrize("name", [t.name for t in LossType])
def test_loss_and_gradient_matches_jax(name):
    rng = np.random.default_rng(3)
    target = rng.uniform(0, 1, 4000).astype(np.float32)
    pred = (target + rng.normal(0, 0.2, 4000)).astype(np.float32)
    pred[:10] = target[:10]                      # zero difference too
    ref_l, ref_g = jlosses.loss_and_gradient(
        JaxLossType[name], jnp.asarray(target), jnp.asarray(pred))
    assert LossType[name].value == JaxLossType[name].value
    assert loss_type_from_string(LossType[name].value) == LossType[name]
    p = torch.from_numpy(pred).requires_grad_(True)
    loss, grad = losses.loss_and_gradient(LossType[name],
                                          torch.from_numpy(target), p)
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(ref_l),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(grad.detach().numpy(), np.asarray(ref_g),
                               rtol=1e-6, atol=1e-7)
    if name in ("L2", "L1", "Huber", "LogL1"):
        # where the analytic gradient is the loss's full derivative,
        # autograd agrees with it
        (auto,) = torch.autograd.grad(loss.sum(), p)
        np.testing.assert_allclose(auto.numpy(), grad.detach().numpy(),
                                   rtol=1e-5, atol=1e-6)


def _random_tree(rng, scale=1.0):
    return {"pos_encoding": (scale * rng.normal(size=64)).astype(np.float32),
            "density_net": [(scale * rng.normal(size=(8, 4)))
                            .astype(np.float32)],
            "dir_encoding": None,
            "rgb_net": [(scale * rng.normal(size=(4, 4))).astype(np.float32),
                        (scale * rng.normal(size=(4, 3))).astype(np.float32)]}


def _to_torch(tree):
    return tree_map(lambda a: torch.from_numpy(a.copy()), tree)


def _assert_tree_close(ours, ref, atol):
    import jax

    ref_leaves = jax.tree_util.tree_leaves(ref)    # dict keys sorted
    our_leaves = []
    tree_map(our_leaves.append, {k: ours[k] for k in sorted(ours)})
    assert len(ref_leaves) == len(our_leaves)
    for a, b in zip(our_leaves, ref_leaves):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=atol)


@pytest.mark.parametrize("masked", [True, False], ids=["l2mask", "l2all"])
def test_twenty_optimizer_steps_match_jax(masked):
    rng = np.random.default_rng(5)
    params0 = _random_tree(rng)
    jopt, opt = JaxOptimizer(OPT_CFG), Optimizer(OPT_CFG)
    import jax

    jparams = jax.tree_util.tree_map(jnp.asarray, params0)
    jstate = jopt.init(jparams)
    params = _to_torch(params0)
    state = opt.init(params)
    assert default_l2_mask(params) == {
        "pos_encoding": False, "density_net": [True], "dir_encoding": None,
        "rgb_net": [True, True]}
    jmask = jax_l2_mask(jparams) if masked else None
    mask = default_l2_mask(params) if masked else None
    aliases = tree_map(lambda t: t, params)      # the same tensor objects
    for step in range(20):     # crosses decay_start = 8 and two intervals
        grads = _random_tree(rng, scale=1e-2)
        np.testing.assert_allclose(float(opt.learning_rate(step)),
                                   float(jopt.learning_rate(step)),
                                   rtol=1e-6)
        jparams, jstate = jopt.step(
            jstate, jparams, jax.tree_util.tree_map(jnp.asarray, grads),
            l2_mask=jmask)
        out_params, out_state = opt.step(state, params, _to_torch(grads),
                                         l2_mask=mask)
        assert out_params is params and out_state is state   # in place
    assert int(state["step"]) == int(jstate["step"]) == 20
    _assert_tree_close(params, jparams, 1e-8)
    _assert_tree_close(aliases, jparams, 1e-8)
    _assert_tree_close(state["m"], jstate["m"], 1e-8)
    _assert_tree_close(state["v"], jstate["v"], 1e-10)
    _assert_tree_close(state["ema"], jstate["ema"], 1e-8)
    _assert_tree_close(opt.inference_params(state, params), jstate["ema"],
                       1e-8)
    assert float(opt.learning_rate(20)) < 1e-2 * 0.33 ** 3 * 1.001


def test_ema_starts_as_a_copy_and_steps_bump_versions():
    params = _to_torch(_random_tree(np.random.default_rng(0)))
    opt = Optimizer(OPT_CFG)
    state = opt.init(params)
    assert torch.equal(state["ema"]["pos_encoding"], params["pos_encoding"])
    assert state["ema"]["pos_encoding"] is not params["pos_encoding"]
    before = (params["rgb_net"][0]._version,
              state["ema"]["rgb_net"][0]._version)
    opt.step(state, params, tree_map(torch.ones_like, params))
    assert params["rgb_net"][0]._version > before[0]
    assert state["ema"]["rgb_net"][0]._version > before[1]


def test_hyperparams_and_chain():
    opt = Optimizer(OPT_CFG)
    opt.update_hyperparams({"nested": {"nested": {"learning_rate": 5e-3}}})
    assert opt.base_learning_rate == 5e-3
    opt.set_learning_rate(1e-3)
    assert float(opt.learning_rate(0)) == pytest.approx(1e-3)
    # decay_end freezes the schedule
    frozen = Optimizer({"otype": "ExponentialDecay", "decay_start": 2,
                        "decay_interval": 2, "decay_base": 0.5,
                        "decay_end": 6,
                        "nested": {"otype": "Adam", "learning_rate": 1.0}})
    jfrozen = JaxOptimizer(frozen.config)
    for step in (0, 1, 2, 3, 4, 6, 7, 50):
        assert float(frozen.learning_rate(step)) == pytest.approx(
            float(jfrozen.learning_rate(step)))
    # no Ema in the chain: inference parameters are the parameters
    params = {"w": [torch.ones(2, 2)]}
    state = frozen.init(params)
    assert "ema" not in state
    assert frozen.inference_params(state, params) is params
    # Shampoo with beta_shampoo 0 is read as Adam; anything else raises
    Optimizer({"otype": "Shampoo", "beta_shampoo": 0.0})
    with pytest.raises(ValueError):
        Optimizer({"otype": "Sgd"})
