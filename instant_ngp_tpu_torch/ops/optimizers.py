"""Nested JSON optimizer stack: Ema > ExponentialDecay > Adam (counterpart
of instant_ngp_tpu/ops/optimizers.py).

The parameters are a tree (dicts and lists) of tensors; the state is
`{"step", "m", "v", "ema"}` with `m`, `v` and `ema` trees of the same
shape, the layout of the JAX package, so that a snapshot of either loads
into the other. `step` updates parameters and state IN PLACE under
`torch.no_grad()`: a tensor that aliases a parameter or an `ema` leaf
(the inference network's weights do) sees the new values and a bumped
`_version`. The step count lives on the parameters' device and the
schedule is computed there, so a step never waits for the host.

The update is the JAX package's to the letter: the learning rate from the
step count before the increment, bias terms from t = step + 1,
    p <- p - lr * (m / bias1) / (sqrt(v / bias2) + eps),
L2 added to the gradient only where `l2_mask` says, and an EMA that starts
as a copy of the parameters and is not debiased.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, List

import torch


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply fn to the corresponding leaves of trees of dicts and lists.
    None is an empty subtree, as in the JAX package's trees."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    out: List[Any] = []
    tree_map(out.append, tree)
    return out


class Optimizer:
    """Composition of Ema / ExponentialDecay / Adam from a JSON config."""

    def __init__(self, config: Dict[str, Any]):
        self.config = copy.deepcopy(config)
        self.chain = []          # [outermost, ..., Adam]
        node = self.config
        while node is not None:
            self.chain.append(node)
            node = node.get("nested")
        kinds = [n.get("otype") for n in self.chain]
        if kinds[-1] not in ("Adam", "Shampoo"):
            raise ValueError(f"innermost optimizer must be Adam-like, got "
                             f"{kinds}")
        # the one shipped Shampoo config sets beta_shampoo = 0, which
        # takes none of the Kronecker preconditioner: it is Adam
        self._adam = self.chain[-1]
        self._decay = next((n for n in self.chain
                            if n.get("otype") == "ExponentialDecay"), None)
        self._ema = next((n for n in self.chain
                          if n.get("otype") == "Ema"), None)

    # -- hyperparameters ------------------------------------------------
    @property
    def base_learning_rate(self) -> float:
        return float(self._adam.get("learning_rate", 1e-3))

    def set_learning_rate(self, lr: float) -> None:
        self._adam["learning_rate"] = float(lr)

    def update_hyperparams(self, partial_config: Dict[str, Any]) -> None:
        """Deep-merge new hyperparameters into the nested chain."""
        def merge(dst, src):
            for k, v in src.items():
                if k == "nested" and "nested" in dst:
                    merge(dst["nested"], v)
                elif isinstance(v, dict) and isinstance(dst.get(k), dict):
                    merge(dst[k], v)
                else:
                    dst[k] = v
        merge(self.config, partial_config)
        self.__init__(self.config)

    def learning_rate(self, step) -> torch.Tensor:
        """Learning rate at `step` (an int or an integer tensor): times
        decay_base every decay_interval steps from decay_start on, frozen
        after decay_end."""
        step_c = torch.as_tensor(step).to(torch.float32)
        lr = torch.full_like(step_c, self.base_learning_rate)
        if self._decay is not None:
            d = self._decay
            start = int(d.get("decay_start", 0))
            interval = max(int(d.get("decay_interval", 1)), 1)
            base = float(d.get("decay_base", 1.0))
            if "decay_end" in d:
                step_c = step_c.clamp(max=float(d["decay_end"]))
            n = torch.floor((step_c - start).clamp(min=0.0) / interval
                            + (step_c >= start).to(torch.float32))
            lr = lr * torch.pow(torch.full_like(n, base), n)
        return lr

    # -- state ----------------------------------------------------------
    def init(self, params) -> Dict[str, Any]:
        leaves = tree_leaves(params)
        device = leaves[0].device if leaves else None
        state = {
            "step": torch.zeros((), dtype=torch.int32, device=device),
            "m": tree_map(lambda p: torch.zeros_like(p.detach()), params),
            "v": tree_map(lambda p: torch.zeros_like(p.detach()), params),
        }
        if self._ema is not None:
            state["ema"] = tree_map(lambda p: p.detach().clone(), params)
        return state

    @torch.no_grad()
    def step(self, state, params, grads, l2_mask=None):
        """One step, in place. -> (params, state), the objects given.

        l2_mask: a tree of bools, or None for every leaf: where L2
        regularization (grad += l2_reg * param) applies."""
        a = self._adam
        beta1 = float(a.get("beta1", 0.9))
        beta2 = float(a.get("beta2", 0.999))
        eps = float(a.get("epsilon", 1e-8))
        l2 = float(a.get("l2_reg", 0.0))
        decay = None if self._ema is None else \
            float(self._ema.get("decay", 0.99))

        lr = self.learning_rate(state["step"])
        state["step"] += 1
        t = state["step"].to(torch.float32)
        bias1 = 1.0 - torch.pow(torch.full_like(t, beta1), t)
        bias2 = 1.0 - torch.pow(torch.full_like(t, beta2), t)

        if l2_mask is None:
            l2_mask = tree_map(lambda p: True, params)
        ema = state.get("ema") if decay is not None else None
        if ema is None:
            ema = tree_map(lambda p: None, params)

        def update(p, g, m, v, e, use_l2):
            if l2 != 0.0 and use_l2:
                g = g + l2 * p
            m.mul_(beta1).add_(g, alpha=1.0 - beta1)
            v.mul_(beta2).add_(g * g, alpha=1.0 - beta2)
            p.sub_(lr * (m / bias1) / (torch.sqrt(v / bias2) + eps))
            if e is not None:
                e.mul_(decay).add_(p, alpha=1.0 - decay)

        tree_map(update, params, grads, state["m"], state["v"], ema,
                 l2_mask)
        return params, state

    def inference_params(self, state, params):
        """The EMA copy when the chain has an Ema, else the parameters."""
        return state.get("ema", params)


def create_optimizer(config: Dict[str, Any]) -> Optimizer:
    return Optimizer(config)
