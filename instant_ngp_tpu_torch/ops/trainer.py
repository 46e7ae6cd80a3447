"""The generic trainer of the Image, SDF and Volume modes (counterpart of
instant_ngp_tpu/ops/trainer.py), and the L2 mask of its optimizer.

A `Trainer` pairs a model (an `nn.Module` with `param_tree()`,
`init_params(generator)` and a forward), an `Optimizer` and a loss. Its
state is the dict of the JAX package, `{"params": <the model's parameter
tensors themselves, in the JAX layout>, "opt": {"step", "m", "v"[,
"ema"]}}`, stepped in place:
- `train_step`: forward under autograd, backward, the loss scale divided
  back out of the gradients, Adam's l2_reg on the network's matrices only,
  one optimizer step;
- `train_step_custom_gradient`: the caller supplies d(loss)/d(output) and
  only the backward and the step run; `training_step` is `train_step`
  under the JAX package's name for its jitted wrapper;
- `inference_params`: the EMA copy when the optimizer keeps one. The
  trainer then also keeps `inference_model`, a second model whose
  parameter tensors ARE the EMA leaves (renders use it under no_grad,
  which sends its MLP through the fused kernel).

Given a `mesh` (parallel/mesh.py), the steps are data parallel over
`mesh_axis`: every rank passes its own shard of the batch (`shard_batch`),
and the gradients are averaged over the ranks in one all-reduce before
the optimizer, so that with shards of equal size the step is the one of
the whole batch and every replica takes it alike; `train_step` returns the
loss averaged the same way. (JAX's counterpart is no code: GSPMD makes
`train_step` the global-batch step over sharded inputs.)
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..parallel.mesh import pmean, psum_many
from ..utils import span
from .optimizers import Optimizer, tree_leaves, tree_map


def default_l2_mask(params: Any) -> Any:
    """Adam's l2_reg applies to network matrices only, never to encoding
    tables: in a dict, every leaf under a key that contains "encoding" is
    False; a bare list of matrices is all True."""
    if isinstance(params, dict):
        return {k: default_l2_mask(v) if isinstance(v, dict)
                else tree_map(lambda _, k=k: "encoding" not in k, v)
                for k, v in params.items()}
    return tree_map(lambda _: True, params)


class Trainer:
    def __init__(self, model: torch.nn.Module, optimizer: Optimizer,
                 loss_fn: Optional[Callable] = None, seed: int = 1337,
                 loss_scale: float = 1.0, mesh=None,
                 mesh_axis: str = "data"):
        self.model = model
        self._group = None if mesh is None else mesh.group(mesh_axis)
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.seed = seed
        self.loss_scale = float(loss_scale)
        self.inference_model = model

    def init_state(self, generator: Optional[torch.Generator] = None
                   ) -> Dict[str, Any]:
        """Initialise the model's parameters from `generator`, a CPU
        generator (default: seeded with `seed`, so a seed gives the same
        weights on any device) -> the state. The parameters then require
        grad."""
        if generator is None:
            generator = torch.Generator().manual_seed(self.seed)
        self.model.init_params(generator)
        self.model.requires_grad_(True)
        params = self.model.param_tree()
        opt = self.optimizer.init(params)
        if "ema" in opt:
            self.inference_model = copy.deepcopy(self.model)
            self.inference_model.requires_grad_(False)
            opt["ema"] = self.inference_model.param_tree()
        return {"params": params, "opt": opt}

    def n_params(self) -> int:
        return self.model.n_params

    def _step(self, state: Dict[str, Any], grads: Any) -> Dict[str, Any]:
        if self.loss_scale != 1.0:
            grads = tree_map(lambda g: g / self.loss_scale, grads)
        if self._group is not None:
            n = torch.distributed.get_world_size(self._group)
            summed = iter(psum_many(tree_leaves(grads), self._group))
            grads = tree_map(lambda _: next(summed) / n, grads)
        self.optimizer.step(state["opt"], state["params"], grads,
                            l2_mask=default_l2_mask(state["params"]))
        return state

    def _grads(self, outputs: torch.Tensor, params: Any,
               grad_outputs: Optional[torch.Tensor] = None) -> Any:
        """d(outputs)/d(params) as a tree like params (None stays None; a
        leaf the outputs do not reach gets zeros)."""
        leaves = tree_leaves(params)
        grads = iter(torch.autograd.grad(outputs, leaves, grad_outputs,
                                         allow_unused=True))

        def take(p):
            g = next(grads)
            return torch.zeros_like(p) if g is None else g
        return tree_map(take, params)

    def train_step(self, state: Dict[str, Any], inputs: torch.Tensor,
                   targets: torch.Tensor, draws=None,
                   generator: Optional[torch.Generator] = None
                   ) -> Tuple[Dict[str, Any], torch.Tensor]:
        """One step -> (state, the loss as a 0-dim tensor on the device;
        reading it waits for the device). `draws` or `generator`: the
        stochastic-corner encode of a grid encoding."""
        with torch.enable_grad():
            with span("trainer.forward"):
                pred = self.model(inputs, draws=draws, generator=generator)
                loss = self.loss_fn(pred, targets) * self.loss_scale
            with span("trainer.backward"):
                grads = self._grads(loss, state["params"])
        loss = loss.detach() / self.loss_scale
        if self._group is not None:
            loss = pmean(loss, self._group)
        with span("trainer.optimizer"):
            state = self._step(state, grads)
        return state, loss

    def train_step_custom_gradient(
            self, state: Dict[str, Any], inputs: torch.Tensor,
            dL_doutput: torch.Tensor, loss_value: torch.Tensor,
            apply_fn: Optional[Callable] = None
    ) -> Tuple[Dict[str, Any], torch.Tensor]:
        """A step from a supplied d(loss)/d(output) (the loss scale in it is
        divided out here) -> (state, loss_value). `apply_fn(inputs)`
        replaces the model's forward."""
        apply_fn = apply_fn or self.model
        with torch.enable_grad():
            out = apply_fn(inputs)
            grads = self._grads(out, state["params"], dL_doutput)
        return self._step(state, grads), loss_value

    def training_step(self, state: Dict[str, Any], inputs: torch.Tensor,
                      targets: torch.Tensor, draws=None,
                      generator: Optional[torch.Generator] = None
                      ) -> Tuple[Dict[str, Any], torch.Tensor]:
        """`train_step` under the JAX package's name for its stateful
        wrapper (which there jits the step once per shape)."""
        return self.train_step(state, inputs, targets, draws, generator)

    @torch.no_grad()
    def load_state(self, state: Dict[str, Any], params: Any,
                   opt: Optional[Dict[str, Any]] = None) -> None:
        """Copy parameters in the JAX layout and an optimizer state {"step",
        "m", "v", "ema"} (tensors or numpy arrays) into `state`, in place:
        absent moments are zero, an absent EMA equals the parameters."""
        self.model.load_params(params)
        opt = opt or {"step": 0}

        def fill(dst, src):
            dst.copy_(torch.as_tensor(src, dtype=dst.dtype).reshape(
                dst.shape))

        own = state["opt"]
        own["step"].fill_(int(opt["step"]))
        for k in ("m", "v"):
            if k in opt:
                tree_map(fill, own[k], opt[k])
            else:
                tree_map(lambda t: t.zero_(), own[k])
        if "ema" in own:
            tree_map(fill, own["ema"], opt.get("ema", params))

    def inference_params(self, state: Dict[str, Any]) -> Any:
        return self.optimizer.inference_params(state["opt"], state["params"])
