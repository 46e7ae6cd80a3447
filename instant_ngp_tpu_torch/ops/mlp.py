"""Bias-free MLPs, and an encoding followed by one (counterpart of
instant_ngp_tpu/ops/mlp.py: `MLP`, `NetworkWithInputEncoding`).

input -> [n_neurons] * n_hidden_layers -> output, no biases (as tcnn's
fully-fused MLPs); n_hidden_layers = 0 is a single input->output matrix.
Master weights are float32 (fan_in, fan_out) matrices. With bf16 compute
the forward takes one of two paths, chosen by grad mode alone:
- grad mode on and the input or a weight requires grad (a train step):
  the differentiable path, float32 matmuls of bf16-rounded operands with
  hidden activations rounded to bf16, under autograd;
- otherwise (inference): `fused_mlp_forward`, the CUDA kernel on a CUDA
  tensor, its plain version on a CPU tensor. The kernel's output has no
  `grad_fn`, so it must never see a call that wants gradients.
With float32 compute the forward is a loop of float32 matmuls.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from .grid_encoding import GridEncoding
from .kernels import mlp_kernels
from .kernels.mlp_kernels import FusedMLPWeights, pack_weights


def apply_activation(name: str, x: torch.Tensor) -> torch.Tensor:
    """The tcnn activation set, by config name."""
    if name in ("None", None, "none"):
        return x
    if name == "ReLU":
        return torch.relu(x)
    if name == "Logistic":
        return torch.sigmoid(x)
    if name == "Exponential":
        return torch.exp(x)
    if name == "Sine":
        return torch.sin(x)
    if name == "Squareplus":
        return 0.5 * (x + torch.sqrt(x * x + 4.0))
    if name == "Softplus":
        return torch.nn.functional.softplus(x)
    if name == "Tanh":
        return torch.tanh(x)
    raise ValueError(f"unknown activation: {name}")


def activation_derivative(name: str, x: torch.Tensor) -> torch.Tensor:
    """d(activation)/dx at the pre-activation x."""
    if name in ("None", None, "none"):
        return torch.ones_like(x)
    if name == "ReLU":
        return (x > 0).to(x.dtype)
    if name == "Logistic":
        s = torch.sigmoid(x)
        return s * (1.0 - s)
    if name == "Exponential":
        return torch.exp(x)
    if name == "Sine":
        return torch.cos(x)
    raise ValueError(f"unknown activation derivative: {name}")


class MLP(nn.Module):
    def __init__(self, n_input_dims: int, n_output_dims: int,
                 n_neurons: int = 64, n_hidden_layers: int = 1,
                 activation: str = "ReLU", output_activation: str = "None",
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if compute_dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"compute dtype {compute_dtype} is not bf16 "
                             f"or float32")
        self.n_input_dims = n_input_dims
        self.n_output_dims = n_output_dims
        self.n_neurons = n_neurons
        self.n_hidden_layers = n_hidden_layers
        self.activation = activation
        self.output_activation = output_activation
        self.compute_dtype = compute_dtype
        self.weights = nn.ParameterList(
            [nn.Parameter(torch.zeros(i, o), requires_grad=False)
             for i, o in self.layer_dims])
        self._packed: FusedMLPWeights | None = None
        self._packed_key = None

    @classmethod
    def from_config(cls, n_input_dims: int, n_output_dims: int,
                    config: Dict[str, Any], **kw) -> "MLP":
        return cls(n_input_dims, n_output_dims,
                   n_neurons=config.get("n_neurons", 64),
                   n_hidden_layers=config.get("n_hidden_layers", 1),
                   activation=config.get("activation", "ReLU"),
                   output_activation=config.get("output_activation", "None"),
                   **kw)

    @property
    def layer_dims(self) -> List[Tuple[int, int]]:
        if self.n_hidden_layers == 0:
            return [(self.n_input_dims, self.n_output_dims)]
        dims = [(self.n_input_dims, self.n_neurons)]
        dims += [(self.n_neurons, self.n_neurons)] * (self.n_hidden_layers - 1)
        dims += [(self.n_neurons, self.n_output_dims)]
        return dims

    def init_params(self, generator: torch.Generator) -> None:
        """Xavier-uniform (the tcnn default), drawn from `generator`."""
        for w in self.weights:
            fan_in, fan_out = w.shape
            bound = (6.0 / (fan_in + fan_out)) ** 0.5
            u = torch.rand(fan_in, fan_out, generator=generator)
            with torch.no_grad():
                w.copy_(u * (2 * bound) - bound)

    def load_weights(self, weights: Sequence[torch.Tensor]) -> None:
        shapes = [tuple(w.shape) for w in weights]
        if shapes != self.layer_dims:
            raise ValueError(f"weight shapes {shapes} != {self.layer_dims}")
        with torch.no_grad():
            for p, w in zip(self.weights, weights):
                p.copy_(torch.as_tensor(w, dtype=torch.float32))

    def kernel_weights(self) -> FusedMLPWeights:
        """The bf16 weights `fused_mlp_forward` takes, packed again only
        when the master weights were replaced, moved or changed in place."""
        key = tuple((w.data_ptr(), w._version) for w in self.weights)
        if key != self._packed_key:
            self._packed = pack_weights(list(self.weights))
            self._packed_key = key
        return self._packed

    def _forward_differentiable(self, x: torch.Tensor) -> torch.Tensor:
        """The bf16 forward under autograd: what `fused_mlp_forward_plain`
        computes, for any activation of the tcnn set."""
        bf16 = torch.bfloat16
        h = x.to(bf16).float()
        for i, w in enumerate(self.weights):
            h = h @ w.to(bf16).float()
            if i + 1 < len(self.weights):
                h = apply_activation(self.activation, h).to(bf16).float()
        return apply_activation(self.output_activation, h)

    def forward(self, x: torch.Tensor,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (N, n_input_dims) -> (N, n_output_dims) float32. `out`, on the
        inference path alone: the buffer `fused_mlp_forward` writes."""
        if self.compute_dtype == torch.bfloat16:
            if torch.is_grad_enabled() and (
                    x.requires_grad
                    or any(w.requires_grad for w in self.weights)):
                if out is not None:
                    raise ValueError("MLP: out is the inference path's")
                return self._forward_differentiable(x)
            return mlp_kernels.fused_mlp_forward(
                x.contiguous(), self.kernel_weights(), self.activation,
                self.output_activation, out=out)
        if out is not None:
            raise ValueError("MLP: out is the inference path's")
        h = x.float()
        for i, w in enumerate(self.weights):
            h = h @ w
            if i + 1 < len(self.weights):
                h = apply_activation(self.activation, h)
        return apply_activation(self.output_activation, h)


class NetworkWithInputEncoding(nn.Module):
    """encoding |> MLP, the network of the Image, SDF and Volume modes.

    `param_tree()` hands out the parameter tensors themselves in the JAX
    layout {"encoding": the flat grid table, or None for an encoding
    without parameters, "net": [weights]}; an optimizer steps them in
    place."""

    def __init__(self, encoding: nn.Module, network: MLP):
        super().__init__()
        if network.n_input_dims != encoding.n_output_dims:
            raise ValueError(f"the network takes {network.n_input_dims} "
                             f"inputs, the encoding gives "
                             f"{encoding.n_output_dims}")
        self.encoding = encoding
        self.network = network

    @property
    def n_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def _table(self) -> Optional[torch.Tensor]:
        return getattr(self.encoding, "params", None)

    def init_params(self, generator: torch.Generator) -> None:
        """The grid table from U(-1e-4, 1e-4) (where there is one), then
        the MLP Xavier-uniform, drawn from `generator` in that order."""
        if self._table() is not None:
            self.encoding.init_params(generator)
        self.network.init_params(generator)

    def param_tree(self) -> Dict[str, Any]:
        return {"encoding": self._table(), "net": list(self.network.weights)}

    def load_params(self, params: Dict[str, Any]) -> None:
        """params in the JAX layout (tensors or numpy arrays)."""
        table = self._table()
        if table is not None:
            with torch.no_grad():
                table.copy_(torch.as_tensor(params["encoding"]).reshape(-1))
        self.network.load_weights(params["net"])

    def forward(self, x: torch.Tensor, max_level: Optional[float] = None,
                draws=None, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """x (N, n_dims) in [0, 1] -> (N, n_output_dims) float32. `draws` or
        `generator` switch a grid encoding to its stochastic-corner
        estimator (training only); other encodings ignore them."""
        if isinstance(self.encoding, GridEncoding):
            feats = self.encoding(x, max_level=max_level, draws=draws,
                                  generator=generator)
        else:
            feats = self.encoding(x)
        return self.network(feats)
