"""NerfNetwork: hash-grid density model and view-dependent RGB head
(counterpart of instant_ngp_tpu/nerf/model.py).

- density path: position in [0,1]^3 -> pos_encoding (HashGrid) -> density
  MLP with 16 raw outputs; channel 0 is the pre-activation density;
- color path: warped direction (+ extra latent dims) -> dir_encoding
  (SH degree 4, or Composite SH + Identity) -> concat(density outputs,
  direction features) -> RGB MLP -> 3 raw outputs.

Outputs are pre-activation; `network_to_rgb` / `network_to_density` apply
the activations (`NerfActivations` names the pair). Parameters load from the JAX layout
{"pos_encoding", "density_net", "dir_encoding", "rgb_net"}, and
`param_tree` hands the module's own parameter tensors out in that layout:
the optimizer updates them in place, and a second network of the same
configuration whose tree IS the optimizer's EMA tree serves inference
with no copy. Parameters do not require grad unless `requires_grad_(True)`
is called, as a trainer does; under grad the forward is differentiable in
the parameters, and in the positions and directions where those require
grad (ops/mlp.py and ops/grid_encoding.py say how).

`encode_draws` / `encode_generator` / `exact_axes` go to the position
encoding alone and switch it to its stochastic-corner estimator (training
and density updates; no gradient reaches the positions then).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
from torch import nn

from ..ops.encodings import create_encoding
from ..ops.factory import derive_grid_config
from ..ops.mlp import MLP, activation_derivative, apply_activation


class NerfNetwork(nn.Module):
    def __init__(self, n_pos_dims: int, n_dir_dims: int, n_extra_dims: int,
                 encoding_config: Dict[str, Any],
                 dir_encoding_config: Dict[str, Any],
                 network_config: Dict[str, Any],
                 rgb_network_config: Dict[str, Any],
                 desired_resolution: float = 2048.0,
                 aabb_scale: float = 1.0,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.n_pos_dims = n_pos_dims
        self.n_dir_dims = n_dir_dims
        self.n_extra_dims = n_extra_dims
        enc_cfg = derive_grid_config(encoding_config, n_pos_dims,
                                     desired_resolution, aabb_scale)
        self.resolved_encoding_config = enc_cfg
        self.pos_encoding = create_encoding(n_pos_dims, enc_cfg)
        self.dir_encoding = create_encoding(n_dir_dims + n_extra_dims,
                                            dir_encoding_config)
        self.n_density_out = int(network_config.get("n_output_dims", 16))
        self.density_net = MLP.from_config(
            self.pos_encoding.n_output_dims, self.n_density_out,
            network_config, compute_dtype=compute_dtype)
        self.rgb_net = MLP.from_config(
            self.n_density_out + self.dir_encoding.n_output_dims, 3,
            rgb_network_config, compute_dtype=compute_dtype)

    def _table(self) -> Optional[torch.Tensor]:
        """The position encoding's table (a grid's), or None for an
        encoding without parameters (Frequency, Identity, ...)."""
        return getattr(self.pos_encoding, "params", None)

    def init_params(self, generator: torch.Generator) -> None:
        if self._table() is not None:
            self.pos_encoding.init_params(generator)
        self.density_net.init_params(generator)
        self.rgb_net.init_params(generator)

    def load_params(self, params: Dict[str, Any]) -> None:
        """params in the JAX layout, as tensors (see convert.params_from_jax).
        The direction encodings the NeRF configs use carry no parameters."""
        if self._table() is not None:
            with torch.no_grad():
                self._table().copy_(
                    torch.as_tensor(params["pos_encoding"]).reshape(-1))
        self.density_net.load_weights(params["density_net"])
        self.rgb_net.load_weights(params["rgb_net"])

    def param_tree(self) -> Dict[str, Any]:
        """The parameter tensors themselves, in the JAX layout (the
        direction encodings, and a position encoding that is not a grid,
        carry none: None, an empty subtree)."""
        return {"pos_encoding": self._table(),
                "density_net": list(self.density_net.weights),
                "dir_encoding": None,
                "rgb_net": list(self.rgb_net.weights)}

    def density_forward(self, pos: torch.Tensor,
                        max_level: Optional[float] = None,
                        encode_draws=None, encode_generator=None,
                        exact_axes: Optional[int] = None,
                        pos_feats: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
        """Warped positions (N, 3) -> raw density-net outputs (N, 16). An
        encoding that is not a grid takes no level cap or corner draws.
        `pos_feats` (N, L*F), where given, are the position encoding's
        features, computed elsewhere (the level-sharded grid of
        parallel/tp.py)."""
        if pos_feats is not None:
            feats = pos_feats
        elif self._table() is None:
            feats = self.pos_encoding(pos)
        elif encode_draws is None and encode_generator is None:
            feats = self.pos_encoding(pos, max_level=max_level)
        else:
            feats = self.pos_encoding(pos, max_level=max_level,
                                      draws=encode_draws,
                                      generator=encode_generator,
                                      exact_axes=exact_axes)
        return self.density_net(feats)

    def density(self, pos: torch.Tensor,
                max_level: Optional[float] = None, **encode
                ) -> torch.Tensor:
        """Raw (pre-activation) density (N,)."""
        return self.density_forward(pos, max_level, **encode)[:, 0]

    def apply_components(self, pos: torch.Tensor, dirs: torch.Tensor,
                         extra: Optional[torch.Tensor] = None,
                         max_level: Optional[float] = None,
                         encode_draws=None, encode_generator=None,
                         exact_axes: Optional[int] = None,
                         pos_feats: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
        """Full forward: warped positions and directions (N, 3), extra
        latents (N, n_extra) -> raw (N, 4) = [r, g, b, density]."""
        density_out = self.density_forward(pos, max_level, encode_draws,
                                           encode_generator, exact_axes,
                                           pos_feats)
        dir_in = dirs
        if self.n_extra_dims:
            if extra is None:
                raise ValueError("model expects extra dims")
            dir_in = torch.cat([dirs, extra], dim=-1)
        rgb_in = torch.cat([density_out, self.dir_encoding(dir_in).float()],
                           dim=-1)
        rgb = self.rgb_net(rgb_in)
        return torch.cat([rgb, density_out[:, :1]], dim=-1)


@dataclasses.dataclass
class NerfActivations:
    """The RGB and density output activations (Exponential RGB where the
    dataset is HDR)."""

    rgb: str = "Logistic"
    density: str = "Exponential"


def network_to_rgb(raw: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "Exponential":
        return torch.exp(raw.clamp(-10.0, 10.0))  # the reference clamps exp
    return apply_activation(activation, raw)


def network_to_rgb_derivative(raw: torch.Tensor, activation: str
                              ) -> torch.Tensor:
    if activation == "Exponential":
        return torch.exp(raw.clamp(-10.0, 10.0))
    return activation_derivative(activation, raw)


def network_to_density(raw: torch.Tensor, activation: str) -> torch.Tensor:
    # unclamped, as in the reference (only its derivative clamps)
    return apply_activation(activation, raw)


def network_to_density_derivative(raw: torch.Tensor, activation: str
                                  ) -> torch.Tensor:
    if activation == "Exponential":
        return torch.exp(raw.clamp(-15.0, 15.0))
    return activation_derivative(activation, raw)
