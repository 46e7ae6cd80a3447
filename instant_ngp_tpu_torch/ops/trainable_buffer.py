"""TrainableBuffer: a trainable tensor with an optimizer of its own
(counterpart of instant_ngp_tpu/ops/trainable_buffer.py).

The testbed keeps three: the 4-channel lat-long environment map, the
2-channel lens-distortion map and the per-image latent codes. A train step
returns their gradients (autograd reaches them through `read_envmap`,
`bilerp_2d` and a gather), and `step` applies the port's `Optimizer` to
the buffer in place, on its device.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence

import torch

from .optimizers import create_optimizer


class TrainableBuffer:
    def __init__(self, shape: Sequence[int],
                 optimizer_config: Dict[str, Any],
                 init_value=None, device=None):
        self.shape = tuple(shape)
        self.optimizer = create_optimizer(optimizer_config)
        if init_value is None:
            params = torch.zeros(self.shape, dtype=torch.float32,
                                 device=device)
        else:
            params = torch.as_tensor(init_value, dtype=torch.float32) \
                .to(device).clone()
        if tuple(params.shape) != self.shape:
            raise ValueError(f"init_value {tuple(params.shape)} != "
                             f"{self.shape}")
        self.state = {"params": params, "opt": self.optimizer.init(params)}

    @property
    def params(self) -> torch.Tensor:
        return self.state["params"]

    def inference_params(self) -> torch.Tensor:
        return self.optimizer.inference_params(self.state["opt"],
                                               self.state["params"])

    def step(self, gradient: torch.Tensor) -> None:
        """One optimizer step, in place."""
        self.optimizer.step(self.state["opt"], self.state["params"],
                            gradient)

    @torch.no_grad()
    def load_state(self, state: Dict[str, Any]) -> None:
        """{"params", "opt": {"step", "m", "v", "ema"}} (numpy arrays or
        tensors; "opt" may be missing), copied in place."""
        def fill(dst, src):
            dst.copy_(torch.as_tensor(src, dtype=dst.dtype).reshape(
                dst.shape))

        fill(self.state["params"], state["params"])
        opt = state.get("opt") or {}
        mine = self.state["opt"]
        mine["step"].fill_(int(opt.get("step", 0)))
        for k in ("m", "v"):
            if k in opt:
                fill(mine[k], opt[k])
            else:
                mine[k].zero_()
        if "ema" in mine:
            fill(mine["ema"], opt.get("ema", state["params"]))


def bilerp_2d(grid: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of grid (H, W, C) at uv (..., 2) in [0,1]^2, texel
    centres at half-integers, clamped at the border; differentiable in the
    grid (and piecewise in uv)."""
    h, w = grid.shape[:2]
    size = torch.tensor([w, h], dtype=torch.float32, device=uv.device)
    pos = torch.minimum((uv * size - 0.5).clamp(min=0.0), size - 1.001)
    p0 = torch.floor(pos)
    frac = pos - p0
    x0, y0 = p0[..., 0].long(), p0[..., 1].long()
    x1, y1 = (x0 + 1).clamp(max=w - 1), (y0 + 1).clamp(max=h - 1)
    fx, fy = frac[..., 0:1], frac[..., 1:2]
    return ((1 - fx) * (1 - fy) * grid[y0, x0] + fx * (1 - fy) * grid[y0, x1]
            + (1 - fx) * fy * grid[y1, x0] + fx * fy * grid[y1, x1])


def read_envmap(envmap: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Lat-long environment map (H, W, 4) looked up by normalized
    directions (..., 3) -> (..., 4) RGBA; differentiable in the map."""
    theta = torch.arcsin(dirs[..., 1].clamp(-1.0, 1.0))   # elevation
    phi = torch.atan2(dirs[..., 0], dirs[..., 2])
    uv = torch.stack([phi / (2 * math.pi) + 0.5, theta / math.pi + 0.5],
                     dim=-1)
    return bilerp_2d(envmap, uv)
