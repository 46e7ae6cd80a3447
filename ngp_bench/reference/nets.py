"""Plain networks and optimizer of the reference: bias-free ReLU MLPs,
the Adam > ExponentialDecay > Ema chain of instant-ngp's configs, and the
Huber and L2 losses (the encodings are in `encodings/`).

Float32 by default. `Precision(dtype)` rounds every MLP operand (the
input, each weight, each hidden activation) and the gradient flowing back
through it to `dtype`: the benchmark's control runs the reference so in
float8, the precision below the bfloat16 the configurations state.
"""

from __future__ import annotations

from typing import List, Optional

import torch


class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dtype):
        ctx.dtype = dtype
        return x.to(dtype).float()

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype).float(), None


class Precision:
    """dtype None: float32 (the reference); else round MLP operands to it."""

    def __init__(self, dtype: Optional[torch.dtype] = None):
        self.dtype = dtype

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.dtype is None else _Round.apply(x, self.dtype)


FP32 = Precision()
# the controls' precision: float8 (e4m3), the one below the bfloat16 the
# configurations state
FP8 = Precision(torch.float8_e4m3fn)


def mlp(weights: List[torch.Tensor], x: torch.Tensor,
        prec: Precision = FP32) -> torch.Tensor:
    """ReLU hidden layers, no output activation, no biases."""
    h = prec(x)
    for i, w in enumerate(weights):
        h = h @ prec(w)
        if i + 1 < len(weights):
            h = prec(torch.relu(h))
    return h


def xavier(fan_in: int, fan_out: int, gen: torch.Generator) -> torch.Tensor:
    bound = (6.0 / (fan_in + fan_out)) ** 0.5
    return torch.rand(fan_in, fan_out, generator=gen,
                      device=gen.device) * (2 * bound) - bound


def layer_dims(n_in: int, n_out: int, cfg: dict):
    hidden = int(cfg.get("n_hidden_layers", 1))
    width = int(cfg.get("n_neurons", 64))
    if hidden == 0:
        return [(n_in, n_out)]
    return [(n_in, width)] + [(width, width)] * (hidden - 1) \
        + [(width, n_out)]


def huber(target: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """The NeRF composite's Huber: alpha 0.1, divided by 5."""
    d = pred - target
    ad = d.abs()
    return torch.where(ad > 0.1, ad - 0.05, 5.0 * d * d) / 5.0


class Adam:
    """instant-ngp's optimizer chain over a list of leaves: the learning
    rate from the step before the increment (ExponentialDecay), bias terms
    from t = step + 1, L2 on the leaves `l2_mask` marks, and an EMA copy
    (not debiased) where the chain has one. State is float32; step counts
    stay on the host."""

    def __init__(self, cfg: dict, leaves: List[torch.Tensor],
                 l2_mask: List[bool]):
        chain, node = [], cfg
        while node is not None:
            chain.append(node)
            node = node.get("nested")
        self.adam = chain[-1]
        self.decay = next((n for n in chain
                           if n.get("otype") == "ExponentialDecay"), None)
        ema = next((n for n in chain if n.get("otype") == "Ema"), None)
        self.ema_decay = None if ema is None else float(ema.get("decay", 0.99))
        self.l2_mask = l2_mask
        self.step_count = 0
        self.m = [torch.zeros_like(p) for p in leaves]
        self.v = [torch.zeros_like(p) for p in leaves]
        self.ema = None if self.ema_decay is None \
            else [p.detach().clone() for p in leaves]

    def learning_rate(self) -> float:
        lr = float(self.adam.get("learning_rate", 1e-3))
        d = self.decay
        if d is None:
            return lr
        step = float(self.step_count)
        if "decay_end" in d:
            step = min(step, float(d["decay_end"]))
        start = int(d.get("decay_start", 0))
        interval = max(int(d.get("decay_interval", 1)), 1)
        n = (max(step - start, 0.0) // interval) + (1.0 if step >= start
                                                     else 0.0)
        return lr * float(d.get("decay_base", 1.0)) ** n

    def effective_gradients(self, leaves, grads):
        """The gradients the moments take: L2 added where masked."""
        l2 = float(self.adam.get("l2_reg", 0.0))
        return [g + l2 * p if (l2 != 0.0 and use) else g
                for p, g, use in zip(leaves, grads, self.l2_mask)]

    @torch.no_grad()
    def step(self, leaves, grads) -> None:
        b1 = float(self.adam.get("beta1", 0.9))
        b2 = float(self.adam.get("beta2", 0.999))
        eps = float(self.adam.get("epsilon", 1e-8))
        lr = self.learning_rate()
        self.step_count += 1
        t = self.step_count
        bias1 = 1.0 - b1 ** t
        bias2 = 1.0 - b2 ** t
        for i, (p, g) in enumerate(zip(leaves,
                                       self.effective_gradients(leaves,
                                                                grads))):
            self.m[i].mul_(b1).add_(g, alpha=1.0 - b1)
            self.v[i].mul_(b2).add_(g * g, alpha=1.0 - b2)
            p.sub_(lr * (self.m[i] / bias1)
                   / (torch.sqrt(self.v[i] / bias2) + eps))
            if self.ema is not None:
                self.ema[i].mul_(self.ema_decay).add_(
                    p, alpha=1.0 - self.ema_decay)
