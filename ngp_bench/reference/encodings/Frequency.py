"""Frequency: the positional encoding of the original NeRF, as tcnn lays
it out: per input dim, per octave k < n_frequencies, (sin, cos) of
(x * 2^k) * pi; n_dims * n_frequencies * 2 features, no parameters.

The features run dim-major, then octave, then (sin, cos), tcnn's order.
The angle is (x * 2^k) * pi, with pi in float32. A product by a power of
two is exact in float32 wherever it does not overflow (x in [0, 1], k <
64), so x * 2^k and 2^k * pi are exact, and (x * 2^k) * pi and
x * (2^k * pi) both round the one exact product x * 2^k * pi once: the
same floats as an encoding that scales by 2^k * pi in one step."""

from __future__ import annotations

import torch

from . import Encoding


class Frequency(Encoding):
    def __init__(self, n_dims: int, n_frequencies: int):
        self.n_frequencies = n_frequencies
        self.n_output = n_dims * n_frequencies * 2

    def encode(self, leaves, x):
        octaves = torch.exp2(torch.arange(self.n_frequencies,
                                          dtype=torch.float32,
                                          device=x.device))
        ang = (x.float()[:, :, None] * octaves) * torch.pi   # (N, dims, F)
        return torch.stack([torch.sin(ang), torch.cos(ang)],
                           dim=-1).reshape(x.shape[0], self.n_output)


def build(n_dims, cfg, **scene):
    return Frequency(n_dims, int(cfg.get("n_frequencies", 12)))
