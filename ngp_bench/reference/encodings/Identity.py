"""Identity: x * scale + offset, no parameters."""

from __future__ import annotations

from . import Encoding


class Identity(Encoding):
    def __init__(self, n_dims: int, scale: float, offset: float):
        self.n_output = n_dims
        self.scale, self.offset = scale, offset

    def encode(self, leaves, x):
        return x * self.scale + self.offset


def build(n_dims, cfg, **scene):
    return Identity(n_dims, float(cfg.get("scale", 1.0)),
                    float(cfg.get("offset", 0.0)))
