"""Composite: nested encodings without parameters over consecutive slices
of the input (each its `n_dims_to_encode`, the last the rest), their
features concatenated in order."""

from __future__ import annotations

import torch

from . import Encoding, build as build_nested


class Composite(Encoding):
    def __init__(self, nested):
        self.nested = nested       # [(first input column, dims, encoding)]
        self.n_output = sum(e.n_output for _, _, e in nested)

    def encode(self, leaves, x):
        return torch.cat([enc.encode([], x[:, start:start + n])
                          for start, n, enc in self.nested], dim=-1)


def build(n_dims, cfg, **scene):
    nested, start = [], 0
    for sub in cfg["nested"]:
        n = int(sub.get("n_dims_to_encode", n_dims - start))
        enc = build_nested(n, sub, **scene)
        if enc.n_leaves:
            raise NotImplementedError("the reference's Composite nests "
                                      "encodings without parameters")
        nested.append((start, n, enc))
        start += n
    return Composite(nested)
