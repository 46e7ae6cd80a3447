"""HashGrid: the multiresolution hash grid of `grid.py`, one table leaf
(U(-r, r)), the exact and the stochastic-corner encodes."""

from __future__ import annotations

import torch

from ..grid import Grid
from . import Encoding


class HashGrid(Encoding):
    n_leaves = 1
    stochastic = True

    def __init__(self, grid: Grid):
        self.grid = grid
        self.n_output = grid.n_output
        # the train step's exact axes (density updates take 0)
        self.exact_axes = grid.exact_axes

    def init(self, gen, table_range):
        g = self.grid
        return [(torch.rand(g.n_entries * g.n_features, generator=gen,
                            device=gen.device) * 2.0 - 1.0) * table_range]

    def encode(self, leaves, x):
        return self.grid.encode(leaves[0], x)

    def encode_exact(self, leaves, x):
        return self.grid.encode_exact(leaves[0], x)

    def draws(self, gen, n, j):
        """The program's order: the uniforms, then the exact axes where
        j > 0."""
        g = self.grid
        u = torch.rand(g.n_dims, n, g.n_levels, generator=gen,
                       device=gen.device)
        axis = None if j == 0 else torch.randint(
            0, g.n_dims, (n, g.n_levels), generator=gen, device=gen.device)
        return u, axis

    def encode_stochastic(self, leaves, x, draws, j):
        u, axis = draws
        return self.grid.encode_stochastic(leaves[0], x, u, axis, j)


def build(n_dims, cfg, desired_resolution=2048.0):
    """`desired_resolution` 2048 over the unit box: a NeRF's position."""
    return HashGrid(Grid(n_dims, cfg, desired_resolution))
