"""The reference's input encodings, found by their `otype`: a config node
{"otype": "<otype>", ...} is built by `<otype>.py` in this directory, so a
new encoding is a new file here. Each file's `build(n_dims, cfg, **scene)`
returns an `Encoding`; `scene` holds what a grid derives its scales from
(`desired_resolution`), which other encodings ignore."""

from __future__ import annotations

import importlib
import os
from typing import List, Optional, Tuple

import torch

from ..grid import Grid

DIR = os.path.dirname(os.path.abspath(__file__))


def build(n_dims: int, cfg: dict, **scene) -> "Encoding":
    """The encoding of config node `cfg` over `n_dims` inputs (the otype
    defaults to HashGrid, as in the program's factory)."""
    otype = cfg.get("otype", "HashGrid")
    if not os.path.isfile(os.path.join(DIR, otype + ".py")):
        raise NotImplementedError(
            f"the reference has no encoding {otype!r}: "
            f"ngp_bench/reference/encodings/{otype}.py is missing")
    return importlib.import_module(f"{__name__}.{otype}").build(n_dims, cfg,
                                                               **scene)


class Encoding:
    """(N, n_dims) inputs in [0, 1] -> (N, n_output) features, in float32.

    `leaves` are the encoding's trained tensors as `init` made them (a
    list, empty for an encoding without parameters). Encodings with the
    stochastic-corner estimator (`stochastic`) also draw its random numbers
    and run its forward; `grid` is the grid whose rows the roofline counts,
    or None."""

    n_output: int
    n_leaves = 0
    stochastic = False
    grid: Optional[Grid] = None

    def init(self, gen: torch.Generator, table_range: float
             ) -> List[torch.Tensor]:
        """The seeded leaves, on the generator's device."""
        return []

    def encode(self, leaves: List[torch.Tensor], x: torch.Tensor
               ) -> torch.Tensor:
        """The exact encode, no gradient."""
        raise NotImplementedError

    def encode_exact(self, leaves: List[torch.Tensor], x: torch.Tensor
                     ) -> torch.Tensor:
        """The exact encode, differentiable in the leaves."""
        return self.encode(leaves, x)

    def draws(self, gen: torch.Generator, n: int, j: int
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The stochastic encode's random numbers for n points."""
        raise NotImplementedError(f"{type(self).__name__} is not stochastic")

    def encode_stochastic(self, leaves: List[torch.Tensor], x: torch.Tensor,
                          draws, j: int) -> torch.Tensor:
        raise NotImplementedError(f"{type(self).__name__} is not stochastic")
