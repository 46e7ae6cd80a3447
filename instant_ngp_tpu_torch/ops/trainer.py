"""The L2 mask of the optimizer (counterpart of
instant_ngp_tpu/ops/trainer.py::default_l2_mask).

The generic `Trainer` of the Image, SDF and Volume modes is not ported
yet; the NeRF train step (nerf/training.py) drives the optimizer itself.
"""

from __future__ import annotations

from typing import Any

from .optimizers import tree_map


def default_l2_mask(params: Any) -> Any:
    """Adam's l2_reg applies to network matrices only, never to encoding
    tables: in a dict, every leaf under a key that contains "encoding" is
    False; a bare list of matrices is all True."""
    if isinstance(params, dict):
        return {k: default_l2_mask(v) if isinstance(v, dict)
                else tree_map(lambda _, k=k: "encoding" not in k, v)
                for k, v in params.items()}
    return tree_map(lambda _: True, params)
