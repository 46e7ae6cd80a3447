"""The yardstick: the card's published peaks and the least work the
inputs need (operations and bytes), counted from the inputs and the
configuration's widths, never from what the program's kernels launch.

Peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet,
dense): 989 TFLOP/s in bf16, 3.35 TB/s of HBM."""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

import torch

HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12


def mlp_flops(dims: Sequence[Tuple[int, int]]) -> int:
    """Forward operations a row: 2 * fan_in * fan_out over the layers."""
    return sum(2 * i * o for i, o in dims)


def mlp_bound_s(rows: int, dims: Sequence[Tuple[int, int]],
                x_bytes_per_value: int = 4) -> float:
    """The least time of a fused MLP over `rows`: its input read and its
    float32 output written once, and the bf16 weights read once, at the
    HBM rate, against its operations at the bf16 rate; the larger."""
    n_weights = sum(i * o for i, o in dims)
    moved = rows * (dims[0][0] * x_bytes_per_value + dims[-1][1] * 4) \
        + 2 * n_weights
    return max(moved / HBM_BYTES_PER_S,
               rows * mlp_flops(dims) / BF16_FLOP_PER_S)


def distinct_rows(rows: torch.Tensor) -> int:
    """How many different table rows a (flat) index tensor names."""
    if rows.numel() == 0:
        return 0
    return int(torch.unique(rows.reshape(-1)).numel())


class GridCall:
    """One encode call's work: points, output features, and per level the
    distinct table rows it reads (a forward) or writes (a gradient)."""

    def __init__(self, kind: str, n_points: int, n_dims: int,
                 n_features: int, rows_per_level: List[int]):
        self.kind = kind                # "forward" or "gradient"
        self.n_points = n_points
        self.n_dims = n_dims
        self.n_features = n_features
        self.rows_per_level = rows_per_level

    def bytes(self) -> int:
        """Forward: the positions read, the features written, each row read
        once. Gradient: the incoming gradient read, each row written
        once."""
        n_out = self.n_points * self.n_features * len(self.rows_per_level)
        rows = sum(self.rows_per_level) * self.n_features * 4
        if self.kind == "forward":
            return self.n_points * self.n_dims * 4 + n_out * 4 + rows
        return n_out * 4 + rows


def grid_bound_s(calls: Iterable[GridCall]) -> Optional[float]:
    calls = list(calls)
    if not calls:
        return None
    return sum(c.bytes() for c in calls) / HBM_BYTES_PER_S


def share_pct(bound_s: Optional[float], measured_s: float
              ) -> Optional[float]:
    """A share of a roofline or a peak in %, or None where nothing was
    measured (never 0 for an absent reading)."""
    if bound_s is None or not measured_s > 0.0 or not bound_s > 0.0:
        return None
    return 100.0 * bound_s / measured_s
