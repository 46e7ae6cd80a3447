"""Whether a train step repeats bit for bit on the card, and which of its
operations PyTorch marks as summing in an order that can change between
runs.

A NeRF run repeats only if every sum it feeds back into itself is taken
in a fixed order: the table gradient and the error map are summed by
`ops/grid_encoding.py::ordered_deposit`, which sorts on the card, as
JAX's `.at[].add` is deterministic. Two checks hold the train paths to
that:
- `warned_ops(fn)` runs fn under `torch.use_deterministic_algorithms(True,
  warn_only=True)` and returns the operations PyTorch warned about; an op
  on the list `ORDER_FREE` warns, but no order can change its result;
- `digest(...)`: two runs from one seed with the mode off must give the
  same bits. This also sees what the mode cannot: an op that has a
  deterministic variant (`index_add_`, `scatter_add_`, `index_copy_` on
  CUDA) switches to it silently under the mode instead of warning.
The mode is never left on: it is a check, not a setting of the port.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import re
import warnings
from typing import Callable, List, Tuple, TypeVar

import torch

T = TypeVar("T")

#: ops that warn under the deterministic mode but whose result does not
#: depend on the order in which the card applies their parts
ORDER_FREE = {
    "scatter_reduce_cuda": (
        "nerf/occupancy.py::splat_and_ema takes each cell's amax of the "
        "samples' densities: max is exact and commutative, so every order "
        "gives the same bits"),
}

_WARNED = re.compile(r"^(\S+) does not have a deterministic implementation")


@contextlib.contextmanager
def _deterministic_mode():
    """The mode on, warnings only, with cuBLAS's workspace variable set so
    that matmuls do not warn; both restored on exit."""
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])
        if env is None:
            del os.environ["CUBLAS_WORKSPACE_CONFIG"]
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = env


def op_of_warning(message: str) -> str:
    """The op a deterministic-mode warning names, or "" for any other
    warning."""
    m = _WARNED.match(message)
    return m.group(1) if m else ""


def warned_ops(fn: Callable[[], T]) -> Tuple[T, List[str]]:
    """fn() under the deterministic mode (warnings only) -> (its result,
    the sorted names of the ops PyTorch warned about, each once)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with _deterministic_mode():
            out = fn()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    ops = {op_of_warning(str(w.message)) for w in caught}
    return out, sorted(op for op in ops if op)


def digest(*tensors: torch.Tensor) -> str:
    """sha256 of the tensors' bytes, in order (read to the host)."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().reshape(-1).contiguous().cpu()
                 .view(torch.uint8).numpy().tobytes())
    return h.hexdigest()
