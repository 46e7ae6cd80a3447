"""What the drivers share. A driver (`drivers/<name>.py`, named by a
traffic file's `driver`) sets the cell up from the seed, runs the measured
window as a closed loop of the program's own calls (`LoopWindow`), and
after the window compares what the window's path produced with the plain
reference. It returns an `Outcome`; `run.py` turns it into the result
line. Sizes come from the configuration and traffic files; `overrides`
(tests only) shrink them for the CPU."""

from __future__ import annotations

import gc
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from ..reference.grid import Grid
from .roofline import GridCall, distinct_rows
from .trace import Profiled, Window


class Outcome:
    def __init__(self):
        self.e2e: Dict[str, float] = {}
        self.checks: Dict[str, Dict[str, Any]] = {}
        self.attempted = 0
        self.failed = 0
        self.memory_peak = 0
        self.window_s = 0.0
        self.psnr_step: Optional[int] = None
        self.readings = Readings()


class Readings:
    """What the per-layer readers read (metrics/<name>.py)."""

    def __init__(self):
        self.window: Optional[Window] = None   # the traced sub-window
        self.units_traced = 0                  # steps or frames in it
        self.spans: Dict[str, List[float]] = {}
        self.grid_calls: List[GridCall] = []
        self.mlp_rows = 0                      # rows the traced frames need
        self.mlp_dims: List[List] = []         # the nets' layer dims
        self.flops_per_unit = 0.0              # model FLOPs a step or frame
        self.units_untraced = 0                # outside the sub-window
        self.seconds_untraced = 0.0
        self.counters: Dict[str, List[float]] = {}


def sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def peak(dev) -> int:
    if torch.device(dev).type == "cuda":
        return int(torch.cuda.max_memory_allocated())
    return 0


def free(dev):
    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()


class LoopWindow:
    """The closed loop: `unit()` runs one chunk and returns how many steps
    or frames it completed; with `trace`, the first chunk past the middle
    (or, where a chunk outlasts the window, the next one) runs under the
    profiler, its time and units kept apart."""

    def __init__(self, dev, seconds: float, trace: bool,
                 on_trace: Callable[[bool], None] = lambda on: None):
        self.dev, self.seconds, self.trace = dev, seconds, trace
        self.on_trace = on_trace
        self.units = 0
        self.elapsed = 0.0
        self.traced_units = 0
        self.traced_seconds = 0.0
        self.profiled: Optional[Profiled] = None

    def run(self, unit: Callable[[], int],
            traced_unit: Optional[Callable[[], int]] = None) -> None:
        traced_unit = traced_unit or unit
        sync(self.dev)
        t0 = time.perf_counter()
        while True:
            now = time.perf_counter()
            over = now - t0 >= self.seconds
            if over and not (self.trace and self.profiled is None):
                break
            if self.trace and self.profiled is None \
                    and now - t0 >= 0.5 * self.seconds:
                self.on_trace(True)
                self.profiled = Profiled(self.dev)
                t1 = time.perf_counter()
                with self.profiled:
                    n = traced_unit()
                self.traced_seconds = time.perf_counter() - t1
                self.traced_units = n
                self.on_trace(False)
            else:
                n = unit()
            self.units += n
        sync(self.dev)
        self.elapsed = time.perf_counter() - t0


# the encodings' kernel entry points: (kind, position of x, draws given)
_GRID_ENTRIES = {"_encode": ("forward", 1, False),
                 "_encode_stochastic": ("forward", 1, True),
                 "_table_gradient": ("gradient", 0, False),
                 "_table_gradient_stochastic": ("gradient", 0, True)}


def grid_recorder(encodings, calls: list):
    """Wrap the kernel entry points of the program's grid encodings to keep
    each call's points and draws as (kind, x, draws, j, one corner);
    `on(True/False)` switches recording. Drivers call it where the
    reference's encoding has a grid; a program encoding without the entry
    points then stops the run, so the roofline cannot go dark unseen."""
    for enc in encodings:
        missing = [a for a in _GRID_ENTRIES if not hasattr(enc, a)]
        if missing:
            raise RuntimeError(
                f"the reference encodes with a grid, but the program's "
                f"{type(enc).__name__} lacks {', '.join(missing)}")
    state = {"on": False}

    def wrap(enc, attr):
        fn = getattr(enc, attr)
        kind, at, stochastic = _GRID_ENTRIES[attr]

        def wrapper(*args):
            if state["on"]:
                draws, j = (args[3], args[4]) if stochastic else (None, None)
                one = stochastic and kind == "gradient" and (
                    j == 0 or enc.stochastic_bwd)
                calls.append((kind, args[at], draws, j, one))
            return fn(*args)
        setattr(enc, attr, wrapper)

    for enc in encodings:
        for attr in _GRID_ENTRIES:
            wrap(enc, attr)

    def on(flag):
        state["on"] = flag
    return on


@torch.no_grad()
def grid_work(grid: Grid, raw_calls) -> List[GridCall]:
    """The recorded calls' distinct rows per level, by the benchmark's own
    index function."""
    if not raw_calls:
        raise RuntimeError("the traced window recorded no call of the "
                           "program's grid entry points")
    out = []
    for kind, x, draws, j, one in raw_calls:
        per_level = []
        for lvl in range(grid.n_levels):
            if draws is None:
                rows, _ = grid.exact_rows(x, lvl)
                per_level.append(distinct_rows(rows))
            else:
                pairs = grid.stochastic_rows(x, lvl, draws.u, draws.axis, j,
                                             sampled_only=one)
                per_level.append(distinct_rows(
                    torch.cat([r.reshape(-1) for r, _ in pairs])))
        out.append(GridCall(kind, x.shape[0], grid.n_dims, grid.n_features,
                            per_level))
    return out


def device_info(dev) -> Dict[str, Any]:
    if torch.device(dev).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1}


def adam_node(opt_cfg):
    """The Adam node at the bottom of an optimizer chain."""
    node = opt_cfg
    while node.get("nested") is not None:
        node = node["nested"]
    return node


def tree_leaves(tree) -> List[torch.Tensor]:
    """The program's parameter or optimizer tree, flattened in its order."""
    from instant_ngp_tpu_torch.ops.optimizers import tree_leaves as leaves

    return leaves(tree)
