"""Small host utilities: EMA meters and named spans (counterpart of
instant_ngp_tpu/utils.py). `Ema` smooths by a wall-clock half-life; the
testbed keeps one per rate it reports.

`span(name)` marks a phase of the program's loops. With no torch profiler
running it is one shared no-op context and records nothing. Under a
profiler (`Testbed.profile_trace`, or a benchmark's traced chunk) it opens
a host range of that name on the profiler's clock, so that a trace names
the phase every host op and idle gap falls in, and times the span: a pair
of CUDA events on the current stream where CUDA is in use, else the host
clock. `span_ms(name)` reads the record (one synchronisation), and
`clear_spans()` empties it.

The host range is a `_RecordFunctionFast`, which is not a user
annotation: the profiler mirrors a user annotation onto the device's
timeline as an interval of its own, which a trace's kernel counts and busy
time would then take in.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import torch
from torch._C._autograd import _profiler_enabled
from torch._C._profiler import _RecordFunctionFast


class Ema:
    """Time-based exponential moving average: half-life in seconds."""

    def __init__(self, half_life_s: float = 1.0):
        self.half_life_s = half_life_s
        self.value: Optional[float] = None
        self._last_t: Optional[float] = None

    def set(self, value: float) -> None:
        self.value = value
        self._last_t = time.monotonic()

    def update(self, value: float, now: Optional[float] = None) -> float:
        now = now if now is not None else time.monotonic()
        if self.value is None or self._last_t is None:
            self.value = value
        else:
            dt = max(now - self._last_t, 0.0)
            alpha = 0.5 ** (dt / max(self.half_life_s, 1e-9))
            self.value = alpha * self.value + (1.0 - alpha) * value
        self._last_t = now
        return self.value


_NO_SPAN = contextlib.nullcontext()
# name -> each call's (start, end) CUDA events, or its host milliseconds
_SPANS: Dict[str, list] = {}


class _Span:
    __slots__ = ("name", "_range", "_start")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._range = _RecordFunctionFast(self.name)
        self._range.__enter__()
        if torch.cuda.is_initialized():
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record()
        else:
            self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if isinstance(self._start, float):
            taken = (time.perf_counter() - self._start) * 1e3
        else:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            taken = (self._start, end)
        _SPANS.setdefault(self.name, []).append(taken)
        self._range.__exit__(*exc)
        return False


def span(name: str):
    """A context naming a phase: the shared no-op unless a torch profiler
    is running (the module docstring says what it records then)."""
    return _Span(name) if _profiler_enabled() else _NO_SPAN


def span_ms(name: str) -> List[float]:
    """Milliseconds of each recorded call of span `name`: on the CUDA
    stream between its two events (after one synchronisation), or on the
    host clock."""
    spans = _SPANS.get(name, [])
    if any(not isinstance(s, float) for s in spans):
        torch.cuda.synchronize()
    return [s if isinstance(s, float) else s[0].elapsed_time(s[1])
            for s in spans]


def clear_spans() -> None:
    _SPANS.clear()
