"""What the benchmark reads from a traced window: device intervals from
`torch.profiler`, reduced to the busy union, the kernel launches, each
kernel's time, the top operations and the idle gaps by what the host was
doing; and CUDA-event spans around calls into the program's layers.

Busy time is the UNION of the kernel, memcpy and memset intervals, so
operations that overlap count once."""

from __future__ import annotations

import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch


class Interval(NamedTuple):
    name: str
    start_us: float
    end_us: float


class Window(NamedTuple):
    """A traced window: device intervals, host intervals, its length."""

    device: List[Interval]
    host: List[Tuple[Interval, int]]   # (interval, depth in the host stack)
    start_us: float
    end_us: float

    @property
    def seconds(self) -> float:
        return (self.end_us - self.start_us) / 1e6


def union_us(intervals: Sequence[Interval]) -> float:
    """Total length covered by the intervals (overlaps counted once)."""
    total, cur_s, cur_e = 0.0, None, None
    for iv in sorted(intervals, key=lambda i: i.start_us):
        if cur_e is None or iv.start_us > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = iv.start_us, iv.end_us
        else:
            cur_e = max(cur_e, iv.end_us)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: Sequence[Interval], start_us: float, end_us: float
         ) -> List[Tuple[float, float]]:
    """The idle stretches of [start, end] that no interval covers."""
    out, cursor = [], start_us
    for iv in sorted(intervals, key=lambda i: i.start_us):
        if iv.start_us > cursor:
            out.append((cursor, min(iv.start_us, end_us)))
        cursor = max(cursor, iv.end_us)
    if cursor < end_us:
        out.append((cursor, end_us))
    return [(s, e) for s, e in out if e > s]


def kernel_launches(window: Window) -> int:
    return sum(1 for iv in window.device if not _is_copy(iv.name))


def _is_copy(name: str) -> bool:
    low = name.lower()
    return low.startswith("memcpy") or low.startswith("memset")


def device_seconds(window: Window, patterns: Sequence[str]) -> float:
    """Summed device time of the kernels whose name contains a pattern."""
    return sum(iv.end_us - iv.start_us for iv in window.device
               if any(p in iv.name for p in patterns)) / 1e6


def breakdown(window: Window, top: int = 10) -> Dict[str, list]:
    """The device operations that took most time, and the idle gaps summed
    by the innermost host operation running at each gap's middle."""
    by_op: Dict[str, float] = {}
    for iv in window.device:
        by_op[iv.name] = by_op.get(iv.name, 0.0) + (iv.end_us - iv.start_us)
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    by_host: Dict[str, float] = {}
    host = sorted(window.host, key=lambda h: h[0].start_us)
    active: List[Tuple[Interval, int]] = []
    k = 0
    for s, e in gaps(window.device, window.start_us, window.end_us):
        mid = 0.5 * (s + e)
        while k < len(host) and host[k][0].start_us <= mid:
            active.append(host[k])
            k += 1
        active = [h for h in active if h[0].end_us >= mid]
        best = max(active, key=lambda h: h[1], default=None)
        name = "host idle" if best is None else best[0].name
        by_host[name] = by_host.get(name, 0.0) + (e - s)
    idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, us / 1e6] for n, us in ops],
            "idle_gaps": [[n, us / 1e6] for n, us in idle]}


class Profiled:
    """`with Profiled(device) as p:` traces the block; `p.window` after it.
    On a CPU device (the tests) nothing is traced and the window is
    empty."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.window: Optional[Window] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        if self.device.type != "cuda":
            return self
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.device.type != "cuda":
            t = (time.perf_counter() - self._t0) * 1e6
            self._empty = Window([], [], 0.0, t)
            return False
        torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        return False

    def read(self) -> Window:
        """The traced window's intervals (read after the measured window:
        reducing the profiler's events takes seconds)."""
        if self.window is None:
            self.window = self._empty if self.device.type != "cuda" \
                else _window_from(self._prof)
            self._prof = None
        return self.window


def _window_from(prof) -> Window:
    from torch.autograd import DeviceType

    device, host = [], []
    for e in prof.events():
        tr = e.time_range
        iv = Interval(e.name, float(tr.start), float(tr.end))
        if e.device_type == DeviceType.CUDA:
            device.append(iv)
        else:
            depth, parent = 0, e.cpu_parent
            while parent is not None:
                depth, parent = depth + 1, parent.cpu_parent
            host.append((iv, depth))
    starts = [iv.start_us for iv, _ in host] + [iv.start_us for iv in device]
    ends = [iv.end_us for iv, _ in host] + [iv.end_us for iv in device]
    return Window(device, host, min(starts), max(ends))


class EventSpans:
    """Spans by name around calls into the program: CUDA events on the
    card (read after the window, so no call waits), the host clock on a
    CPU device (the tests)."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.spans: Dict[str, list] = {}

    def wrap(self, name: str, fn):
        def wrapper(*args, **kwargs):
            if self.cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(*args, **kwargs)
                end.record()
                self.spans.setdefault(name, []).append((start, end))
            else:
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                self.spans.setdefault(name, []).append(
                    (time.perf_counter() - t0) * 1e3)
            return out
        return wrapper

    def ms(self, name: str) -> List[float]:
        spans = self.spans.get(name, [])
        if self.cuda:
            torch.cuda.synchronize()
            return [s.elapsed_time(e) for s, e in spans]
        return list(spans)
