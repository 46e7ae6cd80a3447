"""Small host utilities: EMA meters and phase timers (counterpart of
instant_ngp_tpu/utils.py). `Ema` smooths by a wall-clock half-life; the
testbed keeps one per rate it reports and, in `PhaseTimers`, one per named
phase of its loop.
"""

from __future__ import annotations

import time
from typing import Dict, Optional


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


class PhaseTimers:
    """Named phase wall-clock EMAs, in ms. A phase that ends with work
    still queued on the device measures the host's share only."""

    def __init__(self, half_life_s: float = 1.0):
        self.meters: Dict[str, Ema] = {}
        self.half_life_s = half_life_s

    def time(self, name: str):
        timers = self

        class _Ctx:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                ms = (time.perf_counter() - self.t0) * 1000.0
                timers.meters.setdefault(
                    name, Ema(timers.half_life_s)).update(ms)

        return _Ctx()

    def ms(self, name: str) -> float:
        m = self.meters.get(name)
        return m.value if m and m.value is not None else float("nan")

    def summary(self) -> Dict[str, float]:
        return {k: round(self.ms(k), 3) for k in self.meters}
