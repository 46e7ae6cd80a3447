"""The program's own named spans (`instant_ngp_tpu_torch.utils.span`) as
stream milliseconds: recorded only while a profiler runs, so over the
traced chunk alone. A program without them reads as nothing recorded."""

from __future__ import annotations

from typing import Optional, Sequence


def stream_ms_per_unit(r, names: Sequence[str]) -> Optional[float]:
    """The summed stream milliseconds of every recorded call of the spans
    `names`, over the traced steps or frames; None where none was
    recorded."""
    if not r.units_traced:
        return None
    try:
        from instant_ngp_tpu_torch.utils import span_ms
    except ImportError:
        return None
    ms = [t for name in names for t in span_ms(name)]
    return sum(ms) / r.units_traced if ms else None

