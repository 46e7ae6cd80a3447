"""Mean device milliseconds of the testbed's optimizer step, from CUDA
events around each call in the window."""

import statistics


def read(r):
    spans = r.spans.get("optimizer")
    return statistics.fmean(spans) if spans else None
