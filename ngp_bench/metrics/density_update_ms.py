"""Mean device milliseconds of a density update (`training_prep`), from
CUDA events around each call in the window."""

import statistics


def read(r):
    spans = r.spans.get("training_prep")
    return statistics.fmean(spans) if spans else None
