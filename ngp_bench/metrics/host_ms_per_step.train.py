"""Host milliseconds a train step: the mean length of the program's
`nerf.step` or `image.step` spans, one iteration of the train loop each,
as host intervals of the traced chunk on the profiler's clock."""

import statistics

STEP_SPANS = ("nerf.step", "image.step")


def read(r):
    if r.window is None:
        return None
    us = [iv.end_us - iv.start_us for iv, _ in r.window.host
          if iv.name in STEP_SPANS]
    return statistics.fmean(us) / 1e3 if us else None
