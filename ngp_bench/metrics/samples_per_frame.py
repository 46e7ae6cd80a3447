"""Network evaluations a frame: the port's `last_frame_n_samples`
counter, the mean over the window's frames."""

import statistics


def read(r):
    counts = r.counters.get("samples_per_frame")
    return statistics.fmean(counts) if counts else None
