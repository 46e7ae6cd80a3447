"""The share of the traced frames in which nothing ran on the card:
1 - the union of its kernel, memcpy and memset intervals over the traced
sub-window."""

from ngp_bench.harness.trace import union_us


def read(r):
    if r.window is None or not r.window.device:
        return None
    return 100.0 * (1.0 - union_us(r.window.device)
                    / (r.window.end_us - r.window.start_us))
