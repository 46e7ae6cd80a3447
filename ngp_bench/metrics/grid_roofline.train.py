"""The hash-grid kernels' share of their roofline in the traced train
steps: the least time of the work the recorded encode calls need (each
distinct table row read once by a forward and written once by a gradient,
the positions read, the features written and the incoming gradient read
once, at the HBM rate) over the summed device time of the kernels named
in grid_roofline.train.txt."""

import os

from ngp_bench.harness.roofline import grid_bound_s, share_pct
from ngp_bench.harness.trace import device_seconds

NAMES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "grid_roofline.train.txt")


def read(r):
    if r.window is None or not r.grid_calls:
        return None
    with open(NAMES) as f:
        names = [n.strip() for n in f if n.strip()]
    return share_pct(grid_bound_s(r.grid_calls),
                     device_seconds(r.window, names))
