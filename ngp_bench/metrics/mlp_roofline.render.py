"""The fused MLP kernels' share of their roofline in the traced frames:
`mlp_bound_s` of the rows the frames need (the samples that add weight in
the reference's march of the same frames) through both nets, over the
summed device time of the kernels named in mlp_roofline.render.txt."""

import os

from ngp_bench.harness.roofline import mlp_bound_s, share_pct
from ngp_bench.harness.trace import device_seconds

NAMES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "mlp_roofline.render.txt")


def read(r):
    if r.window is None or not r.mlp_rows or not r.mlp_dims:
        return None
    with open(NAMES) as f:
        names = [n.strip() for n in f if n.strip()]
    bound = sum(mlp_bound_s(r.mlp_rows, dims) for dims in r.mlp_dims)
    return share_pct(bound, device_seconds(r.window, names))
