"""The nets' share of their roofline in the traced train steps: the
operations of both nets' forward and backward (3 x 2 fan_in fan_out over
their layers at the configuration's widths, at the target batch: the
readings' `flops_per_unit`) times the traced steps at 989 TFLOP/s, over the
summed device time of the GEMM kernels named in mlp_roofline.train.txt
(the nets' matmuls under autograd; the density updates' fused MLP kernels
do not match)."""

import os

from ngp_bench.harness.roofline import BF16_FLOP_PER_S, share_pct
from ngp_bench.harness.trace import device_seconds

NAMES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "mlp_roofline.train.txt")


def read(r):
    if r.window is None or not r.units_traced or not r.flops_per_unit:
        return None
    with open(NAMES) as f:
        names = [n.strip() for n in f if n.strip()]
    bound = r.flops_per_unit * r.units_traced / BF16_FLOP_PER_S
    return share_pct(bound, device_seconds(r.window, names))
