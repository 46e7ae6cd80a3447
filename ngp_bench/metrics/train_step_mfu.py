"""The whole train step's share of the card's bf16 peak: the model's
operations (2 * fan_in * fan_out over the nets' layers at the
configuration's widths, x3 for forward and backward, at the target batch)
times the steps over the window's seconds outside the profiled chunk, over
989e12."""

from ngp_bench.harness.roofline import BF16_FLOP_PER_S, share_pct


def read(r):
    if not r.units_untraced or not r.seconds_untraced > 0:
        return None
    flops = r.flops_per_unit * r.units_untraced
    return share_pct(flops / BF16_FLOP_PER_S, r.seconds_untraced)
