"""The whole frame's share of the card's bf16 peak in the traced frames:
the model's forward operations (2 * fan_in * fan_out over both nets) for
the rows the frames need (the samples that add weight in the reference's
march of the same frames), over the traced window's length, over
989e12."""

from ngp_bench.harness.roofline import BF16_FLOP_PER_S, mlp_flops, share_pct


def read(r):
    if r.window is None or not r.mlp_rows or not r.mlp_dims:
        return None
    flops = sum(r.mlp_rows * mlp_flops(dims) for dims in r.mlp_dims)
    return share_pct(flops / BF16_FLOP_PER_S, r.window.seconds)
