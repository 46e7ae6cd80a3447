"""Stream milliseconds a frame of the wavefront renderer's network
rounds (the gather of a round's positions, the encodes, both nets, SH):
the program's `render.network` spans over the traced frames."""

from ngp_bench.harness.spans import stream_ms_per_unit


def read(r):
    return stream_ms_per_unit(r, ["render.network"])
