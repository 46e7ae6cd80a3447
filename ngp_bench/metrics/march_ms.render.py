"""Stream milliseconds a frame of the wavefront renderer's march, pack
and chunk concatenation: the program's `render.march` spans over the
traced frames."""

from ngp_bench.harness.spans import stream_ms_per_unit


def read(r):
    return stream_ms_per_unit(r, ["render.march"])
