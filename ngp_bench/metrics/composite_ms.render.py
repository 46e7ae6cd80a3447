"""Stream milliseconds a frame of the wavefront renderer's compositing
(activations, transmittance, the accumulators' updates): the program's
`render.composite` spans over the traced frames."""

from ngp_bench.harness.spans import stream_ms_per_unit


def read(r):
    return stream_ms_per_unit(r, ["render.composite"])
