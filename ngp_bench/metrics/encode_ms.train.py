"""Stream milliseconds a step of the NeRF step's position and direction
encodes: the program's `nerf.encode` spans (inside `nerf.forward`, train
steps only) over the traced steps."""

from ngp_bench.harness.spans import stream_ms_per_unit


def read(r):
    return stream_ms_per_unit(r, ["nerf.encode"])
