"""Stream milliseconds a step of the NeRF step's density and RGB nets
under autograd (the forward only; their backward is in `nerf.backward`):
the program's `nerf.nets` spans (inside `nerf.forward`, train steps only)
over the traced steps."""

from ngp_bench.harness.spans import stream_ms_per_unit


def read(r):
    return stream_ms_per_unit(r, ["nerf.nets"])
