"""Stream milliseconds a step of the network under autograd: the
program's `nerf.forward` + `nerf.composite` + `nerf.backward` spans (NeRF)
or `trainer.forward` + `trainer.backward` (Image) over the traced steps."""

from ngp_bench.harness.spans import stream_ms_per_unit


def read(r):
    return stream_ms_per_unit(r, ["nerf.forward", "nerf.composite",
                                  "nerf.backward", "trainer.forward",
                                  "trainer.backward"])
