"""Stream milliseconds a step of the NeRF step's rays + march + compaction:
the program's `nerf.sample` spans over the traced steps."""

from ngp_bench.harness.spans import stream_ms_per_unit


def read(r):
    return stream_ms_per_unit(r, ["nerf.sample"])
