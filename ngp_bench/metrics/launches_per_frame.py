"""Kernel launches a frame: the profiler's kernels in the traced
sub-window over its frames (layer: the render loop)."""

from ngp_bench.harness.trace import kernel_launches


def read(r):
    if r.window is None or not r.units_traced:
        return None
    n = kernel_launches(r.window)
    return n / r.units_traced if n else None
