"""The benchmark's CPU tests: run from the repository's root with
`python -m pytest ngp_bench/tests -q`. They import neither JAX nor the JAX
package; tests that need a card carry the `cuda` marker and skip here."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc; skips without one")


# the cells at sizes a CPU test run holds
TINY = {
    "nerf-base-train": {
        "traffic": {"views": 4, "size": 48,
                    "batch": {"samples": 4096, "rays": 256},
                    "chunk_steps": 4, "warmup_chunks": 1, "psnr_views": 1,
                    "psnr_step": 8},
        "network": {"encoding": {"log2_hashmap_size": 12}}},
    "image-base-train": {
        "traffic": {"side": 64, "batch": 1024, "chunk_steps": 4},
        "network": {"encoding": {"log2_hashmap_size": 12, "n_levels": 4,
                                 "stochastic_corners_until": 8}}},
    "nerf-base-render": {
        "traffic": {"size": 32, "path_cameras": 4, "warmup_frames": 1,
                    "trace_frames": 1, "check_frames": 2},
        "network": {"encoding": {"log2_hashmap_size": 12}}},
}


@pytest.fixture(scope="session")
def bench():
    from ngp_bench import run

    return run.load_json(os.path.join(ROOT, "BENCHMARK.json"))


@pytest.fixture
def tiny_run(bench):
    """run(cell, seed, trace) -> the result object of a CPU run at the
    cell's tiny size."""
    import torch

    from ngp_bench import run

    torch.set_num_threads(min(4, torch.get_num_threads()))

    def go(cell, seed=1234567890123, trace=0, seconds=1.0):
        ctx = run.Context(cell, seed, seconds, trace, "cpu", bench,
                          overrides=TINY[cell])
        return run.run(ctx)
    return go
