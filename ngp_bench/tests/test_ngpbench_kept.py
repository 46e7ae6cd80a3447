"""The frames the render cell compares (`drivers/nerf_render.py::KeptFrames`):
the seed's draw among the cameras rendered, each camera's latest frame, and
never more host frames held than are compared."""

import numpy as np
import pytest
import torch


@pytest.fixture
def kept_frames():
    from ngp_bench import run

    return run.load_driver("nerf_render").KeptFrames


@pytest.mark.parametrize("n,k,seed", [(64, 2, 3700000001),
                                      (4, 2, 1234567890123),
                                      (9, 3, 2 ** 31 + 11)])
def test_every_camera_rendered_picks_the_seeds_first(kept_frames, n, k, seed):
    kept = kept_frames(n, k, seed)
    for step in range(3 * n + 1):
        cam = (2 + step) % n
        kept.add(cam, np.full((2, 2, 3), step, np.float32))
        assert len(kept.frames) <= k
    order = torch.randperm(n, generator=torch.Generator()
                           .manual_seed(seed)).tolist()
    assert kept.pick() == order[:k]
    last = {(2 + step) % n: step for step in range(3 * n + 1)}
    for cam in kept.pick():
        assert kept.frames[cam][0, 0, 0] == last[cam]


def test_a_short_window_picks_among_the_cameras_it_rendered(kept_frames):
    n, k, seed = 64, 2, 3700000003
    kept = kept_frames(n, k, seed)
    for cam in range(5):
        kept.add(cam, np.full((1,), cam, np.float32))
    rank = {c: r for r, c in enumerate(torch.randperm(
        n, generator=torch.Generator().manual_seed(seed)).tolist())}
    assert kept.pick() == sorted(range(5), key=rank.__getitem__)[:k]
    assert sorted(kept.frames) == sorted(kept.pick())
    kept.clear()
    assert kept.pick() == [] and not kept.frames
