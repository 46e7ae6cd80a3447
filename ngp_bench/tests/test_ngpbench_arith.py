"""The yardstick's arithmetic on hand-made inputs: the busy union and the
idle gaps, the bytes of a grid call with repeated rows, the FLOPs of the
nets, the roofline share, the worst-leaf gaps and the verdict."""

import math

import pytest
import torch

from ngp_bench.harness import checks, roofline, trace
from ngp_bench.harness.trace import Interval, Window


def test_union_counts_overlap_once():
    ivs = [Interval("a", 0, 10), Interval("b", 5, 15), Interval("c", 20, 30),
           Interval("d", 22, 25)]
    assert trace.union_us(ivs) == 25
    assert trace.union_us([]) == 0


def test_gaps_and_breakdown():
    dev = [Interval("k1", 10, 20), Interval("k2", 15, 30),
           Interval("Memcpy HtoD", 40, 45)]
    host = [(Interval("outer", 0, 100), 0), (Interval("aten::nonzero", 32,
                                                      38), 1)]
    w = Window(dev, host, 0, 50)
    assert trace.gaps(dev, 0, 50) == [(0, 10), (30, 40), (45, 50)]
    b = trace.breakdown(w)
    assert b["device_ops"][0] == ["k2", 15e-6]
    idle = dict(b["idle_gaps"])
    assert idle["aten::nonzero"] == pytest.approx(10e-6)
    assert idle["outer"] == pytest.approx(15e-6)
    assert trace.kernel_launches(w) == 2
    assert trace.device_seconds(w, ["k1"]) == pytest.approx(10e-6)


def test_grid_bytes_count_distinct_rows():
    rows = torch.tensor([[3, 3, 7], [7, 9, 3]])
    assert roofline.distinct_rows(rows) == 3
    fwd = roofline.GridCall("forward", 100, 3, 4, [3, 5])
    assert fwd.bytes() == 100 * 3 * 4 + 100 * 8 * 4 + 8 * 4 * 4
    grad = roofline.GridCall("gradient", 100, 3, 4, [3, 5])
    assert grad.bytes() == 100 * 8 * 4 + 8 * 4 * 4
    bound = roofline.grid_bound_s([fwd, grad])
    assert bound == pytest.approx((fwd.bytes() + grad.bytes()) / 3.35e12)
    assert roofline.grid_bound_s([]) is None


def test_flops_of_the_configurations():
    import json
    import os

    from conftest import ROOT

    from ngp_bench.reference.nerf import NerfModel

    with open(os.path.join(ROOT, "ngp_bench/configs/nerf-base.json")) as f:
        model = NerfModel(json.load(f)["network_config"])
    # 8 x 4 grid features; 16 density outputs and 16 SH coefficients
    assert model.density_dims == [(32, 64), (64, 16)]
    assert model.rgb_dims == [(32, 64), (64, 64), (64, 3)]
    dens, rgb = model.density_dims, model.rgb_dims
    assert roofline.mlp_flops(dens) + roofline.mlp_flops(rgb) == 18816
    assert roofline.mlp_flops(rgb) == 12672
    # 3 x 2^18 x 18,816 = 14.8 GFLOP a NeRF step
    assert 3 * (1 << 18) * 18816 == pytest.approx(14.8e9, rel=1e-2)


def test_mlp_bound_and_share():
    dims = [(32, 64), (64, 16)]
    rows = 1 << 20
    by_bytes = (rows * (32 * 4 + 16 * 4) + 2 * (32 * 64 + 64 * 16)) / 3.35e12
    assert roofline.mlp_bound_s(rows, dims) == pytest.approx(by_bytes)
    assert roofline.share_pct(1.0, 4.0) == 25.0
    assert roofline.share_pct(None, 1.0) is None
    assert roofline.share_pct(1.0, 0.0) is None


def test_worst_leaf_gap_and_null_leaves():
    ref = [1.0, 2.0, 4.0, 1e-9]
    prog = [1.1, 2.0, 4.0, 5e-9]
    leaves = checks.counted_leaves(ref)
    assert leaves == [0, 1, 2]
    # 0.1 over the larger of the leaf's norm (1) and the median's (2)
    assert checks.worst_leaf_gap(prog, ref, leaves) == pytest.approx(0.05)
    n = checks.training_numbers([1.0, 2.0], [1.0, 2.2], prog, ref, prog, ref)
    assert n["loss_gap"] == pytest.approx(0.2 / 2.2)


def test_frame_numbers_are_relative():
    ref = [torch.full((4, 4, 3), 0.5)]
    prog = [ref[0] + 0.05]
    n = checks.frame_numbers(prog, ref)
    assert n["frame_max_gap"] == pytest.approx(0.1)
    assert n["frame_mean_gap"] == pytest.approx(0.1)


def test_verdict_needs_every_number_within_its_limit():
    assert checks.passed(checks.judge({"a": 0.1}, {"a": 0.2}))
    assert not checks.passed(checks.judge({"a": 0.3}, {"a": 0.2}))
    assert not checks.passed(checks.judge({"a": 0.1}, {}))
    assert not checks.passed(checks.judge({"a": math.nan}, {"a": 0.2}))
    assert not checks.passed({})


def test_leaf_norms_by_chunks_against_a_host_copy():
    now = [torch.arange(10.0), torch.ones(3)]
    before = [torch.arange(10.0) * 0.5, torch.zeros(3)]
    got = checks.leaf_norms(now, before, chunk=3)
    assert got[0] == pytest.approx(float(torch.linalg.norm(now[0] * 0.5)))
    assert got[1] == pytest.approx(math.sqrt(3))
    # the gradient from two first moments: (m1 - 0.9 m0) / 0.1
    m0, m1 = [torch.tensor([1.0, 2.0])], [torch.tensor([1.0, 2.0])]
    g = checks.leaf_norms(m1, m0, 1.0 / 0.1, 0.9, chunk=1)
    assert g[0] == pytest.approx(float(torch.linalg.norm(m1[0])))
    assert checks.leaf_norms(m1)[0] == pytest.approx(math.sqrt(5))
    n = checks.training_numbers([1.0], [1.0], [1.0], [1.0], [1.0], [1.0],
                                prefix="exact_")
    assert set(n) == {"exact_loss_gap", "exact_grad_gap",
                      "exact_change_gap"}


def test_frame_mfu_counts_the_reference_rows():
    from ngp_bench import run
    from ngp_bench.harness.cells import Readings

    read = run.load_reader("frame_mfu")
    r = Readings()
    assert read(r) is None
    r.window = Window([], [], 0.0, 2e6)
    r.mlp_rows = 1000
    r.mlp_dims = [[(32, 64), (64, 16)], [(32, 64), (64, 64), (64, 3)]]
    assert read(r) == pytest.approx(100.0 * 1000 * 18816 / 989e12 / 2.0)
