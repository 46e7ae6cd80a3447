"""The result line of a run, driven on the CPU at a tiny size (the look
for a card skipped): its keys and their order, `breakdown` only when
traced, the checks last; and the refusal without a card."""

import io
import json
from contextlib import redirect_stdout

import pytest

CELLS = ["nerf-base-train", "image-base-train", "nerf-base-render"]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_result_keys(tiny_run, bench, cell, trace):
    line = tiny_run(cell, trace=trace)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[:5] == keys
    assert list(line)[-1] == "checks"
    assert ("breakdown" in line) == bool(trace)
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    names = set(line["metrics"])
    if trace:
        layer = {m["name"] for m in bench["per_layer"]
                 if cell in m.get("workloads", [cell])}
        assert names <= layer
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        e2e = {m["name"] for m in bench["end_to_end"]
               if cell in m.get("workloads", [cell])}
        assert names == e2e
        assert all(v["value"] > 0 for k, v in line["metrics"].items()
                   if k != "peak_mem_gib")
    json.dumps(line)


def test_refuses_without_a_card(monkeypatch, capsys):
    import torch

    from ngp_bench import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = io.StringIO()
    with redirect_stdout(out):
        rc = run.main(["--workload", "nerf-base-train", "--seed", "1",
                       "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert out.getvalue() == ""
    assert "CUDA" in capsys.readouterr().err


def test_same_seed_same_inputs():
    import torch

    from ngp_bench.harness import scenes

    a = scenes.procedural_image(32, 2 ** 31 + 7, "cpu")
    b = scenes.procedural_image(32, 2 ** 31 + 7, "cpu")
    c = scenes.procedural_image(32, 2 ** 31 + 8, "cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    s1 = scenes.scene_orbit(8, 0.85, [0.15, 0.65], 2 ** 31 + 7, "cpu")
    s2 = scenes.scene_orbit(8, 0.85, [0.15, 0.65], 2 ** 31 + 7, "cpu")
    assert torch.equal(s1.cams, s2.cams)
