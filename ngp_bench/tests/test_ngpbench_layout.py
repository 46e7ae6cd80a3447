"""BENCHMARK.json against the contract, and every cell, configuration,
mix, driver, limit and metric found by its name."""

import ast
import json
import os
import re

import pytest

from conftest import ROOT

BENCH_DIR = os.path.join(ROOT, "ngp_bench")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "top": ["command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"],
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "e2e": {"name", "unit", "better", "bound", "source"},
    "layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_top_level_keys_and_size(bench):
    assert list(bench) == KEYS["top"]
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert bench["paths"] == ["ngp_bench"]
    assert bench["command"] == ["python3", "ngp_bench/run.py"]
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    # a full check with 24 cells fits the driver's 43200 s
    assert (2 + 14 * 24) * (bench["run_seconds"] + 60) + 24 * 180 \
        + 1200 <= 43200


def test_entries(bench):
    names = set()
    for kind, entries in (("config", bench["configs"]),
                          ("workload", bench["workloads"]),
                          ("e2e", bench["end_to_end"]),
                          ("layer", bench["per_layer"])):
        for e in entries:
            extra = set(e) - KEYS[kind]
            assert extra <= ({"workloads"} if kind in ("e2e", "layer")
                             else set()), (e["name"], extra)
            assert KEYS[kind] <= set(e), e
            assert NAME.match(e["name"]), e["name"]
            assert (kind, e["name"]) not in names
            names.add((kind, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in (
                    "lower", "higher")
            for key in ("why", "layer", "source"):
                if key in e and kind != "e2e" and key != "source":
                    assert 1 <= len(e[key]) <= 200
                    assert "\n" not in e[key] and "\t" not in e[key]


def test_end_to_end_bounds(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def _workloads():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]


@pytest.mark.parametrize("cell", _workloads())
def test_cell_files_found_by_name(bench, cell):
    from ngp_bench import run

    w = next(w for w in bench["workloads"] if w["name"] == cell)
    assert w["chips"] == 1
    config = next(c for c in bench["configs"] if c["name"] == w["config"])
    assert config["file"].startswith("ngp_bench/configs/")
    with open(os.path.join(ROOT, config["file"])) as f:
        assert "network_config" in json.load(f)
    with open(os.path.join(BENCH_DIR, "traffic",
                           w["traffic"] + ".json")) as f:
        driver = run.load_driver(json.load(f)["driver"])
    assert callable(driver.run) and callable(driver.controls)
    with open(os.path.join(BENCH_DIR, "limits", cell + ".json")) as f:
        assert json.load(f)
    e2e = [m["name"] for m in bench["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = [m for m in bench["per_layer"]
             if "workloads" not in m or cell in m["workloads"]]
    assert layer
    for m in layer:
        assert m["moves"] in e2e


def test_metrics_found_by_name(bench):
    from ngp_bench import run

    e2e = {m["name"] for m in bench["end_to_end"]}
    layers = {}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert callable(run.load_reader(m["name"]))
        layers.setdefault(m["layer"], []).append(m["name"])
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert "model (whole step or frame)" in layers


def test_paths_hold_only_the_benchmark():
    for dirpath, _, files in os.walk(BENCH_DIR):
        if "__pycache__" in dirpath:
            continue
        for name in files:
            rel = os.path.relpath(os.path.join(dirpath, name), ROOT)
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _modules():
    for dirpath, _, files in os.walk(BENCH_DIR):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)


@pytest.mark.parametrize("forbidden", ["jax", "jaxlib", "flax",
                                       "instant_ngp_tpu"])
def test_no_module_imports_jax_or_the_jax_package(forbidden):
    for path in _modules():
        assert forbidden not in set(_imports(path)), path


def test_the_reference_imports_nothing_of_the_program():
    for dirpath, _, files in os.walk(os.path.join(BENCH_DIR, "reference")):
        for name in files:
            if name.endswith(".py"):
                tops = set(_imports(os.path.join(dirpath, name)))
                assert not tops & {"instant_ngp_tpu_torch", "instant_ngp_tpu",
                                   "jax"}, name


def test_an_unknown_driver_or_encoding_names_its_missing_file():
    from ngp_bench import run
    from ngp_bench.reference import encodings

    with pytest.raises(SystemExit, match="ngp_bench/harness/drivers/"
                                         "no_such_driver.py is missing"):
        run.load_driver("no_such_driver")
    with pytest.raises(NotImplementedError,
                       match="ngp_bench/reference/encodings/NoSuchEncoding"
                             ".py is missing"):
        encodings.build(3, {"otype": "NoSuchEncoding"})


def test_whole_name_comparison():
    # the port's name begins with the JAX package's: compared whole, it
    # passes, and the JAX package's own name does not
    from ngp_bench.run import FORBIDDEN

    assert "instant_ngp_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "instant_ngp_tpu.ops".split(".")[0] in FORBIDDEN
