"""A new configuration, reference encoding, traffic mix, driver, cell and
metric land as new files plus entries in BENCHMARK.json: in a copy of
`ngp_bench/` and BENCHMARK.json this test adds only those, runs every new
cell through `run.run` on the CPU at a tiny size, traced and untraced,
with `correct` true, and finds every file that was in the copy before
byte for byte as it was.

The new pieces: a NeRF configuration of other widths than nerf-base's
(HashGrid 2 x 4, a 128-wide density net, a 32-wide RGB net) without the
stochastic encode, through `nerf_train` and `nerf_render`; a position
encoding without parameters (`OneBlob`, a new reference file), through
both; a toy driver (`sh_encode`) with its own end-to-end and per-layer
metric."""

import copy
import hashlib
import json
import os
import shutil
import subprocess
import sys
import textwrap

from conftest import ROOT

SEED = 2 ** 31 + 29

ONEBLOB = '''
"""OneBlob: per input dim, the mass of a quartic kernel of radius two
bins, centred at x, in each of n_bins bins over [0, 1]; no parameters."""

import torch

from . import Encoding


class OneBlob(Encoding):
    def __init__(self, n_dims, n_bins):
        self.n_bins = n_bins
        self.n_output = n_dims * n_bins

    def encode(self, leaves, x):
        edges = torch.arange(self.n_bins + 1, dtype=x.dtype,
                             device=x.device) / self.n_bins
        u = ((edges - x[:, :, None]) * (0.5 * self.n_bins)).clamp(-1.0, 1.0)
        cdf = 0.5 + 0.9375 * (u - (2.0 / 3.0) * u ** 3 + 0.2 * u ** 5)
        return (cdf[..., 1:] - cdf[..., :-1]).reshape(x.shape[0],
                                                      self.n_output)


def build(n_dims, cfg, **scene):
    return OneBlob(n_dims, int(cfg.get("n_bins", 16)))
'''

SH_DRIVER = '''
"""A toy driver: the program's direction encoding over seeded directions
in a closed loop, against the reference's encoding of the same."""

import time

import torch

from ngp_bench.harness import cells, checks
from ngp_bench.reference import encodings


def _inputs(ctx):
    gen = torch.Generator(device=ctx.device).manual_seed(ctx.seed)
    return ctx.config["network_config"]["dir_encoding"], torch.rand(
        ctx.traffic["points"], 3, generator=gen, device=ctx.device)


def run(ctx):
    from instant_ngp_tpu_torch.ops.encodings import create_encoding

    out = cells.Outcome()
    cfg, x = _inputs(ctx)
    enc = create_encoding(3, cfg)
    got = enc(x)
    out.e2e["setup_s"] = time.perf_counter() - ctx.t_process
    win = cells.LoopWindow(ctx.device, ctx.seconds, ctx.trace)

    def unit():
        enc(x)
        return 1
    win.run(unit)
    out.window_s, out.attempted = win.elapsed, win.units
    out.e2e["encodes_per_s"] = win.units / win.elapsed
    if ctx.trace:
        out.readings.window = win.profiled.read()
        out.readings.units_traced = win.traced_units
    want = encodings.build(3, cfg).encode([], x)
    out.checks = checks.judge(
        {"encode_gap": float((got.float() - want).abs().max())}, ctx.limits)
    return out


def controls(ctx):
    cfg, x = _inputs(ctx)
    want = encodings.build(3, cfg).encode([], x)
    low = want.to(torch.bfloat16).float()
    return {"control": {"encode_gap": float((low - want).abs().max())}}
'''

UNITS_TRACED = '''
"""Units in the traced chunk."""


def read(r):
    return float(r.units_traced) if r.units_traced else None
'''

RUN = textwrap.dedent('''
    import json, sys
    root, repo, threads, cases = sys.argv[1], sys.argv[2], sys.argv[3], \\
        sys.argv[4:]
    sys.path[:0] = [root, repo]
    import torch
    torch.set_num_threads(int(threads))
    from ngp_bench import run
    bench = run.load_json(root + "/BENCHMARK.json")
    for case in cases:
        cell, trace = case.split(":")
        ctx = run.Context(cell, %d, 0.5, int(trace), "cpu", bench,
                          root=root)
        print(json.dumps({"case": case, "line": run.run(ctx)}), flush=True)
''' % SEED)

TRAIN = {"driver": "nerf_train", "views": 2, "size": 32,
         "focal_factor": 1.1, "radius": 0.85, "elevation": [0.15, 0.65],
         "batch": {"samples": 2048, "rays": 128}, "chunk_steps": 4,
         "warmup_chunks": 1, "psnr_views": 1, "psnr_step": 4}
RENDER = {"driver": "nerf_render", "size": 24, "focal_factor": 1.1,
          "radius": 0.85, "elevation": [0.15, 0.65], "path_cameras": 4,
          "table_range": 1.0, "shell_cells": 2, "warmup_frames": 1,
          "trace_frames": 1, "check_frames": 2}
TRAIN_LIMITS = {"loss_gap": 0.01, "grad_gap": 0.2, "change_gap": 0.2}
RENDER_LIMITS = {"frame_max_gap": 0.02, "frame_mean_gap": 0.01}

# cell: (configuration, traffic, limits); the traffic and limit files are
# new, named after the cell
CELLS = {
    "nerf-narrow-train": ("nerf-narrow", TRAIN, TRAIN_LIMITS),
    "nerf-narrow-render": ("nerf-narrow", RENDER, RENDER_LIMITS),
    "nerf-blob-train": ("nerf-blob", TRAIN, TRAIN_LIMITS),
    "nerf-blob-render": ("nerf-blob", RENDER, RENDER_LIMITS),
    "nerf-blob-sh": ("nerf-blob", {"driver": "sh_encode", "points": 4096},
                     {"encode_gap": 1e-5}),
}
# runs ("<cell>:<trace>") side by side in processes of two threads: the
# training runs take most of the time (the density updates' sweeps of all
# 128^3 cells)
GROUPS = [["nerf-narrow-train:0"], ["nerf-narrow-train:1"],
          ["nerf-blob-train:0", "nerf-blob-train:1"],
          [f"{cell}:{trace}" for cell in ("nerf-narrow-render",
                                          "nerf-blob-render", "nerf-blob-sh")
           for trace in (0, 1)]]


def _digests(top):
    out = {}
    for dirpath, dirs, files in os.walk(top):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, top)] = hashlib.sha256(
                    f.read()).hexdigest()
    return out


def _write(root, rel, content):
    path = os.path.join(root, rel)
    assert not os.path.exists(path), rel
    with open(path, "w") as f:
        f.write(content if isinstance(content, str)
                else json.dumps(content, indent=1))


def _add_files(root):
    with open(os.path.join(root, "ngp_bench/configs/nerf-base.json")) as f:
        base = json.load(f)
    narrow = copy.deepcopy(base)
    narrow["name"] = "nerf-narrow"
    net = narrow["network_config"]
    net["encoding"] = {"otype": "HashGrid", "n_levels": 2,
                       "n_features_per_level": 4, "log2_hashmap_size": 12,
                       "base_resolution": 16, "stochastic_corners_until": 0}
    net["network"]["n_neurons"] = 128
    net["rgb_network"].update(n_neurons=32, n_hidden_layers=1)
    blob = copy.deepcopy(narrow)
    blob["name"] = "nerf-blob"
    blob["network_config"]["encoding"] = {"otype": "OneBlob", "n_bins": 4}
    blob["network_config"]["network"]["n_neurons"] = 32
    for cfg in (narrow, blob):
        _write(root, f"ngp_bench/configs/{cfg['name']}.json", cfg)
    _write(root, "ngp_bench/reference/encodings/OneBlob.py", ONEBLOB)
    _write(root, "ngp_bench/harness/drivers/sh_encode.py", SH_DRIVER)
    _write(root, "ngp_bench/metrics/units_traced.py", UNITS_TRACED)

    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for name in ("nerf-narrow", "nerf-blob"):
        bench["configs"].append({
            "name": name, "source": bench["configs"][0]["source"],
            "file": f"ngp_bench/configs/{name}.json", "reduced": [],
            "why": "a test's configuration"})
    for cell, (config, traffic, limits) in CELLS.items():
        _write(root, f"ngp_bench/traffic/{cell}.json", traffic)
        _write(root, f"ngp_bench/limits/{cell}.json", limits)
        bench["workloads"].append({"name": cell, "config": config,
                                   "traffic": cell, "chips": 1,
                                   "why": "a test's cell"})
        # the cell joins the metrics of the kind of cell its driver runs
        like = {"nerf_train": "nerf-base-train",
                "nerf_render": "nerf-base-render"}.get(traffic["driver"])
        for m in bench["end_to_end"] + bench["per_layer"]:
            if like in m.get("workloads", []):
                m["workloads"].append(cell)
    bench["end_to_end"].append({
        "name": "encodes_per_s", "unit": "encodes/s", "better": "higher",
        "bound": 0.25, "source": "host_clock", "workloads": ["nerf-blob-sh"]})
    bench["per_layer"].append({
        "name": "units_traced", "unit": "units", "better": "higher",
        "source": "program_counter", "layer": "toy", "moves":
        "encodes_per_s", "workloads": ["nerf-blob-sh"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f, indent=1)
    return bench


def test_new_files_alone_add_a_configuration_encoding_and_driver(tmp_path):
    root = str(tmp_path)
    shutil.copytree(os.path.join(ROOT, "ngp_bench"),
                    os.path.join(root, "ngp_bench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    before = _digests(os.path.join(root, "ngp_bench"))
    bench = _add_files(root)

    env = dict(os.environ, JAX_PLATFORMS="cpu", USE_FLAX="0")
    procs = [subprocess.Popen(
        [sys.executable, "-c", RUN, root, ROOT, "2"] + group, cwd=root,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for group in GROUPS]
    lines, failed = {}, []
    try:
        for p in procs:
            out, err = p.communicate(timeout=600)
            if p.returncode:
                failed.append(err[-4000:])
            for row in out.splitlines():
                got = json.loads(row)
                lines[got["case"]] = got["line"]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    assert not failed, failed

    assert set(lines) == {f"{c}:{t}" for c in CELLS for t in (0, 1)}
    for case, line in lines.items():
        cell, trace = case.split(":")
        assert line["correct"] is True, (case, line["checks"])
        assert line["attempted"] > 0
        applies = [m["name"] for m in bench["end_to_end" if trace == "0"
                                            else "per_layer"]
                   if cell in m.get("workloads", [cell])]
        assert line["metrics"] and set(line["metrics"]) <= set(applies)
    assert "units_traced" in lines["nerf-blob-sh:1"]["metrics"]
    assert "encodes_per_s" in lines["nerf-blob-sh:0"]["metrics"]

    after = _digests(os.path.join(root, "ngp_bench"))
    assert {k: after.get(k) for k in before} == before
