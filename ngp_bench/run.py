"""Run one cell of the benchmark once.

    python3 ngp_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell names a configuration (`configs/<name>.json`) and a traffic mix
(`traffic/<mix>.json`) in BENCHMARK.json; the mix names the driver
(`harness/drivers/<driver>.py`). The
last line of standard output is the result, one JSON object; the numbers
that decide `correct` close standard error. `--trace 0` reports the cell's
end-to-end metrics, `--trace 1` its per-layer metrics, each read by
`metrics/<metric>.py`. The run needs a CUDA device and refuses to run
without one.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "instant_ngp_tpu")


class Context:
    """One run: its arguments, its cell's files, its device."""

    def __init__(self, workload, seed, seconds, trace, device, bench,
                 root=ROOT, t_process=None, overrides=None):
        self.workload, self.seed = workload, int(seed)
        self.seconds, self.trace = float(seconds), bool(trace)
        self.device = device
        self.bench = bench
        self.t_process = T_PROCESS if t_process is None else t_process
        self.cell = find(bench["workloads"], workload, "workload")
        self.config_entry = find(bench["configs"], self.cell["config"],
                                 "configuration")
        self.config = load_json(os.path.join(root,
                                             self.config_entry["file"]))
        self.traffic = load_json(os.path.join(
            BENCH_DIR, "traffic", self.cell["traffic"] + ".json"))
        self.limits = load_json(os.path.join(
            BENCH_DIR, "limits", workload + ".json"))
        # the tests' smaller sizes: {"traffic": {...}, "network": {...}}
        for key, target in (("traffic", self.traffic),
                            ("network", self.config["network_config"])):
            merge(target, (overrides or {}).get(key, {}))


def merge(dst, src):
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            merge(dst[k], v)
        else:
            dst[k] = v


def find(entries, name, what):
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise SystemExit(f"no {what} named {name!r} in BENCHMARK.json")


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_file(kind, subdir, name):
    """The module `ngp_bench/<subdir>/<name>.py`, loaded by its path; a
    missing file stops the run with a message that names it."""
    rel = os.path.join(subdir, name + ".py")
    path = os.path.join(BENCH_DIR, rel)
    if not os.path.isfile(path):
        raise SystemExit(f"no {kind} named {name!r}: ngp_bench/{rel} is "
                         f"missing")
    spec = importlib.util.spec_from_file_location(
        f"ngp_bench_{kind}_" + name.replace(".", "_").replace("-", "_"),
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_reader(name):
    """metrics/<name>.py's `read`."""
    return load_file("metric", "metrics", name).read


def load_driver(name):
    """harness/drivers/<name>.py: `run(ctx) -> Outcome` and `controls(ctx)
    -> {name: numbers}`."""
    return load_file("driver", os.path.join("harness", "drivers"), name)


def applies(metric, workload):
    return "workloads" not in metric or workload in metric["workloads"]


def forbidden_modules():
    return sorted({name.split(".")[0] for name in sys.modules
                   if name.split(".")[0] in FORBIDDEN})


def result_line(ctx, outcome, device_info):
    """The result object (its keys in the order the contract lists)."""
    from ngp_bench.harness import checks, trace as tr

    metrics = {}
    if ctx.trace:
        for m in ctx.bench["per_layer"]:
            if applies(m, ctx.workload):
                value = load_reader(m["name"])(outcome.readings)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in ctx.bench["end_to_end"]:
            if applies(m, ctx.workload) and m["name"] in outcome.e2e:
                metrics[m["name"]] = {"value": outcome.e2e[m["name"]],
                                      "unit": m["unit"]}
    device = dict(device_info, memory_peak_bytes=outcome.memory_peak)
    line = {"correct": checks.passed(outcome.checks),
            "attempted": outcome.attempted, "failed": outcome.failed,
            "metrics": metrics, "device": device}
    window = outcome.readings.window
    if ctx.trace and window is not None:
        device["busy_s"] = tr.union_us(window.device) / 1e6
        device["window_s"] = window.seconds
        line["breakdown"] = tr.breakdown(window)
    line["checks"] = outcome.checks
    return line


def run(ctx):
    """Drive the cell -> the result object."""
    from ngp_bench.harness import cells

    outcome = load_driver(ctx.traffic["driver"]).run(ctx)
    line = result_line(ctx, outcome, cells.device_info(ctx.device))
    print(f"ngp_bench: {ctx.workload} seed {ctx.seed}: set-up "
          f"{outcome.e2e.get('setup_s', 0.0):.2f} s, window "
          f"{outcome.window_s:.2f} s, {outcome.attempted} units, "
          + ("" if outcome.psnr_step is None
             else f"quality read at step {outcome.psnr_step}, ")
          + f"whole run {time.perf_counter() - ctx.t_process:.2f} s",
          file=sys.stderr)
    return line


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = find(bench["workloads"], args.workload, "workload")
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        print(f"ngp_bench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    ctx = Context(args.workload, args.seed, args.seconds, args.trace, "cuda",
                  bench)
    line = run(ctx)
    found = forbidden_modules()
    if found:
        print(f"ngp_bench: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    line["device"].update(power_limit(), count=cell["chips"])
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(line))
    return 0


def power_limit():
    """The card's power limit as nvidia-smi reads it (a card below 700 W
    runs slower under load)."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return {}
    return {"power_limit": out[0]} if out else {}


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(main())
