"""The readings that the limits of `correct` are set between, at a cell's
own size and inputs, without the program (each driver's `controls`,
`harness/drivers/<driver>.py`):

- control: the reference computed in float8 (e4m3, the precision below the
  bfloat16 the configurations state) in the program's place, against the
  float32 reference;
- half_batch (training cells): the reference with half of the batch left
  out and the mean taken over the rest, against the reference;
- the Image cell's exact steps (numbers `exact_*`) start from the
  reference's own state after the stochastic steps, as the program's start
  from the program's;
- neighbour (frame cells): each compared frame rendered from the next
  camera of the path, a wrong answer, against the reference.

    python3 ngp_bench/controls.py --workload <cell> --seeds 1 2 3

prints one JSON line a seed. The benchmark's own runs never run it; the
sound runs' readings are those of `run.py`.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(ctx):
    """{name of the control or fault: {number: value}} for ctx's cell and
    seed, from its driver's `controls`."""
    from ngp_bench import run

    return run.load_driver(ctx.traffic["driver"]).controls(ctx)


def main():
    sys.path.insert(0, ROOT)
    from ngp_bench import run as bench_run

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("ngp_bench controls: no CUDA device", file=sys.stderr)
        return 2
    bench = bench_run.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    for seed in args.seeds:
        ctx = bench_run.Context(args.workload, seed, 0, 0, "cuda", bench)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          **readings(ctx)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
