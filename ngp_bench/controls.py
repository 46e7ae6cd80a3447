"""The readings that the limits of `correct` are set between, at a cell's
own size and inputs, without the program:

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
    seed."""
    import torch

    from ngp_bench.harness import cells, checks
    from ngp_bench.reference.nets import Precision

    dev, seed, tr = ctx.device, ctx.seed, ctx.traffic
    net_cfg = ctx.config["network_config"]
    fp8 = Precision(torch.float8_e4m3fn)
    driver = tr["driver"]
    if driver == "nerf_train":
        scene, pixels, focal, _, p0 = cells.nerf_train_inputs(
            tr, net_cfg, seed, dev)
        data = cells.ref_scene_data(pixels, scene.cams, tr["size"], focal)
        p0 = p0.leaves()

        def run(prec, half=False):
            return cells.nerf_reference_readings(
                data, net_cfg, p0, seed, tr["batch"], prec, half)
    elif driver == "image_train":
        return _image_readings(ctx, fp8)
    else:
        return _frame_readings(ctx, fp8)
    ref = run(Precision())
    out = {}
    for name, got in (("control", run(fp8)),
                      ("half_batch", run(Precision(), True))):
        out[name] = checks.training_numbers(got[0], ref[0], got[1], ref[1],
                                            got[2], ref[2])
    return out


def _image_readings(ctx, fp8):
    from ngp_bench.harness import cells, checks
    from ngp_bench.reference.nets import Precision

    dev, seed, tr = ctx.device, ctx.seed, ctx.traffic
    net_cfg = ctx.config["network_config"]
    batch = tr["batch"]
    until = int(net_cfg["encoding"]["stochastic_corners_until"])
    image, _, p0 = cells.image_train_inputs(tr, net_cfg, seed, dev)
    at = cells.image_reference_state(image, net_cfg, p0, seed, batch, until)

    def run(prec, half=False):
        out = {}
        for prefix, params, resume in (("", p0, None),
                                       ("exact_", at[0], (until, *at[1:]))):
            got = cells.image_reference_readings(
                image, net_cfg, params, seed, batch, prec, half, resume)
            out[prefix] = got
        return out

    ref = run(Precision())
    out = {}
    for name, got in (("control", run(fp8)),
                      ("half_batch", run(Precision(), True))):
        out[name] = {}
        for prefix, g in got.items():
            r = ref[prefix]
            out[name].update(checks.training_numbers(
                g[0], r[0], g[1], r[1], g[2], r[2], prefix=prefix))
    return out


def _frame_readings(ctx, fp8):
    import torch

    from ngp_bench.harness import cells, checks
    from ngp_bench.reference import nerf as ref_nerf
    from ngp_bench.reference.nets import Precision

    dev, tr = ctx.device, ctx.traffic
    net_cfg = ctx.config["network_config"]
    path, focal, grid, p, density = cells.nerf_render_inputs(
        tr, net_cfg, ctx.seed, dev)
    bitfield = ref_nerf.bitfield_of(density)
    order = torch.randperm(len(path), generator=torch.Generator()
                           .manual_seed(ctx.seed)).tolist()
    pick = order[:tr["check_frames"]]

    def frames(prec, shift=0):
        return [ref_nerf.render_frame(
            p, grid, bitfield, tr["size"], tr["size"], focal,
            path[(i + shift) % len(path)], prec=prec)[0] for i in pick]

    ref = frames(Precision())
    return {"control": checks.frame_numbers(frames(fp8), ref),
            "neighbour": checks.frame_numbers(frames(Precision(), 1), ref)}


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
