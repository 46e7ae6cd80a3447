#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's NeRF render path once on one NVIDIA GPU.

    python3 chip_smoke.py        (from the repository root; needs one card)

Phases, each of which raises on failure (a non-zero exit):
1. require CUDA; print the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from `instant_ngp_tpu_torch/csrc` (one nvcc per
   source, started together);
3. hold the fused-MLP kernel against its plain PyTorch version on the
   card: the two shapes of the render path at small and ragged row counts
   first (a fault of the input pipeline shows there within seconds), then
   shapes that take the general kernel and the 128-wide instantiation,
   then the path shapes at 2^20 rows, where the kernel, the general
   kernel on the same shape and the plain version are timed with CUDA
   events beside the card's bound; then times at 2^14, 2^17 and 2^21 rows
   and with the input ring at each depth and without it;
4. the main path: a NerfTestbed at configs/nerf/base.json's full width
   (HashGrid L=8, F=4, 2^19 entries per level; 64-wide MLPs; bf16
   compute; weights from a seed, the hash table at a trained scale)
   runs one density pass over all 128^3 cells and renders a 400x400
   Shade frame from an orbit camera, with every kernel's launch count
   set to 0 before and read after;
5. check the result: a small frame rendered on the card agrees with the
   same testbed rendered on the CPU through the plain versions, and that
   comparison can see a density network that is off.

    python3 chip_smoke.py --profile OUT.txt

adds a last phase: one warm frame with CUDA-event spans around each
layer, one under torch.profiler (its table goes to OUT.txt), and a warm
density pass.

The last lines are one JSON object describing the kernels, the card's
name and power limit (nvidia-smi's own line), and
{"ok": true, "device": {...}}.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 1234
N_ROWS = 1 << 20
SMALL_ROWS = (1, 127, 129, 100003)
OTHER_ROWS = (1 << 14, 1 << 17, 1 << 21)   # late render rounds; a full budget
# shapes off the render path: (widths, hidden activation, output activation)
OTHER_SHAPES = (([27, 48, 5], "None", "None"),
                ([32] + [64] * 8 + [16], "ReLU", "None"),
                ([32, 128, 128, 128, 16], "ReLU", "None"),
                ([16, 1], "None", "ReLU"),
                ([32, 64, 64, 16], "Sine", "None"))
# NVIDIA's data sheet for the H100 SXM: memory rate and dense bf16 rate
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
WIDTH = HEIGHT = 400
FOCAL = 440.0              # the synthetic orbit scene's 400 px * 1.1
# kernel vs plain, relative to the reference's max and mean |value|: bf16
# rounding of a hidden value may flip with the summation order (see
# tests/test_torch_cuda_kernels.py)
KERNEL_MAX_REL, KERNEL_MEAN_REL = 2e-2, 1e-3
# the reference must have a scale the check can see: the density outputs
# are the RGB net's first 16 inputs
KERNEL_MIN_MEAN_ABS = 1e-2
# card vs CPU frame: the same flips, composited over up to 512 samples
FRAME_MAX_ABS, FRAME_MEAN_ABS = 2e-2, 1e-3
# halving the density net's output layer must move the CPU frame by this
# much more than the card-vs-CPU mean tolerance
FRAME_SENSITIVITY = 5.0


def look_at(eye, center, up):
    import numpy as np

    f = center - eye
    f = f / np.linalg.norm(f)
    r = np.cross(f, up)
    r = r / np.linalg.norm(r)
    u = np.cross(f, r)
    return np.stack([r, u, f, eye], axis=1).astype(np.float32)


def orbit_camera(angle, elevation, radius=0.85):
    import numpy as np

    c = np.array([0.5, 0.5, 0.5], np.float32)
    eye = c + radius * np.array([np.cos(angle) * np.cos(elevation),
                                 np.sin(elevation),
                                 np.sin(angle) * np.cos(elevation)],
                                np.float32)
    return look_at(eye, c, np.array([0, 1, 0], np.float32))


def trained_scale_params(model, seed):
    """The model's seeded MLP weights, with the hash table drawn from
    U(-1, 1). tcnn's U(-1e-4, 1e-4) init gives density outputs of ~1e-4
    and a density of ~1 everywhere, which would hide a wrong kernel."""
    import numpy as np

    table = np.random.default_rng(seed).uniform(
        -1.0, 1.0, model.pos_encoding.params.numel()).astype(np.float32)
    return {"pos_encoding": table,
            "density_net": [w.detach().cpu().numpy()
                            for w in model.density_net.weights],
            "dir_encoding": {},
            "rgb_net": [w.detach().cpu().numpy()
                        for w in model.rgb_net.weights]}


def cuda_ms(fn, reps=5, inner=10):
    """Median over `reps` of the mean device time of `inner` calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def mlp_bound_ms(rows, dims, x_bytes_per_value):
    """(least ms, "bytes" or "operations"): x and the bf16 weights read
    once and the float32 output written once at the card's memory rate,
    against 2 * rows * fan_in * fan_out operations per layer at its bf16
    tensor-core rate."""
    n_weights = sum(i * o for i, o in zip(dims[:-1], dims[1:]))
    moved = rows * (dims[0] * x_bytes_per_value + dims[-1] * 4) + 2 * n_weights
    by_bytes = 1e3 * moved / HBM_BYTES_PER_S
    by_ops = 1e3 * 2 * rows * n_weights / BF16_FLOP_PER_S
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def check_kernel(out, ref, what):
    """(max abs, mean abs) error of `out`, raising where it is outside the
    tolerance relative to the reference's scale."""
    import torch

    torch.cuda.synchronize()
    err = (out - ref).abs()
    max_abs, mean_abs = err.max().item(), err.mean().item()
    ref_max, ref_mean = ref.abs().max().item(), ref.abs().mean().item()
    if not (torch.isfinite(out).all() and out.shape == ref.shape
            and max_abs <= KERNEL_MAX_REL * ref_max
            and mean_abs <= KERNEL_MEAN_REL * ref_mean):
        raise RuntimeError(
            f"fused_mlp_forward disagrees with its plain version at {what}: "
            f"max abs {max_abs:.3g} mean abs {mean_abs:.3g} (ref max "
            f"{ref_max:.3g} mean {ref_mean:.3g})")
    return max_abs, mean_abs


def profile_frame(tb, cam, smi, out_path):
    """One warm frame with CUDA-event spans around each layer (device time
    between the events, no extra syncs), one under torch.profiler, and a
    warm density pass."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from instant_ngp_tpu_torch.nerf.render import WavefrontRenderer

    spans = {}

    def timed(name, fn):
        def wrapper(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            spans.setdefault(name, []).append((start, end))
            return out
        return wrapper

    model = tb.model
    layers = [("hash-grid encode", model.pos_encoding),
              ("density MLP kernel", model.density_net),
              ("SH direction encode", model.dir_encoding),
              ("RGB MLP kernel", model.rgb_net)]
    prep = WavefrontRenderer._prep
    for name, mod in layers:
        mod.forward = timed(name, mod.forward)
    WavefrontRenderer._prep = timed("march + pack", prep)
    try:
        frame_start = torch.cuda.Event(enable_timing=True)
        frame_end = torch.cuda.Event(enable_timing=True)
        frame_start.record()
        tb.render_frame(WIDTH, HEIGHT, cam, focal_length=FOCAL)
        frame_end.record()
        frame_end.synchronize()
    finally:
        for _, mod in layers:
            del mod.forward
        WavefrontRenderer._prep = prep
    frame_ms = frame_start.elapsed_time(frame_end)
    print(f"profile: warm frame {frame_ms:.1f} ms on the device's clock "
          f"[{smi}]")
    rest = frame_ms
    for name, pairs in spans.items():
        ms = sum(s.elapsed_time(e) for s, e in pairs)
        rest -= ms
        print(f"  {name}: {ms:.1f} ms ({100 * ms / frame_ms:.1f} %), "
              f"{len(pairs)} calls")
    print(f"  the rest (rays, alive set, composite): {rest:.1f} ms "
          f"({100 * rest / frame_ms:.1f} %)")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tb.render_frame(WIDTH, HEIGHT, cam, focal_length=FOCAL)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = prof.key_averages()

    def self_device_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    # an operator's row repeats the time of the kernels it launched, so
    # count the kernels' own rows only
    kernels = [e for e in rows if e.device_type == DeviceType.CUDA]
    busy = sum(self_device_us(e) for e in kernels) / 1e6
    print(f"profile: traced warm frame {wall:.3f} s wall, device busy "
          f"{busy:.3f} s ({100 * busy / wall:.1f} %) [{smi}]")
    for e in sorted(kernels, key=self_device_us, reverse=True)[:8]:
        us = self_device_us(e)
        print(f"  {e.key[:60]}: {us / 1e6:.3f} s "
              f"({100 * us / 1e6 / busy:.1f} % of device time), "
              f"{e.count} calls")
    for e in kernels:
        if "fused_mlp" in e.key:
            us = self_device_us(e)
            print(f"  {e.key[:70]}: {us / 1e3:.3f} ms of device time, "
                  f"{e.count} calls")
    with open(out_path, "w") as f:
        f.write(f"{smi}\n")
        f.write(rows.table(sort_by="self_cuda_time_total", row_limit=40))

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tb.update_density_grid_full()
    torch.cuda.synchronize()
    print(f"profile: warm density pass {time.perf_counter() - t0:.3f} s "
          f"[{smi}]")


def main():
    import numpy as np
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", metavar="OUT",
                        help="also profile a warm frame; the profiler's "
                             "table goes to OUT")
    args = parser.parse_args()

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    sys.path.insert(0, REPO)
    from instant_ngp_tpu_torch.config import (find_network_config,
                                              load_network_config)
    from instant_ngp_tpu_torch.nerf.dataset import scene_config
    from instant_ngp_tpu_torch.nerf.testbed_nerf import NerfTestbed
    from instant_ngp_tpu_torch.ops.encodings import sh_basis
    from instant_ngp_tpu_torch.ops.kernels import _build
    from instant_ngp_tpu_torch.ops.kernels.mlp_kernels import (
        fused_mlp_forward, fused_mlp_forward_plain)

    # phase 1: the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False   # plain f32 is f32
    torch.backends.cudnn.allow_tf32 = False

    # phase 2: build
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load_library()
    print(f"build: {time.perf_counter() - t0:.1f} s -> "
          f"{os.path.relpath(lib_path, REPO)}", flush=True)
    log = (lib_path.parent / "build.log")
    if log.is_file():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")

    # the network of the main path, at full width, weights from a seed
    cfg = load_network_config(find_network_config("base", "nerf"))
    scene = scene_config(aabb_scale=1)
    tb = NerfTestbed(scene, cfg, device=dev, compute_dtype=torch.bfloat16,
                     seed=SEED)
    model = tb.model
    params = trained_scale_params(model, SEED)
    tb.load_params(params)
    print(f"network: grid {model.pos_encoding.n_entries} entries x "
          f"{model.pos_encoding.n_features_per_level} features, density "
          f"{[w.shape[1] for w in model.density_net.weights]}, rgb "
          f"{[w.shape[1] for w in model.rgb_net.weights]}", flush=True)

    # phase 3: kernel vs plain, on the path's inputs
    from instant_ngp_tpu_torch.ops.kernels.mlp_kernels import (
        GENERAL, MMA_STAGES, kernel_variant, pack_weights)

    gen = torch.Generator().manual_seed(SEED + 1)
    n_max = max(N_ROWS, *OTHER_ROWS)
    with torch.no_grad():
        pos = torch.rand(n_max, 3, generator=gen).to(dev)
        d = torch.randn(n_max, 3, generator=gen)
        d = ((d / d.norm(dim=-1, keepdim=True) + 1.0) * 0.5).to(dev)
        feats = model.pos_encoding(pos).contiguous()
        dens_w = model.density_net.kernel_weights()
        dens_plain = fused_mlp_forward_plain(feats, dens_w.layers)
        dirw = d * 2.0 - 1.0
        rgb_in = torch.cat([dens_plain, sh_basis(4, dirw[:, 0], dirw[:, 1],
                                                 dirw[:, 2])], -1).contiguous()
        rgb_w = model.rgb_net.kernel_weights()
        del pos, d, dirw, dens_plain
        path_shapes = (("density", feats, dens_w), ("rgb", rgb_in, rgb_w))

        # small and ragged first: a hang would show here
        worst = 0.0
        for name, x, w in path_shapes:
            for n in SMALL_ROWS:
                ref = fused_mlp_forward_plain(x[:n], w.layers)
                max_abs, _ = check_kernel(fused_mlp_forward(x[:n], w), ref,
                                          f"{name} x {n}")
                check_kernel(fused_mlp_forward(x[:n].to(torch.bfloat16), w),
                             ref, f"{name} x {n}, bf16 input")
                worst = max(worst, max_abs)
        print(f"kernel at {SMALL_ROWS} rows, both path shapes, f32 and "
              f"bf16 input: ok (max abs {worst:.3g})", flush=True)

        other = {}
        rng = np.random.default_rng(SEED + 2)
        for dims, act, out_act in OTHER_SHAPES:
            ws = [torch.from_numpy(rng.uniform(
                -np.sqrt(6.0 / (i + o)), np.sqrt(6.0 / (i + o)), (i, o))
                .astype(np.float32)).to(dev)
                for i, o in zip(dims[:-1], dims[1:])]
            w = pack_weights(ws)
            x = torch.from_numpy(rng.normal(size=(SMALL_ROWS[-1], dims[0]))
                                 .astype(np.float32)).to(dev)
            ref = fused_mlp_forward_plain(x, w.layers, act, out_act)
            max_abs, mean_abs = check_kernel(
                fused_mlp_forward(x, w, act, out_act), ref, str(dims))
            tag = "-".join(map(str, dims)) + f" {act}/{out_act}"
            other[tag] = {"variant": kernel_variant(dims, act, out_act),
                          "rows": x.shape[0], "max_abs_err": max_abs,
                          "mean_abs_err": mean_abs}
            print(f"kernel {tag} x {x.shape[0]} [{other[tag]['variant']}]: "
                  f"max abs {max_abs:.3g} mean abs {mean_abs:.3g}",
                  flush=True)

        shapes = {}
        for name, x_all, w in path_shapes:
            x = x_all[:N_ROWS]
            variant = kernel_variant(w.dims)
            if variant == GENERAL:
                raise RuntimeError(f"the {name} shape {w.dims} has no "
                                   f"instantiation of the mma kernel")
            ref = fused_mlp_forward_plain(x, w.layers)
            ref_mean = ref.abs().mean().item()
            if ref_mean < KERNEL_MIN_MEAN_ABS:
                raise RuntimeError(f"the {name} reference is too small "
                                   f"({ref_mean:.3g}) to check the kernel")
            max_abs, mean_abs = check_kernel(fused_mlp_forward(x, w), ref,
                                             f"{name} x {N_ROWS}")
            check_kernel(fused_mlp_forward(x, w, variant=GENERAL), ref,
                         f"{name} x {N_ROWS}, general kernel")
            # in turns: general, kernel, plain, kernel, general
            general_ms = [cuda_ms(lambda: fused_mlp_forward(
                x, w, variant=GENERAL))]
            ms = [cuda_ms(lambda: fused_mlp_forward(x, w))]
            plain_ms = cuda_ms(lambda: fused_mlp_forward_plain(x, w.layers))
            ms.append(cuda_ms(lambda: fused_mlp_forward(x, w)))
            general_ms.append(cuda_ms(lambda: fused_mlp_forward(
                x, w, variant=GENERAL)))
            ms, general_ms = min(ms), min(general_ms)
            bound_ms, bound_by = mlp_bound_ms(N_ROWS, w.dims, 4)
            by_rows = {}
            for n in OTHER_ROWS:
                xn = x_all[:n]
                by_rows[str(n)] = {
                    "ms": cuda_ms(lambda: fused_mlp_forward(xn, w)),
                    "general_ms": cuda_ms(lambda: fused_mlp_forward(
                        xn, w, variant=GENERAL)),
                    "bound_ms": mlp_bound_ms(n, w.dims, 4)[0]}
            # the input ring at each depth, and the same kernel without it
            # (an input that is not 16-byte aligned takes plain loads)
            ring = {str(k): cuda_ms(lambda: fused_mlp_forward(x, w, stages=k))
                    for k in (1, 2, 3, 4)}
            shifted = torch.empty(x.numel() + 1, device=dev)[1:].view_as(x)
            shifted.copy_(x)
            check_kernel(fused_mlp_forward(shifted, w), ref,
                         f"{name} x {N_ROWS}, unaligned input")
            no_ring_ms = cuda_ms(lambda: fused_mlp_forward(shifted, w))
            del shifted
            xb = x.to(torch.bfloat16)
            bf16_ms = cuda_ms(lambda: fused_mlp_forward(xb, w))
            del xb
            shapes[name] = {
                "dims": list(w.dims), "rows": N_ROWS, "variant": variant,
                "max_abs_err": max_abs, "mean_abs_err": mean_abs,
                "ref_max_abs": ref.abs().max().item(),
                "ref_mean_abs": ref_mean,
                "ms": ms, "general_ms": general_ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "share_of_bound": bound_ms / ms,
                "ms_by_rows": by_rows, "ms_by_ring_depth": ring,
                "ms_plain_loads": no_ring_ms, "ms_bf16_input": bf16_ms}
            print(f"kernel {name} {'-'.join(map(str, w.dims))} x {N_ROWS} "
                  f"[{variant}, ring of {MMA_STAGES}]: max abs {max_abs:.3g} "
                  f"mean abs {mean_abs:.3g} (ref max "
                  f"{shapes[name]['ref_max_abs']:.3g} mean {ref_mean:.3g}) | "
                  f"kernel {ms:.4f} ms, general kernel {general_ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                  f"({bound_by}; {100 * bound_ms / ms:.1f} % reached) "
                  f"[{smi}]", flush=True)
            for n, r in by_rows.items():
                print(f"  x {n}: kernel {r['ms']:.4f} ms, general kernel "
                      f"{r['general_ms']:.4f} ms, bound "
                      f"{r['bound_ms']:.4f} ms [{smi}]")
            print("  ring depth " + ", ".join(
                f"{k}: {v:.4f} ms" for k, v in ring.items())
                + f"; plain loads, no ring: {no_ring_ms:.4f} ms; bf16 "
                f"input: {bf16_ms:.4f} ms [{smi}]", flush=True)
            if not (ms < general_ms):
                raise RuntimeError(f"the mma kernel is not faster than the "
                                   f"general kernel at the {name} shape")
        del feats, rgb_in, path_shapes, x, x_all, ref

    # phase 4: the main path, through the testbed's entry points
    cam = orbit_camera(angle=0.3, elevation=0.4)
    fused_mlp_forward.launches = 0
    fused_mlp_forward.launches_by_variant.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tb.update_density_grid_full()
    torch.cuda.synchronize()
    density_s = time.perf_counter() - t0
    launches_density = fused_mlp_forward.launches
    by_variant_density = dict(fused_mlp_forward.launches_by_variant)
    occupied = int(np.unpackbits(tb.bitfield.cpu().numpy()).sum())
    frames = []
    for _ in range(2):   # a cold frame, then a warm one
        by_variant_before = dict(fused_mlp_forward.launches_by_variant)
        t0 = time.perf_counter()
        frame = tb.render_frame(WIDTH, HEIGHT, cam, focal_length=FOCAL)
        torch.cuda.synchronize()
        frames.append((time.perf_counter() - t0, tb.last_frame_n_samples))
    launches = fused_mlp_forward.launches
    by_variant = dict(fused_mlp_forward.launches_by_variant)
    for shape in shapes.values():
        v = shape["variant"]
        shape["launches_per_frame"] = (by_variant.get(v, 0)
                                       - by_variant_before.get(v, 0))
        shape["launches_per_density_pass"] = by_variant_density.get(v, 0)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"density pass: {tb.density_grid.numel()} cells in "
          f"{density_s:.3f} s, {occupied} occupied bits, "
          f"{launches_density} kernel launches [{smi}]")
    for tag, (sec, n) in zip(("cold", "warm"), frames):
        print(f"frame {WIDTH}x{HEIGHT} ({tag}): {sec:.3f} s, {n} samples, "
              f"{n / sec:.4g} samples/s [{smi}]")
    print(f"main path: {launches} kernel launches {by_variant}, peak "
          f"{peak_gib:.2f} GiB allocated", flush=True)
    if launches_density == 0 or launches <= launches_density:
        raise RuntimeError("the main path did not launch fused_mlp_forward "
                           "in both phases")
    if (GENERAL in by_variant
            or any(s["launches_per_frame"] == 0 for s in shapes.values())
            or shapes["density"]["launches_per_density_pass"] == 0):
        raise RuntimeError("the main path did not go through the mma "
                           "kernel's instantiations for its two shapes")
    if frame.shape != (HEIGHT, WIDTH, 4) or not np.isfinite(frame).all():
        raise RuntimeError("the frame is not finite or has the wrong shape")
    if frames[-1][1] <= 0 or frame[..., 3].max() <= 0.0:
        raise RuntimeError("the frame evaluated no samples")

    # phase 5: the same testbed on the CPU, through the plain versions
    cpu_tb = NerfTestbed(scene, cfg, device="cpu",
                         compute_dtype=torch.bfloat16, seed=SEED)
    cpu_tb.load_params(params)
    cpu_tb.density_grid = tb.density_grid.cpu()
    cpu_tb.bitfield = tb.bitfield.cpu()
    small = (48, 48)
    focal_small = FOCAL * small[0] / WIDTH
    ours = tb.render_frame(*small, cam, focal_length=focal_small)
    ref = cpu_tb.render_frame(*small, cam, focal_length=focal_small)
    err = np.abs(ours - ref)
    print(f"frame {small[0]}x{small[1]} card vs CPU: max abs "
          f"{err.max():.3g}, mean abs {err.mean():.3g}")
    if not (err.max() <= FRAME_MAX_ABS and err.mean() <= FRAME_MEAN_ABS):
        raise RuntimeError("the card's frame disagrees with the CPU's")
    off = [w.copy() for w in params["density_net"]]
    off[-1] = off[-1] * 0.5
    cpu_tb.load_params(dict(params, density_net=off))
    moved = np.abs(cpu_tb.render_frame(*small, cam, focal_length=focal_small)
                   - ref).mean()
    print(f"frame {small[0]}x{small[1]} with the density net's output "
          f"layer halved: mean abs change {moved:.3g}")
    if moved < FRAME_SENSITIVITY * FRAME_MEAN_ABS:
        raise RuntimeError("the frame comparison cannot see a wrong "
                           "density network")

    if args.profile:
        profile_frame(tb, cam, smi, args.profile)

    kernels = [{
        "name": "fused_mlp_forward",
        "route": "cuda",
        "source": "instant_ngp_tpu_torch/csrc/fused_mlp_mma.cu",
        "general_source": "instant_ngp_tpu_torch/csrc/fused_mlp.cu",
        "replaces": "instant_ngp_tpu/ops/pallas/mlp_kernels.py:31",
        "launches": launches,
        "max_abs_err": max(s["max_abs_err"] for s in shapes.values()),
        # one network evaluation of N_ROWS samples: both MLPs
        "ms": sum(s["ms"] for s in shapes.values()),
        "plain_ms": sum(s["plain_ms"] for s in shapes.values()),
        "bound_ms": sum(s["bound_ms"] for s in shapes.values()),
        "bound_by": "bytes" if all(s["bound_by"] == "bytes"
                                   for s in shapes.values()) else "operations",
        # no one PyTorch call computes a fused multi-layer MLP
        "library_ms": None,
        "general_ms": sum(s["general_ms"] for s in shapes.values()),
        "shapes": shapes,
        "other_shapes": other,
    }]
    print(json.dumps({"kernels": kernels}))
    print(smi)   # the card's name and power limit, as nvidia-smi gives them
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
