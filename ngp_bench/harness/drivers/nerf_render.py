"""NeRF frames: a render-only `NerfTestbed` with seeded weights and the
traffic's occupancy shell, closed-loop Shade frames along a camera path
in the window, and sampled frames compared with the reference's
front-to-back render (`reference/nerf.py::render_frame`)."""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from ngp_bench.harness import cells, checks, scenes
from ngp_bench.reference import nerf as ref_nerf
from ngp_bench.reference.nets import FP8, FP32


def run(ctx) -> cells.Outcome:
    from instant_ngp_tpu_torch.nerf.dataset import scene_config
    from instant_ngp_tpu_torch.nerf.testbed_nerf import NerfTestbed

    dev, seed, tr, cfg = ctx.device, ctx.seed, ctx.traffic, ctx.config
    net_cfg = cfg["network_config"]
    out = cells.Outcome()
    size = tr["size"]
    path, focal, p, density = inputs(tr, net_cfg, seed, dev)
    host_path = path.cpu().numpy()

    tb = NerfTestbed(scene_config(1), net_cfg, device=dev, seed=seed)
    tb.load_params(p.program_layout())
    tb.set_density_grid(density)
    bitfield = ref_nerf.bitfield_of(density)
    kept = KeptFrames(len(host_path), tr["check_frames"], seed)

    def frame(i):
        img = tb.render_frame(size, size, host_path[i], focal_length=focal)
        kept.add(i, img[..., :3])
        return img

    for i in range(tr["warmup_frames"]):
        frame(i % len(host_path))
    kept.clear()
    cells.sync(dev)
    out.e2e["setup_s"] = time.perf_counter() - ctx.t_process

    counts: List[int] = []
    state = {"next": tr["warmup_frames"] % len(host_path)}
    traced: List[int] = []
    win = cells.LoopWindow(dev, ctx.seconds, ctx.trace,
                           lambda on: state.__setitem__("tracing", on))

    def unit():
        i = state["next"]
        frame(i)
        counts.append(tb.last_frame_n_samples)
        if state.get("tracing"):
            traced.append(i)
        state["next"] = (i + 1) % len(host_path)
        return 1

    def traced_unit():
        return sum(unit() for _ in range(tr["trace_frames"]))
    win.run(unit, traced_unit)
    out.window_s = win.elapsed
    out.memory_peak = cells.peak(dev)
    out.attempted = win.units
    out.e2e["frame_ms"] = 1e3 * win.elapsed / win.units
    out.e2e["peak_mem_gib"] = out.memory_peak / 2 ** 30
    rd = out.readings
    rd.counters["samples_per_frame"] = [float(c) for c in counts]
    if ctx.trace:
        rd.window = win.profiled.read()
        rd.units_traced = win.traced_units
        rd.mlp_dims = [p.model.density_dims, p.model.rgb_dims]
    del tb
    cells.free(dev)

    pick = kept.pick()
    refs = {i: ref_nerf.render_frame(
        p, bitfield, size, size, focal,
        torch.from_numpy(host_path[i]).to(dev)) for i in set(pick)}
    if traced:
        rows = 0
        for i in traced:
            if i not in refs:
                refs[i] = ref_nerf.render_frame(
                    p, bitfield, size, size, focal,
                    torch.from_numpy(host_path[i]).to(dev))
            rows += refs[i][1]
        rd.mlp_rows = rows
    numbers = checks.frame_numbers([torch.from_numpy(kept.frames[i])
                                    for i in pick],
                                   [refs[i][0] for i in pick])
    out.checks = checks.judge(numbers, ctx.limits)
    return out


class KeptFrames:
    """The frames compared: the first `k` cameras of a permutation of the
    path drawn from the seed, among those the window rendered. Only the
    latest frame of a camera that can still be among them is kept, so every
    other frame's host array is freed for the next one (keeping every
    camera's, the window's first pass over the path faulted in fresh host
    memory for each frame, some 8 ms of a 50 ms frame on the H100's host)."""

    def __init__(self, n_cameras: int, k: int, seed: int):
        order = torch.randperm(n_cameras, generator=torch.Generator()
                               .manual_seed(seed)).tolist()
        self.rank = {c: r for r, c in enumerate(order)}
        self.k = k
        self.rendered: set = set()
        self.frames: Dict[int, np.ndarray] = {}

    def add(self, i: int, img: np.ndarray):
        self.rendered.add(i)
        due = self.pick()
        for j in [j for j in self.frames if j not in due]:
            del self.frames[j]
        if i in due:
            self.frames[i] = img

    def pick(self) -> List[int]:
        return sorted(self.rendered, key=self.rank.__getitem__)[:self.k]

    def clear(self):
        self.rendered.clear()
        self.frames.clear()


def controls(ctx) -> Dict[str, Dict[str, float]]:
    """Each compared frame by the reference in float8 in the program's
    place, and rendered from the next camera of the path (a wrong answer),
    against the float32 reference."""
    dev, tr = ctx.device, ctx.traffic
    path, focal, p, density = inputs(tr, ctx.config["network_config"],
                                     ctx.seed, dev)
    bitfield = ref_nerf.bitfield_of(density)
    order = torch.randperm(len(path), generator=torch.Generator()
                           .manual_seed(ctx.seed)).tolist()
    pick = order[:tr["check_frames"]]

    def frames(prec, shift=0):
        return [ref_nerf.render_frame(
            p, bitfield, tr["size"], tr["size"], focal,
            path[(i + shift) % len(path)], prec=prec)[0] for i in pick]

    ref = frames(FP32)
    return {"control": checks.frame_numbers(frames(FP8), ref),
            "neighbour": checks.frame_numbers(frames(FP32, 1), ref)}


def inputs(tr, net_cfg, seed, dev):
    """The viewer's camera path, the focal length, the seeded weights at a
    trained scale (`NerfParams`) and the shell's density grid."""
    focal = tr["focal_factor"] * tr["size"]
    scene = scenes.scene_orbit(tr["path_cameras"], tr["radius"],
                               tr["elevation"], seed, dev)
    path = scenes.between(scene, tr["path_cameras"], tr["radius"],
                          tr["elevation"])
    gen = torch.Generator(device=dev).manual_seed(seed ^ 0x5EED)
    p = ref_nerf.nerf_init(ref_nerf.NerfModel(net_cfg), gen,
                           tr["table_range"])
    return path, focal, p, scenes.shell_grid(tr["shell_cells"], dev)
