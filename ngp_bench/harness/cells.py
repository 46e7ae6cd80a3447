"""The three drivers a traffic file can name: `nerf_train`, `image_train`
and `nerf_render`. Each sets the cell up from the seed, runs the measured
window as a closed loop of the program's own calls, and after the window
compares what the window's path produced with the plain reference.

A driver returns an `Outcome`; `run.py` turns it into the result line.
Sizes come from the configuration and traffic files; `overrides` (tests
only) shrink them for the CPU."""

from __future__ import annotations

import gc
import math
import sys
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..reference import image as ref_image
from ..reference import nerf as ref_nerf
from ..reference.grid import Grid
from ..reference.nets import Precision, layer_dims
from . import checks, scenes
from .roofline import GridCall, distinct_rows, mlp_flops
from .trace import EventSpans, Profiled, Window


class Outcome:
    def __init__(self):
        self.e2e: Dict[str, float] = {}
        self.checks: Dict[str, Dict[str, Any]] = {}
        self.attempted = 0
        self.failed = 0
        self.memory_peak = 0
        self.window_s = 0.0
        self.psnr_step: Optional[int] = None
        self.readings = Readings()


class Readings:
    """What the per-layer readers read (metrics/<name>.py)."""

    def __init__(self):
        self.window: Optional[Window] = None   # the traced sub-window
        self.units_traced = 0                  # steps or frames in it
        self.spans: Dict[str, List[float]] = {}
        self.grid_calls: List[GridCall] = []
        self.mlp_rows = 0                      # rows the traced frames need
        self.mlp_dims: List[List] = []         # the nets' layer dims
        self.flops_per_unit = 0.0              # model FLOPs a step or frame
        self.units_untraced = 0                # outside the sub-window
        self.seconds_untraced = 0.0
        self.counters: Dict[str, List[float]] = {}


def _sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _peak(dev) -> int:
    if torch.device(dev).type == "cuda":
        return int(torch.cuda.max_memory_allocated())
    return 0


def _free(dev):
    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()


class _Window:
    """The closed loop: `unit()` runs one chunk and returns how many steps
    or frames it completed; with `trace`, the first chunk past the middle
    (or, where a chunk outlasts the window, the next one) runs under the
    profiler, its time and units kept apart."""

    def __init__(self, dev, seconds: float, trace: bool,
                 on_trace: Callable[[bool], None] = lambda on: None):
        self.dev, self.seconds, self.trace = dev, seconds, trace
        self.on_trace = on_trace
        self.units = 0
        self.elapsed = 0.0
        self.traced_units = 0
        self.traced_seconds = 0.0
        self.profiled: Optional[Profiled] = None

    def run(self, unit: Callable[[], int],
            traced_unit: Optional[Callable[[], int]] = None) -> None:
        traced_unit = traced_unit or unit
        _sync(self.dev)
        t0 = time.perf_counter()
        while True:
            now = time.perf_counter()
            over = now - t0 >= self.seconds
            if over and not (self.trace and self.profiled is None):
                break
            if self.trace and self.profiled is None \
                    and now - t0 >= 0.5 * self.seconds:
                self.on_trace(True)
                self.profiled = Profiled(self.dev)
                t1 = time.perf_counter()
                with self.profiled:
                    n = traced_unit()
                self.traced_seconds = time.perf_counter() - t1
                self.traced_units = n
                self.on_trace(False)
            else:
                n = unit()
            self.units += n
        _sync(self.dev)
        self.elapsed = time.perf_counter() - t0


# the encodings' kernel entry points: (kind, position of x, draws given)
_GRID_ENTRIES = {"_encode": ("forward", 1, False),
                 "_encode_stochastic": ("forward", 1, True),
                 "_table_gradient": ("gradient", 0, False),
                 "_table_gradient_stochastic": ("gradient", 0, True)}


def _grid_recorder(encodings, calls: list):
    """Wrap the encodings' kernel entry points to keep each call's points
    and draws as (kind, x, draws, j, one corner); `on(True/False)` switches
    recording."""
    state = {"on": False}

    def wrap(enc, attr):
        fn = getattr(enc, attr)
        kind, at, stochastic = _GRID_ENTRIES[attr]

        def wrapper(*args):
            if state["on"]:
                draws, j = (args[3], args[4]) if stochastic else (None, None)
                one = stochastic and kind == "gradient" and (
                    j == 0 or enc.stochastic_bwd)
                calls.append((kind, args[at], draws, j, one))
            return fn(*args)
        setattr(enc, attr, wrapper)

    for enc in encodings:
        for attr in _GRID_ENTRIES:
            wrap(enc, attr)

    def on(flag):
        state["on"] = flag
    return on


@torch.no_grad()
def _grid_work(grid: Grid, raw_calls) -> List[GridCall]:
    """The recorded calls' distinct rows per level, by the benchmark's own
    index function."""
    out = []
    for kind, x, draws, j, one in raw_calls:
        per_level = []
        for lvl in range(grid.n_levels):
            if draws is None:
                rows, _ = grid.exact_rows(x, lvl)
                per_level.append(distinct_rows(rows))
            else:
                pairs = grid.stochastic_rows(x, lvl, draws.u, draws.axis, j,
                                             sampled_only=one)
                per_level.append(distinct_rows(
                    torch.cat([r.reshape(-1) for r, _ in pairs])))
        out.append(GridCall(kind, x.shape[0], grid.n_dims, grid.n_features,
                            per_level))
    return out


def _device_info(dev) -> Dict[str, Any]:
    if torch.device(dev).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1}


# ======================================================================
# NeRF training
# ======================================================================
def nerf_train(ctx) -> Outcome:
    from instant_ngp_tpu_torch.data.nerf_loader import (FrameMetadata, Lens,
                                                        NerfDataset)
    from instant_ngp_tpu_torch.nerf.testbed_nerf import NerfTestbed

    dev, seed, tr, cfg = ctx.device, ctx.seed, ctx.traffic, ctx.config
    net_cfg = cfg["network_config"]
    out = Outcome()
    size, n_views = tr["size"], tr["views"]
    scene, pixels, focal, grid, p0 = nerf_train_inputs(tr, net_cfg, seed, dev)
    host_pixels = pixels.cpu().numpy()
    host_cams = scene.cams.cpu().numpy()
    meta = [FrameMetadata((size, size), np.array([focal, focal], np.float32),
                          np.array([0.5, 0.5], np.float32),
                          np.zeros(4, np.float32), Lens())
            for _ in range(n_views)]
    ds = NerfDataset(paths=[f"view{i}" for i in range(n_views)],
                     images=list(host_pixels), depths=[None] * n_views,
                     rays=[None] * n_views, metadata=meta,
                     xforms_start=host_cams, xforms_end=host_cams,
                     aabb_scale=1)
    p0_leaves = [t.clone() for t in p0.leaves()]

    tb = NerfTestbed(ds, net_cfg, device=dev, seed=seed)
    batch = tr["batch"]
    tb.target_batch_size, tb.rays_per_batch = batch["samples"], batch["rays"]
    tb.load_params({"pos_encoding": p0.table, "density_net": p0.density,
                    "dir_encoding": None, "rgb_net": p0.rgb})
    if not (tb.stochastic_corners and tb.use_error_map_sampling):
        raise RuntimeError("the testbed's defaults are not the stochastic "
                           "encode with error-map sampling")

    # the first three steps through the window's own call: their losses,
    # the optimizer's first moments after one, the leaves after three
    first: Dict[str, Any] = {"loss": []}
    step_fn = tb.train_step
    beta1 = float(_adam_node(net_cfg["optimizer"]).get("beta1", 0.9))

    def recording_step():
        stats = step_fn()
        if tb.training_step <= 3:
            first["loss"].append(stats["loss"].detach().clone())
            leaves = _leaves(tb.model.param_tree())
            if tb.training_step == 1:
                first["grad"] = checks.leaf_norms(
                    _leaves(tb.opt_state["m"]), None, 1.0 / (1.0 - beta1))
            if tb.training_step == 3:
                first["change"] = checks.leaf_norms(leaves, p0_leaves)
        return stats

    tb.train_step = recording_step
    chunk = tr["chunk_steps"]
    for _ in range(tr["warmup_chunks"]):
        tb.train(chunk)
    del tb.train_step
    _sync(dev)
    out.e2e["setup_s"] = time.perf_counter() - ctx.t_process
    prog_losses = [float(x) for x in first["loss"]]

    # the window
    rd = out.readings
    spans = EventSpans(dev)
    raw_calls: list = []
    if ctx.trace:
        tb.training_prep = spans.wrap("training_prep", tb.training_prep)
        tb.optimizer.step = spans.wrap("optimizer", tb.optimizer.step)
        record = _grid_recorder([tb.model.pos_encoding,
                                 tb.inference_model.pos_encoding], raw_calls)
    else:
        record = None
    win = _Window(dev, ctx.seconds, ctx.trace, record or (lambda on: None))

    # the model the quality is read from: the inference leaves and the
    # density grid as they stand after step `psnr_step` (a chunk's end)
    kept: Dict[str, Any] = {}

    def keep():
        kept.update(step=tb.training_step, grid=tb.density_grid.clone(),
                    leaves=[t.detach().clone()
                            for t in _leaves(tb.inference_params())])

    def unit():
        tb.train(chunk)
        if not kept and tb.training_step >= tr["psnr_step"]:
            keep()
        return chunk
    win.run(unit)
    out.window_s = win.elapsed
    out.memory_peak = _peak(dev)
    out.attempted = win.units
    out.e2e["train_steps_per_s"] = win.units / win.elapsed
    out.e2e["peak_mem_gib"] = out.memory_peak / 2 ** 30

    # quality after a fixed number of steps, outside the window (a window
    # too short to reach them reads the model it ended with)
    if not kept:
        keep()
    with torch.no_grad():
        for dst, src in zip(_leaves(tb.inference_params()), kept["leaves"]):
            dst.copy_(src)
    tb.set_density_grid(kept["grid"])
    out.psnr_step = kept["step"]
    held = scenes.between(scene, tr["psnr_views"], tr["radius"],
                          tr["elevation"])
    mse = 0.0
    for cam in held:
        img = tb.render_frame(size, size, cam.cpu().numpy(),
                              focal_length=focal, min_transmittance=1e-4)
        got = torch.from_numpy(img[..., :3]).to(dev).clamp(0, 1)
        gt = scenes.ground_truth_srgb(cam, size, focal, scene.palette)
        mse += float(((got - gt) ** 2).mean()) / len(held)
    out.e2e["train_psnr_db"] = -10.0 * math.log10(max(mse, 1e-20))

    if ctx.trace:
        rd.window = win.profiled.read()
        rd.units_traced = win.traced_units
        rd.spans = {"training_prep": spans.ms("training_prep"),
                    "optimizer": spans.ms("optimizer")}
        rd.grid_calls = _grid_work(grid, raw_calls)
        rd.flops_per_unit = 3.0 * tb.target_batch_size * _nerf_flops(net_cfg)
        rd.units_untraced = win.units - win.traced_units
        rd.seconds_untraced = win.elapsed - win.traced_seconds
    raw_calls.clear()
    del tb
    _free(dev)

    # the reference replays the first three steps
    data = ref_scene_data(pixels, scene.cams, size, focal)
    ref = nerf_reference_readings(data, net_cfg, p0_leaves, seed, batch,
                                  Precision())
    numbers = checks.training_numbers(prog_losses, ref[0], first["grad"],
                                      ref[1], first["change"], ref[2])
    out.checks = checks.judge(numbers, ctx.limits)
    return out


def nerf_train_inputs(tr, net_cfg, seed, dev):
    """The scene, its views (uint8 on the device), the focal length, the
    grid and the seeded first weights."""
    size = tr["size"]
    focal = tr["focal_factor"] * size
    scene = scenes.scene_orbit(tr["views"], tr["radius"], tr["elevation"],
                               seed, dev)
    pixels = scenes.views_rgba8(scene, size, focal)
    grid = Grid(3, net_cfg["encoding"], 2048.0, 1.0)
    gen = torch.Generator(device=dev).manual_seed(seed ^ 0x5EED)
    return scene, pixels, focal, grid, ref_nerf.nerf_init(grid, net_cfg, gen)


def ref_scene_data(pixels, cams, size, focal):
    n, dev = pixels.shape[0], pixels.device
    return ref_nerf.SceneData(
        pixels=pixels, resolutions=torch.full((n, 2), float(size),
                                              device=dev),
        xforms=cams, focal=torch.full((n, 2), focal, device=dev),
        rolling=torch.zeros(n, 4, device=dev))


def nerf_reference_readings(data, net_cfg, p0_leaves, seed, batch, prec,
                            drop_half=False):
    """Three steps of the reference from the same inputs -> (losses,
    first gradient's leaf norms, the change's leaf norms after three)."""
    n_dens = len(layer_dims(32, 16, net_cfg["network"]))
    leaves = [t.clone() for t in p0_leaves]
    p = ref_nerf.NerfParams(leaves[0], leaves[1:1 + n_dens],
                            leaves[1 + n_dens:])
    ref = ref_nerf.NerfTrainer(data, net_cfg, p, seed, prec, drop_half)
    ref.target_batch, ref.rays_per_batch = batch["samples"], batch["rays"]
    losses, grad = [], None
    for i in range(3):
        ref.density_update()
        s = ref.step()
        losses.append(s["loss"])
        if i == 0:
            grad = checks.leaf_norms(s["grads"])
    return losses, grad, checks.leaf_norms(p.leaves(), p0_leaves)


def _adam_node(opt_cfg):
    node = opt_cfg
    while node.get("nested") is not None:
        node = node["nested"]
    return node


def _leaves(tree) -> List[torch.Tensor]:
    from instant_ngp_tpu_torch.ops.optimizers import tree_leaves

    return tree_leaves(tree)


def _nerf_flops(net_cfg) -> float:
    return float(mlp_flops(layer_dims(32, 16, net_cfg["network"]))
                 + mlp_flops(layer_dims(32, 3, net_cfg.get(
                     "rgb_network", net_cfg["network"]))))


# ======================================================================
# Image training
# ======================================================================
def image_train(ctx) -> Outcome:
    from instant_ngp_tpu_torch.image.testbed_image import ImageTestbed

    dev, seed, tr, cfg = ctx.device, ctx.seed, ctx.traffic, ctx.config
    net_cfg = cfg["network_config"]
    out = Outcome()
    batch, chunk = tr["batch"], tr["chunk_steps"]
    until = int(net_cfg["encoding"]["stochastic_corners_until"])
    # the inputs wait on the host, so the device's peak is the program's
    image, grid, leaves0 = image_train_inputs(tr, net_cfg, seed, dev)
    image = image.cpu()
    p0 = [t.to("cpu", copy=True) for t in leaves0]
    del leaves0
    _free(dev)
    if torch.device(dev).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    tb = ImageTestbed(image.numpy(), net_cfg, seed=seed, device=dev)
    tb.trainer.load_state(tb.state, {"encoding": p0[0], "net": p0[1:]})

    # set-up runs the stochastic steps and the first exact ones through the
    # window's own call; kept: the first three steps' losses, the gradient
    # of the first from Adam's first moment and the change after the
    # three; the state after the last stochastic step (on the host); the
    # same three numbers of the three exact steps after it
    first: Dict[str, Any] = {"loss": [], "exact_loss": [], "n": 0}
    beta1 = float(_adam_node(net_cfg["optimizer"]).get("beta1", 0.9))
    step_fn = tb.trainer.train_step

    def recording_step(state, *args, **kwargs):
        state, loss = step_fn(state, *args, **kwargs)
        first["n"] = n = first["n"] + 1
        params, m = _leaves(state["params"]), _leaves(state["opt"]["m"])
        if n <= 3:
            first["loss"].append(loss.detach().clone())
            if n == 1:
                first["grad"] = checks.leaf_norms(m, None,
                                                  1.0 / (1 - beta1))
            if n == 3:
                first["change"] = checks.leaf_norms(params, p0)
        if n == until:
            first["at"] = [[t.detach().to("cpu", copy=True) for t in tree]
                           for tree in (params, m,
                                        _leaves(state["opt"]["v"]))]
        elif until < n <= until + 3:
            first["exact_loss"].append(loss.detach().clone())
            if n == until + 1:
                first["exact_grad"] = checks.leaf_norms(
                    m, first["at"][1], 1.0 / (1 - beta1), beta1)
            if n == until + 3:
                first["exact_change"] = checks.leaf_norms(params,
                                                          first["at"][0])
        return state, loss

    tb.trainer.train_step = recording_step
    for _ in range(-(-(until + 3) // chunk)):
        tb.train(chunk, batch)
    del tb.trainer.train_step
    _sync(dev)
    out.e2e["setup_s"] = time.perf_counter() - ctx.t_process
    prog = {k: [float(x) for x in first[k]] for k in ("loss", "exact_loss")}

    rd = out.readings
    spans = EventSpans(dev)
    raw_calls: list = []
    record = None
    if ctx.trace:
        tb.trainer.optimizer.step = spans.wrap("optimizer",
                                               tb.trainer.optimizer.step)
        record = _grid_recorder([tb.model.encoding], raw_calls)
    win = _Window(dev, ctx.seconds, ctx.trace, record or (lambda on: None))

    def unit():
        tb.train(chunk, batch)
        return chunk
    win.run(unit)
    out.window_s = win.elapsed
    out.memory_peak = _peak(dev)
    out.attempted = win.units
    out.e2e["train_steps_per_s"] = win.units / win.elapsed
    out.e2e["peak_mem_gib"] = out.memory_peak / 2 ** 30

    if ctx.trace:
        rd.window = win.profiled.read()
        rd.units_traced = win.traced_units
        rd.spans = {"optimizer": spans.ms("optimizer")}
        rd.grid_calls = _grid_work(grid, raw_calls)
        rd.flops_per_unit = 3.0 * batch * mlp_flops(
            layer_dims(grid.n_output, 3, net_cfg["network"]))
        rd.units_untraced = win.units - win.traced_units
        rd.seconds_untraced = win.elapsed - win.traced_seconds
    raw_calls.clear()
    del tb
    _free(dev)

    image = image.to(dev)
    ref = image_reference_readings(image, net_cfg, p0, seed, batch,
                                   Precision())
    numbers = checks.training_numbers(prog["loss"], ref[0], first["grad"],
                                      ref[1], first["change"], ref[2])
    ref = image_reference_readings(image, net_cfg, first["at"][0], seed,
                                   batch, Precision(),
                                   resume=(until, *first["at"][1:]))
    numbers.update(checks.training_numbers(
        prog["exact_loss"], ref[0], first["exact_grad"], ref[1],
        first["exact_change"], ref[2], prefix="exact_"))
    print(f"ngp_bench: exact steps {until + 1}-{until + 3}: losses, program "
          f"{prog['exact_loss']}, reference {ref[0]}; the first's gradient "
          f"by leaf, program {first['exact_grad']}, reference {ref[1]}",
          file=sys.stderr)
    out.checks = checks.judge(numbers, ctx.limits)
    return out


def image_train_inputs(tr, net_cfg, seed, dev):
    """The image (linear, on the device), its grid, the first weights."""
    side = tr["side"]
    image = scenes.procedural_image(side, seed, dev)
    grid = ref_image.image_grid(net_cfg, side, side)
    gen = torch.Generator(device=dev).manual_seed(seed ^ 0x5EED)
    return image, grid, ref_image.image_init(grid, net_cfg, gen)


def image_reference_readings(image, net_cfg, params, seed, batch, prec,
                             drop_half=False, resume=None):
    """Three steps of the reference from `params` (on the host or the
    device) -> (losses, the first gradient's leaf norms, the change's leaf
    norms after three). `resume` = (step, m, v): go on from the state after
    that many steps instead of from the first."""
    dev = image.device
    leaves = [t.to(dev, copy=True) for t in params]
    ref = ref_image.ImageTrainer(image, net_cfg, leaves, seed, prec,
                                 drop_half)
    if resume is not None:
        step, m, v = resume
        ref.resume(step, [t.to(dev, copy=True) for t in m],
                   [t.to(dev, copy=True) for t in v], batch)
    losses, grad = [], None
    for i in range(3):
        s = ref.step(batch)
        losses.append(s["loss"])
        if i == 0:
            grad = checks.leaf_norms(s["grads"])
    return losses, grad, checks.leaf_norms(leaves, params)


def image_reference_state(image, net_cfg, params, seed, batch, steps):
    """The reference's own state after `steps` float32 steps from `params`
    -> [params, m, v] as lists of leaves."""
    leaves = [t.clone() for t in params]
    ref = ref_image.ImageTrainer(image, net_cfg, leaves, seed)
    for _ in range(steps):
        ref.step(batch)
    return [leaves, ref.opt.m, ref.opt.v]


# ======================================================================
# NeRF frames
# ======================================================================
def nerf_render(ctx) -> Outcome:
    from instant_ngp_tpu_torch.nerf.dataset import scene_config
    from instant_ngp_tpu_torch.nerf.testbed_nerf import NerfTestbed

    dev, seed, tr, cfg = ctx.device, ctx.seed, ctx.traffic, ctx.config
    net_cfg = cfg["network_config"]
    out = Outcome()
    size = tr["size"]
    path, focal, grid, p, density = nerf_render_inputs(tr, net_cfg, seed,
                                                       dev)
    host_path = path.cpu().numpy()

    tb = NerfTestbed(scene_config(1), net_cfg, device=dev, seed=seed)
    tb.load_params({"pos_encoding": p.table, "density_net": p.density,
                    "dir_encoding": None, "rgb_net": p.rgb})
    tb.set_density_grid(density)
    bitfield = ref_nerf.bitfield_of(density)
    # every camera's latest frame; the ones compared are drawn from the
    # seed after the window, among the cameras it rendered
    kept: Dict[int, np.ndarray] = {}

    def frame(i):
        img = tb.render_frame(size, size, host_path[i], focal_length=focal)
        kept[i] = img[..., :3]
        return img

    for i in range(tr["warmup_frames"]):
        frame(i % len(host_path))
    kept.clear()
    _sync(dev)
    out.e2e["setup_s"] = time.perf_counter() - ctx.t_process

    counts: List[int] = []
    state = {"next": tr["warmup_frames"] % len(host_path)}
    traced: List[int] = []
    win = _Window(dev, ctx.seconds, ctx.trace,
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
    out.memory_peak = _peak(dev)
    out.attempted = win.units
    out.e2e["frame_ms"] = 1e3 * win.elapsed / win.units
    out.e2e["peak_mem_gib"] = out.memory_peak / 2 ** 30
    rd = out.readings
    rd.counters["samples_per_frame"] = [float(c) for c in counts]
    if ctx.trace:
        rd.window = win.profiled.read()
        rd.units_traced = win.traced_units
        rd.mlp_dims = [layer_dims(32, 16, net_cfg["network"]),
                       layer_dims(32, 3, net_cfg.get("rgb_network",
                                                     net_cfg["network"]))]
    del tb
    _free(dev)

    done = sorted(kept)
    order = torch.randperm(len(done), generator=torch.Generator()
                           .manual_seed(seed)).tolist()
    pick = [done[k] for k in order[:tr["check_frames"]]]
    refs = {i: ref_nerf.render_frame(
        p, grid, bitfield, size, size, focal,
        torch.from_numpy(host_path[i]).to(dev)) for i in set(pick)}
    if traced:
        rows = 0
        for i in traced:
            if i not in refs:
                refs[i] = ref_nerf.render_frame(
                    p, grid, bitfield, size, size, focal,
                    torch.from_numpy(host_path[i]).to(dev))
            rows += refs[i][1]
        rd.mlp_rows = rows
    numbers = checks.frame_numbers([torch.from_numpy(kept[i]) for i in pick],
                                   [refs[i][0] for i in pick])
    out.checks = checks.judge(numbers, ctx.limits)
    return out


def nerf_render_inputs(tr, net_cfg, seed, dev):
    """The viewer's camera path, the focal length, the grid, the seeded
    weights at a trained scale and the shell's density grid."""
    focal = tr["focal_factor"] * tr["size"]
    scene = scenes.scene_orbit(tr["path_cameras"], tr["radius"],
                               tr["elevation"], seed, dev)
    path = scenes.between(scene, tr["path_cameras"], tr["radius"],
                          tr["elevation"])
    grid = Grid(3, net_cfg["encoding"], 2048.0, 1.0)
    gen = torch.Generator(device=dev).manual_seed(seed ^ 0x5EED)
    p = ref_nerf.nerf_init(grid, net_cfg, gen, tr["table_range"])
    return path, focal, grid, p, scenes.shell_grid(tr["shell_cells"], dev)


DRIVERS = {"nerf_train": nerf_train, "image_train": image_train,
           "nerf_render": nerf_render}
