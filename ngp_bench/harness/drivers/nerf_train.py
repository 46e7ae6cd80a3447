"""NeRF training: a `NerfTestbed` over the traffic's orbit views, its
closed loop of `train(chunk)` in the window, the quality of the model
after a fixed step, and the reference's replay of the first three steps
(`reference/nerf.py::NerfTrainer`)."""

from __future__ import annotations

import math
import time
from typing import Any, Dict

import numpy as np
import torch

from ngp_bench.harness import cells, checks, scenes
from ngp_bench.harness.roofline import mlp_flops
from ngp_bench.harness.trace import EventSpans
from ngp_bench.reference import nerf as ref_nerf
from ngp_bench.reference.nets import FP8, FP32


def run(ctx) -> cells.Outcome:
    from instant_ngp_tpu_torch.data.nerf_loader import (FrameMetadata, Lens,
                                                        NerfDataset)
    from instant_ngp_tpu_torch.nerf.testbed_nerf import NerfTestbed

    dev, seed, tr, cfg = ctx.device, ctx.seed, ctx.traffic, ctx.config
    net_cfg = cfg["network_config"]
    out = cells.Outcome()
    size, n_views = tr["size"], tr["views"]
    scene, pixels, focal, p0 = inputs(tr, net_cfg, seed, dev)
    model = p0.model
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
    tb.load_params(p0.program_layout())
    if not tb.use_error_map_sampling:
        raise RuntimeError("the testbed's default is not error-map sampling")

    # the first three steps through the window's own call: their losses,
    # the optimizer's first moments after one, the leaves after three, and
    # whether each ran the position encoding's stochastic forward
    first: Dict[str, Any] = {"loss": [], "stochastic": []}
    step_fn = tb.train_step
    beta1 = float(cells.adam_node(net_cfg["optimizer"]).get("beta1", 0.9))
    enc = tb.model.pos_encoding
    encode_stochastic = getattr(enc, "_encode_stochastic", None)
    calls = [0]
    if encode_stochastic is not None:
        def counted(*args):
            calls[0] += 1
            return encode_stochastic(*args)
        enc._encode_stochastic = counted

    def recording_step():
        before = calls[0]
        stats = step_fn()
        if tb.training_step <= 3:
            first["stochastic"].append(calls[0] > before)
            first["loss"].append(stats["loss"].detach().clone())
            leaves = cells.tree_leaves(tb.model.param_tree())
            if tb.training_step == 1:
                first["grad"] = checks.leaf_norms(
                    cells.tree_leaves(tb.opt_state["m"]), None,
                    1.0 / (1.0 - beta1))
            if tb.training_step == 3:
                first["change"] = checks.leaf_norms(leaves, p0_leaves)
        return stats

    tb.train_step = recording_step
    chunk = tr["chunk_steps"]
    for _ in range(tr["warmup_chunks"]):
        tb.train(chunk)
    del tb.train_step
    if encode_stochastic is not None:
        del enc._encode_stochastic
    # the reference replays the encode the configuration asks for
    replayed = [model.stochastic_at(i) for i in range(3)]
    if first["stochastic"] != replayed:
        raise RuntimeError(
            f"the testbed's first steps ran the stochastic encode "
            f"{first['stochastic']}, the reference replays {replayed}")
    cells.sync(dev)
    out.e2e["setup_s"] = time.perf_counter() - ctx.t_process
    prog_losses = [float(x) for x in first["loss"]]

    # the window
    rd = out.readings
    spans = EventSpans(dev)
    raw_calls: list = []
    if ctx.trace:
        tb.training_prep = spans.wrap("training_prep", tb.training_prep)
        tb.optimizer.step = spans.wrap("optimizer", tb.optimizer.step)
    record = None
    if ctx.trace and model.pos.grid is not None:
        record = cells.grid_recorder([tb.model.pos_encoding,
                                      tb.inference_model.pos_encoding],
                                     raw_calls)
    win = cells.LoopWindow(dev, ctx.seconds, ctx.trace,
                           record or (lambda on: None))

    # the model the quality is read from: the inference leaves and the
    # density grid as they stand after step `psnr_step` (a chunk's end)
    kept: Dict[str, Any] = {}

    def keep():
        kept.update(step=tb.training_step, grid=tb.density_grid.clone(),
                    leaves=[t.detach().clone() for t in
                            cells.tree_leaves(tb.inference_params())])

    def unit():
        tb.train(chunk)
        if not kept and tb.training_step >= tr["psnr_step"]:
            keep()
        return chunk
    win.run(unit)
    out.window_s = win.elapsed
    out.memory_peak = cells.peak(dev)
    out.attempted = win.units
    out.e2e["train_steps_per_s"] = win.units / win.elapsed
    out.e2e["peak_mem_gib"] = out.memory_peak / 2 ** 30

    # quality after a fixed number of steps, outside the window (a window
    # too short to reach them reads the model it ended with)
    if not kept:
        keep()
    with torch.no_grad():
        for dst, src in zip(cells.tree_leaves(tb.inference_params()),
                            kept["leaves"]):
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
        if model.pos.grid is not None:
            rd.grid_calls = cells.grid_work(model.pos.grid, raw_calls)
        rd.flops_per_unit = 3.0 * tb.target_batch_size * float(
            mlp_flops(model.density_dims) + mlp_flops(model.rgb_dims))
        rd.units_untraced = win.units - win.traced_units
        rd.seconds_untraced = win.elapsed - win.traced_seconds
    raw_calls.clear()
    del tb
    cells.free(dev)

    # the reference replays the first three steps
    data = scene_data(pixels, scene.cams, size, focal)
    ref = reference_readings(data, net_cfg, p0_leaves, seed, batch, FP32)
    numbers = checks.training_numbers(prog_losses, ref[0], first["grad"],
                                      ref[1], first["change"], ref[2])
    out.checks = checks.judge(numbers, ctx.limits)
    return out


def controls(ctx) -> Dict[str, Dict[str, float]]:
    """The reference in float8 in the program's place, and with half of
    the batch left out, each against the float32 reference."""
    tr = ctx.traffic
    net_cfg = ctx.config["network_config"]
    scene, pixels, focal, p0 = inputs(tr, net_cfg, ctx.seed, ctx.device)
    data = scene_data(pixels, scene.cams, tr["size"], focal)
    p0 = p0.leaves()

    def readings(prec, half=False):
        return reference_readings(data, net_cfg, p0, ctx.seed, tr["batch"],
                                  prec, half)

    ref = readings(FP32)
    out = {}
    for name, got in (("control", readings(FP8)),
                      ("half_batch", readings(FP32, True))):
        out[name] = checks.training_numbers(got[0], ref[0], got[1], ref[1],
                                            got[2], ref[2])
    return out


def inputs(tr, net_cfg, seed, dev):
    """The scene, its views (uint8 on the device), the focal length and
    the seeded first weights (`NerfParams`, their `model` the
    configuration's encodings and nets)."""
    size = tr["size"]
    focal = tr["focal_factor"] * size
    scene = scenes.scene_orbit(tr["views"], tr["radius"], tr["elevation"],
                               seed, dev)
    pixels = scenes.views_rgba8(scene, size, focal)
    gen = torch.Generator(device=dev).manual_seed(seed ^ 0x5EED)
    return scene, pixels, focal, ref_nerf.nerf_init(
        ref_nerf.NerfModel(net_cfg), gen)


def scene_data(pixels, cams, size, focal):
    n, dev = pixels.shape[0], pixels.device
    return ref_nerf.SceneData(
        pixels=pixels, resolutions=torch.full((n, 2), float(size),
                                              device=dev),
        xforms=cams, focal=torch.full((n, 2), focal, device=dev),
        rolling=torch.zeros(n, 4, device=dev))


def reference_readings(data, net_cfg, p0_leaves, seed, batch, prec,
                       drop_half=False):
    """Three steps of the reference from the same inputs -> (losses,
    first gradient's leaf norms, the change's leaf norms after three)."""
    p = ref_nerf.NerfModel(net_cfg).params([t.clone() for t in p0_leaves])
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
