"""Image training: an `ImageTestbed` over the traffic's procedural image;
set-up runs the stochastic steps and the first exact ones, the window
exact steps only; the reference (`reference/image.py::ImageTrainer`)
replays the first three steps and the three after the last stochastic
one."""

from __future__ import annotations

import sys
import time
from typing import Any, Dict

import torch

from ngp_bench.harness import cells, checks, scenes
from ngp_bench.harness.roofline import mlp_flops
from ngp_bench.harness.trace import EventSpans
from ngp_bench.reference import image as ref_image
from ngp_bench.reference.nets import FP8, FP32, layer_dims


def run(ctx) -> cells.Outcome:
    from instant_ngp_tpu_torch.image.testbed_image import ImageTestbed

    dev, seed, tr, cfg = ctx.device, ctx.seed, ctx.traffic, ctx.config
    net_cfg = cfg["network_config"]
    out = cells.Outcome()
    batch, chunk = tr["batch"], tr["chunk_steps"]
    until = int(net_cfg["encoding"]["stochastic_corners_until"])
    # the inputs wait on the host, so the device's peak is the program's
    image, grid, leaves0 = inputs(tr, net_cfg, seed, dev)
    image = image.cpu()
    p0 = [t.to("cpu", copy=True) for t in leaves0]
    del leaves0
    cells.free(dev)
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
    beta1 = float(cells.adam_node(net_cfg["optimizer"]).get("beta1", 0.9))
    step_fn = tb.trainer.train_step

    def recording_step(state, *args, **kwargs):
        state, loss = step_fn(state, *args, **kwargs)
        first["n"] = n = first["n"] + 1
        params = cells.tree_leaves(state["params"])
        m = cells.tree_leaves(state["opt"]["m"])
        if n <= 3:
            first["loss"].append(loss.detach().clone())
            if n == 1:
                first["grad"] = checks.leaf_norms(m, None,
                                                  1.0 / (1 - beta1))
            if n == 3:
                first["change"] = checks.leaf_norms(params, p0)
        if n == until:
            first["at"] = [[t.detach().to("cpu", copy=True) for t in tree]
                           for tree in (params, m, cells.tree_leaves(
                               state["opt"]["v"]))]
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
    cells.sync(dev)
    out.e2e["setup_s"] = time.perf_counter() - ctx.t_process
    prog = {k: [float(x) for x in first[k]] for k in ("loss", "exact_loss")}

    rd = out.readings
    spans = EventSpans(dev)
    raw_calls: list = []
    record = None
    if ctx.trace:
        tb.trainer.optimizer.step = spans.wrap("optimizer",
                                               tb.trainer.optimizer.step)
        record = cells.grid_recorder([tb.model.encoding], raw_calls)
    win = cells.LoopWindow(dev, ctx.seconds, ctx.trace,
                           record or (lambda on: None))

    def unit():
        tb.train(chunk, batch)
        return chunk
    win.run(unit)
    out.window_s = win.elapsed
    out.memory_peak = cells.peak(dev)
    out.attempted = win.units
    out.e2e["train_steps_per_s"] = win.units / win.elapsed
    out.e2e["peak_mem_gib"] = out.memory_peak / 2 ** 30

    if ctx.trace:
        rd.window = win.profiled.read()
        rd.units_traced = win.traced_units
        rd.spans = {"optimizer": spans.ms("optimizer")}
        rd.grid_calls = cells.grid_work(grid, raw_calls)
        rd.flops_per_unit = 3.0 * batch * mlp_flops(
            layer_dims(grid.n_output, 3, net_cfg["network"]))
        rd.units_untraced = win.units - win.traced_units
        rd.seconds_untraced = win.elapsed - win.traced_seconds
    raw_calls.clear()
    del tb
    cells.free(dev)

    image = image.to(dev)
    ref = reference_readings(image, net_cfg, p0, seed, batch, FP32)
    numbers = checks.training_numbers(prog["loss"], ref[0], first["grad"],
                                      ref[1], first["change"], ref[2])
    ref = reference_readings(image, net_cfg, first["at"][0], seed, batch,
                             FP32, resume=(until, *first["at"][1:]))
    numbers.update(checks.training_numbers(
        prog["exact_loss"], ref[0], first["exact_grad"], ref[1],
        first["exact_change"], ref[2], prefix="exact_"))
    print(f"ngp_bench: exact steps {until + 1}-{until + 3}: losses, program "
          f"{prog['exact_loss']}, reference {ref[0]}; the first's gradient "
          f"by leaf, program {first['exact_grad']}, reference {ref[1]}",
          file=sys.stderr)
    out.checks = checks.judge(numbers, ctx.limits)
    return out


def controls(ctx) -> Dict[str, Dict[str, float]]:
    """The reference in float8 in the program's place, and with half of
    the batch left out, each against the float32 reference; the exact
    steps' numbers (`exact_*`) start from the reference's own state after
    the stochastic steps, as the program's start from the program's."""
    dev, seed, tr = ctx.device, ctx.seed, ctx.traffic
    net_cfg = ctx.config["network_config"]
    batch = tr["batch"]
    until = int(net_cfg["encoding"]["stochastic_corners_until"])
    image, _, p0 = inputs(tr, net_cfg, seed, dev)
    at = reference_state(image, net_cfg, p0, seed, batch, until)

    def readings(prec, half=False):
        out = {}
        for prefix, params, resume in (("", p0, None),
                                       ("exact_", at[0], (until, *at[1:]))):
            out[prefix] = reference_readings(image, net_cfg, params, seed,
                                             batch, prec, half, resume)
        return out

    ref = readings(FP32)
    out = {}
    for name, got in (("control", readings(FP8)),
                      ("half_batch", readings(FP32, True))):
        out[name] = {}
        for prefix, g in got.items():
            r = ref[prefix]
            out[name].update(checks.training_numbers(
                g[0], r[0], g[1], r[1], g[2], r[2], prefix=prefix))
    return out


def inputs(tr, net_cfg, seed, dev):
    """The image (linear, on the device), its grid, the first weights."""
    side = tr["side"]
    image = scenes.procedural_image(side, seed, dev)
    grid = ref_image.image_grid(net_cfg, side, side)
    gen = torch.Generator(device=dev).manual_seed(seed ^ 0x5EED)
    return image, grid, ref_image.image_init(grid, net_cfg, gen)


def reference_readings(image, net_cfg, params, seed, batch, prec,
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


def reference_state(image, net_cfg, params, seed, batch, steps):
    """The reference's own state after `steps` float32 steps from `params`
    -> [params, m, v] as lists of leaves."""
    leaves = [t.clone() for t in params]
    ref = ref_image.ImageTrainer(image, net_cfg, leaves, seed)
    for _ in range(steps):
        ref.step(batch)
    return [leaves, ref.opt.m, ref.opt.v]
