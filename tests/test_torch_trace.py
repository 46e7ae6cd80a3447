"""The port's named spans (`instant_ngp_tpu_torch.utils.span`) and the
benchmark's readers of them, on the CPU.

With no profiler running a span is one shared no-op and records nothing.
Under `torch.profiler` (CPU) the NeRF loop, its train step, the Image loop
with the trainer and the wavefront frame open their spans, nested through
the profiler's `cpu_parent`, and none of them is a user annotation (the
profiler would mirror one onto the device's timeline, where the
benchmark counts kernels). The eight readers are fed made-up readings."""

import os
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_image_mode import CFG as IMAGE_CFG  # noqa: E402
from test_torch_image_mode import image  # noqa: E402
from test_torch_training import make_port_tb  # noqa: E402

from instant_ngp_tpu_torch import utils  # noqa: E402
from instant_ngp_tpu_torch.image.testbed_image import \
    ImageTestbed  # noqa: E402
from ngp_bench import run  # noqa: E402
from ngp_bench.harness.cells import Readings  # noqa: E402
from ngp_bench.harness.trace import Interval, Window  # noqa: E402

torch.set_num_threads(2)

NERF_STEP = ["nerf.sample", "nerf.forward", "nerf.composite",
             "nerf.backward", "nerf.optimizer"]
RENDER_ROUND = ["render.select", "render.network", "render.composite"]


@pytest.fixture(autouse=True)
def empty_record():
    utils.clear_spans()
    yield
    utils.clear_spans()


def traced(fn):
    """Run fn under the CPU profiler -> (its result, the span events by
    name: the profiler's events whose names are the program's spans)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    events = {}
    for e in prof.events():
        if e.name.split(".")[0] in ("nerf", "image", "trainer", "render"):
            events.setdefault(e.name, []).append(e)
    return out, events


def enclosing(event, name):
    parent = event.cpu_parent
    while parent is not None and parent.name != name:
        parent = parent.cpu_parent
    return parent


def assert_no_user_annotation(events):
    assert events
    for name, evs in events.items():
        assert not any(e.is_user_annotation for e in evs), name


def test_a_span_without_a_profiler_is_the_shared_no_op():
    assert not torch._C._autograd._profiler_enabled()
    first = utils.span("nerf.step")
    assert first is utils.span("render.frame")
    with first:
        torch.ones(3).sum()
    assert utils.span_ms("nerf.step") == []
    assert utils._SPANS == {}
    # under a profiler, a span of its own, timed on the host clock here
    with profile(activities=[ProfilerActivity.CPU]):
        with utils.span("nerf.step") as s:
            assert s is not first
    (ms,) = utils.span_ms("nerf.step")
    assert ms >= 0.0


def test_the_nerf_loop_records_its_spans_nested():
    tb = make_port_tb(torch.float32)
    _, events = traced(lambda: tb.train(2))
    assert len(events["nerf.step"]) == 2
    for name in NERF_STEP:
        assert len(events[name]) == 2, name
        assert len(utils.span_ms(name)) == 2, name
        for e in events[name]:
            assert enclosing(e, "nerf.step") is not None, name
    # the warm-up's density updates and one sync at the chunk's end
    assert len(events["nerf.prep"]) == 2
    assert len(events["nerf.sync"]) == 1
    for name in ("nerf.prep", "nerf.sync"):
        assert enclosing(events[name][0], "nerf.step") is not None
    assert all(ms >= 0.0 for ms in utils.span_ms("nerf.step"))
    assert_no_user_annotation(events)


def test_the_train_steps_encodes_and_nets_record_inside_its_forward():
    """`nerf.encode` and `nerf.nets` open in train steps only, twice a step
    (position encode and density net, direction encode and RGB net): a
    density update and a frame's rounds (both through the inference
    network) record neither."""
    tb = make_port_tb(torch.float32)
    _, events = traced(lambda: tb.train(2))
    for name in ("nerf.encode", "nerf.nets"):
        assert len(events[name]) == 4, name
        assert len(utils.span_ms(name)) == 4, name
        for e in events[name]:
            assert enclosing(e, "nerf.forward") is not None, name
    assert_no_user_annotation(events)
    utils.clear_spans()
    _, events = traced(lambda: (tb.training_prep(), tb.render_frame(
        16, 12, tb.effective_xform(0))))
    assert "render.network" in events
    for name in ("nerf.encode", "nerf.nets"):
        assert name not in events and utils.span_ms(name) == [], name


def test_an_image_chunk_records_its_spans_and_the_trainers():
    tb = ImageTestbed(image(), IMAGE_CFG, device="cpu")
    _, events = traced(lambda: tb.train(2, 64))
    assert len(events["image.step"]) == len(events["image.batch"]) == 2
    assert len(events["image.sync"]) == 1
    for name in ("image.batch", "trainer.forward", "trainer.backward",
                 "trainer.optimizer"):
        assert len(events[name]) == 2, name
        assert enclosing(events[name][0], "image.step") is not None, name
    assert enclosing(events["image.sync"][0], "image.step") is None
    assert_no_user_annotation(events)


def test_a_wavefront_frame_records_its_spans():
    tb = make_port_tb(torch.float32)
    tb.train(1)
    assert tb.render_wavefront
    frame, events = traced(lambda: tb.render_frame(
        16, 12, tb.effective_xform(0)))
    assert frame.shape == (12, 16, 4) and np.isfinite(frame).all()
    assert tb.last_frame_n_samples > 0
    assert len(events["render.frame"]) == len(events["render.readback"]) \
        == len(events["render.march"]) == 1
    # every round selects; the last may find no ray left
    rounds = len(events["render.network"])
    assert rounds >= 1
    assert len(events["render.composite"]) == rounds
    assert rounds <= len(events["render.select"]) <= rounds + 1
    for name in ["render.march", "render.readback"] + RENDER_ROUND:
        assert enclosing(events[name][0], "render.frame") is not None, name
    assert len(utils.span_ms("render.network")) == rounds
    assert_no_user_annotation(events)


# -- the benchmark's readers --------------------------------------------------
RECORD = {"nerf.sample": [3.0, 5.0], "nerf.forward": [1.0, 1.0],
          "nerf.composite": [0.5, 0.5], "nerf.backward": [2.0, 2.0],
          "trainer.forward": [0.25], "trainer.backward": [0.75],
          "render.march": [40.0, 60.0], "render.network": [7.0, 8.0, 9.0],
          "render.composite": [1.5, 2.5], "nerf.encode": [0.5, 0.25],
          "nerf.nets": [0.5, 0.75]}
HOST = [("nerf.step", 0.0, 4000.0), ("nerf.sample", 100.0, 900.0),
        ("nerf.step", 5000.0, 11000.0), ("image.step", 0.0, 500.0),
        ("aten::add", 0.0, 20000.0)]
READERS = {
    "march_ms.train": (8.0 / 2),
    "forward_backward_ms.train": (7.0 + 1.0) / 2,
    "encode_ms.train": 0.75 / 2,
    "network_ms.train": 1.25 / 2,
    "march_ms.render": 100.0 / 2,
    "network_ms.render": 24.0 / 2,
    "composite_ms.render": 4.0 / 2,
    # (4 + 6 + 0.5) ms over three step intervals
    "host_ms_per_step.train": 10.5 / 3,
}


def readings(units, host):
    r = Readings()
    r.units_traced = units
    r.window = Window([], [(Interval(n, s, e), 0) for n, s, e in host],
                      0.0, 20000.0)
    return r


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_of_the_spans(monkeypatch, name):
    read = run.load_reader(name)
    monkeypatch.setattr(utils, "span_ms",
                        lambda n: list(RECORD.get(n, [])))
    assert read(readings(2, HOST)) == pytest.approx(READERS[name])
    # nothing recorded, nothing traced
    monkeypatch.setattr(utils, "span_ms", lambda n: [])
    assert read(readings(2, [("aten::add", 0.0, 10.0)])) is None
    r = readings(0, [])
    r.window = None
    assert read(r) is None
    # a program without spans
    monkeypatch.delattr(utils, "span_ms")
    assert read(readings(2, [("aten::add", 0.0, 10.0)])) is None
