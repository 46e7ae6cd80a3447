"""The original NeRF of instant-ngp's `configs/nerf/frequency.json` (the
benchmark's configuration `nerf-frequency`, cell `nerf-frequency-train`)
on the port's NeRF path, against the benchmark's plain float32 reference
(`ngp_bench/reference/`), on the CPU:

- the frozen configuration is the resolved config file less the keys the
  `parent` merge carries into the two Frequency nodes;
- the reference's `Frequency` encoding gives the port's floats, in tcnn's
  feature order;
- the port's `NerfNetwork` at the published widths against the
  reference's `nerf_forward` on the same seeded weights;
- the cell through `run.run` at a tiny size (4 views of 48x48, 4096
  samples a step): traced with the published widths, `correct`, the new
  span metrics read; untraced with nets 32 wide, `correct`;
- planted faults in the program (cos replaced by sin, a step that leaves
  the state unchanged, half the batch left out) make `correct` false,
  with nets 32 wide; the position encoding's top octave zeroed moves each
  compared number several times over the sound run's.

A run's cost is the density updates' sweeps of all 128^3 cells through
the density net (four by the program, three by the reference), some two
minutes on four CPU threads at the published widths, so one run takes
them.

The reference replays the same three steps for every run of one seed and
configuration, so the runs here compute it once (`cached_reference`)."""

import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from instant_ngp_tpu_torch import utils
from instant_ngp_tpu_torch.config import load_network_config
from instant_ngp_tpu_torch.nerf.model import NerfNetwork
from instant_ngp_tpu_torch.ops.encodings import FrequencyEncoding
from ngp_bench import run
from ngp_bench.harness import cells, roofline, trace
from ngp_bench.harness.cells import Readings
from ngp_bench.harness.trace import Interval, Window
from ngp_bench.reference import encodings
from ngp_bench.reference import nerf as ref_nerf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "nerf-frequency-train"
SEED = 2 ** 31 + 11
TINY = {"traffic": {"views": 4, "size": 48,
                    "batch": {"samples": 4096, "rays": 256},
                    "chunk_steps": 4, "warmup_chunks": 1, "psnr_views": 1,
                    "psnr_step": 8}}
NARROW = dict(TINY, network={"network": {"n_neurons": 32,
                                         "n_hidden_layers": 2},
                             "rgb_network": {"n_neurons": 32}})
# what the parent merge of base.json carries into the Frequency nodes
GRID_KEYS = {"n_levels", "n_features_per_level", "log2_hashmap_size",
             "base_resolution", "stochastic_exact_axes", "stochastic_bwd"}


def bench():
    return run.load_json(os.path.join(ROOT, "BENCHMARK.json"))


def frozen():
    entry = run.find(bench()["configs"], "nerf-frequency", "configuration")
    return run.load_json(os.path.join(ROOT, entry["file"]))


def test_the_frozen_configuration_is_the_config_file_less_inherited_keys():
    got = frozen()["network_config"]
    want = load_network_config(os.path.join(ROOT, "configs", "nerf",
                                            "frequency.json"))
    assert set(want["encoding"]) - set(got["encoding"]) == GRID_KEYS
    assert set(want["dir_encoding"]) - set(got["dir_encoding"]) \
        == {"nested"}
    for node in ("encoding", "dir_encoding"):
        want[node] = {k: v for k, v in want[node].items()
                      if k in got[node]}
    assert got == want
    entry = run.find(bench()["configs"], "nerf-frequency", "configuration")
    assert entry["reduced"] == []
    # the published widths: 96-256x7-16 and 40-256-3, 865,792 FLOP a sample
    model = ref_nerf.NerfModel(got)
    assert model.density_dims == [(96, 256)] + [(256, 256)] * 6 \
        + [(256, 16)]
    assert model.rgb_dims == [(40, 256), (256, 3)]
    assert sum(2 * i * o for i, o in model.density_dims
               + model.rgb_dims) == 865792


@pytest.mark.parametrize("n_frequencies", [16, 4])
def test_the_reference_frequency_encoding_gives_the_ports_floats(
        n_frequencies):
    gen = torch.Generator().manual_seed(SEED)
    x = torch.cat([torch.rand(4099, 3, generator=gen),
                   torch.tensor([[0.0, 1.0, 0.5]])])
    want = FrequencyEncoding(3, n_frequencies)(x)
    got = encodings.build(3, {"otype": "Frequency",
                              "n_frequencies": n_frequencies}).encode([], x)
    assert got.shape == (x.shape[0], 3 * n_frequencies * 2)
    assert torch.equal(got, want)
    # tcnn's order: dim-major, then octave, then (sin, cos)
    row = x[7].numpy()
    for d in range(3):
        for k in range(n_frequencies):
            ang = np.float32(row[d] * np.float32(2.0 ** k)) * np.float32(
                np.pi)
            col = (d * n_frequencies + k) * 2
            assert got[7, col] == pytest.approx(np.sin(ang), abs=1e-6)
            assert got[7, col + 1] == pytest.approx(np.cos(ang), abs=1e-6)


# bf16 operands: every input, weight and hidden activation rounded to 8
# significant bits (relative error up to 2^-9) on the way through 9 layers,
# the errors adding up to about 1 % of an output column's largest value
# (1.0 % at this seed, in the density column, whose values are the
# smallest); 3 % leaves room, and a wrong input fails it by over 5x
BF16_TOL = 3e-2


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, BF16_TOL)])
def test_the_ports_network_at_the_published_widths_is_the_references(
        dtype, tol):
    cfg = frozen()["network_config"]
    model = ref_nerf.NerfModel(cfg)
    p = ref_nerf.nerf_init(model, torch.Generator().manual_seed(SEED))
    net = NerfNetwork(3, 3, 0, cfg["encoding"], cfg["dir_encoding"],
                      cfg["network"], cfg["rgb_network"],
                      compute_dtype=dtype)
    net.load_params(p.program_layout())
    gen = torch.Generator().manual_seed(SEED + 1)
    pos, dirs = torch.rand(64, 3, generator=gen), torch.rand(64, 3,
                                                             generator=gen)
    with torch.no_grad():
        got = net.apply_components(pos, dirs)
    want = ref_nerf.nerf_forward(p, model.pos.encode(p.pos, pos), dirs)
    scale = want.abs().amax(dim=0)
    assert ((got - want).abs() / scale).max() < tol
    # a wrong answer: the direction features in the wrong order
    wrong = ref_nerf.nerf_forward(p, model.pos.encode(p.pos, pos),
                                  dirs.flip(-1))
    assert ((wrong - want).abs() / scale).max() > 5 * BF16_TOL


_REFERENCE = {}


@pytest.fixture
def cached_reference(monkeypatch):
    """The nerf_train driver with its reference replay computed once per
    seed, configuration, batch and precision (it reads nothing of the
    program, so a fault planted there leaves it as it is)."""
    load = run.load_driver

    def load_cached(name):
        module = load(name)
        replay = module.reference_readings

        def cached(data, net_cfg, p0, seed, batch, prec, drop_half=False):
            key = (json.dumps(net_cfg, sort_keys=True), seed,
                   json.dumps(batch, sort_keys=True),
                   tuple(data.pixels.shape), prec.dtype, drop_half)
            if key not in _REFERENCE:
                _REFERENCE[key] = replay(data, net_cfg, p0, seed, batch,
                                         prec, drop_half)
            return _REFERENCE[key]
        module.reference_readings = cached
        return module
    monkeypatch.setattr(run, "load_driver", load_cached)
    torch.set_num_threads(min(4, torch.get_num_threads()))


def tiny_run(overrides, traced=0):
    ctx = run.Context(CELL, SEED, 0.5, traced, "cpu", bench(),
                      overrides=overrides)
    return run.run(ctx)


class CpuProfiled(trace.Profiled):
    """The traced chunk under the CPU profiler, so that the program's spans
    record (host milliseconds) in a CPU run; no kernel runs, so the window
    has no device interval."""

    def __enter__(self):
        self._prof = profile(activities=[ProfilerActivity.CPU])
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        self._prof.__exit__(*exc)
        return False

    def read(self):
        if self.window is None:
            self.window = trace._window_from(self._prof)
        return self.window


def test_the_cell_runs_correct_at_the_published_widths(cached_reference,
                                                       monkeypatch):
    monkeypatch.setattr(cells, "Profiled", CpuProfiled)
    utils.clear_spans()
    line = tiny_run(TINY, traced=1)
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0
    got = {k: v["value"] for k, v in line["metrics"].items()}
    # the spans nest inside the step's forward; the roofline reads kernels,
    # of which a CPU run has none (the reader's test is below)
    assert got["encode_ms.train"] > 0.0 and got["network_ms.train"] > 0.0
    assert got["encode_ms.train"] + got["network_ms.train"] \
        < got["forward_backward_ms.train"]
    assert "mlp_roofline.train" not in got
    utils.clear_spans()


def test_the_nets_roofline_reads_the_gemm_kernels_alone():
    with open(os.path.join(ROOT, "ngp_bench", "metrics",
                           "mlp_roofline.train.txt")) as f:
        names = [n.strip() for n in f if n.strip()]
    r = Readings()
    r.units_traced, r.flops_per_unit = 16, 3.0 * 262144 * 865792
    gemm_us = 1000.0
    device = [Interval(n, 0.0, gemm_us / len(names)) for n in names]
    # the density update's fused MLP kernels and elementwise work do not
    # count
    device += [Interval(n, 0.0, 5000.0) for n in (
        "fused_mlp_wgmma_kernel", "fused_mlp_mma_kernel",
        "void at::native::vectorized_elementwise_kernel")]
    r.window = Window(device, [], 0.0, 1e5)
    bound_s = r.flops_per_unit * 16 / roofline.BF16_FLOP_PER_S
    read = run.load_reader("mlp_roofline.train")
    assert read(r) == pytest.approx(100.0 * bound_s / (gemm_us / 1e6))
    r.window = Window(device[len(names):], [], 0.0, 1e5)
    assert read(r) is None


def _top_octave_zeroed(monkeypatch):
    original = FrequencyEncoding.forward

    def forward(self, x):
        out = original(self, x)
        if self.n_frequencies != 16:
            return out
        out = out.view(*x.shape[:-1], self.n_dims, 16, 2).clone()
        out[..., -1, :] = 0.0
        return out.view(*x.shape[:-1], self.n_output_dims)
    monkeypatch.setattr(FrequencyEncoding, "forward", forward)


def _cos_replaced_by_sin(monkeypatch):
    def forward(self, x):
        freqs = torch.exp2(torch.arange(self.n_frequencies, dtype=x.dtype,
                                        device=x.device)) * torch.pi
        ang = x[..., :, None] * freqs
        return torch.stack([torch.sin(ang), torch.sin(ang)],
                           dim=-1).reshape(*x.shape[:-1], self.n_output_dims)
    monkeypatch.setattr(FrequencyEncoding, "forward", forward)


def _unchanged_state(monkeypatch):
    from instant_ngp_tpu_torch.ops import optimizers

    monkeypatch.setattr(optimizers.Optimizer, "step",
                        lambda self, state, params, grads, l2_mask=None:
                        (params, state))


def _half_batch(monkeypatch):
    from instant_ngp_tpu_torch.nerf import training

    original = training.composite_loss

    def half(raw, samples, ts, dts, rays, *args, **kwargs):
        n = rays.valid.shape[0]
        keep = torch.arange(n, device=rays.valid.device) < n // 2
        res = original(raw, samples, ts, dts,
                       rays._replace(valid=rays.valid & keep), *args,
                       **kwargs)
        return res._replace(loss_for_grad=res.loss_for_grad * 2.0,
                            per_ray_loss=res.per_ray_loss * 2.0)
    monkeypatch.setattr(training, "composite_loss", half)


_SOUND = {}


def sound_narrow_run():
    if not _SOUND:
        _SOUND.update(tiny_run(NARROW))
    return _SOUND


@pytest.mark.parametrize("fault", [None, _cos_replaced_by_sin,
                                   _unchanged_state, _half_batch])
def test_a_fault_makes_the_run_incorrect(cached_reference, monkeypatch,
                                         fault):
    if fault is None:
        line = sound_narrow_run()
    else:
        fault(monkeypatch)
        line = tiny_run(NARROW)
    # the sound run at these widths passes, so each fault's failure is its
    # own
    assert line["correct"] is (fault is None), line["checks"]
    if fault is None:
        assert line["attempted"] > 0
        assert line["metrics"]["train_steps_per_s"]["value"] > 0.0
        assert "train_psnr_db" in line["metrics"]


def test_the_top_octave_zeroed_moves_every_number(cached_reference,
                                                  monkeypatch):
    """Six of the 96 position features zeroed: each compared number comes
    out at least 3x the sound run's at the same seed. The cell's limits
    stand over the tail that bf16 against float32 gives across seeds on
    the card (PERF.md), and this fault's readings lie inside that tail, so
    they do not decide `correct` here."""
    sound = sound_narrow_run()["checks"]
    _top_octave_zeroed(monkeypatch)
    got = tiny_run(NARROW)["checks"]
    for name, c in sound.items():
        assert got[name]["value"] > 3.0 * c["value"], name
