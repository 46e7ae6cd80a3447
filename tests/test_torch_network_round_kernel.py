"""The wavefront renderer's RGB-net input rows (csrc/nerf_network_round.cu,
ops/kernels/round_kernels.py) against the plain round, and the round's
dispatch.

On the card (tests marked `cuda`, skipped without one): the kernel's rows
[density outputs | SH degree 4 of the ray's direction] and raw density
column equal the plain round's, run on the same CUDA tensors, bit for bit,
for axis-aligned directions, components of +0 and -0, random unit
directions, 1, 7 and 32 samples a ray, row counts that are not multiples of
the block and blocks of rows (a query budget's calls) that start inside a
ray; Shade, Depth and AO frames through `render_frame` equal the plain
round's, with the default query budget and with one that splits rays. The
file imports no JAX:

    python -m pytest --noconftest -q tests/test_torch_network_round_kernel.py

On the CPU: the dispatch sends Frequency directions, latent dims, float32
nets, grad mode and CPU tensors on to `apply_components`; the round's
orchestration (its blocks of rows, their offsets, the outputs written in
place) with the kernel's plain rows in its place gives the plain round's
outputs, and Depth and AO frames; the kernel's arithmetic, restated in numpy term by term, gives the
plain rows; the wrapper rejects CPU tensors, a wrong dtype or width and
non-contiguous inputs; an MLP writes its inference output into a given
`out` (the round's blocks of rgb) and rejects one it cannot write.
"""

import types

import numpy as np
import pytest
import torch

from instant_ngp_tpu_torch.config import (find_network_config,
                                          load_network_config)
from instant_ngp_tpu_torch.nerf import render
from instant_ngp_tpu_torch.nerf.dataset import scene_config
from instant_ngp_tpu_torch.nerf.model import NerfNetwork
from instant_ngp_tpu_torch.nerf.occupancy import shell_bitfield
from instant_ngp_tpu_torch.ops.kernels import round_kernels
from instant_ngp_tpu_torch.ops.kernels.round_kernels import (
    rgb_net_rows, rgb_net_rows_plain)

CAM = np.array([[1, 0, 0, 0.5], [0, 1, 0, 0.5], [0, 0, 1, -0.4]], np.float32)


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _dirs(n, seed):
    """(n, 3) f32 unit directions: the six axes, axes with -0 and +0 in
    the other components, diagonals, then random ones."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    special = np.array([
        [1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1],
        [-0.0, -0.0, 1], [1, -0.0, 0], [-0.0, -1, -0.0], [0, -0.0, -1],
        [0.5773502691896258] * 3, [-0.5773502691896258] * 3,
        [0.7071067811865476, -0.7071067811865476, -0.0]])
    m = min(n, len(special))
    d[:m] = special[:m]
    return d.astype(np.float32)


def _same_bits(a, b):
    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


# ======================================================================
# on the card
# ======================================================================
@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 7, 32])
@pytest.mark.parametrize("n_rays", [13, 1000])
def test_kernel_rows_equal_the_plain_rows(device, k, n_rays):
    dirs = torch.from_numpy(_dirs(n_rays, seed=k)).to(device)
    gen = torch.Generator(device).manual_seed(n_rays + k)
    n = n_rays * k
    density = torch.randn(n, 16, generator=gen, device=device)
    before = rgb_net_rows.launches
    raw = torch.full((n,), float("nan"), device=device)
    rows = rgb_net_rows(density, dirs, k, raw_density=raw)
    assert rgb_net_rows.launches == before + 1
    assert _same_bits(rows, rgb_net_rows_plain(density, dirs, k))
    assert _same_bits(raw, density[:, 0])
    # a query budget's blocks of rows, each starting where the last
    # stopped, at offsets inside a ray, writing its block of the raw
    # density
    step = 5 if k > 1 else 3
    raw.fill_(float("nan"))
    blocks = [rgb_net_rows(density[i:i + step], dirs, k, i,
                           raw_density=raw[i:i + step])
              for i in range(0, n, step)]
    assert _same_bits(torch.cat(blocks), rgb_net_rows_plain(density, dirs, k))
    assert _same_bits(raw, density[:, 0])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 31, 33, 100003])
def test_kernel_at_ragged_row_counts(device, n):
    k = 7
    n_rays = (n + k - 1) // k + 2
    dirs = torch.from_numpy(_dirs(n_rays, seed=n)).to(device)
    density = torch.randn(n, 16, device=device)
    for row0 in (0, 3, n_rays * k - n):
        assert _same_bits(rgb_net_rows(density, dirs, k, row0),
                          rgb_net_rows_plain(density, dirs, k, row0))


def _testbed(device):
    from instant_ngp_tpu_torch.nerf.testbed_nerf import NerfTestbed

    cfg = load_network_config(find_network_config("base", "nerf"))
    tb = NerfTestbed(scene_config(1), cfg, device=device, seed=3)
    model = tb.model
    # a table of U(-1, 1), so that densities are of order 1 and rays
    # terminate on the shell
    table = np.random.default_rng(3).uniform(
        -1.0, 1.0, model.pos_encoding.params.numel()).astype(np.float32)
    tb.load_params({"pos_encoding": table,
                    "density_net": [w.detach().cpu().numpy()
                                    for w in model.density_net.weights],
                    "dir_encoding": {},
                    "rgb_net": [w.detach().cpu().numpy()
                                for w in model.rgb_net.weights]})
    tb.bitfield = shell_bitfield(device)
    return tb


def _plain_round(monkeypatch):
    monkeypatch.setattr(render, "_round_takes_rows_kernel",
                        lambda model, pos: False)


@pytest.mark.cuda
@pytest.mark.parametrize("budget", [2 << 20, 999])
@pytest.mark.parametrize("mode", ["Shade", "Depth", "AO"])
def test_frame_equals_the_plain_frame(device, mode, budget, monkeypatch):
    tb = _testbed(device)
    tb.render_query_budget = budget
    kw = dict(focal_length=90.0, render_mode=mode)
    before = rgb_net_rows.launches
    frame = tb.render_frame(96, 80, CAM, **kw)
    n_kernel = tb.last_frame_n_samples
    assert rgb_net_rows.launches > before
    assert n_kernel > 0
    with monkeypatch.context() as m:
        _plain_round(m)
        before = rgb_net_rows.launches
        plain = tb.render_frame(96, 80, CAM, **kw)
        assert rgb_net_rows.launches == before
    assert tb.last_frame_n_samples == n_kernel
    np.testing.assert_array_equal(frame, plain)


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(device):
    d = torch.from_numpy(_dirs(8, seed=0)).to(device)
    x = torch.randn(40, 16, device=device)
    with pytest.raises(ValueError, match="no kernel for cpu"):
        rgb_net_rows(x.cpu(), d.cpu(), 5)
    with pytest.raises(ValueError, match="on cpu"):
        rgb_net_rows(x, d.cpu(), 5)
    with pytest.raises(ValueError, match="torch.float64"):
        rgb_net_rows(x.double(), d, 5)
    with pytest.raises(ValueError, match="shape"):
        rgb_net_rows(torch.randn(40, 17, device=device), d, 5)
    with pytest.raises(ValueError, match="contiguous"):
        rgb_net_rows(torch.randn(16, 40, device=device).t(), d, 5)
    with pytest.raises(ValueError, match="rows"):
        rgb_net_rows(x, d, 5, row_offset=1)
    with pytest.raises(ValueError, match="aligned"):
        rgb_net_rows(torch.randn(41 * 16, device=device)[1:1 + 640]
                     .view(40, 16), d, 5)
    with pytest.raises(ValueError, match="raw_density"):
        rgb_net_rows(x, d, 5, raw_density=torch.empty(40, device=device)
                     .double())


# ======================================================================
# on the CPU
# ======================================================================
def _network(name, n_extra=0, compute_dtype=torch.bfloat16):
    cfg = load_network_config(find_network_config(name, "nerf"))
    return NerfNetwork(3, 3, n_extra, cfg["encoding"], cfg["dir_encoding"],
                       cfg["network"], cfg["rgb_network"],
                       compute_dtype=compute_dtype)


ON_CARD = types.SimpleNamespace(device=torch.device("cuda"))


def test_dispatch_takes_the_kernel_for_sh4_alone():
    with torch.no_grad():
        assert render._round_takes_rows_kernel(_network("base"), ON_CARD)


@pytest.mark.parametrize("case", ["frequency", "latent", "float32", "grad",
                                  "cpu"])
def test_dispatch_sends_the_rest_to_apply_components(case):
    model = _network(
        "frequency" if case == "frequency" else "base",
        n_extra=4 if case == "latent" else 0,
        compute_dtype=torch.float32 if case == "float32" else torch.bfloat16)
    pos = torch.zeros(4, 3) if case == "cpu" else ON_CARD
    with torch.set_grad_enabled(case == "grad"):
        assert not render._round_takes_rows_kernel(model, pos)


def _rows_on_cpu(calls):
    """The kernel's plain rows in the kernel's place, on CPU tensors."""
    def rows(density_out, ray_dirs, k, row0, raw_density):
        calls.append(row0)
        raw_density.copy_(density_out[:, 0])
        return rgb_net_rows_plain(density_out, ray_dirs, k, row0)
    return rows


def test_the_rounds_outputs_with_plain_rows_are_the_plain_outputs(
        monkeypatch):
    """`_eval_network_rows`' blocks of rows, their offsets and its outputs
    written in place, on the CPU, with the kernel's plain rows standing in
    for the kernel, at a query budget that splits rays."""
    model = _network("base")
    gen = torch.Generator().manual_seed(0)
    model.init_params(gen)
    k, n_rays, step = 32, 40, 1001
    pos = torch.rand(n_rays * k, 3, generator=gen)
    dirs = torch.from_numpy(_dirs(n_rays, seed=1))
    dirw = ((dirs + 1.0) * 0.5)[:, None, :].expand(-1, k, -1).reshape(-1, 3)
    calls = []
    monkeypatch.setattr(round_kernels, "rgb_net_rows", _rows_on_cpu(calls))
    with torch.no_grad():
        raw = render._eval_network(model, pos, dirw, None, step, None)
        rgb, density = render._eval_network_rows(model, pos, dirs, k, step,
                                                 None)
    assert calls == list(range(0, n_rays * k, step))
    assert _same_bits(rgb, raw[:, :3]) and _same_bits(density, raw[:, 3])


@pytest.mark.parametrize("mode", ["Depth", "AO"])
def test_the_round_with_plain_rows_gives_the_plain_frame(mode, monkeypatch):
    """The same through `render_frame` (Depth and AO: a Shade frame's
    sigmoid rounds differently on the CPU for a strided and a contiguous
    tensor, its vectorized and its scalar loop; on the card the card
    test compares Shade too)."""
    tb = _testbed("cpu")
    tb.render_query_budget = 1001
    kw = dict(focal_length=20.0, render_mode=mode)
    plain = tb.render_frame(24, 20, CAM, **kw)
    calls = []
    monkeypatch.setattr(render, "_round_takes_rows_kernel",
                        lambda model, pos: model.rgb_input_is_density_and_sh4())
    monkeypatch.setattr(round_kernels, "rgb_net_rows", _rows_on_cpu(calls))
    frame = tb.render_frame(24, 20, CAM, **kw)
    assert len(calls) > 2 and any(r % 32 for r in calls)
    np.testing.assert_array_equal(frame, plain)


@pytest.mark.parametrize("case", ["written", "shape", "dtype", "strided",
                                  "misaligned", "grad", "float32"])
def test_an_mlps_out_is_the_inference_paths(case):
    """`MLP.forward(x, out=)` writes the inference path's output into
    `out` (here the plain version's, on the CPU) and rejects an `out` the
    kernels cannot write, or one on another path."""
    from instant_ngp_tpu_torch.ops.mlp import MLP

    cfg = load_network_config(find_network_config("base", "nerf"))
    net = MLP.from_config(32, 16, cfg["network"], compute_dtype=(
        torch.float32 if case == "float32" else torch.bfloat16))
    net.init_params(torch.Generator().manual_seed(0))
    x = torch.randn(10, 32)
    buf = torch.full((11 * 16,), float("nan"))
    out = {"shape": torch.empty(10, 3), "dtype": torch.empty(10, 16).double(),
           "strided": torch.empty(16, 10).t(),
           "misaligned": buf[1:161].view(10, 16)}.get(case, buf[:160]
                                                      .view(10, 16))
    if case == "grad":
        net.requires_grad_(True)
    with torch.set_grad_enabled(case == "grad"):
        if case != "written":
            with pytest.raises(ValueError, match="out"):
                net(x, out=out)
            return
        got = net(x, out=out)
    assert got.data_ptr() == out.data_ptr()
    with torch.no_grad():
        assert _same_bits(out, net(x))


def test_the_kernels_arithmetic_gives_the_plain_rows():
    """csrc/nerf_network_round.cu's sh_quarter and unwarp, restated in
    numpy float32 (each product, sum and difference rounded once, each
    constant the float32 of the Python number)."""
    f = np.float32

    def c(v):
        return f(v)

    k, n_rays = 7, 3001
    d = _dirs(n_rays, seed=5)
    density = np.random.default_rng(5).normal(
        size=(n_rays * k, 16)).astype(f)
    for row0, n in ((0, n_rays * k), (3, 1000), (11, n_rays * k - 20)):
        u = ((d[(row0 + np.arange(n)) // k] + f(1)) * f(0.5)) * f(2) - f(1)
        x, y, z = u[:, 0], u[:, 1], u[:, 2]
        x2, y2, z2 = x * x, y * y, z * z
        one_5z2 = f(1) - f(5) * z2
        sh = np.stack([
            np.full_like(x, c(0.28209479177387814)),
            c(-0.48860251190291987) * y, c(0.48860251190291987) * z,
            c(-0.48860251190291987) * x,
            c(1.0925484305920792) * (x * y),
            c(-1.0925484305920792) * (y * z),
            c(0.94617469575755997) * z2 - c(0.31539156525251999),
            c(-1.0925484305920792) * (x * z),
            c(0.54627421529603959) * x2 - c(0.54627421529603959) * y2,
            (c(0.59004358992664352) * y) * (f(-3) * x2 + y2),
            ((c(2.8906114426405538) * x) * y) * z,
            (c(0.45704579946446572) * y) * one_5z2,
            (c(0.3731763325901154) * z) * (f(5) * z2 - f(3)),
            (c(0.45704579946446572) * x) * one_5z2,
            (c(1.4453057213202769) * z) * (x2 - y2),
            (c(0.59004358992664352) * x) * (-x2 + f(3) * y2)], axis=-1)
        ours = np.concatenate([density[:n], sh], axis=-1)
        plain = rgb_net_rows_plain(torch.from_numpy(density[:n]),
                                   torch.from_numpy(d), k, row0).numpy()
        np.testing.assert_array_equal(ours.view(np.int32),
                                      plain.view(np.int32))


def test_wrapper_rejects_cpu_tensors_and_wrong_inputs():
    d = torch.from_numpy(_dirs(8, seed=0))
    x = torch.randn(40, 16)
    with pytest.raises(ValueError, match="no kernel for cpu"):
        rgb_net_rows(x, d, 5)
    with pytest.raises(ValueError, match="torch.float64"):
        rgb_net_rows(x.double(), d, 5)
    with pytest.raises(ValueError, match="torch.float16"):
        rgb_net_rows(x, d.half(), 5)
    with pytest.raises(ValueError, match="shape"):
        rgb_net_rows(torch.randn(40, 32), d, 5)
    with pytest.raises(ValueError, match="shape"):
        rgb_net_rows(x, torch.randn(8, 4), 5)
    with pytest.raises(ValueError, match="contiguous"):
        rgb_net_rows(torch.randn(16, 40).t(), d, 5)
    with pytest.raises(ValueError, match="contiguous"):
        rgb_net_rows(x, torch.randn(3, 8).t(), 5)
    with pytest.raises(ValueError, match="rows"):
        rgb_net_rows(x, d, 4)
    with pytest.raises(ValueError, match="shape"):
        rgb_net_rows(x, d, 5, raw_density=torch.empty(40, 1))
