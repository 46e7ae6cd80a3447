"""The plain reference against the port's CPU path at a tiny size, and
the control (the reference in float8 in the program's place) failing the
committed limits."""

import json
import os

import pytest
import torch

from conftest import ROOT, TINY

CFG = {"otype": "HashGrid", "n_levels": 4, "n_features_per_level": 4,
       "log2_hashmap_size": 10, "base_resolution": 16,
       "stochastic_exact_axes": 1, "stochastic_bwd": True}


def _pair(n_dims):
    from instant_ngp_tpu_torch.ops.factory import derive_grid_config
    from instant_ngp_tpu_torch.ops.grid_encoding import GridEncoding

    from ngp_bench.reference.grid import Grid

    port = GridEncoding.from_config(
        n_dims, derive_grid_config(CFG, n_dims, 256.0))
    ref = Grid(n_dims, CFG, 256.0)
    gen = torch.Generator().manual_seed(5)
    table = torch.rand(ref.n_entries * ref.n_features, generator=gen) - 0.5
    with torch.no_grad():
        port.params.copy_(table)
    x = torch.rand(300, n_dims, generator=gen)
    return port, ref, table, x, gen


@pytest.mark.parametrize("n_dims", [2, 3])
def test_exact_encode(n_dims):
    port, ref, table, x, _ = _pair(n_dims)
    assert ref.n_entries == port.n_entries
    with torch.no_grad():
        want = port(x)
    torch.testing.assert_close(ref.encode(table, x), want, rtol=0, atol=1e-6)


def test_exact_encode_table_gradient():
    port, ref, table, x, gen = _pair(2)
    port.params.requires_grad_(True)
    g_out = torch.rand(x.shape[0], ref.n_output, generator=gen)
    want_grad, = torch.autograd.grad(port(x), port.params, g_out)
    t = table.clone().requires_grad_(True)
    got = ref.encode_exact(t, x)
    got_grad, = torch.autograd.grad(got, t, g_out)
    torch.testing.assert_close(got, ref.encode(table, x), rtol=0, atol=1e-6)
    torch.testing.assert_close(got_grad, want_grad, rtol=0, atol=1e-5)


@pytest.mark.parametrize("j", [0, 1])
def test_stochastic_encode_and_one_corner_gradient(j):
    from instant_ngp_tpu_torch.ops.grid_encoding import draw_corner_randoms

    port, ref, table, x, gen = _pair(3)
    draws = draw_corner_randoms(gen, x.shape[0], 3, ref.n_levels, j)
    port.params.requires_grad_(True)
    g_out = torch.rand(x.shape[0], ref.n_output, generator=gen)
    out = port(x, draws=draws, exact_axes=j)
    want_grad, = torch.autograd.grad(out, port.params, g_out)
    t = table.clone().requires_grad_(True)
    got = ref.encode_stochastic(t, x, draws.u, draws.axis, j)
    got_grad, = torch.autograd.grad(got, t, g_out)
    torch.testing.assert_close(got, out.detach(), rtol=0, atol=1e-6)
    torch.testing.assert_close(got_grad, want_grad, rtol=0, atol=1e-5)


@pytest.mark.parametrize("cfg", [
    {"otype": "Composite", "nested": [
        {"n_dims_to_encode": 3, "otype": "SphericalHarmonics", "degree": 4},
        {"otype": "Identity"}]},
    {"otype": "SphericalHarmonics", "degree": 4},
    {"otype": "Identity", "scale": 2.0, "offset": -0.5},
    CFG,
])
def test_encodings_by_otype(cfg):
    from instant_ngp_tpu_torch.ops.encodings import create_encoding
    from instant_ngp_tpu_torch.ops.factory import derive_grid_config

    from ngp_bench.reference import encodings

    ref = encodings.build(3, cfg, desired_resolution=256.0)
    port = create_encoding(3, derive_grid_config(cfg, 3, 256.0))
    gen = torch.Generator().manual_seed(7)
    leaves = ref.init(gen, 0.5)
    assert len(leaves) == ref.n_leaves == len(list(port.parameters()))
    with torch.no_grad():
        for dst, src in zip(port.parameters(), leaves):
            dst.copy_(src)
        x = torch.rand(200, 3, generator=gen)
        want = port(x)
    assert ref.n_output == port.n_output_dims
    torch.testing.assert_close(ref.encode(leaves, x), want, rtol=0,
                               atol=1e-6)


def _limits(cell):
    with open(os.path.join(ROOT, "ngp_bench", "limits", cell + ".json")) as f:
        return json.load(f)


@pytest.mark.parametrize("cell", ["nerf-base-train", "image-base-train",
                                  "nerf-base-render"])
def test_control_fails_the_limits(bench, cell):
    from ngp_bench import controls, run
    from ngp_bench.harness import checks

    torch.set_num_threads(min(4, torch.get_num_threads()))
    ctx = run.Context(cell, 2 ** 31 + 11, 0, 0, "cpu", bench,
                      overrides=TINY[cell])
    got = controls.readings(ctx)
    limits = _limits(cell)
    assert not checks.passed(checks.judge(got["control"], limits)), got
