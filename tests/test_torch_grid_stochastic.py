"""The port's stochastic-corner grid encode against the JAX package's
(`GridEncoding.apply_components(rng=...)`), VALUE FOR VALUE: the uniforms
and the axis picks that the JAX encode draws from its key (`split(rng,
d + 1)`, one `uniform` per axis, one `randint`) are made here with the same
calls and handed to the port as `CornerDraws`, so both sides fetch the same
corners. Forward and table gradient, for every number of exact axes j, with
and without the one-corner backward, Hash / Dense / Tiled grids x Linear /
Smoothstep, with and without `max_level`, in 2D and 3D: rtol 1e-5, atol
1e-6 (a few float32 products and sums in another order; the table gradient
sums up to a few hundred deposits per entry, so its atol is 1e-5 as in
tests/test_torch_grid_backward.py).

A sampled corner is the comparison `u < w` of a supplied uniform with a
weight computed in float32. The two sides may round `x * scale + 0.5`
differently (one may contract it into a fused multiply-add), so a `u`
within 1e-5 of its `w` could pick another corner on one side. The test
moves the POINT, not the tolerance: any point that has such a draw at some
level is redrawn until none has (`_points_clear_of_draws`).

The estimator's own statistics are checked with the port's generator: the
mean of 4096 draws lies within 4 standard errors of the exact encode."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from torch_parity import jax_corner_draws  # noqa: E402

from instant_ngp_tpu.ops.grid_encoding import GridEncoding as JaxGrid
from instant_ngp_tpu_torch.ops.grid_encoding import (CornerDraws,
                                                     GridEncoding,
                                                     draw_corner_randoms)

KW = dict(n_levels=4, n_features_per_level=2, log2_hashmap_size=10,
          base_resolution=4, per_level_scale=2.0)
N = 400


def _weights(enc, x):
    """(L, N, d) float32 upper-corner weights, computed with numpy."""
    out = []
    for scale, *_ in enc.levels:
        pos = x * np.float32(scale) + np.float32(0.5)
        w = pos - np.floor(pos)
        if enc.interpolation == "Smoothstep":
            w = w * w * (3.0 - 2.0 * w)
        out.append(w.astype(np.float32))
    return np.stack(out)


def _points_clear_of_draws(enc, draws, rng, n, n_dims, margin=1e-5):
    x = rng.uniform(-0.05, 1.05, (n, n_dims)).astype(np.float32)
    u = draws.u.numpy().transpose(2, 1, 0)                    # (L, N, d)
    for _ in range(100):
        close = (np.abs(_weights(enc, x) - u) < margin).any(axis=(0, 2))
        if not close.any():
            return x
        x[close] = rng.uniform(-0.05, 1.05, (int(close.sum()), n_dims))
    raise AssertionError("could not move the points off the draws")


def _case(n_dims, grid_type, interpolation, j, bwd, seed=0):
    rng = np.random.default_rng(11 + seed + n_dims + len(grid_type)
                                + len(interpolation) + 7 * j)
    kw = dict(KW, n_dims=n_dims, grid_type=grid_type,
              interpolation=interpolation, stochastic_exact_axes=j,
              stochastic_bwd=bwd)
    jax_enc, enc = JaxGrid(**kw), GridEncoding(**kw)
    table = rng.uniform(-1.0, 1.0, enc.n_params).astype(np.float32)
    with torch.no_grad():
        enc.params.copy_(torch.from_numpy(table))
    key = jax.random.PRNGKey(100 + seed)
    draws = jax_corner_draws(key, N, n_dims, enc.n_levels)
    x = _points_clear_of_draws(enc, draws, rng, N, n_dims)
    cot = rng.normal(size=(N, enc.n_output_dims)).astype(np.float32)
    return jax_enc, enc, table, x, cot, key, draws


CASES = [(d, j) for d in (2, 3) for j in range(d)]


@pytest.mark.parametrize("max_level", [None, 1])
@pytest.mark.parametrize("bwd", [False, True], ids=["allcorners",
                                                    "onecorner"])
@pytest.mark.parametrize("interpolation", ["Linear", "Smoothstep"])
@pytest.mark.parametrize("grid_type", ["Hash", "Dense", "Tiled"])
@pytest.mark.parametrize("n_dims, j", CASES,
                         ids=[f"{d}d-j{j}" for d, j in CASES])
def test_stochastic_encode_matches_jax_value_for_value(
        n_dims, j, grid_type, interpolation, bwd, max_level):
    jax_enc, enc, table, x, cot, key, draws = _case(
        n_dims, grid_type, interpolation, j, bwd)
    comps = [jnp.asarray(x[:, k]) for k in range(n_dims)]

    def jax_out(t):
        return jax_enc.apply_components(t, comps, max_level=max_level,
                                        rng=key)

    ref = np.asarray(jax_out(jnp.asarray(table)))
    ref_grad = np.asarray(jax.grad(lambda t: jnp.sum(
        jax_out(t) * jnp.asarray(cot)))(jnp.asarray(table)))

    xt, ct = torch.from_numpy(x), torch.from_numpy(cot)
    with torch.no_grad():
        plain = enc(xt, max_level=max_level, draws=draws)
    enc.params.requires_grad_(True)
    out = enc(xt, max_level=max_level, draws=draws)
    assert "Stochastic" in type(out.grad_fn).__name__
    assert torch.equal(out.detach(), plain)
    (grad,) = torch.autograd.grad((out * ct).sum(), enc.params)

    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=1e-5,
                               atol=1e-6)
    assert np.abs(ref_grad).max() > 0.1
    np.testing.assert_allclose(grad.numpy(), ref_grad, rtol=1e-5, atol=1e-5)
    # the estimator is not the exact encode
    with torch.no_grad():
        exact = enc(xt, max_level=max_level)
    assert (exact - plain).abs().max() > 1e-2
    if max_level is not None:
        first_off = enc.levels[max_level + 1][3] * enc.n_features_per_level
        assert (grad[first_off:] == 0).all()
        assert (plain[:, (max_level + 1) * 2:] == 0).all()


def test_exact_axes_argument_overrides_the_configuration():
    """The density update asks for j = 0 on an encoding configured with
    j = 1 (and the JAX side does the same with `exact_axes=0`)."""
    jax_enc, enc, table, x, _, key, draws = _case(3, "Hash", "Linear", 1,
                                                  True)
    ref = np.asarray(jax_enc.apply_components(
        jnp.asarray(table), [jnp.asarray(x[:, k]) for k in range(3)],
        rng=key, exact_axes=0))
    with torch.no_grad():
        out = enc(torch.from_numpy(x), draws=draws, exact_axes=0)
        j1 = enc(torch.from_numpy(x), draws=draws)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)
    assert (out - j1).abs().max() > 1e-2
    with pytest.raises(ValueError, match="exact_axes"):
        enc(torch.from_numpy(x), draws=draws, exact_axes=3)


@pytest.mark.parametrize("bwd", [False, True], ids=["allcorners",
                                                    "onecorner"])
@pytest.mark.parametrize("j", [0, 1, 2])
def test_which_entries_receive_the_deposit(j, bwd):
    """One point, one level, a one-hot cotangent and a table of distinct
    integers: the forward's value names the corners it fetched (with their
    weights), and the gradient shows which entries received what.
    - all-corner backward: exactly the fetched corners, each with its
      forward weight;
    - one-corner backward (j > 0): ONE entry, the fully sampled corner,
      with weight 1, which for j = 2 is one of the forward's 4 corners and
      for j = 1 one of its 2 (the draw on the exact axis picks which)."""
    enc = GridEncoding(n_dims=3, n_levels=1, n_features_per_level=2,
                       log2_hashmap_size=12, base_resolution=8,
                       grid_type="Dense", stochastic_exact_axes=j,
                       stochastic_bwd=bwd)
    res = enc.levels[0][1]
    assert res == 8
    with torch.no_grad():
        enc.params.copy_(torch.arange(enc.n_params, dtype=torch.float32))
    enc.params.requires_grad_(True)
    # pos = x * 7 + 0.5 = (2.25, 3.5, 4.75): lower corner (2, 3, 4)
    x = torch.tensor([[1.75 / 7, 3.0 / 7, 4.25 / 7]])
    w = np.array([0.25, 0.5, 0.75])
    u = torch.tensor([0.1, 0.9, 0.6]).reshape(3, 1, 1)   # bits (1, 0, 1)
    bern = np.array([1, 0, 1])

    def entry(bits):
        c = np.array([2, 3, 4]) + bits
        return int(c[0] + c[1] * res + c[2] * res * res)

    for a in range(3):
        draws = CornerDraws(u, torch.full((1, 1), a))
        out = enc(x, draws=draws)
        (grad,) = torch.autograd.grad(out[0, 0], enc.params)
        got = {int(i) // 2: float(grad[i]) for i in torch.nonzero(grad)[:, 0]}
        # the corners the estimator must fetch, by hand
        if j == 0:
            want = {entry(bern): 1.0}
        elif j == 1:
            want = {}
            for bit in (0, 1):
                bits = bern.copy()
                bits[a] = bit
                want[entry(bits)] = w[a] if bit else 1 - w[a]
        else:
            want = {}
            e1, e2 = (a + 1) % 3, (a + 2) % 3   # bit 0, bit 1
            for combo in range(4):
                bits = bern.copy()
                bits[e1], bits[e2] = combo & 1, combo >> 1
                wt = (w[e1] if bits[e1] else 1 - w[e1]) \
                    * (w[e2] if bits[e2] else 1 - w[e2])
                want[entry(bits)] = wt
        value = sum(2 * e * wt for e, wt in want.items())   # feature 0 = 2e
        np.testing.assert_allclose(out[0, 0].item(), value, rtol=1e-6)
        if bwd and j > 0:
            assert got == {entry(bern): 1.0}, (a, got)
            assert entry(bern) in want
        else:
            assert got.keys() == want.keys(), (a, got, want)
            for e, wt in want.items():
                np.testing.assert_allclose(got[e], wt, rtol=1e-6)
        if j == 0:
            break                  # the axis pick is not used


def test_input_gradient_is_zero_by_design():
    _, enc, _, x, cot, _, draws = _case(3, "Hash", "Linear", 1, True)
    enc.params.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = enc(xt, draws=draws)
    g_table, g_x = torch.autograd.grad((out * torch.from_numpy(cot)).sum(),
                                       (enc.params, xt))
    assert g_table.abs().max() > 0 and g_x.shape == xt.shape
    assert (g_x == 0).all()
    # and with a frozen table the estimator is a plain function
    enc.params.requires_grad_(False)
    assert enc(xt, draws=draws).grad_fn is None


@pytest.mark.parametrize("interpolation", ["Linear", "Smoothstep"])
@pytest.mark.parametrize("n_dims, j", CASES,
                         ids=[f"{d}d-j{j}" for d, j in CASES])
def test_mean_of_generator_draws_is_the_exact_encode(n_dims, j,
                                                     interpolation):
    """4096 draws of the port's own generator per point: the mean of the
    estimates lies within 4 standard errors of the exact encode (plus 1e-6
    for the float32 mean itself; with ~200 comparisons a seed fails this
    by chance about once in a hundred, and the seed is fixed), forward
    and, through a linear loss, the
    table gradient under both backward rules."""
    n_pts, n_draws = 24, 4096
    enc = GridEncoding(n_dims=n_dims, interpolation=interpolation,
                       stochastic_exact_axes=j, stochastic_bwd=True, **KW)
    rng = np.random.default_rng(3)
    with torch.no_grad():
        enc.params.copy_(torch.from_numpy(
            rng.uniform(-1, 1, enc.n_params).astype(np.float32)))
    # points whose weights are in [0.1, 0.9] at every level: a corner of
    # probability 1e-4 would never be drawn, and the sample's standard
    # error would say 0
    cand = rng.uniform(0.02, 0.98, (4000, n_dims)).astype(np.float32)
    frac = np.stack([np.mod(cand * np.float32(s) + 0.5, 1.0)
                     for s, *_ in enc.levels])
    keep = ((frac > 0.1) & (frac < 0.9)).all(axis=(0, 2))
    assert keep.sum() >= n_pts
    x = torch.from_numpy(cand[keep][:n_pts])
    gen = torch.Generator().manual_seed(18)
    draws = draw_corner_randoms(gen, n_pts * n_draws, n_dims, enc.n_levels,
                                j)
    assert draws.u.shape == (n_dims, n_pts * n_draws, enc.n_levels)
    assert (draws.axis is None) == (j == 0)
    xr = x.repeat_interleave(n_draws, dim=0)
    with torch.no_grad():
        exact = enc(x)
        est = enc(xr, draws=draws).view(n_pts, n_draws, -1).double()
    mean, sem = est.mean(dim=1), est.std(dim=1) / np.sqrt(n_draws)
    assert (sem > 0).any()
    assert ((mean - exact.double()).abs() <= 4 * sem + 1e-6).all()

    # the table gradient of sum(out * c): linear in the deposits, so its
    # mean over draws is the exact gradient; both backward rules
    cot = torch.from_numpy(rng.normal(size=(n_pts, enc.n_output_dims))
                           .astype(np.float32))
    enc.params.requires_grad_(True)
    (g_exact,) = torch.autograd.grad((enc(x) * cot).sum(), enc.params)
    cr = cot.repeat_interleave(n_draws, dim=0)
    for bwd in (False, True):
        enc.stochastic_bwd = bwd
        (g,) = torch.autograd.grad((enc(xr, draws=draws) * cr).sum(),
                                   enc.params)
        g = g / n_draws
        # a deposit is at most |c| in size; 24 points share the entries
        bound = 4 * cot.abs().max().item() * np.sqrt(n_pts / n_draws)
        assert (g - g_exact).abs().max() <= bound
        assert (g - g_exact).abs().mean() <= bound / 20


def test_generator_draws_differ_between_calls_and_follow_the_seed():
    enc = GridEncoding(n_dims=3, stochastic_exact_axes=1, **KW)
    enc.init_params(torch.Generator().manual_seed(0))
    x = torch.rand(50, 3, generator=torch.Generator().manual_seed(1))
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad():
        a, b = enc(x, generator=gen), enc(x, generator=gen)
        c = enc(x, generator=torch.Generator().manual_seed(2))
    assert not torch.equal(a, b) and torch.equal(a, c)
    rows = draw_corner_randoms(gen, 10, 3, 4).rows(2, 5)
    assert rows.u.shape == (3, 3, 4) and rows.axis.shape == (3, 4)


def test_configuration_keys_reach_the_encoding():
    from instant_ngp_tpu_torch.config import (find_network_config,
                                              load_network_config)
    from instant_ngp_tpu_torch.ops.encodings import create_encoding

    cfg = load_network_config(find_network_config("base", "nerf"))
    enc = create_encoding(3, dict(cfg["encoding"], log2_hashmap_size=10))
    assert enc.stochastic_exact_axes == 1 and enc.stochastic_bwd is True
    plain = create_encoding(3, {"otype": "HashGrid", "n_levels": 2})
    assert plain.stochastic_exact_axes == 0 and plain.stochastic_bwd is False
