"""The gradients of the port's exact GridEncoding (its hand-written
`torch.autograd.Function` backward) against `jax.grad` of the JAX
package's GridEncoding.apply, and against PyTorch's autograd through the
plain forward (`table[idx]`), on the same seeded table, points and
cotangent: Hash, Dense and Tiled grids x Linear and Smoothstep (and, for
the input gradient, Nearest), with and without `max_level`.

Table gradient: all three accumulate the same float32 deposits into each
table entry in a different order; with up to a few hundred deposits of
order 1 per entry, rtol 1e-5 / atol 1e-5.

Input gradient: per point a sum over levels and corners of products of
order scale (up to 31 here) x feature x weight, in float32 on both sides:
rtol 1e-4 of the gradient's own scale against `jax.grad`; the same formula
evaluated in float64 agrees with float64 autograd through the plain
forward to 1e-9."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instant_ngp_tpu.ops.grid_encoding import GridEncoding as JaxGrid
from instant_ngp_tpu_torch.ops.grid_encoding import GridEncoding

torch.set_num_threads(2)

KW = dict(n_levels=4, n_features_per_level=2, log2_hashmap_size=10,
          base_resolution=4, per_level_scale=2.0)


def _case(grid_type, interpolation, n_dims=3, n=600):
    rng = np.random.default_rng(7 + len(grid_type) + len(interpolation))
    jax_enc = JaxGrid(n_dims=n_dims, grid_type=grid_type,
                      interpolation=interpolation, **KW)
    enc = GridEncoding(n_dims=n_dims, grid_type=grid_type,
                       interpolation=interpolation, **KW)
    table = rng.uniform(-1.0, 1.0, enc.n_params).astype(np.float32)
    with torch.no_grad():
        enc.params.copy_(torch.from_numpy(table))
    x = rng.uniform(-0.05, 1.05, (n, n_dims)).astype(np.float32)
    cot = rng.normal(size=(n, enc.n_output_dims)).astype(np.float32)
    return jax_enc, enc, table, x, cot


@pytest.mark.parametrize("max_level", [None, 1])
@pytest.mark.parametrize("interpolation", ["Linear", "Smoothstep"])
@pytest.mark.parametrize("grid_type", ["Hash", "Dense", "Tiled"])
def test_table_gradient_matches_jax_and_autograd(grid_type, interpolation,
                                                 max_level):
    jax_enc, enc, table, x, cot = _case(grid_type, interpolation)
    ref = np.asarray(jax.grad(lambda t: jnp.sum(
        jax_enc.apply(t, jnp.asarray(x), max_level=max_level)
        * jnp.asarray(cot)))(jnp.asarray(table)))

    enc.params.requires_grad_(True)
    xt, ct = torch.from_numpy(x), torch.from_numpy(cot)
    out = enc(xt, max_level=max_level)
    assert out.grad_fn is not None and "GridEncode" in type(out.grad_fn).__name__
    (ours,) = torch.autograd.grad((out * ct).sum(), enc.params)
    # autograd through the plain forward's gather
    (plain,) = torch.autograd.grad(
        (enc._encode(enc.params, xt, max_level) * ct).sum(), enc.params)

    assert ours.shape == (enc.n_params,) and np.abs(ref).max() > 0.1
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ours.numpy(), plain.numpy(), rtol=1e-5,
                               atol=1e-5)
    if max_level is not None:
        # the levels the forward zeroed get no gradient
        first_off = enc.levels[max_level + 1][3] * enc.n_features_per_level
        assert (ours[first_off:] == 0).all() and (ours[:first_off] != 0).any()


def test_forward_value_is_the_same_under_grad():
    _, enc, _, x, _ = _case("Hash", "Linear")
    xt = torch.from_numpy(x)
    with torch.no_grad():
        ref = enc(xt)
    enc.params.requires_grad_(True)
    assert torch.equal(enc(xt), ref)
    with torch.no_grad():
        assert enc(xt).grad_fn is None


def _points_off_the_cell_faces(enc, x, margin=1e-3):
    """Drop points within `margin` of a cell face at some level: there the
    interpolant has a kink (Linear) and the two sides may land in
    different cells."""
    frac = np.stack([np.mod(x * np.float32(s) + 0.5, 1.0)
                     for s, *_ in enc.levels])
    return x[((frac > margin) & (frac < 1 - margin)).all(axis=(0, 2))]


@pytest.mark.parametrize("max_level", [None, 1])
@pytest.mark.parametrize("interpolation", ["Linear", "Smoothstep",
                                           "Nearest"])
@pytest.mark.parametrize("grid_type", ["Hash", "Dense", "Tiled"])
@pytest.mark.parametrize("n_dims", [2, 3])
def test_input_gradient_matches_jax_and_float64_autograd(
        n_dims, grid_type, interpolation, max_level):
    jax_enc, enc, table, x, cot = _case(grid_type, interpolation, n_dims)
    x = _points_off_the_cell_faces(enc, x)
    cot = cot[:len(x)]
    assert len(x) > 300
    ref = np.asarray(jax.grad(lambda p: jnp.sum(
        jax_enc.apply(jnp.asarray(table), p, max_level=max_level)
        * jnp.asarray(cot)))(jnp.asarray(x)))

    enc.params.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    ct = torch.from_numpy(cot)
    out = enc(xt, max_level=max_level)
    g_table, g_x = torch.autograd.grad((out * ct).sum(), (enc.params, xt))
    assert g_x.shape == xt.shape
    scale = np.abs(ref).max()
    if interpolation == "Nearest":
        assert scale == 0 and (g_x == 0).all()
    else:
        assert scale > 1.0
        np.testing.assert_allclose(g_x.numpy(), ref, rtol=1e-4,
                                   atol=1e-4 * scale)
    # the table gradient is what it is without the input gradient
    (alone,) = torch.autograd.grad(
        (enc(xt.detach(), max_level=max_level) * ct).sum(), enc.params)
    assert torch.equal(alone, g_table)
    # a frozen table: the input gradient alone, the same
    enc.params.requires_grad_(False)
    (g_x2,) = torch.autograd.grad((enc(xt, max_level=max_level) * ct).sum(),
                                  xt)
    assert torch.equal(g_x2, g_x)

    # the formula in float64 against float64 autograd through table[idx]
    p64 = enc.params.detach().double()
    x64 = xt.detach().double().requires_grad_(True)
    (auto,) = torch.autograd.grad(
        (enc._encode(p64, x64, max_level) * ct.double()).sum(), x64)
    hand = enc._input_gradient(p64, x64.detach(), ct.double(), max_level)
    np.testing.assert_allclose(hand.numpy(), auto.numpy(), rtol=1e-9,
                               atol=1e-9)
    np.testing.assert_allclose(g_x.numpy(), auto.numpy(), rtol=1e-4,
                               atol=1e-4 * max(scale, 1e-30))


def test_input_gradient_raises():
    """It no longer does: a point that requires grad gets its gradient, a
    finite one at the edges of the domain too, and none is computed where
    none is asked for."""
    _, enc, _, x, _ = _case("Hash", "Linear")
    enc.params.requires_grad_(True)
    x[:4] = [[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [-0.05, 0.5, 1.05],
             [0.5, 0.5, 0.5]]
    xt = torch.from_numpy(x).requires_grad_(True)
    out = enc(xt)
    (g,) = torch.autograd.grad(out.sum(), xt)
    assert torch.isfinite(g).all() and g.abs().max() > 0
    with torch.no_grad():          # no gradient asked for: a plain call
        assert enc(xt).grad_fn is None


def test_backward_saves_the_points_only():
    """The Function keeps x for its backward, not the per-level gathers."""
    _, enc, _, x, _ = _case("Hash", "Linear")
    enc.params.requires_grad_(True)
    xt = torch.from_numpy(x)
    out = enc(xt)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 1 and saved[0].shape == xt.shape
    # with an input gradient it keeps the table too, still no gather
    out = enc(xt.clone().requires_grad_(True))
    saved = out.grad_fn.saved_tensors
    assert [tuple(t.shape) for t in saved] == [tuple(xt.shape),
                                               (enc.n_params,)]
