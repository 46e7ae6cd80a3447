"""The table gradient of the port's GridEncoding (its hand-written
`torch.autograd.Function` backward) against `jax.grad` of the JAX
package's GridEncoding.apply, and against PyTorch's autograd through the
plain forward (`table[idx]`), on the same seeded table, points and
cotangent: Hash, Dense and Tiled grids x Linear and Smoothstep, with and
without `max_level`.

All three accumulate the same float32 deposits into each table entry in a
different order; with up to a few hundred deposits of order 1 per entry,
rtol 1e-5 / atol 1e-5."""

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


def test_input_gradient_raises():
    _, enc, _, x, _ = _case("Hash", "Linear")
    enc.params.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    with pytest.raises(NotImplementedError, match="input"):
        enc(xt)
    with torch.no_grad():          # no gradient asked for: fine
        enc(xt)


def test_backward_saves_the_points_only():
    """The Function keeps x for its backward, not the per-level gathers."""
    _, enc, _, x, _ = _case("Hash", "Linear")
    enc.params.requires_grad_(True)
    xt = torch.from_numpy(x)
    out = enc(xt)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 1 and saved[0].shape == xt.shape
