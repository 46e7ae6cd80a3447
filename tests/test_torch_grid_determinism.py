"""The hash grid's table gradient is summed in an order the indices alone
fix (`ops/grid_encoding.py::_deposit`, `index_put_` with accumulate): the
same inputs give the same bits on every call, for the exact encode's
deposit and for every stochastic-corner deposit (one corner at j = 0, the
one fully sampled corner of `stochastic_bwd`, every fetched corner at
j = 1 and j = 2), in 2D and 3D. Each agrees with a float64 `index_add_` of
the same deposits to 1e-6 (rtol and atol: float32 sums of a few dozen
deposits of order 1 at most). The card's half of the check (the order is
what changes between runs there) is in tests/test_torch_cuda_kernels.py;
the JAX-parity tests of the gradient (tests/test_torch_grid_backward.py,
test_torch_grid_stochastic.py) run unchanged."""

import numpy as np
import pytest
import torch

from instant_ngp_tpu_torch.ops.grid_encoding import (GridEncoding,
                                                     draw_corner_randoms)

N = 400
# (dims, exact axes or None for the exact encode, one-corner backward)
CASES = [(2, None, False), (3, None, False), (2, 0, False), (3, 0, False),
         (2, 1, True), (3, 1, True), (3, 1, False), (3, 2, False)]


def _inputs(dims, seed=0):
    torch.manual_seed(seed)
    enc = GridEncoding(dims, n_levels=4, n_features_per_level=2,
                       log2_hashmap_size=10, base_resolution=8)
    enc.init_params(torch.Generator().manual_seed(seed))
    x = torch.rand(N, dims)
    g_out = torch.randn(N, enc.n_output_dims)
    return enc, x, g_out


@pytest.mark.parametrize("dims,j,one_corner", CASES)
def test_table_gradient_is_repeatable_and_exact_to_float64(dims, j,
                                                           one_corner):
    enc, x, g_out = _inputs(dims)
    enc.stochastic_bwd = one_corner
    f = enc.n_features_per_level
    ref = torch.zeros(enc.n_entries, f, dtype=torch.float64)
    if j is None:
        grads = [enc._table_gradient(x, g_out, None) for _ in range(2)]
        for lvl in range(enc.n_levels):
            idx, weight = enc._level_corners(x, lvl)
            g = g_out[:, lvl * f:(lvl + 1) * f].double()
            ref.index_add_(0, idx.reshape(-1), (
                g[:, None, :] * weight[..., None].double()).reshape(-1, f))
    else:
        draws = draw_corner_randoms(torch.Generator().manual_seed(1), N,
                                    dims, enc.n_levels, j)
        grads = [enc._table_gradient_stochastic(x, g_out, None, draws, j)
                 for _ in range(2)]
        for lvl in range(enc.n_levels):
            g = g_out[:, lvl * f:(lvl + 1) * f].double()
            for idx, weight in enc._stochastic_corners(
                    x, lvl, draws, j, sampled_only=one_corner):
                ref.index_add_(0, idx, g if weight is None
                               else g * weight[:, None].double())
    assert torch.equal(grads[0], grads[1])
    assert ref.abs().max() > 0
    np.testing.assert_allclose(grads[0].numpy(), ref.reshape(-1).numpy(),
                               rtol=1e-6, atol=1e-6)
