"""The hash grid's table gradient is summed in an order the indices alone
fix (`ops/grid_encoding.py::ordered_deposit`, `index_put_` with
accumulate): the same inputs give the same bits on every call, for the
exact encode's deposit and for every stochastic-corner deposit (one
corner at j = 0, the one fully sampled corner of `stochastic_bwd`, every
fetched corner at j = 1 and j = 2), in 2D and 3D. Each agrees with a float64 `index_add_` of
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


@pytest.mark.parametrize("shape", [(1 << 18,), (1 << 18, 4)])
def test_ordered_deposit_repeats_where_many_rows_collide(shape):
    """2^18 deposits into 1000 rows, on the CPU, where `index_put_` with
    accumulate adds from several threads: `ordered_deposit` gives the same
    bits on every call and equals a float64 sum to rtol 1e-5 / atol 1e-4
    (float32 sums of ~260 terms of order 1)."""
    from instant_ngp_tpu_torch.ops.grid_encoding import ordered_deposit

    gen = torch.Generator().manual_seed(4)
    rows = torch.randint(0, 1000, shape[:1], generator=gen)
    values = torch.randn(*shape, generator=gen)
    got = []
    for _ in range(3):
        grad = torch.zeros(1000, *shape[1:])
        ordered_deposit(grad, rows, values)
        got.append(grad)
    assert all(torch.equal(got[0], g) for g in got[1:])
    ref = torch.zeros(1000, *shape[1:], dtype=torch.float64).index_add_(
        0, rows, values.double())
    np.testing.assert_allclose(got[0].numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-4)


def test_determinism_helpers():
    """`warned_ops` reads the op out of PyTorch's warning, leaves the mode
    and CUBLAS_WORKSPACE_CONFIG as it found them, and passes the result
    through; every allow-list entry says why order cannot change it;
    `digest` tells bf16 tensors apart by their bits."""
    import os
    import warnings

    from instant_ngp_tpu_torch import determinism

    msg = ("index_add_cuda_ does not have a deterministic implementation, "
           "but you set 'torch.use_deterministic_algorithms(True, "
           "warn_only=True)'.")
    assert determinism.op_of_warning(msg) == "index_add_cuda_"
    assert determinism.op_of_warning("something else") == ""
    env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")

    def step():
        assert torch.are_deterministic_algorithms_enabled()
        warnings.warn(msg)
        warnings.warn("scatter_reduce_cuda does not have a deterministic "
                      "implementation, but ...")
        return 7

    out, ops = determinism.warned_ops(step)
    assert out == 7
    assert ops == ["index_add_cuda_", "scatter_reduce_cuda"]
    assert [op for op in ops if op not in determinism.ORDER_FREE] == \
        ["index_add_cuda_"]
    assert not torch.are_deterministic_algorithms_enabled()
    assert os.environ.get("CUBLAS_WORKSPACE_CONFIG") == env
    assert all(len(why) > 40 for why in determinism.ORDER_FREE.values())
    a = torch.tensor([1.0, 2.0], dtype=torch.bfloat16)
    b = a.clone()
    b[1] = 2.015625     # the next bf16 value above 2
    assert determinism.digest(a, torch.tensor(3)) == \
        determinism.digest(a.clone(), torch.tensor(3))
    assert determinism.digest(a) != determinism.digest(b)
