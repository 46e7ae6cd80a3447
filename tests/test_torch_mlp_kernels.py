"""The port's fused MLP forward (plain version, as the wrapper runs it on a
CPU tensor) and MLP against the JAX package's TPU kernel in interpret mode
and its MLP.apply, on the same seeded inputs and weights.

Tolerances: at bf16 compute both sides round the same operands to bf16
and sum exactly representable products in float32, but in another order;
a hidden value that lands within a float32 ulp of a bf16 rounding
boundary can round the other way, which moves an output by about one
bf16 ulp of that hidden value times its weight. So outputs agree to
atol 2e-3 / rtol 1e-2, and almost all of them (>= 99%) exactly to 1e-5.
At float32 compute only the summation order differs: rtol 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401 (its import sets the thread count)

from instant_ngp_tpu.ops.mlp import MLP as JaxMLP
from instant_ngp_tpu.ops.pallas.mlp_kernels import \
    fused_mlp_forward as jax_fused_mlp_forward
from instant_ngp_tpu_torch.ops.kernels.mlp_kernels import (
    fused_mlp_forward, fused_mlp_forward_plain, pack_weights)
from instant_ngp_tpu_torch.ops.mlp import MLP


def _weights(rng, dims):
    out = []
    for fan_in, fan_out in zip(dims[:-1], dims[1:]):
        bound = np.sqrt(6.0 / (fan_in + fan_out))
        out.append(rng.uniform(-bound, bound, (fan_in, fan_out))
                   .astype(np.float32))
    return out


CASES = {
    # the two cases of tests/test_pallas_kernels.py
    "relu_2hidden": dict(d_in=32, width=64, hidden=2, d_out=16,
                         act="ReLU", out_act="None", n=200),
    "relu_out_relu": dict(d_in=8, width=32, hidden=1, d_out=4,
                          act="ReLU", out_act="ReLU", n=64),
    "sine_hidden": dict(d_in=32, width=64, hidden=2, d_out=16,
                        act="Sine", out_act="None", n=300),
    "exp_out": dict(d_in=32, width=64, hidden=1, d_out=3,
                    act="ReLU", out_act="Exponential", n=257),
    # the NeRF RGB net shape: 16 density outputs + 16 SH features
    "nerf_rgb": dict(d_in=32, width=64, hidden=2, d_out=3,
                     act="ReLU", out_act="None", n=512),
    # the streamed kernel's nets at a narrow depth: configs/nerf/
    # frequency.json's density net (96 inputs, 256 wide) and
    # configs/sdf/frequency.json's (60 inputs, 128 wide)
    "streamed_256": dict(d_in=96, width=256, hidden=2, d_out=16,
                         act="ReLU", out_act="None", n=96),
    "streamed_sdf_128": dict(d_in=60, width=128, hidden=3, d_out=1,
                             act="ReLU", out_act="None", n=130),
    # the general path's nets: the RGB net of a capture with 4 latent dims
    # and configs/image/frequency.json's and oneblob.json's
    "general_latent_rgb": dict(d_in=36, width=64, hidden=2, d_out=3,
                               act="ReLU", out_act="None", n=200),
    "general_image_64": dict(d_in=64, width=64, hidden=2, d_out=3,
                             act="ReLU", out_act="None", n=140),
}


def _assert_bf16_close(ours, ref):
    np.testing.assert_allclose(ours, ref, rtol=1e-2, atol=2e-3)
    exact = np.isclose(ours, ref, rtol=1e-5, atol=1e-6)
    assert exact.mean() >= 0.99, exact.mean()


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_fused_mlp_matches_jax_kernel_and_mlp(name):
    c = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    dims = [c["d_in"]] + [c["width"]] * c["hidden"] + [c["d_out"]]
    ws = _weights(rng, dims)
    x = rng.normal(size=(c["n"], c["d_in"])).astype(np.float32)

    ours = fused_mlp_forward(torch.from_numpy(x),
                             pack_weights([torch.from_numpy(w) for w in ws]),
                             c["act"], c["out_act"]).numpy()
    jax_kernel = np.asarray(jax_fused_mlp_forward(
        [jnp.asarray(w) for w in ws], jnp.asarray(x), activation=c["act"],
        output_activation=c["out_act"], tile=128, interpret=True))
    jax_mlp = JaxMLP(c["d_in"], c["d_out"], c["width"], c["hidden"],
                     activation=c["act"], output_activation=c["out_act"],
                     compute_dtype=jnp.bfloat16)
    ref = np.asarray(jax_mlp.apply([jnp.asarray(w) for w in ws],
                                   jnp.asarray(x)))
    assert ours.shape == (c["n"], c["d_out"]) and ours.dtype == np.float32
    _assert_bf16_close(ours, jax_kernel)
    _assert_bf16_close(ours, ref)
    if c["out_act"] in ("ReLU", "Exponential"):
        assert (ours >= 0).all()

    # the MLP module at bf16 compute goes through the same wrapper
    mlp = MLP(c["d_in"], c["d_out"], c["width"], c["hidden"],
              activation=c["act"], output_activation=c["out_act"],
              compute_dtype=torch.bfloat16)
    mlp.load_weights([torch.from_numpy(w) for w in ws])
    np.testing.assert_array_equal(mlp(torch.from_numpy(x)).numpy(), ours)


@pytest.mark.parametrize("hidden", [0, 1, 3])
def test_f32_mlp_matches_jax(hidden):
    rng = np.random.default_rng(10 + hidden)
    dims = [27] + [48] * hidden + [5]
    ws = _weights(rng, dims)
    x = rng.normal(size=(100, 27)).astype(np.float32)
    mlp = MLP(27, 5, 48, hidden, activation="ReLU",
              output_activation="Logistic", compute_dtype=torch.float32)
    mlp.load_weights([torch.from_numpy(w) for w in ws])
    ref = np.asarray(JaxMLP(27, 5, 48, hidden, activation="ReLU",
                            output_activation="Logistic",
                            compute_dtype=jnp.float32).apply(
        [jnp.asarray(w) for w in ws], jnp.asarray(x)))
    np.testing.assert_allclose(mlp(torch.from_numpy(x)).numpy(), ref,
                               rtol=1e-5, atol=1e-6)


def test_bf16_input_rounds_like_f32_input():
    rng = np.random.default_rng(5)
    ws = pack_weights([torch.from_numpy(w)
                       for w in _weights(rng, [16, 32, 8])])
    x = torch.from_numpy(rng.normal(size=(50, 16)).astype(np.float32))
    np.testing.assert_array_equal(
        fused_mlp_forward(x.to(torch.bfloat16), ws).numpy(),
        fused_mlp_forward(x, ws).numpy())


@pytest.mark.parametrize("kwargs", [
    dict(activation="Tanh"), dict(activation="Exponential"),
    dict(output_activation="Sine"), dict(output_activation="Logistic")])
def test_wrapper_raises_on_unsupported_activation(kwargs):
    rng = np.random.default_rng(6)
    ws = pack_weights([torch.from_numpy(w)
                       for w in _weights(rng, [16, 32, 8])])
    with pytest.raises(ValueError, match="activation"):
        fused_mlp_forward(torch.zeros(4, 16), ws, **kwargs)


@pytest.mark.parametrize("dims", [[32] + [288, 288] + [16],
                                  [300, 64, 16],
                                  [16] + [32] * 33 + [4]])
def test_wrapper_raises_outside_kernel_coverage(dims):
    """Widths above 256 and more than 32 layers: beyond the streamed
    kernel, which takes the 256-wide nets and the 128-wide nets whose
    weights overflow shared memory (the SDF oneblob/frequency configs)."""
    rng = np.random.default_rng(7)
    ws = pack_weights([torch.from_numpy(w) for w in _weights(rng, dims)])
    with pytest.raises(ValueError, match="fused_mlp_forward"):
        fused_mlp_forward(torch.zeros(2, dims[0]), ws)


def test_mlp_repacks_after_weights_change():
    rng = np.random.default_rng(8)
    mlp = MLP(16, 8, 32, 1, compute_dtype=torch.bfloat16)
    mlp.load_weights([torch.from_numpy(w)
                      for w in _weights(rng, [16, 32, 8])])
    x = torch.from_numpy(rng.normal(size=(10, 16)).astype(np.float32))
    first = mlp(x)
    ws2 = _weights(rng, [16, 32, 8])
    mlp.load_weights([torch.from_numpy(w) for w in ws2])
    np.testing.assert_array_equal(
        mlp(x).numpy(),
        fused_mlp_forward_plain(x, [torch.from_numpy(w) for w in ws2])
        .numpy())
    assert not torch.equal(first, mlp(x))
