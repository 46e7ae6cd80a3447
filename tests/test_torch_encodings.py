"""The port's SH, Identity, Composite, Frequency, OneBlob and TriangleWave
encodings and its config loading against the JAX package's. The SH
polynomials are the same float32 expressions term by term: rtol 1e-6 /
atol 1e-7."""

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401 (its import sets the thread count)

from instant_ngp_tpu.config import \
    load_network_config as jax_load_network_config
from instant_ngp_tpu.ops.encodings import create_encoding as jax_create
from instant_ngp_tpu_torch.config import load_network_config
from instant_ngp_tpu_torch.ops.encodings import create_encoding


def _dirs(rng, n, extra=0):
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    warped = (d + 1.0) * 0.5
    if extra:
        warped = np.concatenate(
            [warped, rng.normal(size=(n, extra)).astype(np.float32)], -1)
    return warped.astype(np.float32)


@pytest.mark.parametrize("degree", [1, 2, 3, 4, 5])
def test_sh_matches_jax(degree):
    cfg = {"otype": "SphericalHarmonics", "degree": degree}
    x = _dirs(np.random.default_rng(degree), 400)
    ours = create_encoding(3, cfg)(torch.from_numpy(x)).numpy()
    ref = np.asarray(jax_create(3, cfg).apply(None, jnp.asarray(x)))
    assert ours.shape == (400, degree * degree)
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("n_extra", [0, 2])
def test_composite_sh_identity_matches_jax(n_extra):
    """configs/nerf/base.json's dir_encoding: SH-4 on the direction and
    Identity on the rest (empty without latent dims)."""
    cfg = {"otype": "Composite", "nested": [
        {"n_dims_to_encode": 3, "otype": "SphericalHarmonics", "degree": 4},
        {"otype": "Identity", "scale": 0.5, "offset": 0.25}]}
    x = _dirs(np.random.default_rng(9), 300, n_extra)
    enc = create_encoding(3 + n_extra, cfg)
    ours = enc(torch.from_numpy(x)).numpy()
    ref = np.asarray(jax_create(3 + n_extra, cfg).apply(None,
                                                        jnp.asarray(x)))
    assert enc.n_output_dims == 16 + n_extra == ours.shape[1]
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("otype", ["Frequency", "OneBlob", "TriangleWave"])
def test_unported_encodings_raise(otype):
    """Frequency, OneBlob and TriangleWave through `create_encoding`, with
    the configs' sizes, against the JAX package's on inputs in and just
    outside [0, 1]: rtol 1e-6 / atol 1e-6 (sin and cos of arguments up to
    pi * 2^15 round differently by an ulp of the argument)."""
    cfg = {"otype": otype, "n_frequencies": 16, "n_bins": 32}
    x = np.random.default_rng(5).uniform(-0.05, 1.05, (500, 3)) \
        .astype(np.float32)
    enc = create_encoding(3, cfg)
    ref = np.asarray(jax_create(3, cfg).apply(None, jnp.asarray(x)))
    ours = enc(torch.from_numpy(x)).numpy()
    assert ours.shape == ref.shape == (500, enc.n_output_dims)
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-6)


CONFIGS = sorted(glob.glob(os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "configs", "*", "*.json")))


@pytest.mark.parametrize("path", CONFIGS,
                         ids=[os.path.relpath(p, os.path.dirname(
                             os.path.dirname(p))) for p in CONFIGS])
def test_network_configs_load_like_jax(path):
    """`parent` inheritance and // comments resolve as in the JAX
    package, for every shipped config."""
    assert load_network_config(path) == jax_load_network_config(path)
