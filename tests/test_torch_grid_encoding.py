"""The port's GridEncoding against the JAX package's GridEncoding.apply and
apply_components (exact d-linear path) on the same seeded table and
points: Hash, Dense and Tiled grids x Linear, Smoothstep and Nearest
interpolation, 2D and 3D, with and without `max_level`.

Both sides compute corner indices and weights with the same float32 and
uint32 arithmetic; only the order of the corner sum differs (the JAX
package sums through a one-hot matmul), so rtol 1e-5 / atol 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401 (its import sets the thread count)

from instant_ngp_tpu.ops.factory import derive_grid_config as jax_derive
from instant_ngp_tpu.ops.grid_encoding import GridEncoding as JaxGrid
from instant_ngp_tpu_torch.config import (find_network_config,
                                         load_network_config)
from instant_ngp_tpu_torch.ops.factory import derive_grid_config
from instant_ngp_tpu_torch.ops.grid_encoding import (GridEncoding,
                                                    convert_layout)


KW = dict(n_levels=4, n_features_per_level=2, log2_hashmap_size=10,
          base_resolution=4, per_level_scale=2.0)


@pytest.mark.parametrize("n_dims", [2, 3])
@pytest.mark.parametrize("interpolation", ["Linear", "Smoothstep", "Nearest"])
@pytest.mark.parametrize("grid_type", ["Hash", "Dense", "Tiled"])
def test_grid_encoding_matches_jax(grid_type, interpolation, n_dims):
    rng = np.random.default_rng(
        ["Hash", "Dense", "Tiled"].index(grid_type) * 10 + n_dims)
    jax_enc = JaxGrid(n_dims=n_dims, grid_type=grid_type,
                      interpolation=interpolation, **KW)
    enc = GridEncoding(n_dims=n_dims, grid_type=grid_type,
                       interpolation=interpolation, **KW)
    assert enc.n_params == jax_enc.n_params
    assert jax_enc.layout == "interleaved"
    table = rng.uniform(-1.0, 1.0, enc.n_params).astype(np.float32)
    with torch.no_grad():
        enc.params.copy_(torch.from_numpy(table))
    # a margin outside [0, 1] exercises negative corners (uint32 hash
    # wraparound, dense clamping, tiled wrapping)
    x = rng.uniform(-0.05, 1.05, (500, n_dims)).astype(np.float32)
    for max_level in (None, 1):
        ours = enc(torch.from_numpy(x), max_level=max_level).numpy()
        ref = np.asarray(jax_enc.apply(jnp.asarray(table), jnp.asarray(x),
                                       max_level=max_level))
        ref_c = np.asarray(jax_enc.apply_components(
            jnp.asarray(table), [jnp.asarray(x[:, k]) for k in range(n_dims)],
            max_level=max_level))
        assert ours.shape == (500, KW["n_levels"] * 2)
        np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(ours, ref_c, rtol=1e-5, atol=1e-6)
        if max_level is not None:
            assert (ours[:, (max_level + 1) * 2:] == 0).all()


def test_convert_layout_matches_jax():
    jax_enc = JaxGrid(n_dims=3, **dict(KW, n_features_per_level=4))
    planar = np.random.default_rng(3).normal(size=jax_enc.n_params) \
        .astype(np.float32)
    ref = np.asarray(jax_enc.convert_layout(jnp.asarray(planar), "planar"))
    ours = convert_layout(planar, 4, "planar", "interleaved")
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(
        convert_layout(torch.from_numpy(planar), 4, "planar",
                       "interleaved").numpy(), ref)
    np.testing.assert_array_equal(
        convert_layout(ours, 4, "interleaved", "planar"), planar)


@pytest.mark.parametrize("aabb_scale", [1, 16])
def test_base_config_table_matches_jax(aabb_scale):
    """configs/nerf/base.json: L=8, F=4, 2^19 hash, base 16 -> 2.92 M
    entries at aabb_scale 1 (the derived per-level scale is 2)."""
    enc_cfg = load_network_config(
        find_network_config("base", "nerf"))["encoding"]
    ours = derive_grid_config(enc_cfg, 3, 2048.0, aabb_scale)
    assert ours == jax_derive(enc_cfg, 3, 2048.0, aabb_scale)
    enc = GridEncoding.from_config(3, ours)
    jax_enc = JaxGrid.from_config(3, ours)
    assert enc.n_params == jax_enc.n_params
    assert [lv[3] for lv in enc.levels] == list(jax_enc._offsets)
    assert [lv[4] for lv in enc.levels] == list(jax_enc._hashed)
    if aabb_scale == 1:
        assert enc.n_entries == 2920448


@pytest.mark.parametrize("grid_type", ["Hash", "Dense"])
def test_level_params_and_level_stats_match_jax(grid_type):
    """`level_params` and the LevelStats diagnostic on the same table, some
    of it zero: slices bit for bit, the statistics to float32 rounding of
    numpy's own sums over the same values."""
    jax_enc = JaxGrid(n_dims=3, grid_type=grid_type, **KW)
    enc = GridEncoding(n_dims=3, grid_type=grid_type, **KW)
    rng = np.random.default_rng(7)
    table = rng.uniform(-1.0, 1.0, enc.n_params).astype(np.float32)
    table[rng.uniform(size=table.size) < 0.2] = 0.0
    with torch.no_grad():
        enc.params.copy_(torch.from_numpy(table))
    for lvl in range(KW["n_levels"]):
        ref = np.asarray(jax_enc.level_params(jnp.asarray(table), lvl))
        np.testing.assert_array_equal(enc.level_params(table, lvl), ref)
        np.testing.assert_array_equal(
            enc.level_params(enc.params.detach(), lvl).numpy(), ref)
    ref = jax_enc.level_stats(jnp.asarray(table))
    ours = enc.level_stats()
    assert ours == enc.level_stats(table)
    assert [s["count"] for s in ours] == [s["count"] for s in ref]
    for a, b in zip(ours, ref):
        assert a.keys() == b.keys()
        np.testing.assert_allclose([a[k] for k in sorted(a)],
                                   [b[k] for k in sorted(b)], rtol=1e-6,
                                   atol=1e-7)
        assert 0.1 < a["fraczero"] < 0.3
