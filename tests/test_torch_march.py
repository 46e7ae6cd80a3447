"""The port's march geometry, candidate march and occupancy grid against
the JAX package's (nerf/march.py, nerf/sampler.py::march_rays,
nerf/occupancy.py) on the same seeded inputs.

Integer work (Morton order, bitfields) must match exactly. Float work
runs the same float32 expressions, but log/exp/log1p may differ by an ulp
between the two libraries, so the stepping-space functions and march ts
hold to rtol 1e-6; such an ulp can move a candidate across a cell or box
boundary, so march emit masks may differ in at most 1e-4 of candidates."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401 (its import sets the thread count)

from instant_ngp_tpu.nerf import march as jm
from instant_ngp_tpu.nerf import occupancy as jocc
from instant_ngp_tpu.nerf.sampler import RayBatch as JaxRayBatch
from instant_ngp_tpu.nerf.sampler import march_rays as jax_march_rays
from instant_ngp_tpu_torch.nerf import march as tm
from instant_ngp_tpu_torch.nerf import occupancy as tocc
from instant_ngp_tpu_torch.nerf.sampler import RayBatch, march_rays


def T(a):
    return torch.from_numpy(np.array(a))


def test_morton_matches_jax_and_round_trips():
    rng = np.random.default_rng(0)
    xyz = rng.integers(0, 1024, (3, 5000)).astype(np.int32)
    ours = tm.morton3d(*[T(c) for c in xyz])
    ref = np.asarray(jm.morton3d(*[jnp.asarray(c) for c in xyz]))
    np.testing.assert_array_equal(ours.numpy(), ref)
    back = tm.morton3d_coords(ours)
    for c, b in zip(xyz, back):
        np.testing.assert_array_equal(b.numpy(), c)
    idx = rng.integers(0, 1 << 30, 5000).astype(np.int32)
    for ours_c, ref_c in zip(tm.morton3d_coords(T(idx)),
                             jm.morton3d_coords(jnp.asarray(idx))):
        np.testing.assert_array_equal(ours_c.numpy(), np.asarray(ref_c))


@pytest.mark.parametrize("cone", [0.0, 1.0 / 256.0, 0.05])
def test_stepping_space_matches_jax(cone):
    rng = np.random.default_rng(1)
    t = np.concatenate([rng.uniform(0.0, 0.02, 2000),
                        rng.uniform(0.02, 200.0, 2000)]).astype(np.float32)
    ours = tm.to_stepping_space(T(t), cone)
    ref = np.asarray(jm.to_stepping_space(jnp.asarray(t), cone))
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-6, atol=1e-6)
    n = ref + rng.uniform(0, 3, ref.shape).astype(np.float32)
    np.testing.assert_allclose(
        tm.from_stepping_space(T(n), cone).numpy(),
        np.asarray(jm.from_stepping_space(jnp.asarray(n), cone)),
        rtol=1e-6, atol=1e-7)
    # dt = advance(t) - t cancels: an ulp of t' moves dt by spacing(t)
    dt_diff = np.abs(tm.calc_dt(T(t), cone).numpy()
                     - np.asarray(jm.calc_dt(jnp.asarray(t), cone)))
    assert (dt_diff <= 4 * np.spacing(t + 1.0)).all()
    np.testing.assert_allclose(
        tm.advance_n_steps(T(t), cone, 0.5).numpy(),
        np.asarray(jm.advance_n_steps(jnp.asarray(t), cone, 0.5)),
        rtol=1e-6, atol=1e-7)


def test_mip_selection_and_aabb_match_jax():
    rng = np.random.default_rng(2)
    pos = rng.uniform(-3.0, 4.0, (3000, 3)).astype(np.float32)
    dt = rng.uniform(0.0, 0.2, 3000).astype(np.float32)
    for max_c in (0, 3, 7):
        np.testing.assert_array_equal(
            tm.mip_from_dt(T(dt), T(pos), max_c).numpy(),
            np.asarray(jm.mip_from_dt(jnp.asarray(dt), jnp.asarray(pos),
                                      max_c)))
    o = rng.uniform(-2.0, 3.0, (3000, 3)).astype(np.float32)
    d = rng.normal(size=(3000, 3)).astype(np.float32)
    d[:10, 0] = 0.0  # axis-parallel rays
    lo, hi = np.full(3, -0.5, np.float32), np.full(3, 1.5, np.float32)
    ours = tm.ray_intersect_aabb(T(o), T(d), T(lo), T(hi))
    ref = jm.ray_intersect_aabb(jnp.asarray(o), jnp.asarray(d),
                                jnp.asarray(lo), jnp.asarray(hi))
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def _seeded_grid(rng, n_cascades, lo=0.0, hi=0.05):
    """Densities whose cascade-0 mean is above 0.01, so both packages
    threshold at exactly 0.01; a few untrained (negative) cells."""
    g = rng.uniform(lo, hi, jocc.NERF_GRID_N_CELLS * n_cascades)
    g[rng.random(g.shape[0]) < 0.3] = 0.0
    g[rng.random(g.shape[0]) < 0.01] = -1.0
    return g.astype(np.float32)


@pytest.mark.parametrize("n_cascades,max_cascade", [(1, 0), (2, 1), (2, 0)])
def test_update_bitfield_bit_identical(n_cascades, max_cascade):
    grid = _seeded_grid(np.random.default_rng(n_cascades + max_cascade),
                        n_cascades)
    ours = tocc.update_bitfield(T(grid), max_cascade)
    ref = np.asarray(jocc.update_bitfield(jnp.asarray(grid), max_cascade))
    assert ours.dtype == torch.uint8 and ours.shape == ref.shape
    np.testing.assert_array_equal(ours.numpy(), ref)
    np.testing.assert_allclose(
        tocc.density_grid_mean(T(grid)).item(),
        float(jocc.density_grid_mean(jnp.asarray(grid))), rtol=1e-5)


def test_cell_positions_and_splat_match_jax():
    """The jitter JAX draws from its key is handed to the port."""
    rng = np.random.default_rng(4)
    n_cells = jocc.NERF_GRID_N_CELLS * 2
    idx = rng.integers(0, n_cells, 20000).astype(np.int32)
    key = jax.random.PRNGKey(7)
    ref_pos = np.stack([np.asarray(c)
                        for c in jocc.cell_positions(jnp.asarray(idx), key)],
                       -1)
    jitter = np.stack([np.asarray(jax.random.uniform(k, idx.shape,
                                                     jnp.float32))
                       for k in jax.random.split(key, 3)], -1)
    ours = tocc.cell_positions(T(idx).long(), T(jitter))
    np.testing.assert_allclose(ours.numpy(), ref_pos, rtol=1e-6, atol=1e-7)

    grid = _seeded_grid(rng, 2)
    dens = rng.exponential(2.0, idx.shape[0]).astype(np.float32)
    np.testing.assert_array_equal(
        tocc.splat_and_ema(T(grid), T(idx).long(), T(dens), 0.95).numpy(),
        np.asarray(jocc.splat_and_ema(jnp.asarray(grid), jnp.asarray(idx),
                                      jnp.asarray(dens), 0.95)))


@pytest.mark.parametrize("aabb_scale", [1, 4])
def test_march_rays_matches_jax(aabb_scale):
    rng = np.random.default_rng(aabb_scale)
    max_mip = int(np.log2(aabb_scale))
    cone = 0.0 if aabb_scale == 1 else 1.0 / 256.0
    side = aabb_scale
    lo = np.full(3, 0.5 - side / 2, np.float32)
    hi = np.full(3, 0.5 + side / 2, np.float32)
    grid = _seeded_grid(rng, max_mip + 1)
    bitfield = np.asarray(jocc.update_bitfield(jnp.asarray(grid), max_mip))

    n = 300
    ang = rng.uniform(0, 2 * np.pi, n)
    eye = np.stack([0.5 + 1.2 * side * np.cos(ang),
                    rng.uniform(0.0, 1.0, n),
                    0.5 + 1.2 * side * np.sin(ang)], -1).astype(np.float32)
    target = rng.uniform(0.3, 0.7, (n, 3)).astype(np.float32)
    d = target - eye
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    tmin, tmax = jm.ray_intersect_aabb(jnp.asarray(eye), jnp.asarray(d),
                                       jnp.asarray(lo), jnp.asarray(hi))
    tmin = jnp.maximum(tmin, 0.0)
    valid = np.asarray(tmax >= tmin)
    t_start = np.asarray(jm.advance_n_steps(tmin, cone, 0.5))
    n_march, cap = 384, 200

    ts_j, dts_j, emit_j = jax_march_rays(
        JaxRayBatch(jnp.asarray(eye), jnp.asarray(d), jnp.asarray(t_start),
                    jnp.zeros(n, jnp.int32), jnp.zeros((n, 2)),
                    jnp.zeros((n, 4)), jnp.asarray(valid)),
        jnp.asarray(bitfield), jnp.asarray(lo), jnp.asarray(hi), cone,
        max_mip, n_march, cap)
    ts, dts, emit = march_rays(
        RayBatch(T(eye), T(d), T(t_start), T(valid)), T(bitfield), T(lo),
        T(hi), cone, max_mip, n_march, cap)
    np.testing.assert_allclose(ts.numpy(), np.asarray(ts_j), rtol=1e-6)
    np.testing.assert_allclose(dts.numpy(), np.asarray(dts_j), rtol=1e-4,
                               atol=1e-9)
    emit_j = np.asarray(emit_j)
    assert emit_j.sum() > 1000
    assert (emit.numpy() != emit_j).mean() <= 1e-4
