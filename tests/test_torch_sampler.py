"""The port's training-ray generation, compaction, occupancy sampling and
visibility culling against the JAX package, on the tiny synthetic dataset
of tests/test_nerf_training.py.

Where the JAX package draws random numbers, the draws are made here with
`jax.random` from the step's own key splits and handed to the port, so
both see the same numbers. Integers and booleans (pixel picks, ray ids,
slots, cell indices, visibility) must agree exactly; float fields agree to
rtol 1e-5 / atol 1e-6 (a few float32 operations in a different order)."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_nerf_training import make_dataset  # noqa: E402

from instant_ngp_tpu.nerf import dataset as jdataset
from instant_ngp_tpu.nerf import occupancy as jocc
from instant_ngp_tpu.nerf import sampler as jsampler
from instant_ngp_tpu.nerf.visibility import \
    compute_visible_cells as jax_visible_cells
from instant_ngp_tpu_torch.common import NERF_GRID_N_CELLS
from instant_ngp_tpu_torch.data.nerf_loader import (FrameMetadata, Lens,
                                                    NerfDataset)
from instant_ngp_tpu_torch.nerf import occupancy as occ
from instant_ngp_tpu_torch.nerf import sampler
from instant_ngp_tpu_torch.nerf.dataset import (pack_training_data,
                                                read_rgba,
                                                scene_config_from_dataset)
from instant_ngp_tpu_torch.nerf.occupancy import CellDraws
from instant_ngp_tpu_torch.nerf.sampler import TrainDraws
from instant_ngp_tpu_torch.nerf.visibility import compute_visible_cells

torch.set_num_threads(2)

FLOAT_TOL = dict(rtol=1e-5, atol=1e-6)


# -- shared with tests/test_torch_training.py ---------------------------
def port_dataset(jds) -> NerfDataset:
    """The port's dataset container with a JAX-package dataset's arrays."""
    metas = [FrameMetadata(m.resolution, m.focal_length, m.principal_point,
                           m.rolling_shutter, Lens(m.lens.mode,
                                                   m.lens.params))
             for m in jds.metadata]
    return NerfDataset(paths=list(jds.paths), images=jds.images,
                       depths=jds.depths, rays=jds.rays, metadata=metas,
                       xforms_start=jds.xforms_start,
                       xforms_end=jds.xforms_end, aabb_scale=jds.aabb_scale)


def _t(a, dtype=None):
    return torch.from_numpy(np.array(a)).to(dtype) if dtype \
        else torch.from_numpy(np.array(a))


def jax_train_draws(key, n_rays: int, n_images: int) -> TrainDraws:
    """The numbers nerf_train_step(key) draws, by its own key splits."""
    k_rays, k_bg, _ = jax.random.split(key, 3)
    k_pick, k_t = jax.random.split(k_rays)
    k_img, k_uv, k_mb, _ = jax.random.split(k_pick, 4)
    return TrainDraws(
        img_idx=_t(jax.random.randint(k_img, (n_rays,), 0, n_images),
                   torch.long),
        uv=_t(jax.random.uniform(k_uv, (n_rays, 2))),
        motionblur_time=_t(jax.random.uniform(k_mb, (n_rays,))),
        start_jitter=_t(jax.random.uniform(k_t, (n_rays,))),
        bg_color=_t(jax.random.uniform(k_bg, (n_rays, 3))))


def jax_cell_draws(key, n_uniform: int, n_nonuniform: int, n_cascades: int
                   ) -> CellDraws:
    """The numbers occupancy.sample_cells(key, ...) draws."""
    out = []
    for k, n, salt in zip(jax.random.split(key), (n_uniform, n_nonuniform),
                          (0, 2)):
        keys = jax.random.fold_in(k, salt)
        out.append(_t(jax.random.randint(keys, (10, n), 0,
                                         NERF_GRID_N_CELLS), torch.long))
        out.append(_t(jax.random.randint(jax.random.fold_in(keys, 1), (n,),
                                         0, n_cascades), torch.long))
    return CellDraws(*out)


def jax_cell_jitter(key, n: int) -> torch.Tensor:
    """The (n, 3) jitter occupancy.cell_positions(idx, key) draws."""
    return _t(np.stack([np.asarray(jax.random.uniform(k, (n,), jnp.float32))
                        for k in jax.random.split(key, 3)], -1))


def random_bitfield(seed=0, fill=0.3):
    """A bitfield (numpy uint8) from a random density grid, by the JAX
    package's own update_bitfield."""
    rng = np.random.default_rng(seed)
    grid = np.where(rng.uniform(size=NERF_GRID_N_CELLS) < fill,
                    rng.uniform(0.02, 1.0, NERF_GRID_N_CELLS),
                    0.0).astype(np.float32)
    return grid, np.asarray(jocc.update_bitfield(jnp.asarray(grid), 0))


# ------------------------------------------------------------------------
@pytest.fixture(scope="module")
def datasets():
    jds = make_dataset()
    # partial alpha, a masked (hot-pink) pixel block, a dark pixel
    jds.images[1][4:8, 4:8] = [255, 0, 255, 0]
    jds.images[2][10:14, 10:20] = [200, 100, 10, 128]
    jds.images[3][0:3, 0:3] = [5, 9, 2, 255]
    jdata = jdataset.pack_training_data(jds)
    pds = port_dataset(jds)
    return jds, jdata, pds, pack_training_data(pds, "cpu")


def test_scene_config_and_packing(datasets):
    jds, jdata, pds, data = datasets
    jscene = jdataset.scene_config_from_dataset(jds)
    scene = scene_config_from_dataset(pds)
    for f in ("aabb_scale", "max_cascade", "cone_angle_constant",
              "rgb_activation", "density_activation", "lens_mode",
              "near_distance", "n_extra_dims"):
        assert getattr(scene, f) == getattr(jscene, f), f
    np.testing.assert_array_equal(scene.aabb_min, jscene.aabb_min)
    np.testing.assert_array_equal(scene.aabb_max, jscene.aabb_max)
    assert data.pixels.dtype == torch.uint8
    assert data.n_images == jdata.n_images == 4
    assert data.resolution == jdata.resolution
    for f in ("pixels", "resolutions", "xforms_start", "xforms_end",
              "focal_lengths", "principal_points", "rolling_shutter",
              "lens_params", "exposures"):
        np.testing.assert_array_equal(getattr(data, f).numpy(),
                                      np.asarray(getattr(jdata, f)), f)


def test_read_rgba_matches_jax(datasets):
    _, jdata, _, data = datasets
    rng = np.random.default_rng(1)
    n = 3000
    img = rng.integers(0, 4, n)
    px = rng.integers(-2, 35, (n, 2)).astype(np.int32)   # out of range too
    ref = np.asarray(jdataset.read_rgba(jdata.pixels, jnp.asarray(img),
                                        jnp.asarray(px)))
    ours = read_rgba(data.pixels, _t(img), _t(px)).numpy()
    assert (ref == -1.0).all(axis=-1).any()              # the mask was hit
    np.testing.assert_array_equal(ours == -1.0, ref == -1.0)
    np.testing.assert_allclose(ours, ref, **FLOAT_TOL)


@pytest.mark.parametrize("snap", [False, True], ids=["free", "snapped"])
def test_generate_rays_matches_jax(datasets, snap):
    _, jdata, _, data = datasets
    n_rays = 1024
    lo, hi = np.zeros(3, np.float32), np.ones(3, np.float32)
    for cone in (0.0, 1.0 / 256.0):
        key = jax.random.PRNGKey(3)
        k_rays = jax.random.split(key, 3)[0]
        jrays, jmb = jsampler.generate_rays(
            k_rays, jdata, n_rays, jnp.asarray(lo), jnp.asarray(hi), cone, 0,
            snap)
        draws = jax_train_draws(key, n_rays, 4)
        rays, mb = sampler.generate_rays(draws, data, _t(lo), _t(hi), cone,
                                         0, snap)
        np.testing.assert_array_equal(rays.img_idx.numpy(),
                                      np.asarray(jrays.img_idx))
        np.testing.assert_array_equal(rays.valid.numpy(),
                                      np.asarray(jrays.valid))
        assert 0 < rays.valid.sum() < n_rays         # masked lanes exist
        np.testing.assert_array_equal(mb.numpy(), np.asarray(jmb))
        for f in ("origins", "dirs", "t_start", "uv", "rgba"):
            np.testing.assert_allclose(getattr(rays, f).numpy(),
                                       np.asarray(getattr(jrays, f)),
                                       err_msg=f, **FLOAT_TOL)


def test_rolling_shutter_camera_matches_jax():
    from instant_ngp_tpu import camera as jcamera
    from instant_ngp_tpu_torch import camera

    rng = np.random.default_rng(2)
    n = 200

    def rotations():
        q, _ = np.linalg.qr(rng.normal(size=(n, 3, 3)))
        q = q * np.sign(np.linalg.det(q))[:, None, None]
        return np.concatenate([q, rng.normal(size=(n, 3, 1))],
                              -1).astype(np.float32)

    a, b = rotations(), rotations()
    b[:20] = a[:20]                               # identical: nlerp branch
    shutter = rng.uniform(0, 0.5, (n, 4)).astype(np.float32)
    uv = rng.uniform(size=(n, 2)).astype(np.float32)
    mb = rng.uniform(size=n).astype(np.float32)
    ref = np.asarray(jcamera.xform_with_rolling_shutter(
        *(jnp.asarray(v) for v in (a, b, shutter, uv, mb))))
    ours = camera.xform_with_rolling_shutter(
        *(_t(v) for v in (a, b, shutter, uv, mb))).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-5)
    assert camera.lens_mode_id("Perspective") == \
        jcamera.lens_mode_id("Perspective") == 0
    for name in ("OpenCV", "FTheta", "LatLong", "OpenCVFisheye",
                 "Equirectangular"):
        assert camera.lens_mode_id(name) == jcamera.lens_mode_id(name)
    with pytest.raises(NotImplementedError):
        camera.uv_to_ray(_t(uv), (32, 32), _t(np.ones(2, np.float32)),
                         _t(a[0]), lens_mode=camera.lens_mode_id("OpenCV"))


@pytest.mark.parametrize("capacity", [1 << 14, 1000],
                         ids=["roomy", "truncating"])
def test_compact_samples_matches_jax(datasets, capacity):
    _, jdata, _, data = datasets
    n_rays, n_march, max_k = 512, 96, 32
    lo, hi = np.zeros(3, np.float32), np.ones(3, np.float32)
    _, bitfield = random_bitfield()
    key = jax.random.PRNGKey(9)
    jrays, _ = jsampler.generate_rays(
        jax.random.split(key, 3)[0], jdata, n_rays, jnp.asarray(lo),
        jnp.asarray(hi), 0.0, 0)
    jts, jdts, jemit = jsampler.march_rays(
        jrays, jnp.asarray(bitfield), jnp.asarray(lo), jnp.asarray(hi), 0.0,
        0, n_march, max_k)
    js = jsampler.compact_samples(jrays, jts, jdts, jemit, jnp.asarray(lo),
                                  jnp.asarray(hi), capacity, cone_angle=0.0)

    rays, _ = sampler.generate_rays(jax_train_draws(key, n_rays, 4), data,
                                    _t(lo), _t(hi), 0.0, 0)
    ts, dts, emit = sampler.march_rays(rays, _t(bitfield), _t(lo), _t(hi),
                                       0.0, 0, n_march, max_k)
    np.testing.assert_array_equal(emit.numpy(), np.asarray(jemit))
    s = sampler.compact_samples(rays, ts, emit, _t(lo), _t(hi), capacity,
                                0.0)
    n_emitted = int(np.asarray(jemit).sum())
    if capacity == 1000:
        assert n_emitted > capacity                  # it does truncate
    else:
        assert 0 < n_emitted < capacity
    n = int(s.n_samples)
    assert n == int(js.n_samples) == min(n_emitted, capacity)
    for f in ("ray_base", "ray_count", "cand_slot", "cand_src", "ray_id"):
        np.testing.assert_array_equal(getattr(s, f).numpy(),
                                      np.asarray(getattr(js, f)), f)
    # the sentinels
    assert (s.cand_src[n:] == n_rays * n_march).all()
    assert (s.cand_slot[~emit] == capacity).all()
    assert int((s.cand_slot < capacity).sum()) == n
    for f in ("dts", "t_mid"):
        np.testing.assert_allclose(getattr(s, f).numpy(),
                                   np.asarray(getattr(js, f)), err_msg=f,
                                   **FLOAT_TOL)
    for f in ("positions", "dirs"):
        ref = np.stack([np.asarray(c) for c in getattr(js, f)], -1)
        np.testing.assert_allclose(getattr(s, f).numpy(), ref, err_msg=f,
                                   **FLOAT_TOL)
    with pytest.raises(NotImplementedError):
        sampler.compact_samples(rays, ts, emit, _t(lo), _t(hi), capacity,
                                0.0, order="depth")


def test_sample_cells_matches_jax():
    grid, _ = random_bitfield(seed=4, fill=0.05)
    n_cascades = 2
    grid2 = np.concatenate([grid, -np.ones_like(grid)])   # untrained mip 1
    key = jax.random.PRNGKey(12)
    n_u, n_n = 3000, 2000
    ref = np.asarray(jocc.sample_cells(key, jnp.asarray(grid2), 0, n_u, n_n,
                                       n_cascades))
    ours = occ.sample_cells(jax_cell_draws(key, n_u, n_n, n_cascades),
                            _t(grid2), n_u, n_n, n_cascades).numpy()
    np.testing.assert_array_equal(ours, ref)
    # with 5 % occupied, some slots fail all 10 probes and keep the last
    assert (grid2[ours[n_u:]] <= 0.01).any()
    # the full sweep enumerates and takes no draws
    full = occ.sample_cells(None, _t(grid2), 2 * NERF_GRID_N_CELLS, 0, 2)
    assert torch.equal(full, torch.arange(2 * NERF_GRID_N_CELLS))
    # cell positions from the JAX package's jitter draws
    k_pos = jax.random.PRNGKey(13)
    ref_pos = np.stack([np.asarray(c) for c in jocc.cell_positions(
        jnp.asarray(ref), k_pos)], -1)
    ours_pos = occ.cell_positions(_t(ours), jax_cell_jitter(k_pos, len(ref)))
    np.testing.assert_allclose(ours_pos.numpy(), ref_pos, **FLOAT_TOL)


def test_mark_untrained_and_visible_cells_match_jax(datasets):
    jds, jdata, pds, data = datasets
    jscene = jdataset.scene_config_from_dataset(jds)
    scene = scene_config_from_dataset(pds)
    ref = np.asarray(jax_visible_cells(jdata, jscene))
    ours = compute_visible_cells(data, scene).numpy()
    assert ours.shape == ref.shape == (NERF_GRID_N_CELLS,)
    assert 0 < ref.sum() < ref.size
    np.testing.assert_array_equal(ours, ref)
    rng = np.random.default_rng(6)
    grid = rng.normal(size=NERF_GRID_N_CELLS).astype(np.float32)
    np.testing.assert_array_equal(
        occ.mark_untrained_cells(_t(grid), _t(ours)).numpy(),
        np.asarray(jocc.mark_untrained_cells(jnp.asarray(grid),
                                             jnp.asarray(ref))))


def test_error_map_and_camera_offsets_raise(datasets):
    _, _, _, data = datasets
    draws = jax_train_draws(jax.random.PRNGKey(0), 8, 4)
    with pytest.raises(NotImplementedError, match="error-map"):
        sampler.sample_rays(draws, data, error_cdfs={"cdf_img": None})
    with pytest.raises(NotImplementedError, match="camera offsets"):
        sampler.build_rays(data, draws.img_idx, draws.uv,
                           draws.motionblur_time, 0, cam={"pos": None})
