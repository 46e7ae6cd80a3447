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


def jax_train_draws(key, n_rays: int, n_images: int,
                    with_cdf: bool = False) -> TrainDraws:
    """The numbers nerf_train_step(key) draws for its rays, by its own key
    splits; `with_cdf`: those of sample_rays' error-CDF branch."""
    k_rays, k_bg, _ = jax.random.split(key, 3)
    k_pick, k_t = jax.random.split(k_rays)
    k_img, k_uv, k_mb, k_mix = jax.random.split(k_pick, 4)
    common = dict(
        motionblur_time=_t(jax.random.uniform(k_mb, (n_rays,))),
        start_jitter=_t(jax.random.uniform(k_t, (n_rays,))),
        bg_color=_t(jax.random.uniform(k_bg, (n_rays, 3))))
    if with_cdf:
        return TrainDraws(
            img_idx=None, uv=None,
            u_img=_t(jax.random.uniform(k_img, (n_rays,))),
            use_cdf=_t(jax.random.uniform(k_mix, (n_rays,)) >= 0.5),
            u2=_t(jax.random.uniform(k_uv, (n_rays, 2))),
            u_mix=_t(jax.random.uniform(jax.random.fold_in(k_mix, 1),
                                        (n_rays, 2))),
            jitter=_t(jax.random.uniform(jax.random.fold_in(k_uv, 1),
                                         (n_rays, 2))), **common)
    return TrainDraws(
        img_idx=_t(jax.random.randint(k_img, (n_rays,), 0, n_images),
                   torch.long),
        uv=_t(jax.random.uniform(k_uv, (n_rays, 2))), **common)


def jax_error_cdfs(error_map: np.ndarray, res):
    """The CDFs the JAX testbed's `_rebuild_error_cdfs` makes of an error
    map (n_images, H_c * W_c) with `res` = (W_c, H_c): run on a stand-in
    that carries just the attributes it reads -> (jax dict, port dict)."""
    import types

    from instant_ngp_tpu.nerf.testbed_nerf import NerfTestbed as JaxTestbed

    holder = types.SimpleNamespace(
        _error_map_res=res, _error_map=jnp.asarray(error_map),
        data=types.SimpleNamespace(n_images=error_map.shape[0]))
    JaxTestbed._rebuild_error_cdfs(holder)
    return holder._error_cdfs, {k: _t(v)
                                for k, v in holder._error_cdfs.items()}


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
    # every lens builds rays now (tests/test_torch_lenses.py holds them
    # to the JAX package)
    for name in ("OpenCV", "OpenCVFisheye", "LatLong", "Equirectangular"):
        o, d, ok = camera.uv_to_ray(
            _t(uv), (32, 32), _t(np.full(2, 30.0, np.float32)), _t(a[0]),
            lens_mode=camera.lens_mode_id(name),
            lens_params=_t(np.array([.05, .01, .001, .002, 0, 0, 0],
                                    np.float32)))
        assert o.shape == d.shape == (n, 3) and ok.all()
        assert torch.isfinite(d).all()


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
    # depth-major order keeps the same number of samples (which ones, and
    # where, is in tests/test_torch_render_modes.py); no other order
    sd = sampler.compact_samples(rays, ts, emit, _t(lo), _t(hi), capacity,
                                 0.0, order="depth")
    assert int(sd.n_samples) == n and int(sd.ray_count.sum()) == n
    with pytest.raises(ValueError):
        sampler.compact_samples(rays, ts, emit, _t(lo), _t(hi), capacity,
                                0.0, order="time")


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


def _error_map(rng, n_images, res, flat_images=()):
    cw, ch = res
    em = rng.uniform(0.0, 1.0, (n_images, ch * cw)).astype(np.float32) ** 4
    em[:, 5::7] = 0.0              # cells at the floor among large ones:
    #                                their float32 CDF steps are ties
    em[:, 3 * cw:5 * cw] = 0.0     # and two rows of them
    for i in flat_images:
        em[i] = 0.0                # a whole image at the floor
    return em


@pytest.mark.parametrize("snap", [False, True], ids=["free", "snapped"])
def test_sample_rays_cdf_branch_matches_jax(datasets, snap):
    """Error-map importance sampling, exactly: image, row and column by
    `searchsorted` (the first entry not below the lookup) on float32 CDFs
    that have ties where the map is at its floor."""
    _, jdata, _, data = datasets
    n_rays, res = 4096, (16, 8)
    em = _error_map(np.random.default_rng(21), 4, res, flat_images=(2,))
    jcdfs, cdfs = jax_error_cdfs(em, res)
    assert cdfs["cdf_x_cond_y"].shape == (4, 8, 16)
    assert cdfs["cdf_y"].shape == (4, 8) and cdfs["cdf_img"].shape == (4,)
    assert (np.diff(cdfs["cdf_x_cond_y"].numpy(), axis=2) == 0).any()
    key = jax.random.PRNGKey(5)
    k_pick = jax.random.split(jax.random.split(key, 3)[0])[0]
    ref_img, ref_uv, ref_mb = jsampler.sample_rays(
        k_pick, jdata, n_rays, snap, jcdfs)
    draws = jax_train_draws(key, n_rays, 4, with_cdf=True)
    img, uv, mb = sampler.sample_rays(draws, data, snap, cdfs)
    np.testing.assert_array_equal(img.numpy(), np.asarray(ref_img))
    np.testing.assert_array_equal(mb.numpy(), np.asarray(ref_mb))
    np.testing.assert_allclose(uv.numpy(), np.asarray(ref_uv), rtol=1e-6,
                               atol=1e-7)
    # both halves of both mixes were taken, and the map shows in the pick:
    # image 2 (all floor) gets about half of a uniform share
    assert 0.3 < draws.use_cdf.float().mean() < 0.7
    assert 0.3 < (draws.u_mix < 0.5).float().mean() < 0.7
    share = np.bincount(img.numpy(), minlength=4) / n_rays
    assert 0.09 < share[2] < 0.16 and share[[0, 1, 3]].min() > 0.25
    # the whole ray generation with CDFs
    lo, hi = np.zeros(3, np.float32), np.ones(3, np.float32)
    jrays, _ = jsampler.generate_rays(
        jax.random.split(key, 3)[0], jdata, n_rays, jnp.asarray(lo),
        jnp.asarray(hi), 0.0, 0, snap, error_cdfs=jcdfs)
    rays, _ = sampler.generate_rays(draws, data, _t(lo), _t(hi), 0.0, 0,
                                    snap, error_cdfs=cdfs)
    np.testing.assert_array_equal(rays.valid.numpy(),
                                  np.asarray(jrays.valid))
    for f in ("origins", "dirs", "t_start", "uv", "rgba"):
        np.testing.assert_allclose(getattr(rays, f).numpy(),
                                   np.asarray(getattr(jrays, f)),
                                   err_msg=f, **FLOAT_TOL)


def test_draw_train_randoms_with_cdf_fields():
    gen = torch.Generator().manual_seed(3)
    plain = sampler.draw_train_randoms(gen, 64, 4)
    assert plain.u_img is None and plain.img_idx.shape == (64,)
    d = sampler.draw_train_randoms(gen, 64, 4, with_cdf=True)
    assert d.img_idx is None and d.uv is None
    assert d.use_cdf.dtype == torch.bool
    for f, shape in (("u_img", (64,)), ("u2", (64, 2)), ("u_mix", (64, 2)),
                     ("jitter", (64, 2)), ("bg_color", (64, 3))):
        v = getattr(d, f)
        assert v.shape == shape and 0 <= v.min() and v.max() < 1
    assert d.to("cpu").u2.shape == (64, 2)


def test_rotvec_matrix_value_and_gradient_match_jax():
    """At zero (where camera offsets start), just around the Taylor
    switch, and away from it."""
    rng = np.random.default_rng(4)
    r = rng.normal(size=(40, 3)).astype(np.float32)
    r[:5] = 0.0
    r[5:10] *= 1e-5                       # below t^2 = 1e-8
    r[10:15] *= 2e-4                      # just above
    cot = rng.normal(size=(40, 3, 3)).astype(np.float32)
    ref = np.asarray(jsampler.rotvec_matrix(jnp.asarray(r)))
    ref_g = np.asarray(jax.grad(lambda v: jnp.sum(
        jsampler.rotvec_matrix(v) * jnp.asarray(cot)))(jnp.asarray(r)))
    rt = _t(r).requires_grad_(True)
    out = sampler.rotvec_matrix(rt)
    (g,) = torch.autograd.grad((out * _t(cot)).sum(), rt)
    assert torch.isfinite(g).all() and g[:5].abs().max() > 0.1
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=1e-6,
                               atol=1e-7)
    # just above the switch (1 - cos t) / t^2 cancels in float32 on either
    # side: those rows' gradients to 1e-3, the others' to 1e-5
    near = np.zeros(40, bool)
    near[10:15] = True
    np.testing.assert_allclose(g.numpy()[~near], ref_g[~near], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(g.numpy()[near], ref_g[near], rtol=1e-3,
                               atol=1e-3)
    # a rotation: orthonormal, and the Rodrigues matrix of the host side
    from instant_ngp_tpu_torch.ops.host_adam import rotvec_to_matrix
    np.testing.assert_allclose(out.detach().numpy()[15:],
                               rotvec_to_matrix(r[15:]), rtol=1e-5,
                               atol=1e-6)
    eye = out.detach() @ out.detach().transpose(-1, -2)
    np.testing.assert_allclose(eye.numpy(), np.broadcast_to(np.eye(3),
                                                            eye.shape),
                               atol=1e-5)


@pytest.mark.parametrize("at_zero", [True, False], ids=["zero", "offset"])
def test_build_rays_with_camera_offsets_matches_jax(datasets, at_zero):
    """Origins and directions through the offsets, and the gradients of a
    linear functional of them with respect to pos, rot and focal."""
    _, jdata, _, data = datasets
    n = 300
    rng = np.random.default_rng(8)
    img = rng.integers(0, 4, n)
    uv = rng.uniform(size=(n, 2)).astype(np.float32)
    mb = rng.uniform(size=n).astype(np.float32)
    c_o, c_d = (rng.normal(size=(n, 3)).astype(np.float32) for _ in "od")
    scale = 0.0 if at_zero else 1.0
    cam = {"pos": scale * rng.normal(0, 0.05, (4, 3)).astype(np.float32),
           "rot": scale * rng.normal(0, 0.1, (4, 3)).astype(np.float32),
           "focal": scale * rng.normal(0, 0.05, 2).astype(np.float32)}

    def jax_f(c):
        o, d, _ = jsampler.build_rays(jdata, jnp.asarray(img),
                                      jnp.asarray(uv), jnp.asarray(mb), 0, c)
        return jnp.sum(o * jnp.asarray(c_o) + d * jnp.asarray(c_d)), (o, d)

    (_, (ref_o, ref_d)), ref_g = jax.value_and_grad(jax_f, has_aux=True)(
        {k: jnp.asarray(v) for k, v in cam.items()})
    cam_t = {k: _t(v).requires_grad_(True) for k, v in cam.items()}
    o, d, ok = sampler.build_rays(data, _t(img), _t(uv), _t(mb), 0, cam_t)
    g = torch.autograd.grad((o * _t(c_o) + d * _t(c_d)).sum(),
                            list(cam_t.values()))
    assert ok.all()
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(ref_o),
                               **FLOAT_TOL)
    np.testing.assert_allclose(d.detach().numpy(), np.asarray(ref_d),
                               **FLOAT_TOL)
    for (k, ours) in zip(cam_t, g):
        ref = np.asarray(ref_g[k])
        assert np.abs(ref).max() > 0.1, k
        np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    if at_zero:      # zero offsets are no offsets
        o0, d0, _ = sampler.build_rays(data, _t(img), _t(uv), _t(mb), 0)
        np.testing.assert_allclose(o.detach().numpy(), o0.numpy(), atol=1e-7)
        np.testing.assert_allclose(d.detach().numpy(), d0.numpy(), atol=1e-6)


def test_error_map_and_camera_offsets_raise(datasets):
    """They no longer raise, and neither does a lens other than the
    pinhole, with or without offsets: a vanishing OpenCV distortion gives
    the pinhole's rays."""
    _, _, _, data = datasets
    draws = jax_train_draws(jax.random.PRNGKey(0), 8, 4)
    cam = {"pos": torch.zeros(4, 3), "rot": torch.zeros(4, 3),
           "focal": torch.zeros(2)}
    o, d, ok = sampler.build_rays(data, draws.img_idx, draws.uv,
                                  draws.motionblur_time, 0, cam=cam)
    assert o.shape == d.shape == (8, 3) and ok.all()
    o1, d1, ok1 = sampler.build_rays(data, draws.img_idx, draws.uv,
                                     draws.motionblur_time, 1, cam=cam)
    assert ok1.all()
    np.testing.assert_allclose(o1.numpy(), o.numpy(), atol=1e-7)
    np.testing.assert_allclose(d1.numpy(), d.numpy(), atol=1e-5)
