"""The port's lens models (`camera.py`), the trainable maps' lookups
(`ops/trainable_buffer.py`) and the lenses' users (`build_rays`, the
visibility culling) against the JAX package, on inputs made from a numpy
seed.

Tolerances:
- closed-form lens math (distortion deltas, f-theta, latlong,
  equirectangular, `pos_to_uv`, the aperture, `bilerp_2d`, `read_envmap`):
  rtol 1e-5 / atol 1e-6, a few float32 operations in another order;
- the Newton undistortion: its central differences step by
  max(eps, |1e-6 x|), the resolution of float32, so the Jacobian is mostly
  rounding and XLA and PyTorch round it differently. The undistorted point
  is held to the JAX value at 1e-5 absolute, and to the property that
  matters: distorting it gives back the input to 1e-5;
- gradients with respect to the distortion map and the envmap: rtol 1e-4
  of the largest entry (scatter-adds of float32 in another order);
- visibility is a boolean per cell: equal but for cells whose corner
  projects within float32 rounding of the image's edge (at most 1 cell in
  10^5 may differ)."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_nerf_training import make_dataset  # noqa: E402
from test_torch_sampler import port_dataset  # noqa: E402

from instant_ngp_tpu import camera as jcamera
from instant_ngp_tpu.nerf import dataset as jdataset
from instant_ngp_tpu.nerf import sampler as jsampler
from instant_ngp_tpu.nerf.visibility import \
    compute_visible_cells as jax_visible_cells
from instant_ngp_tpu.ops import trainable_buffer as jbuffer
from instant_ngp_tpu_torch import camera
from instant_ngp_tpu_torch.nerf import sampler
from instant_ngp_tpu_torch.nerf.dataset import (pack_training_data,
                                                scene_config_from_dataset)
from instant_ngp_tpu_torch.nerf.visibility import compute_visible_cells
from instant_ngp_tpu_torch.ops import trainable_buffer as buffer

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-6)
NEWTON_ATOL = 1e-5
LENSES = ["Perspective", "OpenCV", "FTheta", "LatLong", "OpenCVFisheye",
          "Equirectangular"]
LENS_PARAMS = {
    "Perspective": [0, 0, 0, 0, 0, 0, 0],
    "OpenCV": [0.08, -0.02, 0.003, -0.002, 0, 0, 0],
    "OpenCVFisheye": [0.03, 0.01, -0.004, 0.001, 0, 0, 0],
    "FTheta": [0.0, 2.2e-2, 1e-5, -2e-7, 1e-9, 64.0, 48.0],
    "LatLong": [0, 0, 0, 0, 0, 0, 0],
    "Equirectangular": [0, 0, 0, 0, 0, 0, 0],
}
RES = (64, 48)
FOCAL = np.array([50.0, 52.0], np.float32)
CENTER = (0.52, 0.47)


def _t(a):
    return torch.from_numpy(np.array(a))


def _camera(rng):
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    return np.concatenate([q, rng.normal(0.5, 0.3, (3, 1))],
                          axis=1).astype(np.float32)


@pytest.mark.parametrize("name", ["OpenCV", "OpenCVFisheye"])
def test_distortion_delta_and_newton_undistortion_match_jax(name):
    rng = np.random.default_rng(1)
    p = np.array(LENS_PARAMS[name], np.float32)
    u, v = rng.uniform(-0.7, 0.7, (2, 4000)).astype(np.float32)
    u[:3], v[:3] = 0.0, [0.0, 0.3, -0.2]          # the axis and its row
    fn, jfn = {
        "OpenCV": (camera.opencv_lens_distortion_delta,
                   jcamera.opencv_lens_distortion_delta),
        "OpenCVFisheye": (camera.opencv_fisheye_lens_distortion_delta,
                          jcamera.opencv_fisheye_lens_distortion_delta),
    }[name]
    ours = fn(_t(p), _t(u), _t(v))
    ref = jfn(jnp.asarray(p), jnp.asarray(u), jnp.asarray(v))
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    # per-point parameters broadcast
    per = np.broadcast_to(p, (u.size, 7)).copy()
    for a, b in zip(fn(_t(per), _t(u), _t(v)), ours):
        np.testing.assert_array_equal(a.numpy(), b.numpy())

    xu, xv = camera.iterative_lens_undistortion(_t(p), _t(u), _t(v), fn)
    ju, jv = jcamera.iterative_lens_undistortion(
        jnp.asarray(p), jnp.asarray(u), jnp.asarray(v), jfn)
    np.testing.assert_allclose(xu.numpy(), np.asarray(ju), rtol=0,
                               atol=NEWTON_ATOL)
    np.testing.assert_allclose(xv.numpy(), np.asarray(jv), rtol=0,
                               atol=NEWTON_ATOL)
    du, dv = fn(_t(p), xu, xv)
    np.testing.assert_allclose((xu + du).numpy(), u, rtol=0, atol=1e-5)
    np.testing.assert_allclose((xv + dv).numpy(), v, rtol=0, atol=1e-5)
    assert float((xu - _t(u)).abs().max()) > 1e-3     # it did move points


@pytest.mark.parametrize("per_ray", [False, True], ids=["one", "per_ray"])
@pytest.mark.parametrize("name", LENSES)
def test_uv_to_ray_matches_jax(name, per_ray):
    rng = np.random.default_rng(2)
    n = 1500
    uv = rng.uniform(0.0, 1.0, (n, 2)).astype(np.float32)
    uv[0] = CENTER                         # the f-theta lens sees no centre
    mode = camera.lens_mode_id(name)
    params = np.array(LENS_PARAMS[name], np.float32)
    cam, res, fl = _camera(rng), np.array(RES, np.float32), FOCAL
    center = np.array(CENTER, np.float32)
    if per_ray:
        cam = np.stack([_camera(rng) for _ in range(n)])
        res = np.broadcast_to(res, (n, 2)).copy()
        fl = (fl * rng.uniform(0.9, 1.1, (n, 1))).astype(np.float32)
        params = np.broadcast_to(params, (n, 7)).copy()
    o, d, ok = camera.uv_to_ray(
        _t(uv), _t(res) if per_ray else RES, _t(fl), _t(cam), CENTER,
        lens_mode=mode, lens_params=_t(params), near_distance=0.05)
    jo, jd, jok = jcamera.uv_to_ray(
        jnp.asarray(uv), jnp.asarray(res), jnp.asarray(fl),
        jnp.asarray(cam), center, lens_mode=mode,
        lens_params=jnp.asarray(params), near_distance=0.05)
    newton = name in ("OpenCV", "OpenCVFisheye")
    tol = dict(rtol=0, atol=2 * NEWTON_ATOL) if newton else TOL
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), **tol)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **tol)
    assert ok.dtype == torch.bool and o.shape == d.shape == (n, 3)
    if name == "FTheta":
        assert not ok[0] and ok[1:].any() and (d[0] == 0).all()
    else:
        assert ok.all()
    if name in ("Perspective", "OpenCV", "OpenCVFisheye"):
        # projecting a point of the ray gives back its pixel
        back, z = camera.pos_to_uv(o + 0.7 * d, _t(res) if per_ray else RES,
                                   _t(fl), _t(cam), CENTER, mode, _t(params))
        np.testing.assert_allclose(back.numpy(), uv, rtol=0, atol=2e-5)
        assert (z > 0).all()


@pytest.mark.parametrize("name", LENSES)
def test_pos_to_uv_matches_jax(name):
    rng = np.random.default_rng(3)
    pos = rng.uniform(-1, 2, (2000, 3)).astype(np.float32)
    cam = _camera(rng)
    mode = camera.lens_mode_id(name)
    params = np.array(LENS_PARAMS[name], np.float32)
    uv, z = camera.pos_to_uv(_t(pos), RES, _t(FOCAL), _t(cam), CENTER, mode,
                             _t(params))
    juv, jz = jcamera.pos_to_uv(jnp.asarray(pos), RES, jnp.asarray(FOCAL),
                                jnp.asarray(cam), CENTER, mode,
                                jnp.asarray(params))
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), **TOL)
    # a point near the camera's plane projects arbitrarily far away, and
    # the distortion polynomial raises that to the fifth power: compare
    # within ten image widths of the image
    near = np.abs(np.asarray(juv)).max(axis=-1) < 10.0
    assert near.sum() > 1000
    np.testing.assert_allclose(uv.numpy()[near], np.asarray(juv)[near],
                               rtol=1e-4, atol=1e-5)


def test_aperture_and_disk_map_match_jax_from_supplied_samples():
    rng = np.random.default_rng(4)
    n = 900
    s = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    s[:4] = [[0, 0], [1, 1], [-1, 0.3], [1e-13, 1e-14]]
    np.testing.assert_allclose(camera.square2disk_shirley(_t(s)).numpy(),
                               np.asarray(jcamera.square2disk_shirley(
                                   jnp.asarray(s))), **TOL)
    assert float(camera.square2disk_shirley(_t(s)).norm(dim=-1).max()) \
        <= 1.0 + 1e-6
    uv = rng.uniform(size=(n, 2)).astype(np.float32)
    samples = rng.uniform(size=(n, 2)).astype(np.float32)
    cam = _camera(rng)
    kw = dict(aperture_size=0.03, focus_z=1.7)
    o, d, _ = camera.uv_to_ray(_t(uv), RES, _t(FOCAL), _t(cam), CENTER,
                               aperture_samples=_t(samples), **kw)
    jo, jd, _ = jcamera.uv_to_ray(jnp.asarray(uv), RES, jnp.asarray(FOCAL),
                                  jnp.asarray(cam), CENTER,
                                  aperture_samples=jnp.asarray(samples), **kw)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), **TOL)
    # every ray still passes through its pixel's point on the focus plane
    o0, d0, _ = camera.uv_to_ray(_t(uv), RES, _t(FOCAL), _t(cam), CENTER)
    np.testing.assert_allclose((o + 1.7 * d).numpy(),
                               (o0 + 1.7 * d0).numpy(), atol=1e-5)
    assert float((o - o0).norm(dim=-1).max()) > 0.01
    # without samples the aperture is ignored, as in the JAX package
    o1, _, _ = camera.uv_to_ray(_t(uv), RES, _t(FOCAL), _t(cam), CENTER,
                                **kw)
    assert torch.equal(o1, o0)


def test_bilerp_and_envmap_lookup_and_gradients_match_jax():
    rng = np.random.default_rng(5)
    grid = rng.normal(size=(6, 9, 4)).astype(np.float32)
    uv = rng.uniform(-0.1, 1.1, (700, 2)).astype(np.float32)
    uv[:4] = [[0, 0], [1, 1], [0.5 / 9, 0.5 / 6], [1 - 1e-7, 0.5]]
    w = rng.normal(size=(700, 4)).astype(np.float32)
    g = _t(grid).requires_grad_(True)
    out = buffer.bilerp_2d(g, _t(uv))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(
        jbuffer.bilerp_2d(jnp.asarray(grid), jnp.asarray(uv))), **TOL)
    (grad,) = torch.autograd.grad((out * _t(w)).sum(), g)
    ref = jax.grad(lambda m: jnp.sum(jbuffer.bilerp_2d(
        m, jnp.asarray(uv)) * w))(jnp.asarray(grid))
    np.testing.assert_allclose(grad.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())

    dirs = rng.normal(size=(700, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    dirs[:3] = [[0, 1, 0], [0, -1, 0], [0, 0, -1]]     # poles and the seam
    out = buffer.read_envmap(g, _t(dirs))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(
        jbuffer.read_envmap(jnp.asarray(grid), jnp.asarray(dirs))), **TOL)
    (grad,) = torch.autograd.grad((out * _t(w)).sum(), g)
    ref = jax.grad(lambda m: jnp.sum(jbuffer.read_envmap(
        m, jnp.asarray(dirs)) * w))(jnp.asarray(grid))
    np.testing.assert_allclose(grad.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("name", ["Perspective", "OpenCV"])
def test_distortion_map_and_its_gradient_match_jax(name):
    rng = np.random.default_rng(6)
    n = 800
    uv = rng.uniform(size=(n, 2)).astype(np.float32)
    dmap = rng.normal(0, 0.02, (8, 8, 2)).astype(np.float32)
    cam = _camera(rng)
    mode = camera.lens_mode_id(name)
    params = np.array(LENS_PARAMS[name], np.float32)
    w = rng.normal(size=(n, 3)).astype(np.float32)

    m = _t(dmap).requires_grad_(True)
    o, d, _ = camera.uv_to_ray(_t(uv), RES, _t(FOCAL), _t(cam), CENTER,
                               lens_mode=mode, lens_params=_t(params),
                               distortion_map=m)

    def jax_dirs(dm):
        return jcamera.uv_to_ray(
            jnp.asarray(uv), RES, jnp.asarray(FOCAL), jnp.asarray(cam),
            CENTER, lens_mode=mode, lens_params=jnp.asarray(params),
            distortion_map=dm)[1]

    tol = dict(rtol=0, atol=2 * NEWTON_ATOL) if name == "OpenCV" else TOL
    np.testing.assert_allclose(d.detach().numpy(),
                               np.asarray(jax_dirs(jnp.asarray(dmap))), **tol)
    plain = camera.uv_to_ray(_t(uv), RES, _t(FOCAL), _t(cam), CENTER,
                             lens_mode=mode, lens_params=_t(params))[1]
    assert float((d.detach() - plain).abs().max()) > 1e-3
    (grad,) = torch.autograd.grad((d * _t(w)).sum(), m)
    ref = jax.grad(lambda dm: jnp.sum(jax_dirs(dm) * w))(jnp.asarray(dmap))
    assert np.abs(ref).max() > 0
    np.testing.assert_allclose(grad.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())


def _lens_datasets(name):
    jds = make_dataset()
    for i, m in enumerate(jds.metadata):
        m.lens.mode = name
        m.lens.params = np.array(LENS_PARAMS[name], np.float32) \
            * (1.0 + 0.1 * i)
        if name == "FTheta":
            m.lens.params[5:] = 32.0
    pds = port_dataset(jds)
    return jds, jdataset.pack_training_data(jds), pds, \
        pack_training_data(pds, "cpu")


@pytest.mark.parametrize("with_map", [False, True], ids=["lens", "lens+map"])
@pytest.mark.parametrize("name", LENSES[1:])
def test_build_rays_through_each_lens_matches_jax(name, with_map):
    jds, jdata, pds, data = _lens_datasets(name)
    mode = camera.lens_mode_id(name)
    assert scene_config_from_dataset(pds).lens_mode == mode \
        == jdataset.scene_config_from_dataset(jds).lens_mode
    rng = np.random.default_rng(7)
    n = 600
    img = rng.integers(0, 4, n)
    uv = rng.uniform(size=(n, 2)).astype(np.float32)
    mb = rng.uniform(size=n).astype(np.float32)
    dmap = rng.normal(0, 0.02, (4, 4, 2)).astype(np.float32) \
        if with_map else None
    o, d, ok = sampler.build_rays(
        data, _t(img), _t(uv), _t(mb), mode,
        distortion_map=None if dmap is None else _t(dmap))
    jo, jd, jok = jsampler.build_rays(
        jdata, jnp.asarray(img), jnp.asarray(uv), jnp.asarray(mb), mode,
        distortion_map=None if dmap is None else jnp.asarray(dmap))
    valid = np.asarray(jok)
    np.testing.assert_array_equal(ok.numpy(), valid)
    tol = dict(rtol=0, atol=2 * NEWTON_ATOL)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **tol)
    np.testing.assert_allclose(d.numpy()[valid], np.asarray(jd)[valid],
                               **tol)
    np.testing.assert_allclose(d.norm(dim=-1).numpy()[valid], 1.0,
                               atol=1e-5)


@pytest.mark.parametrize("name", LENSES[1:])
def test_visible_cells_through_each_lens_match_jax(name):
    jds, jdata, pds, data = _lens_datasets(name)
    ref = np.asarray(jax_visible_cells(
        jdata, jdataset.scene_config_from_dataset(jds)))
    ours = compute_visible_cells(data, scene_config_from_dataset(pds)).numpy()
    assert ours.shape == ref.shape and ours.dtype == bool
    if name in ("FTheta", "LatLong", "Equirectangular"):
        assert ours.all() and ref.all()
        return
    assert 0 < ref.sum() < ref.size
    assert (ours != ref).sum() <= ref.size // 100000
    # the lens changes what is seen
    jds0 = make_dataset()
    pinhole = compute_visible_cells(
        pack_training_data(port_dataset(jds0), "cpu"),
        scene_config_from_dataset(port_dataset(jds0))).numpy()
    assert (ours != pinhole).sum() > 100
