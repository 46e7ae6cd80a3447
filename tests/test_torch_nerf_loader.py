"""`load_nerf` of the port against the JAX package's: captures written to a
temporary directory (PNG and EXR frames of 12x10 pixels, every key the
loader reads, comments in the JSON) load to the same `NerfDataset` in both
packages, field for field and exactly (both loaders do the same numpy
arithmetic on the same files). Then what the testbed makes of a loaded
dataset: `scene_config_from_dataset` and `pack_training_data` against the
JAX package's, exactly but for the latent codes, whose N(0, 0.1) draws come
from each package's own generator (parity there is by supplied values)."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from instant_ngp_tpu.data import nerf_loader as jloader
from instant_ngp_tpu.nerf import dataset as jdataset
from instant_ngp_tpu_torch.camera import lens_mode_id
from instant_ngp_tpu_torch.data import nerf_loader as loader
from instant_ngp_tpu_torch.data.exr import write_exr
from instant_ngp_tpu_torch.nerf import dataset

W, H = 12, 10
KINDS = ["opencv", "fisheye", "ftheta", "latlong", "mitsuba", "exr", "two"]


def _same(a, b, what=""):
    """Recursive equality of two loaded values; dataclasses of either
    package compare by their fields."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, what
        names = [f.name for f in dataclasses.fields(b)]
        assert names == [f.name for f in dataclasses.fields(a)], what
        for n in names:
            _same(getattr(a, n), getattr(b, n), f"{what}.{n}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{what}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), what
        assert a.dtype == b.dtype and a.shape == b.shape, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert type(a) is type(b) and a == b, (what, a, b)


def _pose(rng):
    m = np.eye(4)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    m[:3, :3] = q
    m[:3, 3] = rng.normal(0, 1.5, 3)
    return m.tolist()


def _png(path, rng, mode="RGBA"):
    c = {"RGBA": 4, "RGB": 3, "L": 1}[mode]
    a = rng.integers(0, 256, (H, W, c), dtype=np.uint8)
    a[0, 0] = 255                           # a white and a black pixel
    a[1, 1, :3 if c > 1 else 1] = 0
    Image.fromarray(a[..., 0] if c == 1 else a, mode).save(path)


def write_capture(root, kind):
    """-> the transforms paths of a capture of `kind`."""
    rng = np.random.default_rng(KINDS.index(kind))
    os.makedirs(root / "images", exist_ok=True)
    hdr = kind == "exr"
    ext = ".exr" if hdr else ".png"
    names = ["img_10", "img_2", "img_1", "img_003", "img_21"]
    frames = []
    for i, name in enumerate(names):
        path = root / "images" / (name + ext)
        if hdr:
            img = rng.uniform(0, 3, (H, W, 4 if i % 2 else 3)).astype(
                np.float32)
            write_exr(str(path), img, half=bool(i % 2))
        else:
            _png(path, rng, "RGBA" if i != 3 else "RGB")
        # file_path with and without its extension, and a Windows path
        fp = f"images/{name}" if i % 2 else f"images\\{name}{ext}"
        frames.append({"file_path": fp, "transform_matrix": _pose(rng),
                       "sharpness": float(30 + 10 * i)})
    top = {"frames": frames, "w": W, "h": H}
    paths = [root / "transforms.json"]

    if kind == "opencv":
        top.update(
            aabb_scale=4, scale=0.5, offset=[0.4, 0.5, 0.6], up=[0, 0, 1],
            render_aabb=[[0.1, 0.2, 0.3], [0.7, 0.8, 0.9]],
            white_transparent=True, importance_sampling=False,
            n_extra_learnable_dims=3, integer_depth_scale=0.001,
            envmap="env.png", sharpen=0.5, fl_x=14.0, fl_y=15.0, cx=5.5,
            cy=5.25, k1=0.05, k2=-0.01, p1=0.002, p2=-0.003,
            rolling_shutter=[0.1, 0.2, 0.3], n_frames=4,
            sharpness_discard_threshold=0.5)
        _png(root / "env.png", rng, "RGBA")
        # per-frame overrides, a depth image, a moving camera, sidecars
        frames[1].update(fl_x=13.0, k1=0.07, cx=6.5, w=W, h=H,
                         rolling_shutter=[0.0, 0.1, 0.9, 0.5])
        frames[2]["depth_path"] = "images\\depth_1.png"
        Image.fromarray(rng.integers(0, 4000, (H, W)).astype(np.uint16)
                        ).save(root / "images" / "depth_1.png")
        frames[1]["transform_matrix_start"] = frames[1].pop(
            "transform_matrix")
        frames[1]["transform_matrix_end"] = _pose(rng)
        _png(root / "images" / "img_2.png.alpha.png", rng, "RGB")
        mask = np.zeros((H, W, 3), np.uint8)
        mask[2:5, 3:7] = 200
        Image.fromarray(mask).save(root / "images" / "dynamic_mask_img_1.png")
        rng.normal(size=(H, W, 6)).astype(np.float32).tofile(
            root / "images" / "rays_img_2.dat")
        frames[0]["sharpness"] = 1.0        # blurrier than its neighbours
    elif kind == "fisheye":
        top.update(aabb=[[-2, -1, -1.5], [2, 3, 1.5]], is_fisheye=True,
                   k1=0.01, k2=0.02, k3=0.003, k4=-0.004, x_fov=70.0,
                   y_fov=60.0, black_transparent=True, enable_depth_loading=False,
                   enable_ray_loading=False, offset=0.25)
        for fr in frames:
            fr.pop("sharpness")
        rng.normal(size=(H, W, 6)).astype(np.float32).tofile(
            root / "images" / "rays_img_2.dat")
    elif kind == "ftheta":
        top.update({f"ftheta_p{i}": v for i, v in enumerate(
            [0.0, 0.08, 1e-3, -1e-5, 1e-7])}, camera_angle_x=1.1,
            aabb_scale=2)
        frames[3]["camera_angle_y"] = 0.9
    elif kind == "latlong":
        top.update(latlong=True, camera_angle_y=0.8)
        frames[2]["equirectangular"] = True
    elif kind == "mitsuba":
        top.update(normal_mts_args="x", camera_angle_x=0.7, scale=0.5,
                   n_extra_learnable_dims=2)
        for i, fr in enumerate(frames):
            fr["driver_parameters"] = {"LightX": 0.1 * i, "LightY": 1.0,
                                       "LightZ": -0.5}
    elif kind == "exr":
        top.update(camera_angle_x=0.7, envmap="env.exr", aabb_scale=16)
        write_exr(str(root / "env.exr"),
                  rng.uniform(0, 2, (4, 8, 4)).astype(np.float32))
    elif kind == "two":
        top.update(fl_x=20.0, aabb_scale=2)
        other = {"frames": [dict(frames.pop(), k1=0.1)], "fl_x": 25.0,
                 "aabb_scale": 8, "p2": 0.01}
        with open(root / "transforms_b.json", "w") as f:
            json.dump(other, f)
        paths.append(root / "transforms_b.json")
    text = json.dumps(top, indent=1)
    # comments, which `loads_json` strips
    text = "// a capture written by a test\n" + text.replace(
        '"frames"', '/* the views */ "frames"', 1)
    with open(paths[0], "w") as f:
        f.write(text)
    return [str(p) for p in paths]


@pytest.fixture(scope="module", params=KINDS)
def loaded(request, tmp_path_factory):
    paths = write_capture(tmp_path_factory.mktemp(request.param),
                          request.param)
    arg = paths if len(paths) > 1 else paths[0]
    return request.param, loader.load_nerf(arg), jloader.load_nerf(arg)


def test_load_nerf_matches_jax_field_for_field(loaded):
    kind, ds, jds = loaded
    _same(ds, jds, kind)
    assert ds.n_images == jds.n_images and ds.n_extra_dims == jds.n_extra_dims
    # the capture exercised what it was written for
    lens = {"opencv": "OpenCV", "fisheye": "OpenCVFisheye",
            "ftheta": "FTheta", "latlong": "LatLong",
            "mitsuba": "Perspective", "exr": "Perspective",
            "two": "Perspective"}[kind]
    assert ds.metadata[0].lens.mode == lens
    if kind == "opencv":
        # sorted naturally as written (a backslash sorts after a slash),
        # then n_frames drops img_21 and the sharpness filter img_10;
        # white pixels went transparent; the sidecars were applied
        assert ds.paths == ["images/img_2", "images/img_003",
                            "images/img_1.png"]
        assert ds.aabb_scale == 4 and ds.n_extra_learnable_dims == 3
        assert not ds.wants_importance_sampling and ds.has_rays
        assert ds.envmap.shape == (H, W, 4) and not ds.is_hdr
        assert ds.render_aabb is not None and ds.sharpen_amount == 0.5
        assert sum(d is not None for d in ds.depths) == 1
        assert all((m.rolling_shutter != 0).any() for m in ds.metadata)
        assert ds.metadata[0].rolling_shutter[3] == 0.5
        assert (ds.xforms_start != ds.xforms_end).any()
        assert any((im[..., 3] == 0).any() for im in ds.images)
        pink = np.array([255, 0, 255, 0], np.uint8)
        assert any((im == pink).all(-1).any() for im in ds.images)
        assert len({tuple(m.focal_length) for m in ds.metadata}) == 2
    elif kind == "fisheye":
        assert not ds.has_rays and ds.scale == pytest.approx(0.25)
        assert ds.metadata[0].focal_length[0] == pytest.approx(
            loader.fov_to_focal_length(W, 70.0))
    elif kind == "mitsuba":
        assert ds.from_mitsuba and ds.has_light_dirs
        assert ds.n_extra_learnable_dims == 0 and ds.n_extra_dims == 3
    elif kind == "exr":
        assert ds.is_hdr and ds.images[0].dtype == np.float16
        assert ds.envmap.shape == (4, 8, 4)
    elif kind == "two":
        assert ds.n_images == 5 and ds.aabb_scale == 8
        assert ds.metadata[-1].lens.mode == "OpenCV"
    elif kind == "latlong":
        assert {m.lens.mode for m in ds.metadata} == {"LatLong",
                                                      "Equirectangular"}


def test_coordinate_methods_match_jax(loaded):
    _, ds, jds = loaded
    rng = np.random.default_rng(0)
    m = rng.normal(size=(3, 4)).astype(np.float32)
    p = rng.normal(size=(7, 3)).astype(np.float32)
    for name, arg in (("nerf_matrix_to_ngp", m), ("ngp_matrix_to_nerf", m),
                      ("nerf_position_to_ngp", p),
                      ("ngp_position_to_nerf", p),
                      ("nerf_direction_to_ngp", p)):
        np.testing.assert_array_equal(getattr(ds, name)(arg),
                                      getattr(jds, name)(arg), err_msg=name)
    np.testing.assert_allclose(
        ds.ngp_matrix_to_nerf(ds.nerf_matrix_to_ngp(m)), m, atol=1e-5)
    np.testing.assert_allclose(
        ds.ngp_position_to_nerf(ds.nerf_position_to_ngp(p)), p, atol=1e-5)


def test_scene_config_and_packed_data_match_jax(loaded):
    kind, ds, jds = loaded
    scene, jscene = (dataset.scene_config_from_dataset(ds),
                     jdataset.scene_config_from_dataset(jds))
    for f in dataclasses.fields(jscene):
        a, b = getattr(scene, f.name), getattr(jscene, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    assert scene.lens_mode == lens_mode_id(ds.metadata[0].lens.mode)
    assert scene.rgb_activation == ("Exponential" if kind == "exr"
                                    else "Logistic")
    data = dataset.pack_training_data(
        ds, "cpu", generator=torch.Generator().manual_seed(3))
    jdata = jdataset.pack_training_data(jds)
    for name in ("pixels", "resolutions", "focal_lengths",
                 "principal_points", "xforms_start", "xforms_end",
                 "rolling_shutter", "lens_params", "exposures", "depths"):
        a, b = getattr(data, name), getattr(jdata, name)
        if b is None:
            assert a is None, name
            continue
        ref = np.asarray(b)
        assert tuple(a.shape) == ref.shape, name
        np.testing.assert_array_equal(a.numpy().astype(ref.dtype), ref,
                                      err_msg=name)
    assert data.pixels.dtype == (torch.float16 if kind == "exr"
                                 else torch.uint8)
    if ds.n_extra_dims == 0:
        assert data.extra_dims is None and jdata.extra_dims is None
        return
    assert tuple(data.extra_dims.shape) == tuple(jdata.extra_dims.shape) \
        == (ds.n_images, ds.n_extra_dims)
    if ds.has_light_dirs:
        np.testing.assert_array_equal(data.extra_dims.numpy(),
                                      np.asarray(jdata.extra_dims))
        return
    # latent codes: N(0, 0.1) from the given generator, or supplied
    again = dataset.pack_training_data(
        ds, "cpu", generator=torch.Generator().manual_seed(3))
    assert torch.equal(data.extra_dims, again.extra_dims)
    assert 0.02 < float(data.extra_dims.std()) < 0.3
    given = dataset.pack_training_data(ds, "cpu",
                                       extra_dims=np.asarray(jdata.extra_dims))
    np.testing.assert_array_equal(given.extra_dims.numpy(),
                                  np.asarray(jdata.extra_dims))


@pytest.mark.parametrize("dtype", [np.uint8, np.float16])
@pytest.mark.parametrize("white, black", [(True, False), (False, True),
                                          (True, True)])
def test_apply_transparency_matches_jax(dtype, white, black):
    rng = np.random.default_rng(1)
    top = 255 if dtype == np.uint8 else 1.0
    img = (rng.integers(0, 2, (6, 7, 4)) * top).astype(dtype)
    img[..., 3] = top
    out = loader.apply_transparency(img, white, black)
    np.testing.assert_array_equal(
        out, jloader.apply_transparency(img, white, black))
    assert (out[..., 3] == 0).any() and (img[..., 3] == top).all()


def test_focal_helpers_and_missing_files():
    for res, deg in ((800, 50.0), (12, 120.0)):
        fl = loader.fov_to_focal_length(res, deg)
        assert fl == jloader.fov_to_focal_length(res, deg)
        assert loader.focal_length_to_fov(res, fl) == \
            jloader.focal_length_to_fov(res, fl) == pytest.approx(deg)
    with pytest.raises(ValueError):
        loader.load_nerf([])


def test_load_nerf_reports_what_is_missing(tmp_path):
    frame = {"file_path": "nowhere.png",
             "transform_matrix": np.eye(4).tolist()}
    with open(tmp_path / "t.json", "w") as f:
        json.dump({"frames": [frame], "fl_x": 10.0}, f)
    with pytest.raises(FileNotFoundError):
        loader.load_nerf(str(tmp_path / "t.json"))
    with open(tmp_path / "e.json", "w") as f:
        json.dump({"frames": []}, f)
    with pytest.raises(ValueError, match="no training images"):
        loader.load_nerf(str(tmp_path / "e.json"))
    _png(tmp_path / "a.png", np.random.default_rng(0))
    frame["file_path"] = "a.png"
    with open(tmp_path / "f.json", "w") as f:
        json.dump({"frames": [frame]}, f)
    with pytest.raises(ValueError, match="fov"):
        loader.load_nerf(str(tmp_path / "f.json"))
