"""The port's facade (`Testbed`, `mode_from_scene`), `config.get_path` /
`set_path`, the render buffer, foveation and camera paths against the JAX
package's on the CPU; the NeRF, Volume and SDF modes through the facade
at tiny sizes.

Tolerances: the numpy helpers are the same float arithmetic on both sides
(1e-6); a camera path's quaternion blend and the motion vectors run
through float32 ray math on two frameworks (1e-5 px). The Image facade
trains 3 steps at bf16 compute from the reference's own draws: losses at
rtol 2e-3 and the render at 2e-3, as tests/test_torch_image_mode.py
states; the Geometry facade's mesh frame at 1e-5.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from torch_parity import jax_corner_draws

from instant_ngp_tpu import camera_path as jax_camera_path
from instant_ngp_tpu import config as jax_config
from instant_ngp_tpu import foveation as jax_foveation
from instant_ngp_tpu import render_buffer as jax_render_buffer
from instant_ngp_tpu.testbed import Testbed as JaxTestbed
from instant_ngp_tpu.testbed import mode_from_scene as jax_mode_from_scene
from instant_ngp_tpu_torch import camera_path, config, foveation
from instant_ngp_tpu_torch import pyngp_compat as ngp
from instant_ngp_tpu_torch import render_buffer
from instant_ngp_tpu_torch.common import TestbedMode, TonemapCurve
from instant_ngp_tpu_torch.data.exr import write_exr
from instant_ngp_tpu_torch.testbed import Testbed, mode_from_scene

IMAGE_CFG = {
    "loss": {"otype": "L2"},
    "optimizer": {"otype": "Adam", "learning_rate": 1e-2, "beta1": 0.9,
                  "beta2": 0.99, "epsilon": 1e-15, "l2_reg": 1e-6},
    "encoding": {"otype": "HashGrid", "n_levels": 2,
                 "n_features_per_level": 2, "log2_hashmap_size": 8,
                 "base_resolution": 4, "stochastic_corners_until": 1},
    "network": {"otype": "FullyFusedMLP", "activation": "ReLU",
                "output_activation": "None", "n_neurons": 32,
                "n_hidden_layers": 1},
}


def _box_obj(path, lo=-0.5, hi=0.5):
    v = [[x, y, z] for x in (lo, hi) for y in (lo, hi) for z in (lo, hi)]
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6),
             (0, 2, 6, 4), (1, 5, 7, 3)]
    with open(path, "w") as f:
        for p in v:
            f.write("v {} {} {}\n".format(*p))
        for a, b, c, d in quads:
            f.write(f"f {a + 1} {b + 1} {c + 1}\nf {a + 1} {c + 1} {d + 1}\n")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """One scene of every kind, written here."""
    root = tmp_path_factory.mktemp("facade")
    out = {"root": root}
    img = np.random.default_rng(0).uniform(0, 1, (12, 16, 3)) \
        .astype(np.float32)
    out["image"] = str(root / "image.exr")
    write_exr(out["image"], img)
    out["obj"] = str(root / "box.obj")
    _box_obj(out["obj"])
    out["geometry"] = str(root / "scene.json")
    with open(out["geometry"], "w") as f:
        json.dump({"geometry": [
            {"center": [0.5, 0.5, 0.5], "path": "box.obj", "type": "Mesh",
             "scale": 0.5},
            {"center": [1.5, 0.5, 0.0], "path": "box.obj", "type": "Mesh",
             "scale": 0.3}]}, f)
    out["config"] = str(root / "net.json")
    with open(out["config"], "w") as f:
        json.dump(IMAGE_CFG, f)
    out["frames"] = str(root / "frames.json")
    with open(out["frames"], "w") as f:
        json.dump({"frames": []}, f)
    out["broken"] = str(root / "broken.json")
    with open(out["broken"], "w") as f:
        f.write("{not json")
    return out


@pytest.mark.parametrize("kind", [
    "dir", "transforms.json", "mesh.obj", "mesh.stl", "img.exr", "img.png",
    "img.jpg", "img.bin", "vol.nvdb", "vol.npy", "geometry", "frames",
    "config", "broken", "missing.json", "other.txt"])
def test_mode_from_scene_on_every_path_kind(files, kind):
    path = {"dir": str(files["root"]), "geometry": files["geometry"],
            "frames": files["frames"], "config": files["config"],
            "broken": files["broken"]}.get(kind, os.path.join(
                str(files["root"]), kind))
    ours = mode_from_scene(path)
    assert ours.value == jax_mode_from_scene(path).value
    assert isinstance(ours, TestbedMode)


def test_get_and_set_path_match_jax():
    cfg = {"optimizer": {"nested": {"learning_rate": 1e-2}}, "x": 3}
    for dotted in ("optimizer.nested.learning_rate", "x", "x.y", "nope",
                   "optimizer.nested"):
        assert config.get_path(cfg, dotted, "d") == \
            jax_config.get_path(cfg, dotted, "d")
    a, b = json.loads(json.dumps(cfg)), json.loads(json.dumps(cfg))
    for dotted, v in (("optimizer.nested.learning_rate", 5.0),
                      ("new.deep.key", [1]), ("x", None)):
        config.set_path(a, dotted, v)
        jax_config.set_path(b, dotted, v)
    assert a == b and a["new"]["deep"]["key"] == [1]


@pytest.mark.parametrize("curve", list(TonemapCurve), ids=lambda c: c.name)
def test_tonemap_curve_matches_jax(curve):
    from instant_ngp_tpu.common import TonemapCurve as JaxCurve

    x = np.random.default_rng(1).uniform(-0.5, 8.0, (64, 3)) \
        .astype(np.float32)
    np.testing.assert_allclose(
        render_buffer.tonemap_curve(x, curve),
        jax_render_buffer.tonemap_curve(x, JaxCurve(curve.value)),
        rtol=1e-6, atol=1e-6)


def test_render_buffer_and_dynamic_resolution_match_jax():
    from instant_ngp_tpu.common import TonemapCurve as JaxCurve

    rng = np.random.default_rng(2)
    ours, ref = render_buffer.RenderBuffer(6, 4), \
        jax_render_buffer.RenderBuffer(6, 4)
    ours.tonemap, ref.tonemap = TonemapCurve.ACES, JaxCurve.ACES
    ours.exposure = ref.exposure = 0.5
    for _ in range(3):
        frame = rng.uniform(0, 2, (4, 6, 4)).astype(np.float32)
        depth = rng.uniform(0, 3, (4, 6)).astype(np.float32)
        ours.accumulate(frame, depth)
        ref.accumulate(frame, depth)
    gt = rng.uniform(0, 1, (4, 6, 3)).astype(np.float32)
    pairs = [(ours.framebuffer(), ref.framebuffer()),
             (ours.framebuffer(srgb=False), ref.framebuffer(srgb=False)),
             (ours.overlay_image(gt, split_x=3),
              ref.overlay_image(gt, split_x=3)),
             (ours.overlay_image(gt, alpha=0.3),
              ref.overlay_image(gt, alpha=0.3)),
             (ours.overlay_false_color(gt), ref.overlay_false_color(gt)),
             (ours.overlay_depth(0.5), ref.overlay_depth(0.5))]
    for a, b in pairs:
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    assert ours.spp == 3
    ours.reset_accumulation()
    assert ours.spp == 0 and not ours.accumulation.any()

    for enabled in (True, False):
        a = render_buffer.DynamicResolution((1920, 1080), 30.0, enabled)
        b = jax_render_buffer.DynamicResolution((1920, 1080), 30.0, enabled)
        for ms in (None, 5.0, 200.0, 33.0, 1.0, 1.0, 80.0):
            assert a.update(ms) == b.update(ms)


def test_foveation_and_motion_vectors_match_jax():
    args = ((2.0, 1.5), (0.5, 0.4), (0.3, 0.2))
    ours = foveation.Foveation.make(*args)
    ref = jax_foveation.Foveation.make(*args)
    uv = np.random.default_rng(3).uniform(-0.1, 1.1, (200, 2))
    for fn in ("warp", "unwarp", "density"):
        np.testing.assert_allclose(getattr(ours, fn)(uv),
                                   getattr(ref, fn)(uv), rtol=1e-6,
                                   atol=1e-6)
    assert foveation.PiecewiseQuadratic.solve(1.0, 0.5, 0.2) == \
        foveation.PiecewiseQuadratic()
    z = np.linspace(0.01, 20, 50)
    np.testing.assert_allclose(foveation.to_ndc_depth(z, 0.1, 10.0),
                               jax_foveation.to_ndc_depth(z, 0.1, 10.0),
                               rtol=1e-6, atol=1e-6)
    rng = np.random.default_rng(4)
    px = rng.integers(0, 32, (40, 2))
    depth = rng.uniform(0.5, 3, 40)
    cam = np.array([[1, 0, 0, 0.5], [0, -1, 0, 0.5], [0, 0, -1, 2.5]],
                   np.float32)
    prev = cam.copy()
    prev[:, 3] += [0.05, -0.02, 0.1]
    kw = dict(resolution=(32, 24), focal_length=(30.0, 30.0), camera=cam,
              prev_camera=prev)
    np.testing.assert_allclose(foveation.motion_vectors(px, depth, **kw),
                               jax_foveation.motion_vectors(px, depth, **kw),
                               rtol=0, atol=1e-5)


def _paths():
    rng = np.random.default_rng(5)
    ours, ref = camera_path.CameraPath(), jax_camera_path.CameraPath()
    for i in range(5):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        m = np.concatenate([q * np.sign(np.linalg.det(q)),
                            rng.normal(0, 1, (3, 1))], 1).astype(np.float32)
        ours.keyframes.append(camera_path.CameraKeyframe.from_matrix(
            m, fov=40 + i, aperture_size=0.01 * i))
        ref.keyframes.append(jax_camera_path.CameraKeyframe.from_matrix(
            m, fov=40 + i, aperture_size=0.01 * i))
    return ours, ref


@pytest.mark.parametrize("loop", [False, True])
def test_camera_path_eval_and_files_match_jax(loop, tmp_path):
    ours, ref = _paths()
    ours.loop = ref.loop = loop
    for t in np.linspace(0, 1, 17):
        a, b = ours.eval(float(t)), ref.eval(float(t))
        np.testing.assert_allclose(a.matrix(), b.matrix(), rtol=1e-6,
                                   atol=1e-6)
        assert a.fov == pytest.approx(b.fov, rel=1e-6)
    p = str(tmp_path / "path.json")
    ours.save(p)
    back = jax_camera_path.CameraPath.load(p)
    assert back.loop == loop and len(back.keyframes) == 5
    np.testing.assert_allclose(back.eval(0.3).matrix(),
                               ours.eval(0.3).matrix(), atol=1e-6)
    assert camera_path.CameraPath.load(p).n_frames() == ours.n_frames()


def _image_pair(files):
    """The JAX facade and the port's on the same image and config, the
    port's testbed holding the JAX testbed's weights and taking its
    draws."""
    jtb, tb = JaxTestbed(seed=7), Testbed(seed=7, device="cpu")
    for t in (jtb, tb):
        t.reload_network_from_json(IMAGE_CFG)
        t.load_file(files["image"])
        t.training_batch_size = 128
    impl = tb.impl

    def draws(step, n):
        key = jax.random.fold_in(jax.random.PRNGKey(jtb.impl.seed), step)
        u = torch.from_numpy(np.asarray(jax.random.uniform(key, (n, 2)))
                             .copy())
        corners = jax_corner_draws(jax.random.fold_in(key, 0x5C), n, 2,
                                   impl.model.encoding.n_levels) \
            if impl._stoch_now() else None
        return u, corners

    impl.draws = draws
    impl.trainer.load_state(impl.state, jax.tree_util.tree_map(
        np.asarray, jtb.impl.state["params"]))
    return jtb, tb


def test_image_scene_through_the_facade_matches_jax(files, tmp_path):
    jtb, tb = _image_pair(files)
    assert tb.mode == TestbedMode.Image and tb.impl.device.type == "cpu"
    losses = [(tb.train(1), jtb.train(1)) for _ in range(3)]
    np.testing.assert_allclose(*zip(*losses), rtol=2e-3)
    assert tb.training_step == jtb.training_step == 3
    for linear in (True, False):
        ours = tb.render(16, 12, linear=linear)
        ref = jtb.render(16, 12, linear=linear)
        assert ours.shape == (12, 16, 4)
        np.testing.assert_allclose(ours, ref, rtol=0, atol=2e-3)
    # frame(): one step and a frame at the dynamic resolution (the full
    # one before any render time is known)
    tb.shall_render, tb.full_resolution = True, (16, 12)
    assert tb.frame() and tb.training_step == 4
    assert tb.last_frame.shape == (12, 16, 4)
    # a snapshot through the facade, into a facade with no scene yet
    snap = str(tmp_path / "image.ingp")
    tb.save_snapshot(snap)
    other = Testbed(device="cpu")
    other.load_file(snap)
    assert other.impl is None and other.mode == TestbedMode.Image
    other.load_training_data(files["image"])
    other.apply_pending_snapshot()
    assert other.training_step == 4
    np.testing.assert_array_equal(other.render(16, 12), tb.render(16, 12))
    out = str(tmp_path / "shot.exr")
    tb.screenshot(out, 16, 12, spp=1)
    assert os.path.getsize(out) > 0


def test_geometry_scene_through_the_facade_matches_jax(files, tmp_path):
    jtb, tb = JaxTestbed(), Testbed(device="cpu")
    # the JAX facade looks for configs/geometry/base.json, which does not
    # exist, unless it is handed a config; the port needs none
    jtb.reload_network_from_json({})
    for t in (jtb, tb):
        t.load_file(files["geometry"])
    assert tb.mode == TestbedMode.Geometry and len(tb.impl.meshes) == 2
    assert np.isnan(tb.train(2)) and tb.training_step == 0
    ref = jtb.render(24, 20)
    ours = tb.render(24, 20)
    np.testing.assert_array_equal(ours[..., 3], ref[..., 3])
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tb.render(24, 20, linear=False),
                               jtb.render(24, 20, linear=False), atol=1e-5)
    # a Geometry snapshot loads on its own (its objects are embedded)
    snap = str(tmp_path / "scene.ingp")
    jtb.save_snapshot(snap)
    alone = Testbed(device="cpu")
    alone.load_file(snap)
    assert alone.mode == TestbedMode.Geometry
    np.testing.assert_allclose(alone.render(24, 20), ref, atol=1e-5)


def test_render_video_writes_a_png_per_frame(files, tmp_path):
    tb = Testbed(device="cpu")
    tb.load_file(files["geometry"])
    cp, _ = _paths()
    cp.duration_seconds, cp.fps = 1.0, 3.0
    out = camera_path.render_video(tb, cp, str(tmp_path / "frames"),
                                   width=8, height=6, spp=1)
    frames = sorted(os.listdir(str(tmp_path / "frames")))
    pngs = [f for f in frames if f.endswith(".png")]
    assert len(pngs) == cp.n_frames() == 3
    assert out.endswith(("frames", "video.mp4"))


def _tiny_capture(root):
    from instant_ngp_tpu_torch.data.images import write_image

    os.makedirs(root / "images", exist_ok=True)
    rng = np.random.default_rng(6)
    frames = []
    for i in range(3):
        write_image(str(root / "images" / f"{i}.exr"),
                    rng.uniform(0, 1, (8, 8, 4)).astype(np.float32))
        a = 0.4 * i
        m = np.eye(4)
        m[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                     [-np.sin(a), 0, np.cos(a)]]
        m[:3, 3] = m[:3, :3] @ [0, 0, 2.0]
        frames.append({"file_path": f"images/{i}.exr",
                       "transform_matrix": m.tolist()})
    with open(root / "transforms.json", "w") as f:
        json.dump({"camera_angle_x": 0.8, "frames": frames}, f)


SMALL_NERF = {
    "loss": {"otype": "Huber"},
    "optimizer": {"otype": "Adam", "learning_rate": 1e-2,
                  "epsilon": 1e-15},
    "encoding": {"otype": "HashGrid", "n_levels": 2,
                 "n_features_per_level": 2, "log2_hashmap_size": 10,
                 "base_resolution": 8},
    "network": {"otype": "FullyFusedMLP", "activation": "ReLU",
                "output_activation": "None", "n_neurons": 32,
                "n_hidden_layers": 1},
}


def test_nerf_volume_and_sdf_through_the_facade(files, tmp_path):
    """The other three modes through `Testbed` alone: load, 2 steps, a
    frame, a snapshot back into a fresh facade on the same scene."""
    _tiny_capture(tmp_path)
    vol = str(tmp_path / "cloud.npy")
    g = np.mgrid[0:12, 0:10, 0:8].astype(np.float32)
    np.save(vol, np.exp(-((g - 5) ** 2).sum(0) / 8).astype(np.float32))
    small_field = dict(SMALL_NERF, encoding=dict(SMALL_NERF["encoding"]))
    scenes = [(str(tmp_path), TestbedMode.Nerf),
              (vol, TestbedMode.Volume), (files["obj"], TestbedMode.Sdf)]
    for scene, mode in scenes:
        tb = Testbed(device="cpu")
        tb.reload_network_from_json(small_field)
        tb.load_training_data(scene)
        assert tb.mode == mode and tb.impl.device.type == "cpu"
        tb.training_batch_size = 1 << 10
        if mode == TestbedMode.Nerf:
            tb.impl.target_batch_size = 1 << 12
            tb.impl.rays_per_batch = 1 << 8
        loss = tb.train(2)
        assert np.isfinite(loss) and tb.training_step == 2
        frame = tb.render(8, 6)
        assert frame.shape == (6, 8, 4) and np.isfinite(frame).all()
        snap = str(tmp_path / f"{mode.value}.ingp")
        tb.save_snapshot(snap)
        again = Testbed(device="cpu")
        again.reload_network_from_json(small_field)
        again.load_training_data(scene)
        again.load_snapshot(snap)
        assert again.training_step == 2
    assert tb.nerf is tb.impl


def test_the_default_device_is_the_card():
    if torch.cuda.is_available():
        assert Testbed().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            Testbed()
    assert ngp.Testbed is Testbed and ngp.GeometryMode == TestbedMode.Geometry
    ngp.free_temporary_memory()
