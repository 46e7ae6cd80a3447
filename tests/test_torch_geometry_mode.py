"""The port's Geometry mode against the JAX package's on the CPU, and the
port's msgpack codec against msgpack.

One JAX scene per file (module fixture): two boxes as meshes (the scene of
tests/test_geom_modes.py) and a NeRF object, a small HashGrid config whose
snapshot the JAX package's `save_snapshot` writes with seeded weights and
no training. Both packages render it.

Tolerances:
- the object BVH's masks and the mesh trace are exact (t within 1e-5: the
  same triangles through two builds of one C++ source);
- mesh-only frames: alpha equal, colours within 1e-5 (the same BRDF in
  float32 on both sides);
- a frame with the NeRF object: both sides run the nets at bf16 compute
  with float32 sums in another order; a hidden value near a bf16 rounding
  boundary can round the other way, so pixels agree to 2e-3 (max) and
  1e-4 (mean); its chunks are exact: many chunks equal one chunk.
"""

import json
import os
import zlib

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest

import torch_parity  # noqa: F401 (its import sets the thread count)

from instant_ngp_tpu.data.snapshot import load_snapshot as jax_load_snapshot
from instant_ngp_tpu.data.snapshot import save_snapshot as jax_save_snapshot
from instant_ngp_tpu.geometry import GeometryBvh as JaxGeometryBvh
from instant_ngp_tpu.geometry import GeometryTestbed as JaxGeometryTestbed
from instant_ngp_tpu.nerf.model import NerfNetwork as JaxNerfNetwork
from instant_ngp_tpu_torch.convert import nerf_object_params_from_jax
from instant_ngp_tpu_torch.data.msgpack_codec import packb, unpackb
from instant_ngp_tpu_torch.data.snapshot import load_snapshot
from instant_ngp_tpu_torch.geometry import GeometryBvh, GeometryTestbed


NERF_CFG = {
    "encoding": {"otype": "HashGrid", "n_levels": 2,
                 "n_features_per_level": 2, "log2_hashmap_size": 10,
                 "base_resolution": 8, "per_level_scale": 2.0},
    "network": {"otype": "FullyFusedMLP", "activation": "ReLU",
                "output_activation": "None", "n_neurons": 32,
                "n_hidden_layers": 1},
    "rgb_network": {"otype": "FullyFusedMLP", "activation": "ReLU",
                    "output_activation": "None", "n_neurons": 32,
                    "n_hidden_layers": 1},
    "dir_encoding": {"otype": "SphericalHarmonics", "degree": 4},
    "optimizer": {"otype": "Adam", "learning_rate": 1e-2},
}
CAM = np.array([[1, 0, 0, 0.5], [0, -1, 0, 0.5], [0, 0, -1, 2.5]],
               np.float32)
BOX_CAM = np.array([[1, 0, 0, 1.0], [0, -1, 0, 0.0], [0, 0, 1, -3.0]],
                   np.float32)


def _box_triangles(lo, hi):
    v = np.array([[x, y, z] for x in (lo, hi) for y in (lo, hi)
                  for z in (lo, hi)], np.float32)
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6),
             (0, 2, 6, 4), (1, 5, 7, 3)]
    return np.asarray([[v[a], v[b], v[c]] for a, b, c, d in quads]
                      + [[v[a], v[c], v[d]] for a, b, c, d in quads],
                      np.float32)


def _write_obj(path, tris):
    with open(path, "w") as f:
        for t in tris:
            for p in t:
                f.write(f"v {p[0]} {p[1]} {p[2]}\n")
        for i in range(len(tris)):
            f.write(f"f {3 * i + 1} {3 * i + 2} {3 * i + 3}\n")


def _nerf_snapshot(path, seed=0):
    """A NeRF `.ingp` as the JAX package writes it: seeded parameters (a
    U(-1, 1) table, so the object is visible and the nets matter), no
    training, the raw tree under trainer.params."""
    net = JaxNerfNetwork(3, 3, 0, NERF_CFG["encoding"],
                         NERF_CFG["dir_encoding"], NERF_CFG["network"],
                         NERF_CFG["rgb_network"])
    params = jax.tree_util.tree_map(np.asarray,
                                    net.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    params["pos_encoding"] = rng.uniform(
        -1, 1, params["pos_encoding"].shape).astype(np.float32)
    jax_save_snapshot(path, {
        "mode": "nerf", "config": NERF_CFG, "grid_layout": "interleaved",
        "trainer": {"params": params}, "aabb_scale": 1,
        "density_grid": np.zeros(128 ** 3, np.float32),
        "training_step": 0})
    return params


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("geometry")
    obj = str(root / "box.obj")
    _write_obj(obj, _box_triangles(-0.5, 0.5))
    boxes = str(root / "boxes.json")
    with open(boxes, "w") as f:
        json.dump({"geometry": [
            {"center": [0.0, 0.0, 0.0], "path": obj, "type": "Mesh"},
            {"center": [2.0, 0.0, 0.0], "path": obj, "type": "Mesh"}]}, f)
    nerf = str(root / "object.ingp")
    params = _nerf_snapshot(nerf)
    mixed = str(root / "mixed.json")
    with open(mixed, "w") as f:
        json.dump({"geometry": [
            {"center": [0.5, 0.6, 0.5], "path": "box.obj", "type": "Mesh",
             "scale": 0.4},
            {"center": [0.0, 0.0, 0.0], "path": "object.ingp",
             "type": "Nerf"}]}, f)
    return {"root": root, "boxes": boxes, "mixed": mixed, "nerf": nerf,
            "params": params,
            "jax_boxes": JaxGeometryTestbed(boxes),
            "jax_mixed": JaxGeometryTestbed(mixed)}


def test_geometry_bvh_masks_equal_jax():
    rng = np.random.default_rng(0)
    lo = rng.uniform(-2, 2, (13, 3)).astype(np.float32)
    aabbs = [(a, a + rng.uniform(0.1, 1.0, 3).astype(np.float32))
             for a in lo]
    o = rng.uniform(-4, 4, (500, 3)).astype(np.float32)
    d = rng.normal(size=(500, 3)).astype(np.float32)
    d[:7, 0] = 0.0      # axis-parallel rays take the 1e-12 guard
    ours = GeometryBvh(aabbs).intersect_mask(o, d)
    ref = JaxGeometryBvh(aabbs).intersect_mask(o, d)
    np.testing.assert_array_equal(ours, ref)
    assert ours.any() and not ours.all()
    assert not GeometryBvh([]).intersect_mask(o, d).any()


def test_trace_meshes_equals_jax(scene):
    tb = GeometryTestbed(scene["boxes"], device="cpu")
    assert len(tb.meshes) == 2 and tb.train(3) != tb.train(3)  # nan: no-op
    rng = np.random.default_rng(1)
    o = np.concatenate([rng.uniform(-1, 3, (400, 2)),
                        np.full((400, 1), -3.0)], 1).astype(np.float32)
    d = np.concatenate([rng.normal(0, 0.1, (400, 2)),
                        np.ones((400, 1))], 1).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t, obj, tri = tb.trace_meshes(o, d)
    rt, robj, rtri = scene["jax_boxes"].trace_meshes(o, d)
    np.testing.assert_array_equal(obj, robj)
    np.testing.assert_array_equal(tri, rtri)
    np.testing.assert_allclose(t, rt, rtol=0, atol=1e-5)
    assert (obj == 0).any() and (obj == 1).any() and (obj < 0).any()


@pytest.mark.parametrize("mode", ["Shade", "Normals", "Depth"])
def test_mesh_frame_equals_jax(scene, mode):
    tb = GeometryTestbed(scene["boxes"], device="cpu")
    ours = tb.render_frame(32, 32, BOX_CAM, render_mode=mode)
    ref = scene["jax_boxes"].render_frame(32, 32, BOX_CAM, render_mode=mode)
    assert ours.shape == (32, 32, 4) and ours.dtype == np.float32
    np.testing.assert_array_equal(ours[..., 3], ref[..., 3])
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)
    assert 0 < ours[..., 3].mean() < 1


def _assert_nerf_frame_close(ours, ref):
    err = np.abs(ours - ref)
    assert err.max() <= 2e-3 and err.mean() <= 1e-4, (err.max(), err.mean())


def test_mesh_and_nerf_frame_matches_jax(scene):
    tb = GeometryTestbed(scene["mixed"], device="cpu")
    assert len(tb.meshes) == 1 and len(tb.nerfs) == 1
    ours = tb.render_frame(24, 24, CAM)
    ref = scene["jax_mixed"].render_frame(24, 24, CAM)
    _assert_nerf_frame_close(ours, ref)
    # the NeRF object covers part of the frame, in front of the mesh in
    # places: its colour is not the background's nor the mesh's alone
    assert tb.last_frame_n_samples > 0
    assert 0.05 < ours[..., 3].mean() < 1.0
    mesh_only = GeometryTestbed(scene["mixed"], device="cpu")
    mesh_only.nerfs = []
    assert np.abs(mesh_only.render_frame(24, 24, CAM) - ours).max() > 0.05


def test_nerf_object_chunks_equal_one_chunk(scene):
    tb = GeometryTestbed(scene["mixed"], device="cpu")
    whole = tb.render_frame(24, 24, CAM)
    n_samples = tb.last_frame_n_samples
    tb.nerf_chunk_samples = 1 << 12
    calls = []
    model = tb.nerfs[0].model
    forward = model.density_net.forward

    def counting(x):
        calls.append(x.shape[0])
        return forward(x)

    model.density_net.forward = counting
    pieces = tb.render_frame(24, 24, CAM)
    n_chunks = -(-n_samples // (1 << 12))
    assert len(calls) == n_chunks >= 2 and max(calls) <= 1 << 12
    np.testing.assert_array_equal(pieces, whole)


def test_snapshot_cross_load_renders_the_same(scene, tmp_path):
    jax_tb = scene["jax_mixed"]
    ref = jax_tb.render_frame(24, 24, CAM)
    # JAX -> port
    p1 = str(tmp_path / "jax_scene.ingp")
    jax_tb.save_snapshot(p1)
    snap = load_snapshot(p1)
    assert snap["mode"] == "geometry"
    tb = GeometryTestbed.from_snapshot(snap, device="cpu")
    ours = tb.render_frame(24, 24, CAM)
    _assert_nerf_frame_close(ours, ref)
    # port -> JAX
    p2 = str(tmp_path / "port_scene.ingp")
    tb.save_snapshot(p2)
    back = JaxGeometryTestbed.from_snapshot(jax_load_snapshot(p2))
    np.testing.assert_array_equal(back.render_frame(24, 24, CAM), ref)
    # the helper for a JAX NerfObject's parameters
    port = nerf_object_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jax_tb.nerfs[0].params),
        NERF_CFG)
    np.testing.assert_array_equal(
        port["pos_encoding"].numpy(), scene["params"]["pos_encoding"])


def _jax_snapshots(scene, tmp_path):
    """NeRF, Image and Geometry snapshots as the JAX package writes them."""
    from instant_ngp_tpu.image import ImageTestbed as JaxImageTestbed

    image_cfg = {"encoding": {"otype": "HashGrid", "n_levels": 2,
                              "n_features_per_level": 2,
                              "log2_hashmap_size": 8, "base_resolution": 4},
                 "network": NERF_CFG["network"],
                 "optimizer": NERF_CFG["optimizer"],
                 "loss": {"otype": "L2"}}
    img = np.random.default_rng(3).uniform(0, 1, (8, 8, 3)) \
        .astype(np.float32)
    image = str(tmp_path / "image.ingp")
    JaxImageTestbed(img, image_cfg, seed=1).save_snapshot(image)
    geometry = str(tmp_path / "geometry.ingp")
    scene["jax_mixed"].save_snapshot(geometry)
    return {"nerf": scene["nerf"], "image": image, "geometry": geometry}


def test_codec_bytes_equal_msgpack(scene, tmp_path):
    for kind, path in _jax_snapshots(scene, tmp_path).items():
        with open(path, "rb") as f:
            raw = zlib.decompress(f.read())
        obj = msgpack.unpackb(raw, raw=False, strict_map_key=False)
        assert packb(obj) == raw, kind
        assert unpackb(raw) == obj, kind
        assert packb(obj) == msgpack.packb(obj, use_bin_type=True), kind
    # every encoding of the subset, at each size boundary
    edge = {"ints": [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1,
                     2 ** 32, 2 ** 64 - 1, -1, -32, -33, -128, -129,
                     -32768, -32769, -2 ** 31, -2 ** 31 - 1, -2 ** 63],
            "floats": [0.0, -1.5, 1e300, float("inf")],
            "strs": ["", "a" * 31, "b" * 32, "c" * 255, "d" * 256,
                     "e" * 65536, "é中"],
            "bins": [b"", b"x" * 255, b"y" * 256, b"z" * 65536],
            "lists": [list(range(15)), list(range(16)),
                      list(range(65536))],
            "maps": [{str(i): i for i in range(15)},
                     {i: None for i in range(16)}],
            "other": [None, True, False, ((1, 2), [3])],
            "big": {str(i): i for i in range(70000)}}
    want = msgpack.packb(edge, use_bin_type=True)
    assert packb(edge) == want
    assert unpackb(want) == msgpack.unpackb(want, raw=False,
                                            strict_map_key=False)
    with pytest.raises(ValueError):
        unpackb(want + b"\xc0")


def test_port_snapshots_load_in_jax_byte_for_byte(scene, tmp_path):
    """A snapshot the port writes decodes with msgpack and re-encodes to
    the same bytes, and the JAX package's loader reads it."""
    tb = GeometryTestbed(scene["mixed"], device="cpu")
    path = str(tmp_path / "scene.ingp")
    tb.save_snapshot(path)
    with open(path, "rb") as f:
        raw = zlib.decompress(f.read())
    obj = msgpack.unpackb(raw, raw=False, strict_map_key=False)
    assert msgpack.packb(obj, use_bin_type=True) == raw
    snap = jax_load_snapshot(path)
    assert snap["mode"] == "geometry" and len(snap["objects"]) == 2
    assert isinstance(jnp.asarray(snap["objects"][1]["nerf"]["params"]
                                  ["pos_encoding"]), jax.Array)
    assert not os.path.exists(path + ".tmp")
