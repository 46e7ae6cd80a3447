"""The port's SDF mode against the JAX package's `SdfTestbed`, and the
pieces it stands on: the triangle BVH, the triangle octree, the Takikawa
encoding, the SDF bricks and the BRDF.

The mesh: marching cubes of a bumpy sphere on a 14^3 grid (about 600
triangles, curved, written as OBJ and read back by both packages'
`load_obj`). The networks: the forms of configs/sdf/base.json (HashGrid
L=6, F=2, 2^13 entries a level, from 4 to 128) and
configs/sdf/takikawa.json (an octree of 5 levels, features from level 3:
8 of them), each with a 32-wide MLP, MAPE, loaded with the JAX testbed's
weights. A module fixture trains the JAX base testbed 40 steps at float32
compute and hands its state to the port, so frames, IoU and slices see a
fitted surface. The finest level is 128, not 2048: a distance fitted in
40 steps at 2048 is rough enough that the 96 rounds of the sphere trace
amplify the 1e-7 by which the two packages' distances differ (the grid's
and the MLP's sums in another order) into different paths (measured: 65-70
% of the Normals pixels within 1e-4 at 2048, 98 % at 128).

The samples come from `np.random.RandomState(seed)` in both packages and
the BVH is the same C++ source built with the same flags, so samples and
labels are compared bit for bit with no hook. The stochastic encode's
corner draws are JAX's, through the port's `draws` hook.

Tolerances (float32 compute unless said):
- BVH distances (Watertight, Raystab, Unsigned), `ray_trace`,
  `closest_point`, octree codes and lookups, samples: exactly;
- the Takikawa forward and its table gradient, `SdfBricks.distance`,
  `evaluate_shading`: 1e-5 (sums of eight weighted corners in another
  order);
- 3 train steps across `stochastic_corners_until` = 2: losses at rtol
  1e-4, every parameter to 1e-4 (bf16 compute: losses at 5e-3; Takikawa:
  exact encode, the same);
- frames (16 x 16) of the fitted model: the trace's `converged` test can
  flip on one ulp of a distance, so at least 97 % of the pixels agree to
  1e-4 in every mode, shadows included; the GT oracles: at least 99 % of
  the pixels to 1e-4 (the rays are made by each package's own camera
  code), and each oracle's silhouette agrees with the ray-traced one on
  at least 90 % of the pixels, as the JAX package's own test requires;
- IoU: 1e-3; the PNG slice atlas: at least 99.9 % of the bytes equal, none
  more than 1 apart (network), all equal (ground truth);
- snapshots both ways (hash grid and Takikawa): distances at 1e-5 and the
  optimizer's second moments at 1e-6.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instant_ngp_tpu.data.snapshot import load_snapshot as jax_load_snapshot
from instant_ngp_tpu.geom.triangle_bvh import TriangleBvh as JaxBvh
from instant_ngp_tpu.geom.triangle_bvh import load_obj as jax_load_obj
from instant_ngp_tpu.geom.triangle_bvh import \
    normalize_mesh_to_unit_cube as jax_normalize
from instant_ngp_tpu.geom.triangle_octree import TriangleOctree as JaxOctree
from instant_ngp_tpu.ops.takikawa import TakikawaEncoding as JaxTakikawa
from instant_ngp_tpu.sdf import SdfTestbed as JaxSdfTestbed
from instant_ngp_tpu.sdf.brdf import BRDFParams as JaxBRDF
from instant_ngp_tpu.sdf.brdf import evaluate_shading as jax_shading
from instant_ngp_tpu.sdf.bricks import SdfBricks as JaxBricks
from instant_ngp_tpu_torch.data.snapshot import load_snapshot
from instant_ngp_tpu_torch.geom.marching import save_mesh
from instant_ngp_tpu_torch.geom.marching_cubes import marching_cubes
from instant_ngp_tpu_torch.geom.triangle_bvh import (
    TriangleBvh, load_obj, normalize_mesh_to_unit_cube)
from instant_ngp_tpu_torch.geom.triangle_octree import TriangleOctree
from instant_ngp_tpu_torch.ops.grid_encoding import CornerDraws
from instant_ngp_tpu_torch.ops.takikawa import TakikawaEncoding
from instant_ngp_tpu_torch.sdf import SdfTestbed
from instant_ngp_tpu_torch.sdf.brdf import BRDFParams, evaluate_shading
from instant_ngp_tpu_torch.sdf.bricks import SdfBricks

torch.set_num_threads(2)

CFG = {
    "loss": {"otype": "MAPE"},
    "optimizer": {"otype": "Ema", "decay": 0.95, "nested": {
        "otype": "ExponentialDecay", "decay_start": 10000,
        "decay_interval": 5000, "decay_base": 0.33, "nested": {
            "otype": "Adam", "learning_rate": 1e-2, "beta1": 0.9,
            "beta2": 0.99, "epsilon": 1e-15, "l2_reg": 1e-6}}},
    "encoding": {"otype": "HashGrid", "n_levels": 6,
                 "n_features_per_level": 2, "log2_hashmap_size": 13,
                 "base_resolution": 4, "per_level_scale": 2.0,
                 "stochastic_corners_until": 2},
    "network": {"otype": "FullyFusedMLP", "activation": "ReLU",
                "output_activation": "None", "n_neurons": 32,
                "n_hidden_layers": 2},
}
TAKIKAWA = dict(CFG, encoding={"otype": "Takikawa", "n_levels": 5,
                               "starting_level": 3,
                               "sum_instead_of_concat": False})
BATCH = 512
CAM = np.array([[1, 0, 0, 0.5], [0, -1, 0, 0.5], [0, 0, -1, 1.9]],
               np.float32)


def bumpy_sphere(res=14):
    g = np.linspace(-1, 1, res, dtype=np.float32)
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    r = np.sqrt(x * x + y * y + z * z)
    field = r - 0.65 - 0.08 * np.sin(5 * x) * np.sin(4 * y + 1) * np.cos(3 * z)
    verts, faces = marching_cubes(field, 0.0)
    return verts, faces


@pytest.fixture(scope="module")
def mesh_path(tmp_path_factory):
    verts, faces = bumpy_sphere()
    path = str(tmp_path_factory.mktemp("mesh") / "bumpy.obj")
    save_mesh(path, verts, faces)
    return path


def jax_corner_draws(key, n, n_dims, n_levels) -> CornerDraws:
    keys = jax.random.split(key, n_dims + 1)
    u = np.stack([np.asarray(jax.random.uniform(keys[k], (n, n_levels)))
                  for k in range(n_dims)])
    axis = np.asarray(jax.random.randint(keys[n_dims], (n, n_levels), 0,
                                         n_dims))
    return CornerDraws(torch.from_numpy(u.copy()),
                       torch.from_numpy(axis.copy()).long())


def pair(mesh_path, compute="f32", cfg=CFG):
    """(JAX testbed, port testbed with its weights and its draws)."""
    jtb = JaxSdfTestbed(mesh_path, cfg, compute_dtype=jnp.float32
                        if compute == "f32" else jnp.bfloat16)

    def draws(step, n):
        key = jax.random.fold_in(jax.random.PRNGKey(jtb.seed ^ 0x5C), step)
        return jax_corner_draws(key, n, 3, tb.model.encoding.n_levels)

    tb = SdfTestbed(mesh_path, cfg, compute_dtype=torch.float32
                    if compute == "f32" else torch.bfloat16, device="cpu",
                    draws=draws)
    tb.trainer.load_state(tb.state, jax.tree_util.tree_map(
        np.asarray, jtb.state["params"]))
    return jtb, tb


def copy_state(jtb, tb):
    tree = jax.tree_util.tree_map(np.asarray, jtb.state)
    tb.trainer.load_state(tb.state, tree["params"], tree["opt"])
    tb.training_step = jtb.training_step


@pytest.fixture(scope="module")
def fitted(mesh_path):
    """The JAX base testbed after 40 steps, and the port with its state."""
    jtb, tb = pair(mesh_path)
    jtb.train(40, batch_size=1 << 11)
    copy_state(jtb, tb)
    return jtb, tb


# -- the BVH and the mesh -----------------------------------------------------
def test_obj_and_normalisation_match_jax(mesh_path):
    tris = load_obj(mesh_path)
    np.testing.assert_array_equal(tris, jax_load_obj(mesh_path))
    assert tris.shape[0] > 300
    out, scale, offset = normalize_mesh_to_unit_cube(tris)
    ref, rscale, roffset = jax_normalize(tris)
    np.testing.assert_array_equal(out, ref)
    assert scale == rscale and np.array_equal(offset, roffset)


@pytest.mark.parametrize("mode", ["Watertight", "Raystab", "Unsigned"])
def test_bvh_distances_match_jax_exactly(mesh_path, mode):
    tris, _, _ = normalize_mesh_to_unit_cube(load_obj(mesh_path))
    ours, ref = TriangleBvh(tris), JaxBvh(tris)
    assert ours.n_nodes == ref.n_nodes
    x = np.random.default_rng(0).uniform(-0.1, 1.1, (6000, 3)) \
        .astype(np.float32)
    d = ours.signed_distance(x, mode, (0.3, 0.7))
    np.testing.assert_array_equal(d, ref.signed_distance(x, mode,
                                                         (0.3, 0.7)))
    if mode != "Unsigned":
        assert 500 < (d < 0).sum() < 5500


def test_bvh_ray_trace_and_closest_point_match_jax(mesh_path):
    tris, _, _ = normalize_mesh_to_unit_cube(load_obj(mesh_path))
    ours, ref = TriangleBvh(tris), JaxBvh(tris)
    rng = np.random.default_rng(1)
    o = rng.uniform(-0.5, 1.5, (4000, 3)).astype(np.float32)
    d = rng.normal(size=(4000, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[:2000] = 0.5 - o[:2000]                # aimed at the centre: hits
    for a, b in zip(ours.ray_trace(o, d), ref.ray_trace(o, d)):
        np.testing.assert_array_equal(a, b)
    assert (ours.ray_trace(o, d)[1] >= 0).sum() > 2000
    for a, b in zip(ours.closest_point(o), ref.closest_point(o)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ours.triangle_normals(),
                                  ref.triangle_normals())


# -- octree, Takikawa, bricks, BRDF -------------------------------------------
def test_octree_contains_and_vertex_indices_match_jax(mesh_path):
    tris, _, _ = normalize_mesh_to_unit_cube(load_obj(mesh_path))
    ours, ref = TriangleOctree(tris, 5), JaxOctree(tris, 5)
    assert ours.n_vertices == ref.n_vertices
    for a, b in zip(ours.levels, ref.levels):
        np.testing.assert_array_equal(a.cell_codes, b.cell_codes)
        np.testing.assert_array_equal(a.vertex_codes, b.vertex_codes)
        assert a.vertex_offset == b.vertex_offset
    x = np.random.default_rng(2).uniform(0, 1, (4000, 3)).astype(np.float32)
    for level in range(5):
        got = ours.contains(torch.from_numpy(x), level).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(ref.contains(jnp.asarray(x), level)))
        res = 1 << level
        cells = np.clip(np.floor(x * res), 0, res - 1).astype(np.int32)
        ids, occ = ours.vertex_indices(level, torch.from_numpy(cells))
        rids, rocc = ref.vertex_indices(level, jnp.asarray(cells))
        np.testing.assert_array_equal(occ.numpy(), np.asarray(rocc))
        np.testing.assert_array_equal(ids.numpy(), np.asarray(rids))
    assert 0 < got.mean() < 1


@pytest.mark.parametrize("sum_levels", [False, True],
                         ids=["concatenated", "summed"])
def test_takikawa_forward_and_table_gradient_match_jax(mesh_path,
                                                       sum_levels):
    tris, _, _ = normalize_mesh_to_unit_cube(load_obj(mesh_path))
    octree, joctree = TriangleOctree(tris, 5), JaxOctree(tris, 5)
    enc = TakikawaEncoding(octree, 3, sum_instead_of_concat=sum_levels)
    jenc = JaxTakikawa(joctree, 3, sum_instead_of_concat=sum_levels)
    assert enc.n_output_dims == jenc.n_output_dims == (4 if sum_levels
                                                       else 8)
    rng = np.random.default_rng(3)
    table = rng.uniform(-1, 1, enc.n_params).astype(np.float32)
    x = rng.uniform(0, 1, (3000, 3)).astype(np.float32)
    cot = rng.normal(size=(3000, enc.n_output_dims)).astype(np.float32)
    with torch.no_grad():
        enc.params.copy_(torch.from_numpy(table))
    enc.params.requires_grad_(True)
    out = enc(torch.from_numpy(x))
    (grad,) = torch.autograd.grad((out * torch.from_numpy(cot)).sum(),
                                  enc.params)
    ref = np.asarray(jenc.apply(jnp.asarray(table), jnp.asarray(x)))
    ref_g = np.asarray(jax.grad(lambda t: jnp.sum(
        jenc.apply(t, jnp.asarray(x)) * cot))(jnp.asarray(table)))
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=1e-5)
    np.testing.assert_allclose(grad.numpy(), ref_g, atol=1e-5)
    assert (np.abs(ref).sum(-1) == 0).any() and (ref_g != 0).any()


def test_sdf_bricks_distance_matches_jax(mesh_path):
    tris, _, _ = normalize_mesh_to_unit_cube(load_obj(mesh_path))
    bvh = TriangleBvh(tris)
    ours = SdfBricks(TriangleOctree(tris, 5), bvh, brick_res=5,
                     brick_level=4)
    ref = JaxBricks(JaxOctree(tris, 5), JaxBvh(tris), brick_res=5,
                    brick_level=4)
    assert ours.level == ref.level == 4
    np.testing.assert_array_equal(ours.data.numpy(), np.asarray(ref.data))
    x = np.random.default_rng(4).uniform(0, 1, (5000, 3)).astype(np.float32)
    got = ours.distance(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref.distance(jnp.asarray(x))),
                               atol=1e-5)
    assert (got != 0.5 / ours.res).sum() > 200


@pytest.mark.parametrize("params", [
    {}, {"metallic": 0.7, "roughness": 0.2},
    {"clearcoat": 1.0, "clearcoat_gloss": 0.6, "sheen": 0.5,
     "subsurface": 0.4, "specular_tint": 0.3},
    {"roughness": 1.0, "clearcoat": 0.5, "clearcoat_gloss": -9.0}],
    ids=["defaults", "metallic", "lobes", "rough"])
def test_evaluate_shading_matches_jax(params):
    rng = np.random.default_rng(5)

    def unit(n):
        v = rng.normal(size=(n, 3)).astype(np.float32)
        return v / np.linalg.norm(v, axis=-1, keepdims=True)
    n_, l_, v_ = unit(2000), unit(1)[0], unit(2000)
    base = np.array([0.8, 0.5, 0.3], np.float32)
    amb = np.array([0.1, 0.2, 0.05], np.float32)
    light = np.ones(3, np.float32)
    ref = np.asarray(jax_shading(
        jnp.asarray(base), jnp.asarray(amb), jnp.asarray(light),
        JaxBRDF(**params), jnp.asarray(l_), jnp.asarray(v_),
        jnp.asarray(n_)))
    ours = evaluate_shading(*(torch.from_numpy(a) for a in (base, amb, light)),
                            BRDFParams(**params),
                            *(torch.from_numpy(a) for a in (l_, v_, n_)))
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-5, atol=1e-5)


# -- samples and training -----------------------------------------------------
def test_training_samples_are_the_same_bits(mesh_path):
    jtb, tb = pair(mesh_path)
    for uniform_only in (False, True, False):
        ours = tb.generate_training_samples(1000, uniform_only=uniform_only)
        ref = jtb.generate_training_samples(1000, uniform_only=uniform_only)
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a, b)
    assert (ours[1][:500] == 0).all() and (ours[1][500:] != 0).all()
    np.testing.assert_array_equal(tb.sample_surface(64),
                                  jtb.sample_surface(64))
    assert tb.mesh_scale == jtb.mesh_scale
    assert tb.bounding_radius == jtb.bounding_radius


@pytest.mark.parametrize("compute,cfg", [("f32", "base"), ("bf16", "base"),
                                         ("f32", "takikawa")])
def test_training_across_the_stochastic_switch_matches_jax(mesh_path,
                                                           compute, cfg):
    jtb, tb = pair(mesh_path, compute, CFG if cfg == "base" else TAKIKAWA)
    # the octree encoding has no stochastic form: its steps are all exact
    until = 2 if cfg == "base" else 256
    assert tb._stoch_now() and tb.stochastic_corners_until == until
    jl = [jtb.train(1, BATCH) for _ in range(3)]
    tl = [tb.train(1, BATCH) for _ in range(3)]
    assert tb._stoch_now() == (cfg != "base") and tb.training_step == 3
    np.testing.assert_allclose(tl, jl, rtol=1e-4 if compute == "f32"
                               else 5e-3)
    if compute == "f32":
        ref, ours = jtb.state["params"], tb.state["params"]
        np.testing.assert_allclose(ours["encoding"].detach().numpy(),
                                   np.asarray(ref["encoding"]), atol=1e-4)
        for a, b in zip(ours["net"], ref["net"]):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       atol=1e-4)
    if cfg == "takikawa":
        assert tb.model.network.n_input_dims == 8
    assert tb.sample_seconds > 0


def test_override_training_data_takes_the_same_permutations(mesh_path):
    jtb, tb = pair(mesh_path)
    pos, dist = jtb.generate_training_samples(800)
    tb.generate_training_samples(800)
    for t in (jtb, tb):
        t.override_training_data(pos, dist)
        t.stochastic_corners = False
    jl = [jtb.train(1, 256) for _ in range(2)]
    tl = [tb.train(1, 256) for _ in range(2)]
    np.testing.assert_allclose(tl, jl, rtol=1e-4)


# -- frames -------------------------------------------------------------------
def _frames_agree(ours, ref, share, what):
    assert ours.shape == ref.shape and np.isfinite(ours).all(), what
    close = (np.abs(ours - ref) <= 1e-4).all(-1)
    assert close.mean() >= share, (what, close.mean())


@pytest.mark.parametrize("mode", ["Shade", "Normals", "Depth", "Positions",
                                  "Shade+shadows"])
def test_frame_matches_jax(fitted, mode):
    jtb, tb = fitted
    render_mode, _, shadows = mode.partition("+")
    jtb.render_with_shadows = tb.render_with_shadows = bool(shadows)
    try:
        ref = jtb.render_frame(16, 16, CAM, render_mode=render_mode)
        ours = tb.render_frame(16, 16, CAM, render_mode=render_mode)
    finally:
        jtb.render_with_shadows = tb.render_with_shadows = False
    _frames_agree(ours, ref, 0.97, mode)
    assert 0.2 < ref[..., 3].mean() < 0.9
    if shadows:
        unshadowed = tb.render_frame(16, 16, CAM)
        assert (ours[..., :3] < unshadowed[..., :3] - 1e-3).any()


@pytest.mark.parametrize("oracle", ["RaytracedMesh", "SpheretracedMesh",
                                    "SDFBricks"])
def test_ground_truth_frame_matches_jax(fitted, oracle):
    jtb, tb = fitted
    jtb.groundtruth_mode = tb.groundtruth_mode = oracle
    jtb.brick_level = tb.brick_level = 4
    try:
        ref = jtb.render_frame(16, 16, CAM, use_gt=True)
        ours = tb.render_frame(16, 16, CAM, use_gt=True)
        tb.groundtruth_mode = "RaytracedMesh"
        raytraced = tb.render_frame(16, 16, CAM, use_gt=True)
    finally:
        jtb.groundtruth_mode = tb.groundtruth_mode = "RaytracedMesh"
    _frames_agree(ours, ref, 0.99, oracle)
    agree = ((ours[..., 3] > 0.5) == (raytraced[..., 3] > 0.5)).mean()
    assert agree >= 0.9, (oracle, agree)


def test_normals_by_differences_match_autograd(fitted):
    jtb, tb = fitted
    x = np.random.default_rng(6).uniform(0.2, 0.8, (500, 3)) \
        .astype(np.float32)
    params = jtb.trainer.inference_params(jtb.state)
    for fd in (False, True):
        ours = tb.normals(torch.from_numpy(x), finite_differences=fd)
        ref = jtb.normals(params, jnp.asarray(x), finite_differences=fd)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref),
                                   atol=1e-3 if fd else 1e-4)


def test_iou_matches_jax(fitted):
    jtb, tb = fitted
    jtb._np_rng = np.random.RandomState(9)
    tb._np_rng = np.random.RandomState(9)
    ours, ref = tb.calculate_iou(1 << 14), jtb.calculate_iou(1 << 14)
    assert abs(ours - ref) <= 1e-3 and ref > 0.25, (ours, ref)


@pytest.mark.parametrize("ground_truth", [False, True],
                         ids=["network", "ground_truth"])
def test_png_slices_match_jax(fitted, tmp_path, ground_truth):
    from PIL import Image

    jtb, tb = fitted
    shapes = []
    pixels = []
    for name, t in (("jax", jtb), ("port", tb)):
        base = str(tmp_path / name)
        res = t.compute_and_save_png_slices(base, resolution=32,
                                            ground_truth=ground_truth)
        shapes.append(res)
        path = f"{base}.density_slices_{res[0]}x{res[1]}x{res[2]}.png"
        pixels.append(np.asarray(Image.open(path)).astype(np.int32))
    assert shapes[0] == shapes[1]
    diff = np.abs(pixels[0] - pixels[1])
    if ground_truth:
        assert diff.max() == 0
    else:
        assert diff.max() <= 1 and (diff == 0).mean() >= 0.999
    assert pixels[0].min() < 60 and pixels[0].max() > 200


def test_the_default_device_is_the_card(mesh_path):
    if torch.cuda.is_available():
        tb = SdfTestbed(mesh_path, CFG)
        assert tb.device.type == "cuda" and tb.model.network.weights[0].is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            SdfTestbed(mesh_path, CFG)


# -- snapshots ----------------------------------------------------------------
@pytest.mark.parametrize("cfg", ["base", "takikawa"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_snapshot_crosses_packages(mesh_path, tmp_path, direction, cfg):
    jtb, tb = pair(mesh_path, "f32", CFG if cfg == "base" else TAKIKAWA)
    path = os.path.join(tmp_path, "sdf.ingp")
    if direction == "jax_to_port":
        jtb.train(2, 256)
        jtb.save_snapshot(path)
        tb.load_snapshot_state(load_snapshot(path))
    else:
        tb.train(2, 256)
        tb.save_snapshot(path)
        jtb.load_snapshot_state(jax_load_snapshot(path))
    snap = load_snapshot(path)
    assert snap["mesh_scale"] == tb.mesh_scale
    np.testing.assert_array_equal(snap["mesh_offset"], tb.mesh_offset)
    assert tb.training_step == jtb.training_step == 2
    x = np.random.default_rng(7).uniform(0, 1, (2000, 3)).astype(np.float32)
    with torch.no_grad():
        ours = tb.distance(torch.from_numpy(x)).numpy()
    ref = np.asarray(jtb.distance(jtb.trainer.inference_params(jtb.state),
                                  jnp.asarray(x)))
    np.testing.assert_allclose(ours, ref, atol=1e-5)
    np.testing.assert_allclose(
        tb.state["opt"]["v"]["net"][0].detach().numpy(),
        np.asarray(jtb.state["opt"]["v"]["net"][0]), rtol=1e-6, atol=1e-12)


def test_volume_and_sdf_run_without_jax(mesh_path):
    """`instant_ngp_tpu_torch.volume` and `.sdf` import, train a step and
    render a frame with jax, msgpack, PIL and the JAX package made
    unimportable, as on a machine that has none of them."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = r"""
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "msgpack", "PIL",
                                  "instant_ngp_tpu"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import numpy as np, torch
from instant_ngp_tpu_torch.config import (find_network_config,
                                          load_network_config)
from instant_ngp_tpu_torch.sdf import SdfTestbed
from instant_ngp_tpu_torch.volume import VolumeTestbed
cam = np.array([[1, 0, 0, 0.5], [0, -1, 0, 0.5], [0, 0, -1, 1.9]], np.float32)
for name in ("base", "takikawa"):
    cfg = load_network_config(find_network_config(name, "sdf"))
    cfg["encoding"].update(log2_hashmap_size=12, n_levels=6)
    tb = SdfTestbed(sys.argv[1], cfg, device="cpu")
    assert np.isfinite(tb.train(1, 256))
    frame = tb.render_frame(4, 4, cam)
    assert frame.shape == (4, 4, 4) and np.isfinite(frame).all()
cfg = load_network_config(find_network_config("base", "volume"))
cfg["encoding"].update(log2_hashmap_size=12, n_levels=4)
g = np.zeros((32, 8, 8), np.float32)
g[8:24, 2:6, 2:6] = 5.0
vtb = VolumeTestbed(g, cfg, device="cpu")
assert np.isfinite(vtb.train(1, 256))
frame = vtb.render_frame(4, 4, cam, n_events=4)
assert frame.shape == (4, 4, 4) and np.isfinite(frame).all()
assert not any(m.split(".")[0] in ("jax", "msgpack", "PIL",
                                   "instant_ngp_tpu")
               for m in sys.modules)
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=repo)
    proc = subprocess.run([sys.executable, "-c", code, mesh_path], cwd=repo,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
