"""The port's mesh tools and FLIP against the JAX package's.

- marching cubes (its case table built at import) and marching tetrahedra
  on a 24^3 sphere and on random fields, welding, smoothing, normals:
  the same numpy arithmetic, so vertices and faces are equal;
- `save_mesh` (PLY and OBJ) and the port's `load_mesh`, which reads the
  files either package writes: positions exactly, colours to the byte;
- `NerfTestbed.compute_marching_cubes_mesh` and `optimise_mesh_step` on a
  tiny network (L=4 hash grid, 32-wide MLPs, float32 compute) loaded with
  the JAX testbed's weights, its table at a trained scale: the density
  fields agree to 1e-4 (tests/test_torch_render_modes.py), so the
  threshold is taken in the middle of the widest gap between the grid's
  values near 2.5 (a few 1e-3 from the nearest). Then the marching-cubes
  faces are equal and its vertices agree to 1e-4 of a cell; marching
  tetrahedra welds vertices rounded to 1e-6, which such differences can
  tip, so its triangles are compared as sorted centroids. A colour is
  seen along the vertex normal, which those 1e-4 turn: 1e-3. An Adam step
  moves a coordinate by about the learning rate (1e-3) whatever the size
  of its gradient, so two steps agree to 1 % of it, 1e-5;
- FLIP: numpy and scipy on both sides, 1e-5.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_nerf_training import CFG, make_dataset  # noqa: E402
from test_torch_sampler import port_dataset  # noqa: E402

from instant_ngp_tpu.geom import marching as jmarching
from instant_ngp_tpu.geom.marching_cubes import \
    marching_cubes as jax_marching_cubes
from instant_ngp_tpu.metrics import compute_error as jax_compute_error
from instant_ngp_tpu.metrics_flip import compute_flip as jax_compute_flip
from instant_ngp_tpu.nerf.testbed_nerf import NerfTestbed as JaxTestbed
from instant_ngp_tpu_torch.convert import opt_state_from_jax, params_from_jax
from instant_ngp_tpu_torch.geom import marching
from instant_ngp_tpu_torch.geom.marching_cubes import (N_TRIS, TRI_TABLE,
                                                       marching_cubes)
from instant_ngp_tpu_torch.metrics import compute_error, compute_error_img
from instant_ngp_tpu_torch.metrics_flip import compute_flip
from instant_ngp_tpu_torch.nerf.testbed_nerf import NerfTestbed

torch.set_num_threads(2)

RES = 24


def sphere(res=RES, radius=0.6):
    g = np.linspace(-1, 1, res, dtype=np.float32)
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    return np.sqrt(x * x + y * y + z * z) - radius


FIELDS = {
    "sphere": lambda: sphere(),
    "random": lambda: np.random.default_rng(0).normal(
        size=(9, 11, 10)).astype(np.float32),
    "smooth_random": lambda: np.cumsum(np.random.default_rng(1).normal(
        size=(12, 12, 12)), axis=0).astype(np.float32),
}


# -- extraction ---------------------------------------------------------------
def test_case_table_matches_jax():
    from instant_ngp_tpu.geom import marching_cubes as jmc

    np.testing.assert_array_equal(TRI_TABLE, jmc.TRI_TABLE)
    np.testing.assert_array_equal(N_TRIS, jmc.N_TRIS)
    assert N_TRIS.max() <= 5 and N_TRIS[0] == N_TRIS[255] == 0


@pytest.mark.parametrize("name", list(FIELDS))
def test_marching_cubes_and_tetrahedra_match_jax(name):
    field = FIELDS[name]()
    origin, spacing = np.array([0.1, -0.2, 0.3], np.float32), \
        np.array([0.05, 0.04, 0.03], np.float32)
    v, f = marching_cubes(field, 0.1, origin, spacing)
    jv, jf = jax_marching_cubes(field, 0.1, origin, spacing)
    assert len(f) > 0
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(f, jf)
    v, f = marching.marching_tetrahedra(field, 0.1, origin, spacing)
    jv, jf = jmarching.marching_tetrahedra(field, 0.1, origin, spacing)
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(f, jf)


def test_weld_smooth_normals_match_jax():
    v, f = marching_cubes(sphere(), 0.0)
    soup = v[f]
    for ours, ref in zip(marching.weld_vertices(soup),
                         jmarching.weld_vertices(soup)):
        np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(marching.smooth_mesh(v, f, 3, 0.4),
                                  jmarching.smooth_mesh(v, f, 3, 0.4))
    n = marching.vertex_normals(v, f)
    np.testing.assert_array_equal(n, jmarching.vertex_normals(v, f))
    # the sphere's normals point outwards
    centred = v - v.mean(0)
    assert ((n * centred).sum(-1) > 0).all()


@pytest.mark.parametrize("suffix", ["ply", "obj"])
def test_saved_meshes_read_back_from_either_package(suffix, tmp_path):
    v, f = marching_cubes(sphere(16), 0.0)
    colors = np.random.default_rng(3).uniform(0, 1, v.shape) \
        .astype(np.float32)
    normals = marching.vertex_normals(v, f)
    for kw in ({"colors": colors}, {"normals": normals}, {}):
        ours, ref = str(tmp_path / f"ours.{suffix}"), \
            str(tmp_path / f"ref.{suffix}")
        marching.save_mesh(ours, v, f, **kw)
        jmarching.save_mesh(ref, v, f, **kw)
        for path in (ours, ref):
            rv, rf, rc = marching.load_mesh(path)
            np.testing.assert_array_equal(rv, v)
            np.testing.assert_array_equal(rf, f)
            if "colors" not in kw:
                assert rc is None
            elif suffix == "ply":
                # stored as bytes, truncated
                np.testing.assert_array_equal(
                    rc, (colors * 255).astype(np.uint8) / np.float32(255))
            else:
                np.testing.assert_allclose(rc, colors, rtol=1e-6)
        if suffix == "ply":
            with open(ours, "rb") as a, open(ref, "rb") as b:
                assert a.read() == b.read()


# -- the NeRF testbed's mesh methods ------------------------------------------
@pytest.fixture(scope="module")
def testbeds():
    """(JAX testbed of the tiny network, its table at a trained scale and
    the density net's output scaled so that raw densities reach 4 +- 4,
    every cell occupied; the port's testbed with the same state)."""
    jds = make_dataset()
    jtb = JaxTestbed(jds, CFG, compute_dtype=jnp.float32)
    state = jax.tree_util.tree_map(np.asarray, jtb.state)
    table = np.random.default_rng(1).uniform(
        -1, 1, state["params"]["pos_encoding"].shape).astype(np.float32)
    out_layer = state["params"]["density_net"][-1].copy()
    out_layer[:, 0] *= 40.0
    for tree in (state["params"], state["opt"]["ema"]):
        tree["pos_encoding"] = table
        tree["density_net"] = list(tree["density_net"][:-1]) + [out_layer]
    jtb.state = jax.tree_util.tree_map(jnp.asarray, state)
    grid = np.ones(jtb.density_grid.shape, np.float32)
    jtb.density_grid = jnp.asarray(grid)
    tb = NerfTestbed(port_dataset(jds), CFG, device="cpu",
                     compute_dtype=torch.float32)
    tb.load_state(params_from_jax(state["params"]),
                  opt_state_from_jax(state["opt"]))
    tb.set_density_grid(grid)
    values = np.sort(jtb.density_on_grid(RES).ravel())
    values = values[(values > 1.5) & (values < 3.5)]
    gap = int(np.argmax(np.diff(values)))
    thresh = float(0.5 * (values[gap] + values[gap + 1]))
    assert values[gap + 1] - values[gap] > 2e-3
    return jtb, tb, thresh


@pytest.mark.parametrize("algorithm", ["mc", "tets"])
def test_compute_marching_cubes_mesh_matches_jax(testbeds, algorithm):
    jtb, tb, thresh = testbeds
    jtb.mesh_algorithm = tb.mesh_algorithm = algorithm
    try:
        ref = jtb.compute_marching_cubes_mesh(RES, thresh)
        ours = tb.compute_marching_cubes_mesh(RES, thresh)
    finally:
        jtb.mesh_algorithm = tb.mesh_algorithm = "mc"
    assert len(ours[1]) > 50
    spacing = float((jtb.scene.aabb_max - jtb.scene.aabb_min)[0]) / (RES - 1)
    if algorithm == "mc":
        np.testing.assert_array_equal(ours[1], ref[1])
        np.testing.assert_allclose(ours[0], ref[0], atol=1e-4 * spacing)
        np.testing.assert_allclose(ours[2], np.asarray(ref[2]), atol=1e-3)
    else:
        def centroids(v, f):
            c = v[f].mean(axis=1)
            return c[np.lexsort(np.round(c / spacing, 2).T[::-1])]
        assert len(ours[1]) == len(ref[1])
        np.testing.assert_allclose(centroids(*ours[:2]),
                                   centroids(*ref[:2]), atol=1e-3 * spacing)
    # a box of the caller's; nothing inside it is dense: an empty mesh
    box = (np.full(3, 0.4, np.float32), np.full(3, 0.45, np.float32))
    empty = tb.compute_marching_cubes_mesh(8, 1e6, aabb=box)
    assert [len(a) for a in empty] == [0, 0, 0]


def test_optimise_mesh_step_matches_jax(testbeds):
    jtb, tb, thresh = testbeds
    verts, faces, _ = tb.compute_marching_cubes_mesh(RES, thresh)
    kw = dict(n_steps=2, thresh=thresh, smooth_amount=0.01,
              density_amount=0.01, inflate_amount=0.001,
              learning_rate=1e-3)
    ours = tb.optimise_mesh_step(verts, faces, **kw)
    ref = jtb.optimise_mesh_step(verts, faces, **kw)
    assert ours.dtype == np.float32 and ours.shape == verts.shape
    np.testing.assert_allclose(ours, ref, atol=1e-5)
    assert np.abs(ours - verts).max() > 1e-3
    # the density's input gradient against JAX's
    raw, grad = tb._density_and_input_grad(verts)
    from instant_ngp_tpu.nerf.march import warp_position

    params = jtb.inference_params()
    lo, hi = jnp.asarray(jtb.scene.aabb_min), jnp.asarray(jtb.scene.aabb_max)
    ref_g = jax.grad(lambda p: jnp.sum(jtb.model.density(
        params, warp_position(p, lo, hi))))(jnp.asarray(verts))
    np.testing.assert_allclose(grad, np.asarray(ref_g), rtol=1e-4,
                               atol=1e-4 * np.abs(grad).max())


# -- FLIP ---------------------------------------------------------------------
@pytest.mark.parametrize("case", ["noise", "blur", "hdr"])
def test_flip_matches_jax(case):
    rng = np.random.default_rng(4)
    ref = rng.uniform(0, 1, (40, 48, 3)).astype(np.float32)
    if case == "noise":
        img = np.clip(ref + rng.normal(0, 0.05, ref.shape), 0, 1)
    elif case == "blur":
        img = (ref + np.roll(ref, 1, 0) + np.roll(ref, 1, 1)) / 3
    else:
        img, ref = 3.0 * ref, 2.5 * np.roll(ref, 2, 1)
    img = img.astype(np.float32)
    ours = compute_error_img("FLIP", img, ref)
    theirs = jax_compute_error_img_flip(img, ref)
    assert ours.shape == (40, 48) and 0.0 <= ours.min() <= ours.max() <= 1.0
    np.testing.assert_allclose(ours, theirs, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(compute_error("FLIP", img, ref),
                               jax_compute_error("FLIP", img, ref),
                               rtol=1e-5)
    np.testing.assert_allclose(compute_flip(ref.clip(0, 1), ref.clip(0, 1)),
                               0.0, atol=1e-6)
    np.testing.assert_allclose(
        compute_flip(ref.clip(0, 1), img.clip(0, 1)),
        jax_compute_flip(ref.clip(0, 1), img.clip(0, 1)), rtol=1e-5,
        atol=1e-5)


def jax_compute_error_img_flip(img, ref):
    from instant_ngp_tpu.metrics import compute_error_img as jax_error_img

    return jax_error_img("FLIP", img, ref)
