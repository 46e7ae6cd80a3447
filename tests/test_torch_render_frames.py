"""The port's `NerfTestbed` frames against the JAX package: the wavefront
renderer against `render_tile`, `render_frame` through a lens, the envmap
and latent codes in every mode, the rendering latent code, a training
view through its own lens, the aperture, the Distortion picture, the
density slice and grid, the PNG slice atlas, and the mesh tools on a
network with latent dims; on the tiny NeRF of
tests/test_torch_render_modes.py (tests/torch_parity.py's `pair` fixture,
a module of its own here), with the tolerances stated there."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from torch_parity import (LENS, N_EXTRA, _t, make_dataset,  # noqa: E402
                          pair)  # noqa: F401 (a fixture)

from instant_ngp_tpu.nerf import render as jrender
from instant_ngp_tpu_torch.nerf import render

FRAME_TOL = dict(rtol=5e-4, atol=5e-4)


# -- the testbed's frames -------------------------------------------------------
@pytest.mark.parametrize("mode", ["Shade", "Depth", "AO"])
def test_wavefront_renderer_matches_render_tile(pair, mode):
    _, tb = pair
    cam = tb.data.xforms_start[2].numpy()
    kw = dict(focal_length=20.0, render_mode=mode, min_transmittance=1e-3,
              background_color=(0.2, 0.3, 0.1), extra_dims=[0.1, 0.2])
    assert tb.render_wavefront and tb._uses_wavefront(mode)
    wave = tb.render_frame(16, 16, cam, **kw)
    n_wave = tb.last_frame_n_samples
    tb.render_wavefront = False
    try:
        assert not tb._uses_wavefront(mode)
        tile = tb.render_frame(16, 16, cam, tile=100, **kw)
        n_tile = tb.last_frame_n_samples
    finally:
        tb.render_wavefront = True
    np.testing.assert_allclose(wave, tile, rtol=1e-5, atol=1e-5)
    assert wave[..., 3].max() > 0.5 and n_wave > 0 and n_tile > 0


@pytest.mark.parametrize("mode", ["Shade", "Depth", "Normals", "Positions",
                                  "EncodingVis", "Cost", "AO"])
def test_render_frame_matches_jax_through_lens_envmap_and_latents(pair, mode):
    """`render_frame` with its whole signature: an OpenCV lens with its own
    principal point, the envmap as the background, a latent override and
    2 spp."""
    jtb, tb = pair
    rng = np.random.default_rng(6)
    env = rng.uniform(0, 1, (8, 16, 4)).astype(np.float32)
    jtb.envmap.state["params"] = jnp.asarray(env)
    tb.envmap.params.copy_(_t(env))
    cam = np.asarray(jtb.data.xforms_start[3])
    kw = dict(focal_length=(20.0, 21.0), spp=2, render_mode=mode,
              min_transmittance=1e-3, background_color=(0.1, 0.2, 0.3),
              lens_mode=1, lens_params=LENS, screen_center=(0.52, 0.48),
              use_envmap_background=True, extra_dims=[0.25, -0.1])
    ref = jtb.render_frame(16, 16, cam, tile=256, **kw)
    ours = tb.render_frame(16, 16, cam, tile=100, **kw)
    assert ours.shape == (16, 16, 4) and np.isfinite(ours).all()
    # EncodingVis shows 20x a feature of a table of U(-1, 1), and a normal
    # is the field's gradient, which jumps at every cell border: the lens's
    # 1e-5 in a direction is up to 5e-3 of such a colour in single pixels
    tol = dict(rtol=5e-3, atol=5e-3) \
        if mode in ("EncodingVis", "Normals") else FRAME_TOL
    np.testing.assert_allclose(ours, ref, **tol)
    assert mode == "AO" or ours[..., :3].std() > 1e-3
    # each of the four arguments matters
    base = tb.render_frame(16, 16, cam, tile=100, **kw)
    np.testing.assert_array_equal(base, ours)
    for change in (dict(lens_mode=0), dict(use_envmap_background=False),
                   dict(screen_center=(0.5, 0.5))):
        other = tb.render_frame(16, 16, cam, tile=100, **dict(kw, **change))
        if mode in ("Cost",) and "use_envmap_background" in change:
            continue                      # Cost shows no background
        assert np.abs(other - ours).max() > 1e-4, change
    if mode == "Shade":
        other = tb.render_frame(16, 16, cam, tile=100,
                                **dict(kw, extra_dims=[2.0, 2.0]))
        assert np.abs(other - ours).max() > 1e-4
        # the lens by its name, the mode by the enum
        from instant_ngp_tpu_torch.common import RenderMode
        named = tb.render_frame(16, 16, cam, tile=100, **dict(
            kw, lens_mode="OpenCV", render_mode=RenderMode.Shade))
        np.testing.assert_array_equal(named, ours)


def test_rendering_extra_dims_default_to_view_0_and_can_be_set(pair):
    jtb, tb = pair
    np.testing.assert_array_equal(tb.get_rendering_extra_dims().numpy(),
                                  np.asarray(jtb.get_rendering_extra_dims()))
    assert torch.equal(tb.get_rendering_extra_dims(), tb.data.extra_dims[0])
    cam = np.asarray(jtb.data.xforms_start[0])
    kw = dict(focal_length=20.0, use_envmap_background=False)
    default = tb.render_frame(12, 12, cam, **kw)
    np.testing.assert_allclose(default, jtb.render_frame(12, 12, cam, **kw),
                               **FRAME_TOL)
    for t in (jtb, tb):
        t.set_rendering_extra_dims_from_training_view(2)
    assert torch.equal(tb.get_rendering_extra_dims(), tb.data.extra_dims[2])
    for t in (jtb, tb):
        t.set_rendering_extra_dims(np.array([1.5, -1.0], np.float32))
    np.testing.assert_array_equal(tb.get_rendering_extra_dims().numpy(),
                                  [1.5, -1.0])
    np.testing.assert_allclose(tb.render_frame(12, 12, cam, **kw),
                               jtb.render_frame(12, 12, cam, **kw),
                               **FRAME_TOL)
    assert np.abs(tb.render_frame(12, 12, cam, **kw) - default).max() > 1e-4
    with pytest.raises(ValueError):
        tb.set_rendering_extra_dims([1.0])
    with pytest.raises(ValueError):
        tb.set_rendering_extra_dims_from_training_view(9)
    for t in (jtb, tb):
        t.set_rendering_extra_dims_from_training_view(0)


def test_render_training_view_goes_through_the_views_lens(pair):
    jtb, tb = pair
    assert tb.scene.lens_mode == jtb.scene.lens_mode == 1
    ref = jtb.render_training_view(1, width=16, height=16)
    ours = tb.render_training_view(1, width=16, height=16)
    np.testing.assert_allclose(ours, ref, **FRAME_TOL)
    # its own lens, principal point and latent: not the default frame's
    plain = tb.render_frame(16, 16, tb.effective_xform(1),
                            tb.data.focal_lengths[1].numpy() / 2,
                            min_transmittance=1e-4)
    assert np.abs(plain - ours).max() > 1e-3
    np.testing.assert_allclose(tb.eval_psnr(1, downscale=2),
                               jtb.eval_psnr(1, downscale=2), rtol=1e-3)


def test_camera_rays_with_aperture_match_jax_from_the_same_samples():
    cam = make_dataset().xforms_start[1]
    key = jax.random.PRNGKey(3)
    kw = dict(screen_center=(0.5, 0.45), lens_mode=1, lens_params=LENS,
              aperture_size=0.02, focus_z=0.9)
    jo, jd = jrender.camera_rays_for_frame(
        10, 8, (12.0, 12.5), cam, jitter=jnp.asarray([0.3, 0.7]),
        aperture_key=key, **kw)
    samples = np.asarray(jax.random.uniform(key, (80, 2)))
    o, d = render.camera_rays_for_frame(
        10, 8, (12.0, 12.5), cam, device="cpu", jitter=(0.3, 0.7),
        aperture_samples=_t(samples), **kw)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=2e-5)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=2e-5)
    # from a generator: other samples, the same focus plane
    gen = torch.Generator().manual_seed(0)
    o2, d2 = render.camera_rays_for_frame(
        10, 8, (12.0, 12.5), cam, device="cpu", jitter=(0.3, 0.7),
        generator=gen, **kw)
    assert float((o2 - o).abs().max()) > 1e-3
    with pytest.raises(ValueError, match="aperture"):
        render.camera_rays_for_frame(10, 8, (12.0, 12.5), cam, device="cpu",
                                     aperture_size=0.02)


@pytest.mark.parametrize("lens, with_map", [(0, True), (1, False), (1, True),
                                            (4, True)])
def test_distortion_flow_image_matches_jax(lens, with_map):
    rng = np.random.default_rng(8)
    cam = make_dataset().xforms_start[2]
    dmap = rng.normal(0, 0.01, (8, 8, 2)).astype(np.float32) \
        if with_map else None
    kw = dict(screen_center=(0.5, 0.5), lens_mode=lens, lens_params=LENS)
    ref = np.asarray(jrender.distortion_flow_image(
        20, 16, (22.0, 22.0), cam,
        distortion_map=None if dmap is None else jnp.asarray(dmap), **kw))
    ours = render.distortion_flow_image(
        20, 16, (22.0, 22.0), cam, device="cpu",
        distortion_map=None if dmap is None else _t(dmap), **kw).numpy()
    assert ours.shape == ref.shape == (16, 20, 4)
    # the hue of a displacement near zero is arbitrary: compare where the
    # flow has a magnitude
    strong = ref[..., :3].max(-1) > 0.02
    assert strong.mean() > 0.5
    np.testing.assert_allclose(ours[strong], ref[strong], atol=2e-3)
    np.testing.assert_allclose(ours[..., :3].max(-1), ref[..., :3].max(-1),
                               atol=2e-3)
    h = rng.uniform(-1, 2, 500).astype(np.float32)
    s, v = rng.uniform(0, 1, (2, 500)).astype(np.float32)
    for a, b in zip(render.hsv_to_rgb(_t(h), _t(s), _t(v)),
                    jrender.hsv_to_rgb(jnp.asarray(h), jnp.asarray(s),
                                       jnp.asarray(v))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


def test_distortion_mode_of_render_frame_matches_jax(pair):
    jtb, tb = pair
    rng = np.random.default_rng(9)
    dmap = rng.normal(0, 0.01, (32, 32, 2)).astype(np.float32)
    jtb.distortion_map.state["params"] = jnp.asarray(dmap)
    tb.distortion_map.params.copy_(_t(dmap))
    cam = np.asarray(jtb.data.xforms_start[0])
    try:
        kw = dict(focal_length=20.0, render_mode="Distortion", lens_mode=1,
                  lens_params=LENS, use_distortion_map=True)
        ref = jtb.render_frame(16, 16, cam, **kw)
        ours = tb.render_frame(16, 16, cam, **kw)
        np.testing.assert_allclose(ours[..., :3].max(-1),
                                   ref[..., :3].max(-1), atol=2e-3)
        off = tb.render_frame(16, 16, cam, **dict(kw,
                                                  use_distortion_map=False))
        assert np.abs(off - ours).max() > 1e-3
        # the map also bends the rays of a marched frame
        shade = dict(focal_length=20.0, use_envmap_background=False)
        bent = tb.render_frame(16, 16, cam, use_distortion_map=True, **shade)
        np.testing.assert_allclose(
            bent, jtb.render_frame(16, 16, cam, use_distortion_map=True,
                                   **shade), **FRAME_TOL)
        assert np.abs(bent - tb.render_frame(16, 16, cam, **shade)).max() \
            > 1e-3
    finally:
        jtb.distortion_map.state["params"] = jnp.zeros((32, 32, 2))
        tb.distortion_map.params.zero_()
    with pytest.raises(ValueError, match="Slice"):
        tb.render_frame(8, 8, cam, focal_length=20.0, render_mode="Slice")


# -- the density field ----------------------------------------------------------
def test_density_slice_and_grid_match_jax(pair, tmp_path):
    jtb, tb = pair
    ref = jtb.render_density_slice(24, plane_z=0.45)
    ours = tb.render_density_slice(24, plane_z=0.45)
    assert ours.shape == ref.shape == (24, 24, 3)
    np.testing.assert_allclose(ours, ref, atol=1e-3)
    assert ours.std() > 0.05
    ref = jtb.density_on_grid(12)
    ours = tb.density_on_grid(12)
    assert ours.shape == (12, 12, 12)
    empty = ref == -10000.0
    np.testing.assert_array_equal(ours == -10000.0, empty)
    assert 0 < empty.sum() < empty.size
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-4)
    box = (np.array([0.2, 0.3, 0.1], np.float32),
           np.array([0.8, 0.7, 0.9], np.float32))
    np.testing.assert_allclose(tb.density_on_grid((4, 6, 5), aabb=box),
                               jtb.density_on_grid((4, 6, 5), aabb=box),
                               rtol=1e-4, atol=1e-4)
    a = tb.compute_and_save_png_slices(str(tmp_path / "ours"), 16, aabb=box)
    b = jtb.compute_and_save_png_slices(str(tmp_path / "theirs"), 16,
                                        aabb=box)
    assert tuple(a) == tuple(b) == (16, 16, 16)
    from PIL import Image
    name = "density_slices_16x16x16.png"
    ours = np.asarray(Image.open(tmp_path / f"ours.{name}"), np.int32)
    ref = np.asarray(Image.open(tmp_path / f"theirs.{name}"), np.int32)
    assert ours.shape == ref.shape and np.abs(ours - ref).max() <= 1
    assert ours.std() > 1


def test_find_closest_training_view_and_mesh_tools(pair):
    jtb, tb = pair
    for i in range(4):
        cam = np.asarray(jtb.data.xforms_start[i]).copy()
        cam[:, 3] += 0.01
        assert tb.find_closest_training_view(cam) == i \
            == jtb.find_closest_training_view(cam)
    # the mesh tools on a network with latent dims (the JAX testbed's
    # mesh method takes none, so its pieces are called here): marching
    # cubes of the same field, the vertex colours through the RGB net with
    # view 0's latent code, one optimisation step of the vertices (the
    # threshold in the widest gap of the field's values near 2.5)
    from instant_ngp_tpu.geom.marching import vertex_normals
    from instant_ngp_tpu.geom.marching_cubes import marching_cubes
    from instant_ngp_tpu.nerf.march import warp_direction, warp_position
    from instant_ngp_tpu.nerf.model import network_to_rgb

    res = 16
    field = jtb.density_on_grid(res)
    values = np.sort(field[(field > 1.5) & (field < 3.5)])
    gap = int(np.argmax(np.diff(values)))
    thresh = float(0.5 * (values[gap] + values[gap + 1]))
    verts, faces, colors = tb.compute_marching_cubes_mesh(res, thresh)
    lo, hi = jtb.scene.aabb_min, jtb.scene.aabb_max
    ref_v, ref_f = marching_cubes(-field, -thresh, lo, (hi - lo) / (res - 1))
    assert len(faces) > 20
    np.testing.assert_array_equal(faces, ref_f)
    np.testing.assert_allclose(verts, ref_v, atol=1e-5)
    latent = tb.get_rendering_extra_dims().numpy()
    raw = jtb.model.apply(
        jtb.inference_params(), warp_position(jnp.asarray(verts), lo, hi),
        warp_direction(-jnp.asarray(vertex_normals(verts, faces))),
        jnp.broadcast_to(jnp.asarray(latent), (len(verts), N_EXTRA)))
    np.testing.assert_allclose(
        colors, np.asarray(network_to_rgb(raw[:, :3],
                                          jtb.scene.rgb_activation)),
        atol=1e-3)
    kw = dict(thresh=thresh, learning_rate=1e-3, smooth_amount=0.01,
              density_amount=0.01)
    np.testing.assert_allclose(tb.optimise_mesh_step(verts, faces, **kw),
                               jtb.optimise_mesh_step(verts, faces, **kw),
                               atol=1e-5)
