"""The port's render modes against the JAX package, on a tiny NeRF of the
JAX testbed's seeded weights whose density field was made steep (a hash
table of U(-1, 1), the density net's output scaled): the synthetic scene of
tests/test_nerf_training.py seen through an OpenCV lens, with 2 latent dims
per image (so the RGB net is 16 + 16 + 2 wide), an L=4 hash grid with F=4
and 32-wide MLPs, at float32 compute. Its state goes into a port testbed
(`sync_port`), and both render the same rays.

Tolerances:
- depth-major compaction: slots, sources and counts are integers and must
  agree exactly, truncating budgets included; positions to rtol 1e-5 /
  atol 1e-6;
- `render_tile` per mode and `render_frame`: rtol/atol 1e-4, as the JAX
  package holds its own two renderers to each other (summation order, ulps
  of exp). Normals divide a gradient by its norm: the same 1e-4 where the
  density gradient is not tiny, which a trained-scale table ensures;
- `render_frame` of the testbeds: rtol/atol 5e-4. The fixture's density
  field is steep (raw densities of 4 +- 4 from a table of U(-1, 1)), so a
  ray direction that differs in its last bits moves a density by 1e-4 of
  itself, and through the OpenCV lens the Newton undistortion differs by
  up to 1e-5 in the direction between XLA and PyTorch (see
  tests/test_torch_lenses.py); Normals and EncodingVis frames through the
  lens 5e-3 (a gradient that jumps at cell borders; 20x a feature);
- the wavefront renderer against `render_tile` inside the port: 1e-5 (the
  same weighted sums, accumulated in rounds)."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_nerf_training import CFG, make_dataset  # noqa: E402
from test_torch_sampler import port_dataset, random_bitfield  # noqa: E402

from instant_ngp_tpu.nerf import render as jrender
from instant_ngp_tpu.nerf import sampler as jsampler
from instant_ngp_tpu.nerf.testbed_nerf import NerfTestbed as JaxTestbed
from instant_ngp_tpu_torch.convert import (buffer_state_from_jax,
                                           opt_state_from_jax,
                                           params_from_jax)
from instant_ngp_tpu_torch.nerf import render, sampler
from instant_ngp_tpu_torch.nerf.render import RENDER_TILE_MODES
from instant_ngp_tpu_torch.nerf.testbed_nerf import NerfTestbed

torch.set_num_threads(2)

N_EXTRA = 2
LENS = np.array([0.06, -0.015, 0.002, -0.003, 0, 0, 0], np.float32)
MODES_CFG = dict(
    CFG,
    encoding=dict(CFG["encoding"], n_features_per_level=4,
                  stochastic_exact_axes=1, stochastic_bwd=True),
    dir_encoding={"otype": "Composite", "nested": [
        {"n_dims_to_encode": 3, "otype": "SphericalHarmonics", "degree": 4},
        {"otype": "Identity"}]})
TILE_TOL = dict(rtol=1e-4, atol=1e-4)
FRAME_TOL = dict(rtol=5e-4, atol=5e-4)


def _t(a):
    return torch.from_numpy(np.array(a))


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def lens_dataset(lens="OpenCV", n_extra=N_EXTRA, depths=False, envmap=None):
    """The tiny dataset with a lens, latent dims, depth images and an
    environment map (as the JAX package's container)."""
    jds = make_dataset()
    for i, m in enumerate(jds.metadata):
        m.lens.mode = lens
        if lens != "Perspective":
            m.lens.params = LENS * (1.0 + 0.1 * i)
        m.principal_point = np.array([0.5 + 0.01 * i, 0.49], np.float32)
    jds.n_extra_learnable_dims = n_extra
    if depths:
        # the sphere of the images at its distance, nothing elsewhere
        jds.depths = [np.where(im[..., 3] > 0, 0.8 - 0.2 * (i % 2), 0.0)
                      .astype(np.float32) for i, im in enumerate(jds.images)]
    jds.envmap = envmap
    return jds


def port_lens_dataset(jds):
    pds = port_dataset(jds)
    pds.n_extra_learnable_dims = jds.n_extra_learnable_dims
    pds.envmap = jds.envmap
    return pds


def set_knobs(tb, n_rays=512):
    tb.target_batch_size = 1 << 12
    tb.rays_per_batch = n_rays
    tb.adapt_ray_batch = False
    tb.n_march = 96
    tb.max_samples_per_ray = 32
    tb.density_samples_override = 1 << 12
    tb.steps_per_dispatch = 1


def sync_port(tb, jtb):
    """The JAX testbed's whole training state into the port's: network,
    optimizer, occupancy, step counts and the three trainable buffers."""
    state = _numpy_tree(jtb.state)
    tb.load_state(params_from_jax(state["params"]),
                  opt_state_from_jax(state["opt"]))
    tb.set_density_grid(np.asarray(jtb.density_grid))
    tb.training_step = jtb.training_step
    tb.density_grid_ema_step = jtb.density_grid_ema_step
    for ours, theirs in ((tb._extra_dims_buf, jtb._extra_dims_buf),
                         (tb.envmap, jtb.envmap),
                         (tb.distortion_map, jtb.distortion_map)):
        if theirs is not None:
            ours.load_state(buffer_state_from_jax(_numpy_tree(theirs.state)))
    return tb


@pytest.fixture(scope="module")
def pair():
    """(JAX testbed with a steep density field, port testbed of the same
    state)."""
    jds = lens_dataset()
    jtb = JaxTestbed(jds, MODES_CFG, compute_dtype=jnp.float32)
    set_knobs(jtb)
    jtb.max_samples_per_ray = 64
    # a table at a trained scale: densities that occlude, gradients that
    # have a direction
    rng = np.random.default_rng(1)
    state = _numpy_tree(jtb.state)
    table = state["params"]["pos_encoding"]
    table = table + rng.uniform(-1.0, 1.0, table.shape).astype(np.float32)
    out_layer = state["params"]["density_net"][-1].copy()
    out_layer[:, 0] *= 40.0          # raw densities of 4 +- 4
    for tree in (state["params"], state["opt"]["ema"]):
        tree["pos_encoding"] = table
        tree["density_net"] = list(tree["density_net"][:-1]) + [out_layer]
    jtb.state = jax.tree_util.tree_map(jnp.asarray, state)
    # the occupancy of that field: one full sweep with the exact encode
    jtb.stochastic_corners = False
    jtb.density_samples_override = None
    jtb.training_step = 1
    jtb.training_prep()
    jtb.density_samples_override = 1 << 12
    jtb.training_step = 256
    tb = NerfTestbed(port_lens_dataset(jds), MODES_CFG, device="cpu",
                     compute_dtype=torch.float32)
    set_knobs(tb)
    tb.max_samples_per_ray = 64
    sync_port(tb, jtb)
    return jtb, tb


# -- depth-major compaction ----------------------------------------------------
@pytest.mark.parametrize("capacity", [1 << 14, 3000, 200],
                         ids=["roomy", "truncating", "tiny"])
def test_depth_major_compaction_matches_jax_exactly(pair, capacity):
    jtb, tb = pair
    n_rays, n_march, max_k = 300, 96, 32
    lo, hi = np.zeros(3, np.float32), np.ones(3, np.float32)
    _, bitfield = random_bitfield(seed=3)
    rng = np.random.default_rng(4)
    o = rng.uniform(-0.5, 1.5, (n_rays, 3)).astype(np.float32)
    d = (0.5 - o) + rng.normal(0, 0.2, (n_rays, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    t0 = rng.uniform(0.0, 0.6, n_rays).astype(np.float32)
    valid = rng.uniform(size=n_rays) > 0.1
    jrays = jsampler.RayBatch(jnp.asarray(o), jnp.asarray(d),
                              jnp.asarray(t0), jnp.zeros(n_rays, jnp.int32),
                              jnp.zeros((n_rays, 2)), jnp.zeros((n_rays, 4)),
                              jnp.asarray(valid))
    rays = sampler.RayBatch(_t(o), _t(d), _t(t0), _t(valid))
    jts, jdts, jemit = jsampler.march_rays(
        jrays, jnp.asarray(bitfield), jnp.asarray(lo), jnp.asarray(hi), 0.0,
        0, n_march, max_k)
    ts, dts, emit = sampler.march_rays(rays, _t(bitfield), _t(lo), _t(hi),
                                       0.0, 0, n_march, max_k)
    np.testing.assert_array_equal(emit.numpy(), np.asarray(jemit))
    js = jsampler.compact_samples(jrays, jts, jdts, jemit, jnp.asarray(lo),
                                  jnp.asarray(hi), capacity, order="depth",
                                  cone_angle=0.0)
    s = sampler.compact_samples(rays, ts, emit, _t(lo), _t(hi), capacity,
                                0.0, order="depth")
    n_emitted = int(np.asarray(jemit).sum())
    assert (n_emitted > capacity) == (capacity < 1 << 14)
    n = int(s.n_samples)
    assert n == int(js.n_samples) == min(n_emitted, capacity)
    for f in ("cand_slot", "cand_src", "ray_count", "ray_base", "ray_id"):
        np.testing.assert_array_equal(getattr(s, f).numpy(),
                                      np.asarray(getattr(js, f)), f)
    assert int((s.cand_slot < capacity).sum()) == n == int(s.ray_count.sum())
    assert (s.cand_src[n:] == n_rays * n_march).all()
    for f in ("dts", "t_mid"):
        np.testing.assert_allclose(getattr(s, f).numpy()[:n],
                                   np.asarray(getattr(js, f))[:n],
                                   rtol=1e-5, atol=1e-6, err_msg=f)
    for f in ("positions", "dirs"):
        ref = np.stack([np.asarray(c) for c in getattr(js, f)], -1)
        np.testing.assert_allclose(getattr(s, f).numpy()[:n], ref[:n],
                                   rtol=1e-5, atol=1e-6, err_msg=f)
    if n_emitted > capacity:
        # the deep tail goes, of every ray alike: a kept candidate's
        # column of the march grid is never deeper than a dropped one's
        column = torch.arange(n_march).expand(n_rays, n_march)
        kept = emit & (s.cand_slot < capacity)
        dropped = emit & ~kept
        assert int(column[kept].max()) <= int(column[dropped].min())


# -- render_tile, mode by mode -----------------------------------------------
def _tile_rays(jtb, view=1, size=12):
    cam = np.asarray(jtb.data.xforms_start[view])
    o, d = jrender.camera_rays_for_frame(size, size, (15.0, 15.0), cam)
    return np.asarray(o), np.asarray(d)


def _jax_cfg(jtb, tb, mode, capacity, n_rays, min_t=1e-3):
    return jrender.RenderConfig(
        n_rays=n_rays, n_march=tb.n_march, max_samples_per_ray=32,
        sample_capacity=capacity, cone_angle=jtb.scene.cone_angle_constant,
        max_mip=jtb.scene.max_cascade,
        rgb_activation=jtb.scene.rgb_activation,
        density_activation=jtb.scene.density_activation,
        min_transmittance=min_t, render_mode=mode)


def _port_cfg(tb, mode, capacity, min_t=1e-3):
    return render.RenderConfig(
        n_march=tb.n_march, max_samples_per_ray=32,
        cone_angle=tb.scene.cone_angle_constant,
        max_mip=tb.scene.max_cascade,
        rgb_activation=tb.scene.rgb_activation,
        density_activation=tb.scene.density_activation,
        min_transmittance=min_t, render_mode=mode, sample_capacity=capacity)


@pytest.mark.parametrize("capacity", [1 << 13, 1500],
                         ids=["roomy", "truncating"])
@pytest.mark.parametrize("mode", RENDER_TILE_MODES)
def test_render_tile_matches_jax_in_every_mode(pair, mode, capacity):
    jtb, tb = pair
    o, d = _tile_rays(jtb)
    n = o.shape[0]
    bg = np.random.default_rng(5).uniform(size=(n, 3)).astype(np.float32)
    extra = np.array([0.3, -0.2], np.float32)
    lo, hi = jnp.asarray(jtb.scene.aabb_min), jnp.asarray(jtb.scene.aabb_max)
    ref = jrender.render_tile(
        jtb.model, _jax_cfg(jtb, tb, mode, capacity, n),
        jtb.inference_params(), jnp.asarray(o), jnp.asarray(d), jtb.bitfield,
        lo, hi, jnp.asarray(bg), jnp.asarray(extra))
    with torch.no_grad():
        out = render.render_tile(
            tb.inference_model, _port_cfg(tb, mode, capacity), _t(o), _t(d),
            tb.bitfield, tb.aabb_min, tb.aabb_max, _t(bg), _t(extra))
    assert int(out["n_samples"]) == int(ref["n_samples"]) > 0
    if capacity == 1500:
        assert int(out["n_samples"]) == capacity       # the budget binds
    for k in ("rgb", "alpha", "depth"):
        a, b = out[k].numpy(), np.asarray(ref[k])
        assert a.shape == b.shape and np.isfinite(a).all()
        np.testing.assert_allclose(a, b, err_msg=k, **TILE_TOL)
    assert float(out["alpha"].max()) > 0.5            # the scene occludes
    if mode != "AO":                  # (opaque everywhere it hits)
        assert float(out["rgb"].std()) > 1e-3         # and is not constant
    # a constant background broadcasts
    with torch.no_grad():
        again = render.render_tile(
            tb.inference_model, _port_cfg(tb, mode, capacity), _t(o), _t(d),
            tb.bitfield, tb.aabb_min, tb.aabb_max, _t(bg[0]), _t(extra))
    assert torch.equal(again["alpha"], out["alpha"])


def test_render_tile_rejects_other_modes_and_needs_its_latents(pair):
    _, tb = pair
    o = torch.zeros(4, 3)
    d = torch.tensor([[0.0, 0.0, 1.0]]).expand(4, 3)
    args = (o, d, tb.bitfield, tb.aabb_min, tb.aabb_max, torch.zeros(3))
    with pytest.raises(ValueError, match="mode"):
        render.render_tile(tb.inference_model,
                           _port_cfg(tb, "Slice", 64), *args)
    # rays that miss everything evaluate nothing and show the background
    with torch.no_grad():
        out = render.render_tile(tb.inference_model,
                                 _port_cfg(tb, "Normals", 64), o - 5.0, d,
                                 tb.bitfield, tb.aabb_min, tb.aabb_max,
                                 torch.full((3,), 0.25))
    assert int(out["n_samples"]) == 0 and (out["rgb"] == 0.25).all()
    o, d = (_t(v) for v in _tile_rays(pair[0]))
    with pytest.raises(ValueError, match="extra"), torch.no_grad():
        render.render_tile(tb.inference_model, _port_cfg(tb, "Shade", 64),
                           o, d, tb.bitfield, tb.aabb_min, tb.aabb_max,
                           torch.zeros(3))


def test_normals_run_under_grad_inside_no_grad_and_leave_no_graph(pair):
    jtb, tb = pair
    o, d = _tile_rays(jtb, size=6)
    with torch.no_grad():
        out = render.render_tile(
            tb.inference_model, _port_cfg(tb, "Normals", 1 << 12), _t(o),
            _t(d), tb.bitfield, tb.aabb_min, tb.aabb_max, torch.zeros(3),
            torch.zeros(N_EXTRA))
    assert not out["rgb"].requires_grad and out["rgb"].grad_fn is None
    assert all(p.grad is None for p in tb.inference_model.parameters())
    assert int(out["n_samples"]) > 0


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
    for name in ("compute_marching_cubes_mesh", "optimise_mesh_step"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            getattr(tb, name)()
