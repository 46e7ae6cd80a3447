"""The port's render modes against the JAX package (depth-major compaction
and `render_tile` here; the testbed's frames, the density field and the
mesh tools in tests/test_torch_render_frames.py), on a tiny NeRF of the
JAX testbed's seeded weights whose density field was made steep (a hash
table of U(-1, 1), the density net's output scaled): the synthetic scene of
tests/test_nerf_training.py seen through an OpenCV lens, with 2 latent dims
per image (so the RGB net is 16 + 16 + 2 wide), an L=4 hash grid with F=4
and 32-wide MLPs, at float32 compute. Its state goes into a port testbed
(`sync_port`), and both render the same rays; the pair is
tests/torch_parity.py's fixture `pair`.

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

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from torch_parity import (N_EXTRA, _t, pair,  # noqa: E402,F401 (a fixture)
                          random_bitfield)

from instant_ngp_tpu.nerf import render as jrender
from instant_ngp_tpu.nerf import sampler as jsampler
from instant_ngp_tpu_torch.nerf import render, sampler
from instant_ngp_tpu_torch.nerf.render import RENDER_TILE_MODES

TILE_TOL = dict(rtol=1e-4, atol=1e-4)


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
