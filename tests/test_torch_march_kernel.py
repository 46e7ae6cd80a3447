"""The wavefront renderer's march-and-pack kernel (csrc/nerf_march.cu,
ops/kernels/march_kernels.py) against its plain version, and the kernel's
early exit against the full candidate plane.

On the card (tests marked `cuda`, skipped without one): the kernel's packed
rows equal the plain version's, run on the same CUDA tensors, bit for bit
over the columns the rounds read (a ray's n_cand rounded up to whole rounds
of `chunk`), for cone angles 0 and 1/256, max_mip 0 and 7, random
bitfields at 1, 30 and 95 % occupancy and the benchmark's shell, on rays
that miss the box, start inside it, graze a face, an edge or a corner, or
reach the cap of kept samples, at ray counts that are not multiples of the
block; a frame through `render_frame` equals the plain version's. The file
imports no JAX:

    python -m pytest --noconftest -q tests/test_torch_march_kernel.py

On the CPU: the kernel's stopping rules, restated per ray in numpy (a ray
stops at its cap of kept samples, or at the first candidate past the box's
far face on some axis in that axis' direction of travel), keep the packed
rows of the full (rays, n_march) plane.
"""

import numpy as np
import pytest
import torch

from instant_ngp_tpu_torch.common import NERF_CASCADES, NERF_GRIDSIZE
from instant_ngp_tpu_torch.nerf.dataset import scene_config
from instant_ngp_tpu_torch.nerf.occupancy import pack_bitfield, shell_bitfield
from instant_ngp_tpu_torch.nerf.render import RenderConfig, WavefrontRenderer
from instant_ngp_tpu_torch.nerf.sampler import march_rays
from instant_ngp_tpu_torch.ops.kernels.march_kernels import march_and_pack

CONES = (0.0, 1.0 / 256.0)
MAX_MIPS = (0, 7)
BITFIELDS = ("occupied_1", "occupied_30", "occupied_95", "shell")
N_MARCH, MAX_SAMPLES, CHUNK = 1024, 512, 32


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _box(max_mip):
    """The box of a scene whose cascades reach max_mip (aabb_scale
    2^max_mip), f32 numpy."""
    scene = scene_config(1 << max_mip)
    return (np.asarray(scene.aabb_min, np.float32),
            np.asarray(scene.aabb_max, np.float32))


def _unit(v):
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _rays(n, lo, hi, seed):
    """(origins, dirs) (n, 3) f32 numpy: rays from outside at the box, from
    inside it, along a face (in its plane, and tilted by one part in 10^7),
    along an edge, through a corner, along a diagonal, and rays that miss
    the box, in turn."""
    rng = np.random.default_rng(seed)
    side, centre = hi - lo, (lo + hi) / 2
    o = np.empty((n, 3), np.float32)
    d = np.empty((n, 3), np.float32)
    kind = np.arange(n) % 8
    inner = lo + side * rng.uniform(0.0, 1.0, (n, 3))
    shell = centre + side * 1.5 * _unit(rng.normal(size=(n, 3)))
    # 0: from outside at a point of the box
    o[:] = shell
    d[:] = _unit(inner - shell)
    # 1: from inside, any direction
    sel = kind == 1
    o[sel], d[sel] = inner[sel], _unit(rng.normal(size=(sel.sum(), 3)))
    # 2, 3: on a face plane (lo or hi of an axis), moving in it or tilted
    for k in (2, 3):
        sel = np.flatnonzero(kind == k)
        axis = rng.integers(0, 3, sel.size)
        face = np.where(rng.random(sel.size) < 0.5, lo[axis], hi[axis])
        dd = rng.normal(size=(sel.size, 3))
        dd[np.arange(sel.size), axis] = 0.0 if k == 2 else 1e-7 * np.sign(
            rng.normal(size=sel.size))
        oo = inner[sel].copy()
        oo[np.arange(sel.size), axis] = face
        # start outside the box half the time, in the face's plane
        back = rng.random(sel.size) < 0.5
        oo[back] -= (side * _unit(dd[back])).astype(np.float32)
        oo[np.arange(sel.size)[back], axis[back]] = face[back]
        o[sel], d[sel] = oo, _unit(dd)
    # 4: along an edge (two coordinates on faces), from outside
    sel = np.flatnonzero(kind == 4)
    axis = rng.integers(0, 3, sel.size)
    oo = np.where(rng.random((sel.size, 3)) < 0.5, lo, hi).astype(np.float32)
    dd = np.zeros((sel.size, 3), np.float32)
    sgn = np.where(rng.random(sel.size) < 0.5, -1.0, 1.0)
    dd[np.arange(sel.size), axis] = sgn
    oo[np.arange(sel.size), axis] = centre[axis] - sgn * side[axis]
    o[sel], d[sel] = oo, dd
    # 5: through a corner, from outside, at the corner
    sel = np.flatnonzero(kind == 5)
    corner = np.where(rng.random((sel.size, 3)) < 0.5, lo, hi)
    o[sel] = corner + side * _unit(rng.normal(size=(sel.size, 3)))
    d[sel] = _unit(corner - o[sel])
    # 6: along a diagonal, corner to corner, the longest chords
    sel = np.flatnonzero(kind == 6)
    corner = np.where(rng.random((sel.size, 3)) < 0.5, lo, hi)
    far = lo + hi - corner
    o[sel] = corner - 0.25 * (far - corner)
    d[sel] = _unit(far - corner)
    # 7: from outside, away from the box
    sel = kind == 7
    o[sel], d[sel] = shell[sel], _unit(shell[sel] - centre)
    return o, d


def _bitfield(kind, seed):
    """uint8 (NERF_CASCADES * 128^3 / 8,): every cascade's cells occupied
    at random with the named share, or the render benchmark's shell."""
    if kind == "shell":
        return shell_bitfield("cpu")
    share = int(kind.split("_")[1]) / 100.0
    gen = torch.Generator().manual_seed(seed)
    return pack_bitfield(torch.rand(NERF_CASCADES * NERF_GRIDSIZE ** 3,
                                    generator=gen) < share)


def _renderer(cone, max_mip, device):
    lo, hi = _box(max_mip)
    cfg = RenderConfig(n_march=N_MARCH, max_samples_per_ray=MAX_SAMPLES,
                       cone_angle=cone, max_mip=max_mip,
                       rgb_activation="Logistic",
                       density_activation="Exponential")
    return WavefrontRenderer(None, cfg, torch.from_numpy(lo).to(device),
                             torch.from_numpy(hi).to(device), chunk=CHUNK)


def _read_columns(n_cand, n_cols):
    """(R, C) bool: the columns the rounds read, n_cand rounded up to
    whole rounds of CHUNK."""
    end = (n_cand + CHUNK - 1) // CHUNK * CHUNK
    return torch.arange(n_cols, device=n_cand.device)[None, :] < end[:, None]


def _assert_same_rows(got, want):
    ts, ok, n_cand, valid = got
    w_ts, w_ok, w_n, w_valid = want
    assert torch.equal(valid, w_valid)
    assert torch.equal(n_cand, w_n)
    read = _read_columns(w_n, w_ts.shape[1])
    assert torch.equal(ok[read], w_ok[read])
    # the same bits, zeros included
    assert torch.equal(ts[read].view(torch.int32),
                       w_ts[read].view(torch.int32))


# ======================================================================
# on the card
# ======================================================================
@pytest.mark.cuda
@pytest.mark.parametrize("bits,max_mip", [
    (bits, max_mip) for bits in BITFIELDS for max_mip in MAX_MIPS
    # the shell lies in cascade 0, which the rays through a box of 128
    # barely meet
    if (bits, max_mip) != ("shell", 7)])
@pytest.mark.parametrize("cone", CONES)
def test_kernel_rows_equal_the_plain_rows(device, cone, max_mip, bits):
    n = 4099                                  # not a multiple of the block
    lo, hi = _box(max_mip)
    o, d = _rays(n, lo, hi, seed=100 * CONES.index(cone) + 10 * max_mip
                 + BITFIELDS.index(bits))
    o, d = torch.from_numpy(o).to(device), torch.from_numpy(d).to(device)
    bitfield = _bitfield(bits, seed=max_mip).to(device)
    wr = _renderer(cone, max_mip, device)
    before = march_and_pack.launches
    got = wr._march_and_pack(o, d, bitfield)
    assert march_and_pack.launches == before + 1
    want = wr._march_and_pack_plain(o, d, bitfield)
    _assert_same_rows(got, want)
    n_cand, valid = want[2], want[3]
    # the cases are there: misses, rays that emit, and (where the box is
    # dense enough) rays at the cap
    assert not valid.all() and (n_cand > 0).any()
    if bits == "occupied_95":
        assert (n_cand == MAX_SAMPLES).any()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 127, 129, 1000])
def test_kernel_at_ragged_ray_counts(device, n):
    lo, hi = _box(0)
    o, d = _rays(n, lo, hi, seed=n)
    o, d = torch.from_numpy(o).to(device), torch.from_numpy(d).to(device)
    bitfield = _bitfield("occupied_30", seed=n).to(device)
    wr = _renderer(0.0, 0, device)
    _assert_same_rows(wr._march_and_pack(o, d, bitfield),
                      wr._march_and_pack_plain(o, d, bitfield))


def _testbed(device):
    from instant_ngp_tpu_torch.config import (find_network_config,
                                              load_network_config)
    from instant_ngp_tpu_torch.nerf.testbed_nerf import NerfTestbed

    cfg = load_network_config(find_network_config("base", "nerf"))
    tb = NerfTestbed(scene_config(1), cfg, device=device, seed=3)
    model = tb.model
    # a table of U(-1, 1), so that densities are of order 1 and rays
    # terminate on the shell
    table = np.random.default_rng(3).uniform(
        -1.0, 1.0, model.pos_encoding.params.numel()).astype(np.float32)
    tb.load_params({"pos_encoding": table,
                    "density_net": [w.detach().cpu().numpy()
                                    for w in model.density_net.weights],
                    "dir_encoding": {},
                    "rgb_net": [w.detach().cpu().numpy()
                                for w in model.rgb_net.weights]})
    tb.bitfield = _bitfield("shell", seed=0).to(device)
    return tb


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["Shade", "Depth"])
def test_frame_equals_the_plain_frame(device, mode, monkeypatch):
    tb = _testbed(device)
    cam = np.array([[1, 0, 0, 0.5], [0, 1, 0, 0.5], [0, 0, 1, -0.4]],
                   np.float32)
    kw = dict(focal_length=90.0, render_mode=mode)
    before = march_and_pack.launches
    frame = tb.render_frame(96, 80, cam, **kw)
    n_kernel = tb.last_frame_n_samples
    assert march_and_pack.launches > before
    assert n_kernel > 0
    monkeypatch.setattr(WavefrontRenderer, "_march_and_pack",
                        WavefrontRenderer._march_and_pack_plain)
    plain = tb.render_frame(96, 80, cam, **kw)
    assert tb.last_frame_n_samples == n_kernel
    np.testing.assert_array_equal(frame, plain)


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(device):
    wr = _renderer(0.0, 0, device)
    o = torch.rand(64, 3, device=device)
    d = torch.rand(64, 3, device=device)
    bitfield = _bitfield("occupied_30", seed=0).to(device)
    args = (wr.aabb_min, wr.aabb_max, 0.0, 0, N_MARCH, MAX_SAMPLES,
            MAX_SAMPLES, CHUNK)
    with pytest.raises(ValueError, match="no kernel for cpu"):
        march_and_pack(o.cpu(), d.cpu(), bitfield.cpu(), wr.aabb_min.cpu(),
                       wr.aabb_max.cpu(), *args[2:])
    with pytest.raises(ValueError, match="torch.float64"):
        march_and_pack(o.double(), d, bitfield, *args)
    with pytest.raises(ValueError, match="contiguous"):
        march_and_pack(o, torch.rand(3, 64, device=device).t(), bitfield,
                       *args)
    with pytest.raises(ValueError, match="bitfield"):
        march_and_pack(o, d, bitfield[:100], *args)
    with pytest.raises(ValueError, match="on cpu"):
        march_and_pack(o, d, bitfield.cpu(), *args)
    with pytest.raises(ValueError, match="n_cols"):
        march_and_pack(o, d, bitfield, *args[:6], 500, CHUNK)


# ======================================================================
# on the CPU
# ======================================================================
def test_wrapper_rejects_cpu_tensors():
    o = torch.rand(8, 3)
    with pytest.raises(ValueError, match="no kernel for cpu"):
        march_and_pack(o, o, torch.zeros(1 << 18, dtype=torch.uint8),
                       torch.zeros(3), torch.ones(3), 0.0, 0, N_MARCH,
                       MAX_SAMPLES, MAX_SAMPLES, CHUNK)


def _walk(ts, pos, emit, dirs, lo, hi, cap, n_cols):
    """The kernel's walk over the plane's candidates, per ray in lockstep
    over k: a ray stops at its cap of kept samples or at the first
    candidate past the box's far face on some axis in that axis' direction
    of travel; -> (packed ts, packed ok, n_cand, the candidates walked)."""
    n, m = ts.shape
    rows_t = np.zeros((n, n_cols), np.float32)
    rows_ok = np.zeros((n, n_cols), bool)
    count = np.zeros(n, np.int64)
    walking = np.ones(n, bool)
    walked = np.zeros(n, np.int64)
    for k in range(m):
        p = pos[:, k]
        past = (((dirs <= 0) & (p < lo)) | ((dirs >= 0) & (p > hi))).any(-1)
        walking &= ~past
        walked += walking
        keep = np.flatnonzero(walking & emit[:, k])
        rows_t[keep, count[keep]] = ts[keep, k]
        rows_ok[keep, count[keep]] = True
        count[keep] += 1
        walking &= count < cap
    return rows_t, rows_ok, count, walked


@pytest.mark.parametrize("cone,max_mip", [(0.0, 0), (1.0 / 256.0, 7)])
def test_the_kernels_early_exit_keeps_the_planes_rows(cone, max_mip):
    """The walk's rows against the plain version's over the columns the
    rounds read, on 4096 seeded rays of every kind (grazing ones among
    them) through a bitfield of 95 % occupancy; the exits must engage."""
    n = 4096
    lo, hi = _box(max_mip)
    o, d = _rays(n, lo, hi, seed=17 + max_mip)
    wr = _renderer(cone, max_mip, "cpu")
    bitfield = _bitfield("occupied_95", seed=5)
    o_t, d_t = torch.from_numpy(o), torch.from_numpy(d)
    want = wr._march_and_pack(o_t, d_t, bitfield)

    # the plane: every candidate's t and position, and its emission before
    # the cap, by the plain version's own functions
    from instant_ngp_tpu_torch.nerf.render import _march_start
    from instant_ngp_tpu_torch.nerf.sampler import RayBatch

    t_start, valid = _march_start(o_t, d_t, wr.aabb_min, wr.aabb_max, cone)
    ts, _, emit = march_rays(RayBatch(o_t, d_t, t_start, valid), bitfield,
                             wr.aabb_min, wr.aabb_max, cone, max_mip,
                             N_MARCH, N_MARCH)
    pos = o_t[:, None, :] + ts[..., None] * d_t[:, None, :]
    rows_t, rows_ok, count, walked = _walk(
        ts.numpy(), pos.numpy(), emit.numpy(), d, lo, hi, MAX_SAMPLES,
        wr._c_pad)
    end = (count + CHUNK - 1) // CHUNK * CHUNK
    np.testing.assert_array_equal(count, want[2].numpy())
    read = np.arange(wr._c_pad)[None, :] < end[:, None]
    np.testing.assert_array_equal(rows_ok[read], want[1].numpy()[read])
    np.testing.assert_array_equal(rows_t[read].view(np.int32),
                                  want[0].numpy()[read].view(np.int32))
    # the exits engage: rays at the cap, and rays that stop at the far
    # face well before n_march
    assert (count == MAX_SAMPLES).any()
    stopped = valid.numpy() & (count < MAX_SAMPLES)
    assert stopped.any() and (walked[stopped] < N_MARCH).mean() > 0.5
