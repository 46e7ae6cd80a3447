"""The grid kernels' table-gradient route, modelled in plain PyTorch on the
CPU, and the dispatch of `GridEncoding` between the kernels and the plain
versions.

`csrc/grid_encoding.cu` sums the table gradient without atomics. Its
deposits are laid out [group][point][level][corner]; those of a (point,
level) whose gradient is zero are left out (they add +-0); the table rows
of the rest are sorted by a stable LSD radix sort of 8-bit digits with the
int32 position as payload (each pass: a histogram per tile of the input, an
exclusive scan of the counts digit by digit over the tiles, and a scatter
ranked within the tile in input order); then one sequential float32 sum per
run of equal rows of the rounded products g * weight, a partial sum per
group (one fetched corner of the stochastic j-axis deposit) added to the
row's total in turn, the run owned by the tile of the sum that holds its
head and continued past that tile's end (the same adds in the same order,
so the model sums each run whole). `sorted_deposit` below is that
route, written with torch ops (no sort call: `radix_sort` is the model of
the passes). It is held:
- against `ordered_deposit` as the plain version calls it on the CPU
  (`index_add_`, serial in the order of the rows): the same bits for the
  exact deposit and the one-corner deposits, whose rows get one sequential
  sum either way; the j-axis deposit with every fetched corner adds the
  groups' deposits in another grouping there, so to rtol 1e-6 / atol 1e-6
  (a float32 sum of a few dozen deposits of order 1 regrouped);
- against `jax.grad` of the JAX package's encode on the same table,
  points, cotangent and corner draws: rtol 1e-5 / atol 1e-5 (the JAX
  package sums the deposits in its own order; tests/test_torch_grid_
  backward.py's tolerance);
over the exact deposit, j = 0, j = 1 with the fetched corners and with the
one sampled corner, and j = 2 (3D), in 2D and 3D, Hash / Dense / Tiled
grids, 2 and 4 features a level, with and without `max_level`; the last
eighth of the points are a train step's padding (one position, a zero
gradient). `radix_sort` is also held against `torch.sort(stable=True)` on
keys with long runs of equal values.

The kernels themselves need the card: tests/test_torch_cuda_kernels.py
holds each against its plain version there."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import jax_corner_draws

from instant_ngp_tpu.ops.grid_encoding import GridEncoding as JaxGrid
from instant_ngp_tpu_torch.ops.grid_encoding import (GridEncoding,
                                                     draw_corner_randoms)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(n_levels=4, log2_hashmap_size=9, base_resolution=4,
          per_level_scale=2.0)
N = 300
# (n_dims, j exact axes or None for the exact encode, one-corner backward)
VARIANTS = [(d, j, one) for d in (2, 3)
            for j, one in ((None, False), (0, False), (1, False), (1, True))
            ] + [(3, 2, False), (3, 2, True)]
VARIANT_IDS = [f"{d}d-" + ("exact" if j is None else f"j{j}" if j == 0
                           else f"j{j}-{'onecorner' if one else 'fetched'}")
               for d, j, one in VARIANTS]


# the kernels' radix digit and tile of a pass (csrc/grid_encoding.cu
# kRadixBits, kSortTile); the model's tile of the sum is smaller than the
# kernel's kSumTile (1024), so that at these sizes runs cross a tile's end
RADIX_BITS, SORT_TILE, SUM_TILE = 8, 4096, 16


def radix_pass(keys, perm, shift, tile=SORT_TILE):
    """One stable LSD pass by the digit (keys >> shift) & 255: the counts
    of each (digit, tile), scanned digit-major over the tiles, give each
    tile's place in a digit; an item's rank within its tile and digit is
    the count of the same digit before it in the tile."""
    n = keys.numel()
    n_tiles = -(-n // tile)
    digit = ((keys >> shift) & ((1 << RADIX_BITS) - 1)).long()
    tile_of = torch.arange(n) // tile
    counts = torch.bincount(digit * n_tiles + tile_of,
                            minlength=(1 << RADIX_BITS) * n_tiles)
    start = torch.cumsum(counts, 0) - counts            # exclusive
    seen = torch.nn.functional.one_hot(digit, 1 << RADIX_BITS).cumsum(0)
    first = tile_of * tile                               # the tile's start
    before_tile = torch.where(first > 0, seen[(first - 1).clamp(min=0),
                                               digit], 0)
    rank = seen[torch.arange(n), digit] - 1 - before_tile
    dest = start[digit * n_tiles + tile_of] + rank
    out_keys, out_perm = torch.empty_like(keys), torch.empty_like(perm)
    out_keys[dest], out_perm[dest] = keys, perm
    return out_keys, out_perm


def radix_passes(n_entries):
    """The passes of a sort of rows < n_entries: one per 8-bit digit of
    ceil(log2(n_entries)) bits (csrc/grid_encoding.cu
    grid_deposit_scratch)."""
    return -(-max(1, (n_entries - 1).bit_length()) // RADIX_BITS)


def radix_sort(keys, n_entries, tile=SORT_TILE):
    """(sorted keys, positions) of int32 keys < n_entries: one pass per
    8-bit digit of the rows' own bits, ceil(log2(n_entries)) of them."""
    perm = torch.arange(keys.numel(), dtype=torch.int32)
    for p in range(radix_passes(n_entries)):
        keys, perm = radix_pass(keys, perm, RADIX_BITS * p, tile)
    return keys, perm


def sorted_deposit(enc, x, g_out, max_level, draws=None, j=None,
                   stats=None):
    """The table gradient by the kernels' route: the deposits of the
    unmasked levels laid out [group][point][level][corner], those of a
    zero gradient left out, the rows radix-sorted with their positions,
    then per run of equal rows a sequential float32 sum of each group's
    deposits, the groups' sums added to the row in turn. `stats` (a dict)
    receives the deposits kept and the runs that cross a tile of the
    sum."""
    f = enc.n_features_per_level
    keys, values, groups, keep = [], [], [], []
    one = j is not None and (j == 0 or enc.stochastic_bwd)
    n_groups = 1 if j is None or one else 1 << j
    levels = [lvl for lvl in range(enc.n_levels)
              if not enc._masked(max_level, lvl)]
    for group in range(n_groups):
        rows_g, vals_g, keep_g = [], [], []
        for lvl in levels:
            g = g_out[:, lvl * f:(lvl + 1) * f]
            if j is None:
                rows, weight = enc._level_corners(x, lvl)         # (N, C)
                vals = g[:, None, :] * weight[..., None]
            else:
                rows, weight = enc._stochastic_corners(
                    x, lvl, draws, j, sampled_only=one)[group]
                rows = rows[:, None]
                vals = (g if weight is None else g * weight[:, None])[:, None]
            rows_g.append(rows)
            vals_g.append(vals)
            keep_g.append((g != 0).any(1)[:, None].expand(rows.shape))
        if not levels:
            continue
        # (N, levels, C): point-major, the levels of a point together
        keys.append(torch.stack(rows_g, 1).reshape(-1))
        values.append(torch.stack(vals_g, 1).reshape(-1, f))
        keep.append(torch.stack(keep_g, 1).reshape(-1))
        groups.append(torch.full((keys[-1].numel(),), group))
    grad = torch.zeros(enc.n_entries, f)
    if not keys:
        return grad.reshape(-1)
    keep = torch.cat(keep)
    keys = torch.cat(keys).to(torch.int32)[keep]
    values, groups = torch.cat(values)[keep], torch.cat(groups)[keep]
    keys, perm = radix_sort(keys, enc.n_entries)
    values, groups = values[perm.long()], groups[perm.long()]
    head = torch.ones_like(keys, dtype=torch.bool)
    head[1:] = keys[1:] != keys[:-1]
    heads = torch.nonzero(head)[:, 0]
    ends = torch.cat([heads[1:], torch.tensor([len(keys)])])
    if stats is not None:
        stats["kept"] = len(keys)
        stats["crossing"] = int((ends > (heads // SUM_TILE + 1)
                                 * SUM_TILE).sum()) if len(keys) else 0
    if not len(keys):
        return grad.reshape(-1)
    # every run at once, one rank at a time: the adds of a run are those of
    # its owner's thread, in sorted order, across the tiles it spans
    segment = torch.cumsum(head.long(), 0) - 1
    rank = torch.arange(len(keys)) - heads[segment]
    n_seg = len(heads)
    total = torch.zeros(n_seg, f)
    acc = torch.zeros(n_seg, f)
    current = torch.full((n_seg,), -1)
    for r in range(int(rank.max()) + 1):
        at = rank == r
        seg, grp = segment[at], groups[at]
        flush = (current[seg] >= 0) & (current[seg] != grp)
        total[seg[flush]] = total[seg[flush]] + acc[seg[flush]]
        acc[seg[flush]] = 0.0
        current[seg] = grp
        acc[seg] = acc[seg] + values[at]
    grad[keys[head].long()] = total + acc
    return grad.reshape(-1)


def _points_clear_of_draws(enc, draws, rng, n, n_dims, margin=1e-5):
    """Points none of whose weights lies within `margin` of its uniform,
    so that both packages pick the same corner."""
    x = rng.uniform(-0.05, 1.05, (n, n_dims)).astype(np.float32)
    u = draws.u.numpy().transpose(2, 1, 0)                    # (L, N, d)
    for _ in range(100):
        w = np.stack([(x * np.float32(s) + np.float32(0.5))
                      - np.floor(x * np.float32(s) + np.float32(0.5))
                      for s, *_ in enc.levels])
        close = (np.abs(w - u) < margin).any(axis=(0, 2))
        if not close.any():
            return x
        x[close] = rng.uniform(-0.05, 1.05, (int(close.sum()), n_dims))
    raise AssertionError("could not move the points off the draws")


def _case(n_dims, grid_type, n_features, j, one, seed=0):
    rng = np.random.default_rng(seed + 17 * n_dims + len(grid_type)
                                + n_features + 5 * (j or 0) + one)
    kw = dict(KW, n_dims=n_dims, grid_type=grid_type,
              n_features_per_level=n_features,
              stochastic_exact_axes=0 if j is None else j,
              stochastic_bwd=one)
    enc = GridEncoding(**kw)
    table = rng.uniform(-1.0, 1.0, enc.n_params).astype(np.float32)
    with torch.no_grad():
        enc.params.copy_(torch.from_numpy(table))
    key = jax.random.PRNGKey(200 + seed)
    draws = None
    if j is None:
        x = rng.uniform(-0.05, 1.05, (N, n_dims)).astype(np.float32)
    else:
        draws = jax_corner_draws(key, N, n_dims, enc.n_levels)
        x = _points_clear_of_draws(enc, draws, rng, N, n_dims)
    cot = rng.normal(size=(N, enc.n_output_dims)).astype(np.float32)
    x[-(N // 8):] = 0.3         # a train step's padding: no gradient
    cot[-(N // 8):] = 0.0
    return kw, enc, table, torch.from_numpy(x), torch.from_numpy(cot), key, \
        draws


@pytest.mark.parametrize("max_level", [None, 1])
@pytest.mark.parametrize("n_features", [2, 4])
@pytest.mark.parametrize("grid_type", ["Hash", "Dense", "Tiled"])
@pytest.mark.parametrize("n_dims,j,one", VARIANTS, ids=VARIANT_IDS)
def test_sorted_deposit_model_against_ordered_deposit(n_dims, j, one,
                                                      grid_type, n_features,
                                                      max_level):
    _, enc, _, x, cot, _, draws = _case(n_dims, grid_type, n_features, j,
                                        one)
    stats = {}
    model = sorted_deposit(enc, x, cot, max_level, draws, j, stats)
    # the padding was left out, and some runs go on past a tile's end
    n_groups = 1 if j is None or j == 0 or one else 1 << j
    per_point = n_groups * (1 << n_dims if j is None else 1)
    active = enc._active_levels(max_level)
    assert stats["kept"] == (N - N // 8) * per_point * active
    assert stats["crossing"] > 0
    if j is None:
        plain = enc._table_gradient(x, cot, max_level)
    else:
        plain = enc._table_gradient_stochastic(x, cot, max_level, draws, j)
    assert model.abs().max() > 0.1
    if j is not None and j > 0 and not one:
        np.testing.assert_allclose(model.numpy(), plain.numpy(), rtol=1e-6,
                                   atol=1e-6)
    else:
        assert torch.equal(model, plain)
    if max_level is not None:
        first_off = enc.levels[max_level + 1][3] * enc.n_features_per_level
        assert (model[first_off:] == 0).all()


# each variant once against the JAX package, over the grid types, feature
# counts and max_level in turn
JAX_CASES = [(d, j, one, ("Hash", "Dense", "Tiled")[i % 3], (2, 4)[i % 2],
              (None, 1)[i // 2 % 2])
             for i, (d, j, one) in enumerate(VARIANTS)]


@pytest.mark.parametrize("n_dims,j,one,grid_type,n_features,max_level",
                         JAX_CASES, ids=VARIANT_IDS)
def test_sorted_deposit_model_against_jax(n_dims, j, one, grid_type,
                                          n_features, max_level):
    kw, enc, table, x, cot, key, draws = _case(n_dims, grid_type,
                                               n_features, j, one)
    jax_enc = JaxGrid(**kw)
    comps = [jnp.asarray(x.numpy()[:, k]) for k in range(n_dims)]

    def jax_out(t):
        if j is None:
            return jax_enc.apply(t, jnp.asarray(x.numpy()),
                                 max_level=max_level)
        return jax_enc.apply_components(t, comps, max_level=max_level,
                                        rng=key)

    ref = np.asarray(jax.jit(jax.grad(lambda t: jnp.sum(
        jax_out(t) * jnp.asarray(cot.numpy()))))(jnp.asarray(table)))
    model = sorted_deposit(enc, x, cot, max_level, draws, j)
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(model.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n_entries", [256, 300, 2_920_448])
def test_radix_model_is_a_stable_sort(n_entries):
    """The radix passes (one for 8-bit rows, the kernel's single pass into
    one buffer; two for 9-bit rows; three for base.json's 22-bit rows)
    order keys with long runs of equal values as a stable sort does, over
    several tiles."""
    rng = np.random.default_rng(n_entries)
    keys = rng.integers(0, n_entries, 12_000)
    keys[1000:4000] = keys[0]                    # a run across a tile's end
    keys[5000:5600] = n_entries - 1
    keys[7000:] = rng.integers(0, 4, 5000)       # four long interleaved runs
    keys = torch.from_numpy(keys).to(torch.int32)
    got, perm = radix_sort(keys, n_entries)
    assert radix_passes(n_entries) == {256: 1, 300: 2, 2_920_448: 3}[
        n_entries]
    want = torch.sort(keys, stable=True)
    assert torch.equal(got, want.values)
    assert torch.equal(perm.long(), want.indices)


def test_dispatch_takes_the_plain_version_on_cpu(monkeypatch):
    """On CPU tensors the five dispatching methods, and the forward with
    both gradients through autograd, run the plain versions and never
    reach a kernel wrapper."""
    from instant_ngp_tpu_torch.ops.kernels import grid_kernels

    def no_kernel(*args, **kwargs):
        raise AssertionError("a kernel wrapper was called for CPU tensors")

    for name in ("encode_forward", "table_gradient", "input_gradient"):
        monkeypatch.setattr(grid_kernels, name, no_kernel)
    _, enc, _, x, cot, _, draws = _case(3, "Hash", 4, 1, False)
    before = GridEncoding.plain_calls_on_cuda
    p = enc.params.detach()
    assert torch.equal(enc._encode(p, x, None), enc._encode_plain(p, x, None))
    assert torch.equal(enc._encode_stochastic(p, x, 1, draws, 1),
                       enc._encode_stochastic_plain(p, x, 1, draws, 1))
    assert torch.equal(enc._table_gradient(x, cot, None),
                       enc._table_gradient_plain(x, cot, None))
    assert torch.equal(
        enc._table_gradient_stochastic(x, cot, None, draws, 1),
        enc._table_gradient_stochastic_plain(x, cot, None, draws, 1))
    assert torch.equal(enc._input_gradient(p, x, cot, 2),
                       enc._input_gradient_plain(p, x, cot, 2))
    enc.params.requires_grad_(True)
    xg = x.clone().requires_grad_(True)
    for kwargs in ({}, {"draws": draws}):
        out = enc(xg, **kwargs)
        g_table, g_x = torch.autograd.grad((out * cot).sum(),
                                           (enc.params, xg))
        assert g_table.abs().max() > 0 and torch.isfinite(g_x).all()
    assert GridEncoding.plain_calls_on_cuda == before


def test_wrappers_take_cuda_tensors_only():
    """A wrapper never computes on the CPU: the dispatch alone picks the
    plain version there."""
    from instant_ngp_tpu_torch.ops.kernels import grid_kernels

    _, enc, _, x, cot, _, draws = _case(2, "Tiled", 2, 0, False)
    desc = enc.kernel_desc
    p = enc.params.detach()
    for call in (lambda: grid_kernels.encode_forward(desc, p, x, 4),
                 lambda: grid_kernels.encode_forward(desc, p, x, 4, draws, 0),
                 lambda: grid_kernels.table_gradient(desc, x, cot, 4),
                 lambda: grid_kernels.input_gradient(desc, p, x, cot, 4)):
        with pytest.raises(ValueError, match="no kernel for cpu"):
            call()


@pytest.mark.parametrize("n_features,n_levels,ok", [
    (2, 4, True), (8, 2, True), (1, 4, False), (3, 4, False),
    (2, 33, False)])
def test_kernel_desc_mirrors_the_levels(n_features, n_levels, ok):
    """The levels the kernels get are the module's own (scale, res, size,
    offset, hashed), in the order `csrc/grid_encoding.cu::make_grid`
    reads them; a grid they cannot take raises when the kernels are asked
    for it, and still encodes on the CPU."""
    enc = GridEncoding(3, n_levels=n_levels, n_features_per_level=n_features,
                       log2_hashmap_size=12, base_resolution=8,
                       per_level_scale=1.05, grid_type="Tiled",
                       interpolation="Smoothstep")
    if not ok:
        with pytest.raises(ValueError):
            enc.kernel_desc
        assert enc(torch.rand(5, 3)).shape == (5, enc.n_output_dims)
        return
    desc = enc.kernel_desc
    assert desc.ints[:5] == (3, n_levels, n_features, 2, 1)
    assert desc.n_entries == enc.n_entries
    for lvl, (scale, res, size, offset, hashed) in enumerate(enc.levels):
        assert desc.ints[5 + 4 * lvl:9 + 4 * lvl] == (res, size, offset,
                                                      int(hashed))
        assert np.float32(desc.scales[lvl]) == np.float32(scale)


def test_grid_encoding_imports_and_encodes_without_nvcc(tmp_path):
    """With no nvcc to be found, the module imports, encodes and
    differentiates on the CPU, and never loads the kernels' builder."""
    code = (
        "import sys, torch\n"
        "from instant_ngp_tpu_torch.ops.grid_encoding import GridEncoding\n"
        "enc = GridEncoding(3, n_levels=2, n_features_per_level=2,\n"
        "                   log2_hashmap_size=8, base_resolution=4)\n"
        "enc.params.requires_grad_(True)\n"
        "enc(torch.rand(7, 3)).sum().backward()\n"
        "assert enc.params.grad.abs().max() > 0\n"
        "assert 'instant_ngp_tpu_torch.ops.kernels._build' not in "
        "sys.modules\n"
        "print('ok')\n")
    env = dict(os.environ, PATH=str(tmp_path),
               CUDA_HOME=str(tmp_path / "none"), PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_draws_on_the_generator_reach_every_variant():
    """The port's own draws (`draw_corner_randoms`) feed the model like
    the JAX draws: every variant of the deposit is finite and nonzero."""
    enc = GridEncoding(3, **KW, n_features_per_level=2)
    enc.init_params(torch.Generator().manual_seed(3))
    x = torch.rand(64, 3, generator=torch.Generator().manual_seed(4))
    cot = torch.randn(64, enc.n_output_dims,
                      generator=torch.Generator().manual_seed(5))
    for j in range(3):
        draws = draw_corner_randoms(torch.Generator().manual_seed(6 + j), 64,
                                    3, enc.n_levels, j)
        for one in (False, True):
            enc.stochastic_bwd = one
            got = sorted_deposit(enc, x, cot, None, draws, j)
            assert torch.isfinite(got).all() and got.abs().max() > 0
