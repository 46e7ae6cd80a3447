"""The layouts of the port's wgmma MLP kernel (csrc/fused_mlp_wgmma.cu: the
general and the streamed path), held on the CPU against an independent
reading of the PTX layouts.

- The packing. `pack_weights(...).packed_wgmma` must be, chunk after chunk,
  the shared-memory image that a K-major wgmma operand with the 128-byte
  swizzle is read from. `_decode_chunk` rebuilds a chunk from that rule
  alone: the operand's rows (output columns n) are 128 bytes of 64 K values
  each, grouped in atoms of 8 rows (1024 bytes); in row n the 16-byte group
  holding K values 8j .. 8j + 7 sits at group position j XOR (n mod 8).
- The data flow. `_emulate_wgmma_kernel` runs one 64-row group (one
  warpgroup) through the kernel's lanes: the A fragments of the input as
  the kernel loads them, B read from the packed chunks through the
  decoder, the sums in the m64nNk16 accumulator layout, and the kernel's
  accumulator-to-A-fragment conversion between layers. Lane (g, t) =
  (lane // 4, lane % 4) of warp w holds, of a 16-deep step of A, rows
  16w + g + 8 half at columns 2t + 8 hi + {0, 1} in register half + 2 hi;
  of the accumulator, register r, row 16w + g + 8 ((r mod 4) // 2) at
  column 8 (r // 4) + 2t + (r mod 2). Up to 128 wide the A fragments stay
  in registers; at 256 the kernel writes them into a warpgroup's 64-row A
  tile in shared memory by its `a_offset` rule (store_fragments for the
  input, store_operand between layers), and wgmma reads that tile as a
  K-major operand with the 128-byte swizzle, which the emulation decodes
  with `_decode_chunk`, the rule the weights are read by.
"""

import numpy as np
import pytest
import torch

from instant_ngp_tpu_torch.ops.kernels.mlp_kernels import (
    GENERAL, STREAMED, fused_mlp_forward, fused_mlp_forward_plain,
    kernel_variant, pack_weights, wgmma_hidden_width, wgmma_layer_shapes)

torch.set_num_threads(2)

#: the nets of the configurations that take the streamed path (the six of
#: chip_smoke.py's WIDE_NETS) and the general path's config shapes
WIDE_NETS = ([96] + [256] * 7 + [16], [40, 256, 3], [3] + [256] * 7 + [16],
             [19, 256, 3], [60] + [128] * 8 + [1], [96] + [128] * 6 + [1])
GENERAL_NETS = ([36, 64, 64, 3], [64, 64, 64, 3], [27, 48, 5])


def _weights(rng, dims):
    return [torch.from_numpy(rng.uniform(-1, 1, (i, o)).astype(np.float32))
            for i, o in zip(dims[:-1], dims[1:])]


def _hidden_width(dims):
    """NP: the least of 64, 128, 256 holding the hidden widths, the input
    rounded up to 64 and an output wider than 16."""
    k0 = -(-dims[0] // 64) * 64
    need = max([k0] + list(dims[1:-1]) + ([dims[-1]] if dims[-1] > 16 else []))
    return min(w for w in (64, 128, 256) if w >= need)


def _layer_shapes(dims):
    """(K, N) of each layer as the kernel pads it, from its own rules: every
    width to NP, but K of the first layer of a 256-wide net (to a multiple
    of 64) and N of a last layer of at most 16 outputs (to 16)."""
    k0 = -(-dims[0] // 64) * 64
    np_ = _hidden_width(dims)
    ks = [k0 if np_ == 256 else np_] + [np_] * (len(dims) - 2)
    ns = [np_] * (len(dims) - 2) + [16 if dims[-1] <= 16 else np_]
    return list(zip(ks, ns))


def _decode_chunk(image, n_rows):
    """(64, n_rows) K x N values of one chunk from its bytes (as int16)."""
    atoms = image.reshape(n_rows // 8, 8, 8, 8)   # [atom][row][group][elem]
    r8 = np.arange(8)[:, None]
    logical = atoms[:, r8, np.arange(8)[None, :] ^ r8, :]
    # [atom][row][logical group][elem] -> B[k = 8 group + elem, n = 8 atom + row]
    return logical.transpose(2, 3, 0, 1).reshape(64, n_rows)


def _decode_layers(packed, dims):
    """Every padded layer of `packed_wgmma`, chunk by chunk."""
    flat = packed.view(torch.int16).numpy()
    layers, at = [], 0
    for k, n in _layer_shapes(dims):
        chunks = []
        for _ in range(k // 64):
            chunks.append(_decode_chunk(flat[at:at + 64 * n], n))
            at += 64 * n
        layers.append(np.concatenate(chunks, 0))
    assert at == flat.size
    return layers


@pytest.mark.parametrize("dims", WIDE_NETS + GENERAL_NETS,
                         ids=lambda d: "-".join(map(str, d)))
def test_packed_chunks_decode_to_every_layer(dims):
    ws = _weights(np.random.default_rng(len(dims) + dims[0]), dims)
    packed = pack_weights(ws)
    assert wgmma_layer_shapes(dims) == tuple(_layer_shapes(dims))
    assert kernel_variant(dims) in (GENERAL, STREAMED)
    for w, got in zip(ws, _decode_layers(packed.packed_wgmma, dims)):
        want = w.to(torch.bfloat16).view(torch.int16).numpy()
        i, o = want.shape
        np.testing.assert_array_equal(got[:i, :o], want)
        pad = got.copy()
        pad[:i, :o] = 0
        assert not pad.any()


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)) \
        .to(torch.bfloat16).float().numpy()


_ACTS = {"None": lambda v: v, "ReLU": lambda v: np.maximum(v, 0),
         "Sine": np.sin, "Exponential": np.exp}
W, LANE = np.meshgrid(np.arange(4), np.arange(32), indexing="ij")
G, T = LANE // 4, LANE % 4


def _a_lanes_from_rows(rows, n_steps):
    """The kernel's load of a warpgroup's 64 rows into A fragments:
    a[w, lane, ks, half + 2 hi] = the pair at row 16w + g + 8 half, column
    16 ks + 8 hi + 2t (load_input)."""
    a = np.zeros((4, 32, n_steps, 4, 2), np.float32)
    for ks in range(n_steps):
        for half in range(2):
            for hi in range(2):
                c = 16 * ks + 8 * hi + 2 * T
                r = 16 * W + G + 8 * half
                a[:, :, ks, half + 2 * hi, 0] = rows[r, c]
                a[:, :, ks, half + 2 * hi, 1] = rows[r, c + 1]
    return a


def _rows_from_a_lanes(a):
    """The A operand a step's fragments stand for, in the PTX layout."""
    n_steps = a.shape[2]
    rows = np.full((64, 16 * n_steps), np.nan, np.float32)
    for ks in range(n_steps):
        for reg in range(4):
            half, hi = reg % 2, reg // 2
            for e in range(2):
                rows[16 * W + G + 8 * half, 16 * ks + 8 * hi + 2 * T + e] = \
                    a[:, :, ks, reg, e]
    return rows


def _acc_lanes(d):
    """The m64nN accumulator layout of a (64, N) product."""
    n_regs = d.shape[1] // 2
    r = np.arange(n_regs)
    rows = 16 * W[..., None] + G[..., None] + 8 * ((r % 4) // 2)
    cols = 8 * (r // 4) + 2 * T[..., None] + r % 2
    return d[rows, cols]


def _to_operand(acc, act):
    """The kernel's conversion (to_operand): of 8-column tiles 2ks and
    2ks + 1, registers 4 (2ks + hi) + 2 half and + 1 are the pair of A
    register half + 2 hi of step ks."""
    n_steps = acc.shape[2] // 8
    a = np.zeros((4, 32, n_steps, 4, 2), np.float32)
    for ks in range(n_steps):
        for hi in range(2):
            for half in range(2):
                r = 4 * (2 * ks + hi) + 2 * half
                a[:, :, ks, half + 2 * hi] = acc[:, :, r:r + 2]
    return _bf16(_ACTS[act](a))


def _a_offset(m, col_tile):
    """The kernel's a_offset: byte offset of columns 8 col_tile .. + 7 of
    row m in a warpgroup's A tile."""
    return ((col_tile // 8) * 8192 + (m // 8) * 1024 + (m % 8) * 128
            + ((col_tile % 8) ^ (m % 8)) * 16)


def _store_fragments(tile, a):
    """store_fragments: register half + 2 hi of step ks (the pair at row
    16w + g + 8 half, columns 16 ks + 8 hi + 2t) into the A tile, a bf16
    value per element of `tile`."""
    for ks in range(a.shape[2]):
        for reg in range(4):
            at = (_a_offset(16 * W + G + 8 * (reg % 2), 2 * ks + reg // 2)
                  // 2 + 2 * T)
            tile[at], tile[at + 1] = a[:, :, ks, reg, 0], a[:, :, ks, reg, 1]


def _store_operand(tile, acc, act):
    """store_operand: accumulator registers 4c, 4c + 1 (row 16w + g) and
    4c + 2, 4c + 3 (row + 8) of 8-column tile c, activated and rounded,
    into the A tile."""
    v = _bf16(_ACTS[act](acc))
    for c in range(acc.shape[2] // 4):
        for half in range(2):
            at = _a_offset(16 * W + G + 8 * half, c) // 2 + 2 * T
            tile[at] = v[:, :, 4 * c + 2 * half]
            tile[at + 1] = v[:, :, 4 * c + 2 * half + 1]


def _a_tile_rows(tile, k):
    """The (64, k) A operand that wgmma reads from the tile: 64-deep
    chunks of 8 KB, each decoded by the weights' swizzle rule with the
    tile's 64 rows in the place of a chunk's output columns."""
    return np.concatenate([_decode_chunk(tile[4096 * kb:4096 * (kb + 1)], 64).T
                           for kb in range(k // 64)], 1)


def _emulate_wgmma_kernel(x, packed, dims, act, out_act):
    """One warpgroup's 64 rows through the kernel's data flow: the A
    fragments in registers up to 128 wide, in the shared A tile at 256."""
    shapes = _layer_shapes(dims)
    in_tile = _hidden_width(dims) == 256
    rows = np.zeros((64, shapes[0][0]), np.float32)
    rows[:x.shape[0], :dims[0]] = x
    a = _a_lanes_from_rows(_bf16(rows), shapes[0][0] // 16)
    if in_tile:
        # 64 rows x 256 bf16; never written elements stay NaN and would
        # spoil every product that reads them
        tile = np.full(64 * 256, np.nan, np.float32)
        _store_fragments(tile, a)
        np.testing.assert_array_equal(_a_tile_rows(tile, shapes[0][0]),
                                      _bf16(rows))
    flat = packed.float().numpy()
    at = 0
    for li, (k, n) in enumerate(shapes):
        d = np.zeros((64, n), np.float32)
        a_tile = _a_tile_rows(tile, k) if in_tile else None
        for kb in range(k // 64):
            chunk = flat[at:at + 64 * n]
            # the same byte image, read as bf16 values instead of bits
            b = _decode_chunk(chunk, n)
            at += 64 * n
            for ks in range(4):
                step = 4 * kb + ks
                a_rows = (a_tile[:, 16 * step:16 * step + 16] if in_tile else
                          _rows_from_a_lanes(a[:, :, step:step + 1]))
                d += a_rows @ b[16 * ks:16 * ks + 16]
        acc = _acc_lanes(d)
        if li + 1 < len(shapes):
            # the conversion is the identity on the operand it stands for
            if in_tile:
                _store_operand(tile, acc, act)
                np.testing.assert_array_equal(_a_tile_rows(tile, 256),
                                              _bf16(_ACTS[act](d)))
            else:
                a = _to_operand(acc, act)
                np.testing.assert_array_equal(
                    _rows_from_a_lanes(a), _bf16(_ACTS[act](d)))
    assert at == flat.size
    out = np.zeros_like(d)
    r = np.arange(acc.shape[2])
    out[16 * W[..., None] + G[..., None] + 8 * ((r % 4) // 2),
        8 * (r // 4) + 2 * T[..., None] + r % 2] = acc
    return _ACTS[out_act](out)[:x.shape[0], :dims[-1]]


@pytest.mark.parametrize("dims,act,out_act", [
    ([96, 256, 256, 16], "ReLU", "None"),      # frequency.json density, cut
    ([40, 256, 3], "ReLU", "None"),            # frequency.json RGB
    ([60, 128, 128, 128, 1], "ReLU", "None"),  # sdf/frequency.json, cut
    ([96, 256, 256, 16], "Sine", "Exponential"),
    ([36, 64, 64, 3], "ReLU", "None"),         # the general path's nets
    ([64, 64, 64, 3], "ReLU", "None"),
    ([27, 48, 5], "None", "None"),
], ids=lambda v: "-".join(map(str, v)) if isinstance(v, list) else v)
def test_emulated_wgmma_lanes_match_plain(dims, act, out_act):
    rng = np.random.default_rng(sum(dims))
    ws = [torch.from_numpy(rng.uniform(-np.sqrt(6 / i), np.sqrt(6 / i),
                                       (i, o)).astype(np.float32))
          for i, o in zip(dims[:-1], dims[1:])]
    x = rng.normal(size=(57, dims[0])).astype(np.float32)
    packed = pack_weights(ws)
    ours = _emulate_wgmma_kernel(x, packed.packed_wgmma, dims, act, out_act)
    ref = fused_mlp_forward_plain(torch.from_numpy(x), packed.layers, act,
                                  out_act).numpy()
    # the same bf16 operands summed in another order (16 deep at a time
    # here): a hidden value within a float32 ulp of a bf16 rounding
    # boundary may round the other way (see tests/test_torch_mlp_kernels.py);
    # 256-wide layers have more such values, so >= 95 % of the outputs, not
    # 99 %, are equal to 1e-5
    np.testing.assert_allclose(ours, ref, rtol=1e-2, atol=2e-3)
    assert np.isclose(ours, ref, rtol=1e-5, atol=1e-6).mean() >= 0.95


@pytest.mark.parametrize("width", [256, 128, 64])
def test_emulated_wgmma_lanes_route_a_permutation_exactly(width):
    """One-hot weights: every output is one bf16-rounded input, so a swapped
    lane, row, column or swizzle group is an exact mismatch."""
    rng = np.random.default_rng(width)
    d_in = width // 2 + 3
    p0 = rng.permutation(width)[:d_in]
    w0 = np.zeros((d_in, width), np.float32)
    w0[np.arange(d_in), p0] = 1.0
    p1 = rng.permutation(width)
    w1 = np.zeros((width, width), np.float32)
    w1[np.arange(width), p1] = 1.0
    keep = rng.permutation(d_in)[:16]
    w2 = np.zeros((width, 16), np.float32)
    w2[p1[p0[keep]], np.arange(16)] = 1.0
    dims = [d_in, width, width, 16]
    assert wgmma_hidden_width(dims) == width
    x = np.abs(rng.normal(size=(64, d_in))).astype(np.float32)
    packed = pack_weights([torch.from_numpy(w) for w in (w0, w1, w2)])
    ours = _emulate_wgmma_kernel(x, packed.packed_wgmma, dims, "ReLU", "None")
    np.testing.assert_array_equal(ours, _bf16(x)[:, keep])


@pytest.mark.parametrize("dims,variant", [([36, 64, 64, 3], None),
                                          ([32, 64, 16], GENERAL),
                                          ([96, 256, 256, 16], STREAMED)])
def test_the_wgmma_kernel_sizes_its_own_rings(dims, variant):
    """`stages` is the mma kernel's input ring; the wgmma kernel's plan
    alone places the weights and the input, on every device."""
    packed = pack_weights(_weights(np.random.default_rng(0), dims))
    x = torch.zeros(2, dims[0])
    with pytest.raises(ValueError, match="sizes its rings"):
        fused_mlp_forward(x, packed, variant=variant, stages=2)
    assert torch.equal(fused_mlp_forward(x, packed, variant=variant),
                       fused_mlp_forward_plain(x, packed.layers))
