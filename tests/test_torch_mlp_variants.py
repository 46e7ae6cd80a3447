"""What surrounds the port's fused-MLP CUDA kernels and runs on the CPU:
the packing of the weights, the choice of the kernel variant, and the
testbed's default device.

The packing is held to the layout of `mma.sync.m16n8k16` written out here
with plain loops, independently of `pack_weights`' index arithmetic: lane
(g, t) = (lane // 4, lane % 4) holds, of a 16 x 8 B tile, column g and rows
2t + 8 reg + half; of a 16 x 16 A tile, rows g and g + 8 and columns
2t + 8 hi + half; of a 16 x 8 accumulator tile, rows g and g + 8 and
columns 2t + j. An emulation of the kernel's lanes on these layouts must
reproduce the plain version exactly up to float32 summation order."""

import glob
import importlib.util
import os

import numpy as np
import pytest
import torch

from instant_ngp_tpu_torch.config import load_network_config
from instant_ngp_tpu_torch.nerf.dataset import scene_config
from instant_ngp_tpu_torch.nerf.model import NerfNetwork
from instant_ngp_tpu_torch.nerf.testbed_nerf import NerfTestbed
from instant_ngp_tpu_torch.ops.kernels.mlp_kernels import (
    GENERAL, MMA_VARIANTS, SMEM_LIMIT, fused_mlp_forward,
    fused_mlp_forward_plain, kernel_variant, mma_layer_shapes, mma_shape,
    mma_smem_bytes, pack_weights)

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _card_cases():
    spec = importlib.util.spec_from_file_location(
        "_card_kernel_tests",
        os.path.join(REPO, "tests", "test_torch_cuda_kernels.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.CASES


CARD_CASES = _card_cases()


def _weights(rng, dims):
    return [torch.from_numpy(rng.uniform(-1, 1, (i, o)).astype(np.float32))
            for i, o in zip(dims[:-1], dims[1:])]


def _pad16(n):
    return (n + 15) // 16 * 16


def _unpack_general(packed, dims):
    """Padded (pad16(in), pad16(out)) layers of the general packing and
    the skew columns that must be zero."""
    layers, skews, at = [], [], 0
    for i, o in zip(dims[:-1], dims[1:]):
        rows, ld = _pad16(i), _pad16(o) + 8
        block = packed[at:at + rows * ld].reshape(rows, ld)
        layers.append(block[:, :ld - 8])
        skews.append(block[:, ld - 8:])
        at += rows * ld
    assert at == packed.numel()
    return layers, skews


def _unpack_mma(packed, dims):
    """Padded layers of the fragment-order packing, element by element."""
    layers, at = [], 0
    packed = packed.view(torch.int16).numpy()
    for li, (k_p, n_p) in enumerate(mma_layer_shapes(dims)):
        n_tiles = n_p // 8
        group = 2 if n_tiles % 2 == 0 else 1
        w = np.full((k_p, n_p), -1, np.int16)
        seen = np.zeros((k_p, n_p), bool)
        for step in range(k_p // 16):
            for ng in range(n_tiles // group):
                for lane in range(32):
                    g, t = lane // 4, lane % 4
                    for j in range(group):
                        for reg in range(2):
                            for half in range(2):
                                slot = 2 * t + 8 * reg + half
                                if li == 0:
                                    # the kernel reads input columns
                                    # 4t .. 4t + 3 of a step as the k slots
                                    # (2t, 2t + 1, 2t + 8, 2t + 9)
                                    row = 16 * step + 4 * t + 2 * reg + half
                                else:
                                    row = 16 * step + slot
                                col = 8 * (ng * group + j) + g
                                assert not seen[row, col]
                                seen[row, col] = True
                                w[row, col] = packed[at]
                                at += 1
        assert seen.all()
        layers.append(torch.from_numpy(w).view(torch.bfloat16))
    assert at == packed.size
    return layers


@pytest.mark.parametrize("case", range(len(CARD_CASES)))
def test_packing_unpacks_bit_for_bit(case):
    dims, _, _ = CARD_CASES[case]
    ws = _weights(np.random.default_rng(case), dims)
    packed = pack_weights(ws)
    general, skews = _unpack_general(packed.packed_general, dims)
    for s in skews:
        assert not s.view(torch.int16).any()
    layouts = [general]
    if mma_shape(dims) is None:
        assert packed.packed is packed.packed_general
    else:
        assert packed.packed.numel() % 8 == 0
        layouts.append(_unpack_mma(packed.packed, dims))
    for layers in layouts:
        for w, got in zip(ws, layers):
            want = w.to(torch.bfloat16)
            i, o = want.shape
            assert torch.equal(got[:i, :o].view(torch.int16),
                               want.view(torch.int16))
            padding = got.clone()
            padding[:i, :o] = 0
            assert not padding.view(torch.int16).any()


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _emulate_mma_kernel(x, packed, dims, act, out_act):
    """One 16-row group through the mma kernel's data flow, lane by lane:
    A operands from the rows as the kernel's loader permutes them, B
    fragments from the packed buffer, accumulators turned into the next
    layer's A operand in place."""
    acts = {"None": lambda v: v, "ReLU": lambda v: np.maximum(v, 0),
            "Sine": np.sin, "Exponential": np.exp}
    buf = packed.float().numpy()
    shapes = mma_layer_shapes(dims)
    in_p = shapes[0][0]
    rows = np.zeros((16, in_p), np.float32)
    rows[:x.shape[0], :dims[0]] = x
    rows = _bf16(rows)
    # a[step][lane][register]: register = half + 2 * hi, a pair of values
    a = np.zeros((in_p // 16, 32, 4, 2), np.float32)
    for step in range(in_p // 16):
        for lane in range(32):
            g, t = lane // 4, lane % 4
            for half in range(2):
                four = rows[g + 8 * half, 16 * step + 4 * t:][:4]
                a[step, lane, half] = four[:2]
                a[step, lane, half + 2] = four[2:]
    at = 0
    for li, (k_p, n_p) in enumerate(shapes):
        n_tiles = n_p // 8
        group = 2 if n_tiles % 2 == 0 else 1
        acc = np.zeros((n_tiles, 32, 4), np.float32)
        for step in range(k_p // 16):
            for ng in range(n_tiles // group):
                frag = buf[at:at + 32 * group * 4].reshape(32, group, 2, 2)
                at += 32 * group * 4
                for j in range(group):
                    tile = ng * group + j
                    # the 16 x 16 A tile and 16 x 8 B tile of the PTX layout
                    a_tile = np.zeros((16, 16), np.float32)
                    b_tile = np.zeros((16, 8), np.float32)
                    for lane in range(32):
                        g, t = lane // 4, lane % 4
                        for reg in range(4):
                            half, hi = reg % 2, reg // 2
                            a_tile[g + 8 * half, 2 * t + 8 * hi:][:2] = \
                                a[step, lane, reg]
                        for reg in range(2):
                            b_tile[2 * t + 8 * reg:, g][:2] = \
                                frag[lane, j, reg]
                    c_tile = a_tile @ b_tile
                    for lane in range(32):
                        g, t = lane // 4, lane % 4
                        acc[tile, lane] += [c_tile[g, 2 * t],
                                            c_tile[g, 2 * t + 1],
                                            c_tile[g + 8, 2 * t],
                                            c_tile[g + 8, 2 * t + 1]]
        if li + 1 < len(shapes):
            h = _bf16(acts[act](acc).astype(np.float32))
            a = np.zeros((n_tiles // 2, 32, 4, 2), np.float32)
            for step in range(n_tiles // 2):
                for hi in range(2):
                    for half in range(2):
                        a[step, :, half + 2 * hi] = \
                            h[2 * step + hi, :, 2 * half:2 * half + 2]
    assert at == buf.size
    out = np.zeros((16, shapes[-1][1]), np.float32)
    for tile in range(acc.shape[0]):
        for lane in range(32):
            g, t = lane // 4, lane % 4
            out[g, 8 * tile + 2 * t:][:2] = acc[tile, lane, :2]
            out[g + 8, 8 * tile + 2 * t:][:2] = acc[tile, lane, 2:]
    return acts[out_act](out)[:x.shape[0], :dims[-1]]


@pytest.mark.parametrize("dims,act,out_act", [
    ([32, 64, 16], "ReLU", "None"),
    ([32, 64, 64, 3], "ReLU", "None"),
    ([27, 64, 64, 64, 5], "ReLU", "ReLU"),
    ([16, 64, 16], "ReLU", "None"),
    ([32, 3], "ReLU", "None"),
    ([32, 128, 128, 16], "ReLU", "None"),
])
def test_emulated_mma_lanes_match_plain(dims, act, out_act):
    rng = np.random.default_rng(sum(dims))
    ws = _weights(rng, dims)
    x = rng.normal(size=(13, dims[0])).astype(np.float32)
    packed = pack_weights(ws)
    assert kernel_variant(dims, act, out_act) != GENERAL
    ours = _emulate_mma_kernel(x, packed.packed, dims, act, out_act)
    ref = fused_mlp_forward_plain(torch.from_numpy(x), packed.layers, act,
                                  out_act).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-2, atol=2e-3)
    assert np.isclose(ours, ref, rtol=1e-5, atol=1e-6).mean() >= 0.99


def test_emulated_mma_lanes_route_a_permutation_exactly():
    """With one-hot weights every output is one input, so a swapped lane,
    row or column shows as an exact mismatch, not as noise."""
    rng = np.random.default_rng(3)
    p0 = rng.permutation(64)[:32]
    w0 = torch.zeros(32, 64)
    w0[torch.arange(32), torch.from_numpy(p0)] = 1.0
    w1 = torch.zeros(64, 16)
    keep = rng.permutation(32)[:16]
    w1[torch.from_numpy(p0[keep]), torch.arange(16)] = 1.0
    x = np.abs(rng.normal(size=(16, 32))).astype(np.float32)
    packed = pack_weights([w0, w1])
    ours = _emulate_mma_kernel(x, packed.packed, [32, 64, 16], "ReLU",
                               "None")
    np.testing.assert_array_equal(ours, _bf16(x)[:, keep])


def _config_nets(path):
    cfg = load_network_config(path)
    if "log2_hashmap_size" in cfg["encoding"]:
        cfg["encoding"]["log2_hashmap_size"] = 10
    model = NerfNetwork(
        3, 3, 0, cfg["encoding"],
        cfg.get("dir_encoding", {"otype": "SphericalHarmonics", "degree": 4}),
        cfg["network"], cfg.get("rgb_network", cfg["network"]))
    return [([net.layer_dims[0][0]] + [o for _, o in net.layer_dims],
             net.activation, net.output_activation)
            for net in (model.density_net, model.rgb_net)]


NERF_CONFIGS = sorted(os.path.basename(p) for p in
                      glob.glob(os.path.join(REPO, "configs/nerf/*.json")))


@pytest.mark.parametrize("name", NERF_CONFIGS)
def test_every_nerf_config_net_that_fits_has_an_instantiation(name):
    try:
        nets = _config_nets(os.path.join(REPO, "configs", "nerf", name))
    except (NotImplementedError, ValueError) as e:
        # an encoding the port does not have yet; its nets are 256 wide
        assert name in ("frequency.json", "tensor.json"), e
        return
    for dims, act, out_act in nets:
        if max(dims) > 128:
            packed = pack_weights(_weights(np.random.default_rng(0), dims))
            with pytest.raises(ValueError, match="fused_mlp_forward"):
                fused_mlp_forward(torch.zeros(2, dims[0]), packed, act,
                                  out_act)
            continue
        variant = kernel_variant(dims, act, out_act)
        assert variant.startswith("mma_"), (dims, variant)
        shape = mma_shape(dims)
        assert (*shape, act, out_act) in MMA_VARIANTS
        assert mma_smem_bytes(dims, 3) <= SMEM_LIMIT


@pytest.mark.parametrize("dims,act,out_act,variant", [
    ([32, 64, 16], "ReLU", "None", "mma_32x64x16_ReLU_None"),
    ([32, 64, 64, 3], "ReLU", "None", "mma_32x64x8_ReLU_None"),
    ([32, 64, 64, 1], "ReLU", "None", "mma_32x64x8_ReLU_None"),
    ([27, 64, 4], "ReLU", "ReLU", "mma_32x64x8_ReLU_ReLU"),
    ([32, 128, 128, 128, 16], "ReLU", "None", "mma_32x128x16_ReLU_None"),
    ([16, 64, 16], "ReLU", "None", "mma_16x64x16_ReLU_None"),
    ([32, 3], "ReLU", "None", "mma_32x64x8_ReLU_None"),
    # no instantiation: activations, widths, chains that are not uniform
    ([32, 64, 64, 16], "Sine", "None", GENERAL),
    ([32, 64, 3], "ReLU", "Exponential", GENERAL),
    ([27, 48, 5], "None", "None", GENERAL),
    ([8, 32, 4], "ReLU", "ReLU", GENERAL),
    ([16, 1], "None", "ReLU", GENERAL),
    ([32, 64, 128, 16], "ReLU", "None", GENERAL),
    ([48, 64, 16], "ReLU", "None", GENERAL),
    ([32, 64, 32], "ReLU", "None", GENERAL),
    ([32] + [64] * 8 + [16], "ReLU", "None", "mma_32x64x16_ReLU_None"),
])
def test_variant_is_a_function_of_shape_and_activations(dims, act, out_act,
                                                        variant):
    assert kernel_variant(dims, act, out_act) == variant
    # on a CPU tensor every variant is the plain version
    ws = _weights(np.random.default_rng(1), dims)
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(5, dims[0])).astype(np.float32))
    packed = pack_weights(ws)
    want = fused_mlp_forward_plain(x, packed.layers, act, out_act)
    assert torch.equal(fused_mlp_forward(x, packed, act, out_act), want)
    assert torch.equal(fused_mlp_forward(x, packed, act, out_act,
                                         variant=GENERAL), want)


def test_wide_nets_raise_the_shared_memory_error():
    ws = _weights(np.random.default_rng(0), [48] + [128] * 7 + [16])
    with pytest.raises(ValueError, match="shared memory"):
        fused_mlp_forward(torch.zeros(2, 48), pack_weights(ws))
    ws = _weights(np.random.default_rng(0), [32, 256, 256, 16])
    with pytest.raises(ValueError, match="exceed 128"):
        fused_mlp_forward(torch.zeros(2, 32), pack_weights(ws))
    ws = _weights(np.random.default_rng(0), [32, 64, 16])
    with pytest.raises(ValueError, match="variant"):
        fused_mlp_forward(torch.zeros(2, 32), pack_weights(ws),
                          variant="mma_32x64x8_ReLU_None")


def test_launch_counters_stay_zero_on_the_cpu():
    before = (fused_mlp_forward.launches,
              dict(fused_mlp_forward.launches_by_variant))
    ws = _weights(np.random.default_rng(0), [32, 64, 16])
    fused_mlp_forward(torch.zeros(2, 32), pack_weights(ws))
    assert before == (fused_mlp_forward.launches,
                      fused_mlp_forward.launches_by_variant)


def _small_cfg():
    cfg = load_network_config(os.path.join(REPO, "configs/nerf/base.json"))
    cfg["encoding"]["log2_hashmap_size"] = 10
    return cfg


def test_testbed_without_a_device_asks_for_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default does not raise")
    with pytest.raises(RuntimeError, match="CUDA device was asked for"):
        NerfTestbed(scene_config(1), _small_cfg())


def test_testbed_on_the_cpu_when_asked():
    tb = NerfTestbed(scene_config(1), _small_cfg(), device="cpu", seed=0)
    assert tb.device.type == "cpu"
    assert tb.density_grid.device.type == "cpu"
    tb.set_density_grid(np.full(128 ** 3, 0.02, np.float32))
    cam = np.array([[1, 0, 0, 0.5], [0, 1, 0, 0.5], [0, 0, 1, -1.0]],
                   np.float32)
    frame = tb.render_frame(4, 4, cam, focal_length=4.0)
    assert frame.shape == (4, 4, 4) and np.isfinite(frame).all()
    assert frame[..., 3].max() > 0
