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
    GENERAL, MMA_VARIANTS, SMEM_LIMIT, STREAMED, fused_mlp_forward,
    fused_mlp_forward_plain, general_smem_bytes, kernel_variant,
    mma_layer_shapes, mma_shape, mma_smem_bytes, pack_weights,
    wgmma_hidden_width)

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _sibling(name):
    spec = importlib.util.spec_from_file_location(
        f"_{name}", os.path.join(REPO, "tests", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CARD_CASES = _sibling("test_torch_cuda_kernels").CASES
# the decoder of the wgmma kernel's swizzled weight chunks
_decode_wgmma_layers = _sibling("test_torch_mlp_wgmma")._decode_layers


def _weights(rng, dims):
    return [torch.from_numpy(rng.uniform(-1, 1, (i, o)).astype(np.float32))
            for i, o in zip(dims[:-1], dims[1:])]


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
    # the wgmma kernel's chunks (general and streamed path), decoded from
    # the 128-byte swizzle rule by tests/test_torch_mlp_wgmma.py
    layouts = [[torch.from_numpy(w).view(torch.bfloat16) for w in
                _decode_wgmma_layers(packed.packed_wgmma, dims)]]
    if mma_shape(dims) is None:
        assert packed.packed is packed.packed_wgmma
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
    """Every net of configs/nerf/ has a kernel on the card: an mma
    instantiation where its weights fit, else (the 256-wide nets of
    frequency.json and none.json) the streamed kernel. tensor.json fails
    to build in the JAX package as well (its Composite direction encoding
    hands spherical harmonics more than 3 dims)."""
    try:
        nets = _config_nets(os.path.join(REPO, "configs", "nerf", name))
    except (NotImplementedError, ValueError) as e:
        assert name == "tensor.json", e
        return
    for dims, act, out_act in nets:
        variant = kernel_variant(dims, act, out_act)
        if max(dims) > 128:
            assert name in ("frequency.json", "none.json"), dims
            assert variant == STREAMED, (dims, variant)
            # the wgmma kernel takes every chain up to 256 wide
            assert wgmma_hidden_width(dims) == 256
            x = torch.from_numpy(np.random.default_rng(0).normal(
                size=(3, dims[0])).astype(np.float32))
            packed = pack_weights(_weights(np.random.default_rng(0), dims))
            assert torch.equal(
                fused_mlp_forward(x, packed, act, out_act),
                fused_mlp_forward_plain(x, packed.layers, act, out_act))
            continue
        assert variant.startswith("mma_"), (dims, variant)
        shape = mma_shape(dims)
        assert (*shape, act, out_act) in MMA_VARIANTS
        assert mma_smem_bytes(dims, 3) <= SMEM_LIMIT


SDF_CONFIGS = sorted(os.path.basename(p) for p in
                     glob.glob(os.path.join(REPO, "configs/sdf/*.json")))


@pytest.mark.parametrize("name", SDF_CONFIGS)
def test_every_sdf_config_net_has_a_kernel(name):
    """configs/sdf/: the 64-wide nets on the 32x64x8 instantiation (the
    Takikawa net's 24 features too), the 128-wide 6- and 8-layer nets of
    oneblob.json and frequency.json on the streamed kernel."""
    from instant_ngp_tpu_torch.ops.factory import create_network_with_encoding

    cfg = load_network_config(os.path.join(REPO, "configs", "sdf", name))
    if cfg["encoding"].get("otype") == "Takikawa":
        net_cfg, d_in = cfg["network"], 24
    else:
        if "log2_hashmap_size" in cfg["encoding"]:
            cfg["encoding"]["log2_hashmap_size"] = 10
        model, _ = create_network_with_encoding(3, 1, cfg)
        net_cfg, d_in = cfg["network"], model.network.n_input_dims
    width, hidden = net_cfg["n_neurons"], net_cfg["n_hidden_layers"]
    dims = [d_in] + [width] * hidden + [1]
    variant = kernel_variant(dims, net_cfg["activation"],
                             net_cfg["output_activation"])
    if name in ("frequency.json", "oneblob.json"):
        assert width == 128 and hidden in (6, 8)
        assert general_smem_bytes(dims) > SMEM_LIMIT
        assert variant == STREAMED
        assert wgmma_hidden_width(dims) == 128
    else:
        assert variant == "mma_32x64x8_ReLU_None", (dims, variant)


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
    # weights that do not fit in shared memory at once: the streamed path
    ([96] + [256] * 7 + [16], "ReLU", "None", STREAMED),
    ([40, 256, 3], "ReLU", "None", STREAMED),
    ([60] + [128] * 8 + [1], "ReLU", "None", STREAMED),
    ([32] + [128] * 9 + [16], "ReLU", "None", STREAMED),
    ([16] + [32] * 10 + [4], "ReLU", "None", STREAMED),
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
                                         variant=STREAMED), want)
    if variant != STREAMED:
        assert torch.equal(fused_mlp_forward(x, packed, act, out_act,
                                             variant=GENERAL), want)


def test_wide_nets_raise_the_shared_memory_error():
    """Only what no kernel takes raises: the general kernel forced onto
    weights that overflow its shared memory, a width above the streamed
    kernel's 256, more than 32 layers."""
    ws = _weights(np.random.default_rng(0), [48] + [128] * 7 + [16])
    assert kernel_variant([48] + [128] * 7 + [16]) == STREAMED
    with pytest.raises(ValueError, match="shared memory"):
        fused_mlp_forward(torch.zeros(2, 48), pack_weights(ws),
                          variant=GENERAL)
    ws = _weights(np.random.default_rng(0), [32, 300, 16])
    with pytest.raises(ValueError, match="exceed 256"):
        fused_mlp_forward(torch.zeros(2, 32), pack_weights(ws))
    ws = _weights(np.random.default_rng(0), [8] + [16] * 33 + [4])
    with pytest.raises(ValueError, match="supported 1-32"):
        fused_mlp_forward(torch.zeros(2, 8), pack_weights(ws))
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


@pytest.mark.parametrize("name", ["frequency.json", "none.json"])
def test_wide_nerf_configs_match_jax_and_train(name, tmp_path):
    """configs/nerf/frequency.json and none.json: a position encoding with
    no table and 256-wide nets. The port's network matches the JAX one on
    the same weights (bf16 compute: 2e-3 / 1e-2, as the kernel tests), and
    a NerfTestbed of the config trains, renders and round-trips a snapshot
    on the CPU."""
    import jax
    import jax.numpy as jnp

    from instant_ngp_tpu.nerf.model import NerfNetwork as JaxNerfNetwork
    from instant_ngp_tpu_torch.convert import params_from_jax
    from instant_ngp_tpu_torch.data.nerf_loader import (FrameMetadata, Lens,
                                                        NerfDataset)
    from instant_ngp_tpu_torch.data.snapshot import load_snapshot

    cfg = load_network_config(os.path.join(REPO, "configs", "nerf", name))
    args = (3, 3, 0, cfg["encoding"], cfg.get(
        "dir_encoding", {"otype": "SphericalHarmonics", "degree": 4}),
        cfg["network"], cfg.get("rgb_network", cfg["network"]))
    jax_net = JaxNerfNetwork(*args)
    params = jax.tree_util.tree_map(np.asarray,
                                    jax_net.init(jax.random.PRNGKey(0)))
    net = NerfNetwork(*args)
    net.load_params(params_from_jax(params))
    assert net.param_tree()["pos_encoding"] is None
    rng = np.random.default_rng(1)
    pos = rng.uniform(0, 1, (64, 3)).astype(np.float32)
    dirs = rng.uniform(0, 1, (64, 3)).astype(np.float32)
    ref = np.asarray(jax_net.apply(params, jnp.asarray(pos),
                                   jnp.asarray(dirs)))
    with torch.no_grad():
        ours = net.apply_components(torch.from_numpy(pos),
                                    torch.from_numpy(dirs)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-2, atol=2e-3)

    cam = np.array([[1, 0, 0, 0.5], [0, 1, 0, 0.5], [0, 0, 1, -0.6]],
                   np.float32)
    img = np.full((8, 8, 4), 200, np.uint8)
    meta = FrameMetadata((8, 8), np.array([8.0, 8.0], np.float32),
                         np.array([0.5, 0.5], np.float32),
                         np.zeros(4, np.float32), Lens())
    ds = NerfDataset(paths=["a"], images=[img], depths=[None], rays=[None],
                     metadata=[meta], xforms_start=cam[None],
                     xforms_end=cam[None])
    tb = NerfTestbed(ds, cfg, device="cpu", seed=0)
    tb.target_batch_size = 1 << 10
    tb.rays_per_batch = 32
    # a few cells a density update, over a grid marked occupied
    tb.density_samples_override = 1 << 10
    tb.set_density_grid(np.full(128 ** 3, 0.02, np.float32))
    assert np.isfinite(tb.train(2)) and tb.training_step == 2
    frame = tb.render_frame(4, 4, cam, focal_length=4.0)
    assert np.isfinite(frame).all()
    path = str(tmp_path / "wide.ingp")
    tb.save_snapshot(path)
    snap = load_snapshot(path)
    assert snap["params"]["pos_encoding"] is None
    other = NerfTestbed(ds, cfg, device="cpu", seed=1)
    other.load_snapshot_state(snap)
    np.testing.assert_array_equal(
        other.render_frame(4, 4, cam, focal_length=4.0), frame)
