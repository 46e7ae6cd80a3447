"""The port's CUDA kernels against their plain PyTorch versions on the card.

Needs an NVIDIA GPU with nvcc (the kernels are built on first use); every
test here is marked `cuda` and skips without a card. The file imports no
JAX, so it runs on a machine without it:

    python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py

Tolerance: the kernel and the plain version round the same bf16 operands
and sum exact products in float32 in another order, so a hidden value near
a bf16 rounding boundary can round the other way: max abs error <= 2e-2
and mean abs error <= 1e-3 on outputs of order 1."""

import numpy as np
import pytest
import torch

from instant_ngp_tpu_torch.ops.kernels.mlp_kernels import (
    _ACTIVATION_IDS, GENERAL, MMA_VARIANTS, STREAMED, fused_mlp_forward,
    fused_mlp_forward_plain, kernel_variant, pack_weights, wgmma_plan)
from instant_ngp_tpu_torch.ops.mlp import MLP

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _weights(rng, dims, device):
    return [torch.from_numpy(rng.uniform(
        -np.sqrt(6.0 / (i + o)), np.sqrt(6.0 / (i + o)), (i, o))
        .astype(np.float32)).to(device) for i, o in zip(dims[:-1], dims[1:])]


CASES = [
    # (dims, hidden activation, output activation)
    ([32, 64, 16], "ReLU", "None"),              # NeRF density net
    ([32, 64, 64, 3], "ReLU", "None"),           # NeRF RGB net
    ([8, 32, 4], "ReLU", "ReLU"),
    ([32, 64, 64, 16], "Sine", "None"),
    ([32, 64, 3], "ReLU", "Exponential"),
    ([27, 48, 5], "None", "None"),               # widths not multiples of 16
    ([32] + [64] * 8 + [16], "ReLU", "None"),    # 9 layers
    ([32, 128, 128, 128, 16], "ReLU", "None"),   # 128 wide
    ([16, 1], "None", "ReLU"),                   # one layer
    # one per instantiation of the mma kernel the cases above do not reach,
    # and the shapes of its other branches
    ([32, 64, 64, 4], "ReLU", "ReLU"),           # volume nets
    ([16, 64, 16], "ReLU", "None"),              # 16 inputs
    ([32, 3], "ReLU", "None"),                   # one layer, mma kernel
    ([27, 64, 64, 5], "ReLU", "None"),           # inputs narrower than padded
    ([32, 64, 8], "ReLU", "None"),               # 8 outputs stored directly
    ([32, 128, 16], "ReLU", "None"),             # 128 wide, two layers
    # the RGB net of a capture with 4 latent dims per image: 36 inputs pad
    # to 48, which has no instantiation, so the general kernel takes it
    ([36, 64, 64, 3], "ReLU", "None"),
    # the nets of SDF mode: configs/sdf/base.json's, and the Takikawa
    # encoding's 24 features, narrower than the padded width of 32
    ([32, 64, 64, 1], "ReLU", "None"),
    ([24, 64, 64, 1], "ReLU", "None"),
    # nets whose weights do not fit in shared memory at once take the
    # streamed kernel: configs/nerf/frequency.json's and none.json's
    # density and RGB nets, configs/sdf/frequency.json's (8 hidden layers
    # of 128) and oneblob.json's (6), a 200-wide layer, 17 layers
    ([96] + [256] * 7 + [16], "ReLU", "None"),
    ([40, 256, 3], "ReLU", "None"),
    ([3] + [256] * 7 + [16], "ReLU", "None"),
    ([19, 256, 3], "ReLU", "None"),
    ([60] + [128] * 8 + [1], "ReLU", "None"),
    ([96] + [128] * 6 + [1], "ReLU", "None"),
    ([40, 200, 256, 5], "ReLU", "ReLU"),
    # a linear chain carries every bf16 rounding flip to the output, so
    # 16 hidden layers of 48 part by ~2.3e-2 between two correct float32
    # summation orders; 16 wide keeps them at ~1.3e-2
    ([8] + [16] * 16 + [4], "None", "ReLU"),
]


def test_latent_dims_rgb_shape_takes_the_general_kernel():
    from instant_ngp_tpu_torch.ops.kernels.mlp_kernels import kernel_variant

    assert kernel_variant([36, 64, 64, 3]) == GENERAL
    assert kernel_variant([32, 64, 64, 3]) != GENERAL


@pytest.mark.parametrize("n", [1, 127, 129, 100003])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_fused_mlp_kernel_matches_plain(device, case, n):
    dims, act, out_act = CASES[case]
    rng = np.random.default_rng(case * 7 + n)
    ws = _weights(rng, dims, device)
    packed = pack_weights(ws)
    x = torch.from_numpy(rng.normal(size=(n, dims[0])).astype(np.float32)) \
        .to(device)
    before = fused_mlp_forward.launches
    out = fused_mlp_forward(x, packed, act, out_act)
    assert fused_mlp_forward.launches == before + 1
    ref = fused_mlp_forward_plain(x, packed.layers, act, out_act)
    torch.cuda.synchronize()
    assert out.shape == (n, dims[-1]) and out.dtype == torch.float32
    err = (out - ref).abs()
    assert torch.isfinite(out).all()
    assert err.max().item() <= 2e-2 and err.mean().item() <= 1e-3
    # the general kernel takes every shape whose weights fit, the streamed
    # kernel every shape, and an input that is not 16-byte aligned takes
    # the mma kernel's plain loads
    forced = [fused_mlp_forward(x, packed, act, out_act, variant=STREAMED)]
    if kernel_variant(dims, act, out_act) != STREAMED:
        forced.append(fused_mlp_forward(x, packed, act, out_act,
                                        variant=GENERAL))
    shifted = torch.empty(x.numel() + 1, device=device)[1:].view_as(x)
    shifted.copy_(x)
    assert shifted.data_ptr() % 16 != 0
    unaligned = fused_mlp_forward(shifted, packed, act, out_act)
    torch.cuda.synchronize()
    for other in (*forced, unaligned):
        err = (other - ref).abs()
        assert err.max().item() <= 2e-2 and err.mean().item() <= 1e-3
    # bf16 input takes the same path as its f32 value
    out_b = fused_mlp_forward(x.to(torch.bfloat16), packed, act, out_act)
    ref_b = fused_mlp_forward(x.to(torch.bfloat16).float(), packed, act,
                              out_act)
    torch.cuda.synchronize()
    assert torch.equal(out_b, ref_b)


@pytest.mark.parametrize("stages", [1, 2, 3, 4])
@pytest.mark.parametrize("dims", [[32, 64, 16], [32, 64, 64, 3]])
def test_every_ring_depth_gives_the_same_rows(device, dims, stages):
    """More tiles than stages for some blocks and fewer for others: the
    ring wraps, and the result does not depend on its depth."""
    rng = np.random.default_rng(stages)
    packed = pack_weights(_weights(rng, dims, device))
    n = 128 * 132 * 4 * 3 + 77
    x = torch.from_numpy(rng.normal(size=(n, 32)).astype(np.float32)) \
        .to(device)
    out = fused_mlp_forward(x, packed, stages=stages)
    ref = fused_mlp_forward(x, packed, variant=GENERAL)
    small = fused_mlp_forward(x[:200], packed, stages=stages)
    torch.cuda.synchronize()
    assert (out - ref).abs().max().item() <= 2e-2
    assert torch.equal(out[:200], small)


def test_permutation_weights_route_inputs_exactly(device):
    """One-hot weights: every output is one bf16-rounded input, so a
    wrong lane, row or column mapping is an exact mismatch."""
    rng = np.random.default_rng(3)
    p0 = torch.from_numpy(rng.permutation(64)[:32])
    keep = torch.from_numpy(rng.permutation(32))
    x = torch.from_numpy(np.abs(rng.normal(size=(1000, 32)))
                         .astype(np.float32)).to(device)
    want = x.to(torch.bfloat16).float()
    for d_out in (16, 3):
        w0 = torch.zeros(32, 64)
        w0[torch.arange(32), p0] = 1.0
        w1 = torch.zeros(64, 64)
        w1[torch.arange(64), torch.arange(64)] = 1.0
        w2 = torch.zeros(64, d_out)
        w2[p0[keep[:d_out]], torch.arange(d_out)] = 1.0
        packed = pack_weights([w.to(device) for w in (w0, w1, w2)])
        assert kernel_variant(packed.dims) != GENERAL
        out = fused_mlp_forward(x, packed)
        torch.cuda.synchronize()
        assert torch.equal(out, want[:, keep[:d_out].to(device)])


def test_variant_table_matches_the_library(device):
    import ctypes

    from instant_ngp_tpu_torch.ops.kernels._build import load_library

    lib = load_library()
    shapes = [c[0] for c in CASES] + [[48, 64, 16], [32, 64, 128, 16],
                                      [32, 64, 32], [32, 128, 3]]
    for dims in shapes:
        for act in ("None", "ReLU", "Sine"):
            for out_act in ("None", "ReLU", "Exponential"):
                has = lib.fused_mlp_mma_has_variant(
                    len(dims) - 1, (ctypes.c_int * len(dims))(*dims),
                    _ACTIVATION_IDS[act], _ACTIVATION_IDS[out_act])
                assert bool(has) == kernel_variant(
                    dims, act, out_act).startswith("mma_"), (dims, act,
                                                             out_act)
    assert len(MMA_VARIANTS) == 5


def test_zero_rows_launch_nothing(device):
    packed = pack_weights(_weights(np.random.default_rng(0), [32, 64, 16],
                                   device))
    before = fused_mlp_forward.launches
    out = fused_mlp_forward(torch.zeros(0, 32, device=device), packed)
    assert out.shape == (0, 16) and fused_mlp_forward.launches == before


def test_wrapper_rejects_what_the_kernel_does_not_take(device):
    packed = pack_weights(_weights(np.random.default_rng(1), [32, 64, 16],
                                   device))
    x = torch.zeros(64, 32, device=device)
    with pytest.raises(ValueError, match="contiguous"):
        fused_mlp_forward(torch.zeros(32, 64, device=device).T, packed)
    with pytest.raises(ValueError, match="dtype"):
        fused_mlp_forward(x.half(), packed)
    with pytest.raises(ValueError, match="width"):
        fused_mlp_forward(torch.zeros(64, 16, device=device), packed)
    with pytest.raises(ValueError, match="weights on"):
        fused_mlp_forward(x, pack_weights(_weights(
            np.random.default_rng(1), [32, 64, 16], "cpu")))


def test_mlp_forward_on_cuda_launches_the_kernel(device):
    mlp = MLP(32, 16, 64, 1, compute_dtype=torch.bfloat16)
    mlp.init_params(torch.Generator().manual_seed(0))
    mlp.to(device)
    x = torch.rand(1000, 32, device=device)
    before = fused_mlp_forward.launches
    out = mlp(x)
    assert fused_mlp_forward.launches == before + 1
    ref = fused_mlp_forward_plain(x, list(mlp.weights))
    torch.cuda.synchronize()
    assert (out - ref).abs().max().item() <= 2e-2


def test_kernel_on_ema_weights_after_an_optimizer_step(device):
    """An inference network whose parameters are the optimizer's EMA
    leaves: after a step (in place) the kernel must compute with the new
    EMA values; a stale pack of the old ones would pass unnoticed."""
    from instant_ngp_tpu_torch.ops.optimizers import Optimizer

    gen = torch.Generator().manual_seed(3)
    train_net = MLP(32, 16, 64, 1, compute_dtype=torch.bfloat16)
    train_net.init_params(gen)
    train_net.to(device).requires_grad_(True)
    ema_net = MLP(32, 16, 64, 1, compute_dtype=torch.bfloat16).to(device)
    opt = Optimizer({"otype": "Ema", "decay": 0.5, "nested": {
        "otype": "Adam", "learning_rate": 1e-1}})
    params = {"net": list(train_net.weights)}
    state = opt.init(params)
    ema_net.load_weights(state["ema"]["net"])
    state["ema"] = {"net": list(ema_net.weights)}
    x = torch.rand(5000, 32, device=device)
    with torch.no_grad():
        out0 = ema_net(x)                          # packs the weights
        grads = {"net": [torch.ones_like(w) for w in train_net.weights]}
        opt.step(state, params, grads)
        before = fused_mlp_forward.launches
        out1 = ema_net(x)
        assert fused_mlp_forward.launches == before + 1
        ref = fused_mlp_forward_plain(x, list(ema_net.weights))
    torch.cuda.synchronize()
    assert (out1 - ref).abs().max().item() <= 2e-2
    assert (out1 - ref).abs().mean().item() <= 1e-3
    # the step moved the weights by 0.05: the old pack would be far off
    assert (out0 - ref).abs().mean().item() > 0.1


def test_input_or_weights_that_require_grad_never_reach_the_kernel(device):
    mlp = MLP(32, 16, 64, 1, compute_dtype=torch.bfloat16)
    mlp.init_params(torch.Generator().manual_seed(0))
    mlp.to(device)
    x = torch.rand(1000, 32, device=device)
    before = fused_mlp_forward.launches
    out = mlp(x.clone().requires_grad_(True))
    assert out.grad_fn is not None
    mlp.requires_grad_(True)
    out = mlp(x)
    assert out.grad_fn is not None
    torch.autograd.grad(out.sum(), list(mlp.weights))
    assert fused_mlp_forward.launches == before
    with torch.no_grad():
        assert mlp(x).grad_fn is None
    assert fused_mlp_forward.launches == before + 1


def test_image_render_goes_through_the_32x64x8_instantiation(device):
    """Image mode at configs/image/base.json's widths (a small table): a
    render launches the (32, 64, 8, ReLU, None) instantiation of the mma
    kernel, once per chunk, a train step launches nothing, and the frame
    agrees with the same testbed's on the CPU (the plain version)."""
    from instant_ngp_tpu_torch.config import (find_network_config,
                                              load_network_config)
    from instant_ngp_tpu_torch.image.testbed_image import ImageTestbed

    cfg = load_network_config(find_network_config("base", "image"))
    cfg["encoding"]["log2_hashmap_size"] = 14
    y, x = np.mgrid[0:48, 0:64].astype(np.float32)
    img = np.stack([0.5 + 0.4 * np.sin(x / 5), 0.5 + 0.4 * np.cos(y / 4),
                    ((x // 8 + y // 8) % 2) * 0.8], -1).astype(np.float32)
    tb = ImageTestbed(img, cfg, device=device)
    table = np.random.default_rng(0).uniform(
        -1, 1, tb.model.encoding.n_params).astype(np.float32)
    params = {"encoding": table,
              "net": [w.detach().cpu() for w in tb.model.network.weights]}
    tb.trainer.load_state(tb.state, params)
    before = dict(fused_mlp_forward.launches_by_variant)
    tb.train(2, 1 << 12)
    assert fused_mlp_forward.launches_by_variant == before
    tb.trainer.load_state(tb.state, params)
    tb.render_chunk = 1 << 11
    ours = tb.render(64, 48)
    launched = {k: v - before.get(k, 0) for k, v in
                fused_mlp_forward.launches_by_variant.items()
                if v != before.get(k, 0)}
    assert launched == {"mma_32x64x8_ReLU_None": 2}
    cpu = ImageTestbed(img, cfg, device="cpu")
    cpu.trainer.load_state(cpu.state, params)
    ref = cpu.render(64, 48)
    err = np.abs(ours - ref)
    # linear colours of the sRGB outputs: of order 0.04 on average
    assert np.abs(ref[..., :3]).mean() > 0.02
    assert err.max() <= 2e-2 and err.mean() <= 1e-3


@pytest.mark.parametrize("dims,act,out_act,variant", [
    ([32, 64, 64, 4], "ReLU", "ReLU", "mma_32x64x8_ReLU_ReLU"),
    ([24, 64, 64, 1], "ReLU", "None", "mma_32x64x8_ReLU_None")],
    ids=["volume", "takikawa"])
def test_volume_and_sdf_shapes_at_2_20_rows(device, dims, act, out_act,
                                             variant):
    """The Volume net and the Takikawa SDF net at the row count of a
    frame's round, on their instantiations."""
    assert kernel_variant(dims, act, out_act) == variant
    rng = np.random.default_rng(len(dims) + dims[0])
    packed = pack_weights(_weights(rng, dims, device))
    x = torch.from_numpy(rng.normal(size=(1 << 20, dims[0]))
                         .astype(np.float32)).to(device)
    before = dict(fused_mlp_forward.launches_by_variant)
    out = fused_mlp_forward(x, packed, act, out_act)
    assert fused_mlp_forward.launches_by_variant[variant] \
        == before.get(variant, 0) + 1
    ref = fused_mlp_forward_plain(x, packed.layers, act, out_act)
    torch.cuda.synchronize()
    err = (out - ref).abs()
    assert ref.abs().mean().item() > 1e-2
    assert err.max().item() <= 2e-2 and err.mean().item() <= 1e-3


def _cloud(side=64):
    g = (np.arange(side, dtype=np.float32) + 0.5) / side - 0.5
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    d = 20.0 * np.exp(-(x * x + y * y + z * z) / 0.02)
    d[d < 0.05] = 0
    return d.astype(np.float32)


def test_volume_mode_on_the_card_matches_the_cpu(device):
    """2 Volume train steps and a 16x16 frame of a small net on the card
    against the CPU from the same draws: the frame launches the ReLU/ReLU
    instantiation once per event round and no train step launches it."""
    from instant_ngp_tpu_torch.config import (find_network_config,
                                              load_network_config)
    from instant_ngp_tpu_torch.volume.testbed_volume import (
        VolumeRenderDraws, VolumeTestbed, VolumeTrainDraws)

    cfg = load_network_config(find_network_config("base", "volume"))
    cfg["encoding"].update(log2_hashmap_size=12)       # 16 levels: 32 wide
    cfg["optimizer"]["nested"]["nested"]["learning_rate"] = 1e-2
    tbs = {d: VolumeTestbed(_cloud(128), cfg, device=d)
           for d in (device, "cpu")}
    table = np.random.default_rng(0).uniform(
        -1, 1, tbs["cpu"].model.encoding.n_params).astype(np.float32)
    net = [w.detach().cpu().numpy().copy()
           for w in tbs["cpu"].model.network.weights]
    net[-1][:, 3] *= 40.0
    gen = torch.Generator().manual_seed(1)
    train = [VolumeTrainDraws.draw(gen, 256) for _ in range(2)]
    render = VolumeRenderDraws.draw(gen, 256)
    losses, frames = {}, {}
    for d, tb in tbs.items():
        tb.stochastic_corners = False
        tb.trainer.load_state(tb.state, {"encoding": table, "net": net})
        tb.draws = lambda step, n, d=d: (VolumeTrainDraws(**{
            k: v.to(d) for k, v in vars(train[step]).items()}), None)
        before = dict(fused_mlp_forward.launches_by_variant)
        losses[d] = [tb.train(1, 1024) for _ in range(2)]
        assert fused_mlp_forward.launches_by_variant == before
        frames[d] = tb.render_frame(16, 16, np.array(
            [[1, 0, 0, 0.5], [0, -1, 0, 0.5], [0, 0, 1, -1.2]], np.float32),
            draws=VolumeRenderDraws(**{k: v.to(d)
                                       for k, v in vars(render).items()}))
        launched = fused_mlp_forward.launches_by_variant.get(
            "mma_32x64x8_ReLU_ReLU", 0) - before.get(
            "mma_32x64x8_ReLU_ReLU", 0)
        assert launched == (32 if d == device else 0)
    np.testing.assert_allclose(losses[device], losses["cpu"], rtol=2e-2)
    err = np.abs(frames[device] - frames["cpu"])
    assert frames["cpu"][..., 3].max() > 0.3
    assert err.max() <= 2e-2 and err.mean() <= 1e-3


def test_sdf_mode_on_the_card_matches_the_cpu(device, tmp_path):
    """2 SDF train steps on the same samples (the same numpy stream) on
    the card and on the CPU, then a Shade frame of the card's weights on
    both: it launches the 32x64x8 ReLU/None instantiation 96 times (one
    per round of the sphere trace), the train steps none."""
    from instant_ngp_tpu_torch.config import (find_network_config,
                                              load_network_config)
    from instant_ngp_tpu_torch.geom.marching import save_mesh
    from instant_ngp_tpu_torch.geom.marching_cubes import marching_cubes
    from instant_ngp_tpu_torch.sdf import SdfTestbed

    g = np.linspace(-1, 1, 20, dtype=np.float32)
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    verts, faces = marching_cubes(np.sqrt(x * x + y * y + z * z) - 0.6, 0.0)
    path = str(tmp_path / "sphere.obj")
    save_mesh(path, verts, faces)
    cfg = load_network_config(find_network_config("base", "sdf"))
    # 16 levels (32 features, the instantiation's width) from 8 to 123
    cfg["encoding"].update(log2_hashmap_size=12, base_resolution=8,
                           per_level_scale=1.2)
    losses, frames = {}, {}
    tbs = {d: SdfTestbed(path, cfg, device=d) for d in (device, "cpu")}
    for d, tb in tbs.items():
        tb.stochastic_corners = False
        before = dict(fused_mlp_forward.launches_by_variant)
        losses[d] = [tb.train(1, 1 << 12) for _ in range(2)]
        assert fused_mlp_forward.launches_by_variant == before
    np.testing.assert_allclose(losses[device], losses["cpu"], rtol=2e-2)
    tbs[device].train(64, 1 << 12)
    trained = tbs[device].trainer.inference_params(tbs[device].state)
    tbs["cpu"].trainer.load_state(tbs["cpu"].state, {
        "encoding": trained["encoding"].detach().cpu(),
        "net": [w.detach().cpu() for w in trained["net"]]})
    cam = np.array([[1, 0, 0, 0.5], [0, -1, 0, 0.5], [0, 0, -1, 1.9]],
                   np.float32)
    before = dict(fused_mlp_forward.launches_by_variant)
    for d, tb in tbs.items():
        frames[d] = tb.render_frame(24, 24, cam, render_mode="Depth")
    assert fused_mlp_forward.launches_by_variant.get(
        "mma_32x64x8_ReLU_None", 0) - before.get(
        "mma_32x64x8_ReLU_None", 0) == 96
    hits = [f[..., 3] > 0.5 for f in frames.values()]
    assert (hits[0] == hits[1]).mean() >= 0.95 and hits[1].mean() > 0.05
    both = hits[0] & hits[1]
    close = np.abs(frames[device][..., 0] - frames["cpu"][..., 0])[both]
    assert (close <= 5e-3).mean() >= 0.95


def _one_hot_chain(rng, d_in, width, d_out, device, depth=1):
    """A permutation net d_in -> width (-> width, `depth` times) -> d_out:
    every output is one input, routed through every hidden column."""
    p0 = torch.from_numpy(rng.permutation(width)[:d_in])
    keep = torch.from_numpy(rng.permutation(d_in)[:d_out])
    w0 = torch.zeros(d_in, width)
    w0[torch.arange(d_in), p0] = 1.0
    ws, at = [w0], p0
    for _ in range(depth):
        p = torch.from_numpy(rng.permutation(width))
        w = torch.zeros(width, width)
        w[torch.arange(width), p] = 1.0
        ws.append(w)
        at = p[at]
    w_out = torch.zeros(width, d_out)
    w_out[at[keep], torch.arange(d_out)] = 1.0
    ws.append(w_out)
    return pack_weights([w.to(device) for w in ws]), keep


@pytest.mark.parametrize("d_in,width,d_out,depth,variant,resident", [
    (36, 64, 3, 1, GENERAL, True), (36, 64, 16, 1, GENERAL, True),
    (64, 64, 3, 1, GENERAL, True), (67, 128, 16, 1, STREAMED, True),
    (131, 256, 16, 1, STREAMED, False), (96, 256, 40, 1, STREAMED, False),
    (36, 64, 3, 17, STREAMED, False), (67, 128, 16, 8, STREAMED, False)])
def test_one_hot_routes_exactly_through_the_wgmma_paths(
        device, d_in, width, d_out, depth, variant, resident):
    """The general and the streamed path, each swizzle row, lane and
    column, with the weights resident and streamed through the ring at
    each padded width: a wrong mapping is an exact mismatch, not noise."""
    rng = np.random.default_rng(width + d_in + d_out + depth)
    packed, keep = _one_hot_chain(rng, d_in, width, d_out, device, depth)
    x = torch.from_numpy(np.abs(rng.normal(size=(3000, d_in)))
                         .astype(np.float32)).to(device)
    want = x.to(torch.bfloat16).float()[:, keep.to(device)]
    if width <= 64:
        assert kernel_variant(packed.dims) == variant
    assert wgmma_plan(packed.dims)[0] == resident
    out = fused_mlp_forward(x, packed, variant=variant)
    torch.cuda.synchronize()
    assert torch.equal(out, want), (out - want).abs().max()


@pytest.mark.parametrize("dims", [[3] + [256] * 7 + [16], [19, 256, 3],
                                  [60] + [128] * 8 + [1]],
                         ids=["3-wide", "19-wide", "60-wide"])
def test_bf16_rows_that_are_not_16_byte_multiples(device, dims):
    """bf16 input of 3, 19 and 60 columns (6, 38, 120 bytes a row): no bulk
    copy of the rows, the per-row loads instead."""
    rng = np.random.default_rng(dims[0])
    packed = pack_weights(_weights(rng, dims, device))
    x = torch.from_numpy(rng.normal(size=(100003, dims[0]))
                         .astype(np.float32)).to(device).to(torch.bfloat16)
    assert kernel_variant(dims) == STREAMED
    out = fused_mlp_forward(x, packed)
    ref = fused_mlp_forward_plain(x, packed.layers)
    same = fused_mlp_forward(x.float(), packed)
    torch.cuda.synchronize()
    err = (out - ref).abs()
    assert err.max().item() <= 2e-2 and err.mean().item() <= 1e-3
    assert torch.equal(out, same)


@pytest.mark.parametrize("act,out_act", [("Sine", "None"),
                                         ("ReLU", "Exponential"),
                                         ("Sine", "Exponential")])
def test_sine_and_exponential_on_the_streamed_path(device, act, out_act):
    dims = [96] + [256] * 3 + [16]
    assert kernel_variant(dims, act, out_act) == STREAMED
    rng = np.random.default_rng(7)
    packed = pack_weights(_weights(rng, dims, device))
    x = torch.from_numpy(rng.normal(size=(20000, 96)).astype(np.float32)) \
        .to(device)
    ref = fused_mlp_forward_plain(x, packed.layers, act, out_act)
    out = fused_mlp_forward(x, packed, act, out_act)
    torch.cuda.synchronize()
    err = (out - ref).abs()
    assert err.max().item() <= 2e-2 * max(1.0, ref.abs().max().item())
    assert err.mean().item() <= 1e-3 * max(1.0, ref.abs().mean().item())


@pytest.mark.parametrize("n_tiles", [2, 3])
@pytest.mark.parametrize("dims", [[96] + [256] * 7 + [16],
                                  [60] + [128] * 8 + [1]])
def test_two_and_three_tile_launches(device, dims, n_tiles):
    """Tiles of 128 rows, one block each: every block's producer streams
    the whole ring once and stops; the rows of one tile do not depend on
    how many tiles run beside it."""
    rng = np.random.default_rng(n_tiles)
    packed = pack_weights(_weights(rng, dims, device))
    n = n_tiles * 128
    x = torch.from_numpy(rng.normal(size=(n, dims[0])).astype(np.float32)) \
        .to(device)
    assert not wgmma_plan(dims)[0]
    ref = fused_mlp_forward_plain(x, packed.layers)
    out = fused_mlp_forward(x, packed)
    alone = fused_mlp_forward(x[:128], packed)
    torch.cuda.synchronize()
    err = (out - ref).abs()
    assert err.max().item() <= 2e-2 and err.mean().item() <= 1e-3
    assert torch.equal(out[:128], alone)


@pytest.mark.parametrize("dims,dtype,aligned,plan", [
    # the configurations' nets: the 1-hidden-layer RGB nets and the general
    # path's stay resident, the deep 128- and 256-wide nets stream
    ([40, 256, 3], torch.float32, True, (True, 2)),
    ([19, 256, 3], torch.float32, True, (True, 0)),
    ([36, 64, 64, 3], torch.float32, True, (True, 2)),
    ([96] + [256] * 7 + [16], torch.float32, True, (False, 1)),
    ([96] + [256] * 7 + [16], torch.bfloat16, True, (False, 2)),
    ([60] + [128] * 8 + [1], torch.float32, True, (False, 2)),
    # rows that are not 16-byte multiples, or x off 16 bytes: no input ring
    ([60] + [128] * 8 + [1], torch.bfloat16, True, (False, 0)),
    ([36, 64, 64, 3], torch.float32, False, (True, 0))])
def test_the_wgmma_plan_places_weights_and_input_rings(device, dims, dtype,
                                                      aligned, plan):
    resident, n_stages, in_stages, smem = wgmma_plan(dims, dtype, aligned)
    assert (resident, in_stages) == plan
    assert smem <= torch.cuda.get_device_properties(
        device).shared_memory_per_block_optin
    assert n_stages >= (1 if resident else 2)


@pytest.mark.parametrize("stochastic", [False, True])
def test_table_gradient_has_the_same_bits_in_every_run(device, stochastic):
    """The hash grid's table gradient at configs/nerf/base.json's width
    (L=8, F=4, 2^19 entries a level) from 2^18 samples, the exact deposit
    and the one-corner stochastic one: summed by `index_put_` in an order
    the indices fix (atomic adds would change it between runs)."""
    from instant_ngp_tpu_torch.ops.grid_encoding import (GridEncoding,
                                                         draw_corner_randoms)

    enc = GridEncoding(3, n_levels=8, n_features_per_level=4,
                       log2_hashmap_size=19, base_resolution=16,
                       stochastic_exact_axes=1, stochastic_bwd=True).to(device)
    n = 1 << 18
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.rand(n, 3, device=device, generator=gen)
    g_out = torch.randn(n, enc.n_output_dims, device=device, generator=gen)
    draws = draw_corner_randoms(gen, n, 3, enc.n_levels, 1)

    def grad():
        if stochastic:
            return enc._table_gradient_stochastic(x, g_out, None, draws, 1)
        return enc._table_gradient(x, g_out, None)

    first, second = grad(), grad()
    torch.cuda.synchronize()
    assert first.abs().max().item() > 0
    assert torch.equal(first, second)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_narrow_rows_take_the_ring_and_match_plain(device, dtype):
    """The Takikawa net's 24-wide rows (96 bytes in f32, 48 in bf16) take
    the input ring by a tensor copy that zero-fills columns 24-31 and the
    rows past the end: one row, a tile less one, a tile, a tile and one,
    and 2^20 + 37 rows, each against the plain version; the same x 4
    bytes off its alignment takes the per-row loads, with the same rows."""
    from instant_ngp_tpu_torch.ops.kernels.mlp_kernels import (
        RING, ROWS, mma_input_path)

    rng = np.random.default_rng(24)
    packed = pack_weights(_weights(rng, [24, 64, 64, 1], device))
    n_max = (1 << 20) + 37
    x_all = torch.from_numpy(rng.normal(size=(n_max, 24)).astype(
        np.float32)).to(device).to(dtype)
    shifted_all = torch.empty(x_all.numel() + 8, dtype=dtype,
                              device=device)[4 // x_all.element_size():][
        :x_all.numel()].view_as(x_all)
    shifted_all.copy_(x_all)
    assert shifted_all.data_ptr() % 16 == 4
    for x, path in ((x_all, RING), (shifted_all, ROWS)):
        assert mma_input_path(24, 32, x.element_size(),
                              x.data_ptr() % 16 == 0) == path
        for n in (1, 127, 128, 129, n_max):
            before = dict(fused_mlp_forward.launches_by_input_path)
            out = fused_mlp_forward(x[:n], packed)
            assert fused_mlp_forward.launches_by_input_path[path] == \
                before.get(path, 0) + 1
            ref = fused_mlp_forward_plain(x[:n], packed.layers)
            torch.cuda.synchronize()
            err = (out - ref).abs()
            assert out.shape == (n, 1) and torch.isfinite(out).all()
            assert err.max().item() <= 2e-2 and err.mean().item() <= 1e-3
            if path == ROWS:
                assert torch.equal(out, fused_mlp_forward(x_all[:n], packed))


def test_input_path_matches_the_library(device):
    from instant_ngp_tpu_torch.ops.kernels._build import load_library
    from instant_ngp_tpu_torch.ops.kernels.mlp_kernels import (
        RING, mma_input_path)

    lib = load_library()
    for d_in in range(1, 33):
        in_p = 16 if d_in <= 16 else 32
        for elem in (2, 4):
            for aligned in (False, True):
                assert (lib.fused_mlp_mma_input_path(d_in, in_p, elem,
                                                     int(aligned)) == 1) \
                    == (mma_input_path(d_in, in_p, elem, aligned) == RING)


def test_error_map_has_the_same_bits_in_every_run(device):
    """The error map's bilinear deposit of 2^16 rays into 64 maps of 64x64
    cells (every cell takes a few deposits), summed in an order the cells
    fix: the same bits on every call."""
    from instant_ngp_tpu_torch.nerf.sampler import RayBatch
    from instant_ngp_tpu_torch.nerf.training import error_map_delta

    gen = torch.Generator(device=device).manual_seed(0)
    n = 1 << 16
    rays = RayBatch(None, None, None, None,
                    img_idx=torch.randint(0, 64, (n,), device=device,
                                          generator=gen),
                    uv=torch.rand(n, 2, device=device, generator=gen))
    loss = torch.rand(n, device=device, generator=gen)
    em = torch.zeros(64, 64 * 64, device=device)
    first = error_map_delta(em, rays, loss, (64, 64))
    second = error_map_delta(em, rays, loss, (64, 64))
    torch.cuda.synchronize()
    assert first.min().item() >= 0 and first.max().item() > 0
    assert torch.equal(first, second)


def test_train_paths_repeat_and_warn_only_of_order_free_ops(device):
    """chip_smoke.py's determinism sweep at a small size: NeRF with the
    defaults, NeRF exact with camera and distortion optimisation, Image,
    Volume and SDF each take 2 steps under the deterministic mode (warnings
    only), and twice more with it off from one seed; it raises on a warned
    op outside determinism.ORDER_FREE or on runs that differ."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("_chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    out = smoke.determinism_sweep(smoke.make_scene(n_cams=4, size=32),
                                  device, "", small=True)
    assert len(out) == 5
    assert all(r["repeats"] and not r["outside"] for r in out.values())


# -- the grid encode (csrc/grid_encoding.cu) ----------------------------------
# Tolerances: the exact forward sums 2^d products of order 1 in another
# order than the plain version's reduction: max abs 1e-5. The stochastic
# forward and the table gradient repeat the plain arithmetic in its order
# (the table gradient: index_put_'s stable order, sequential float32 sums,
# one per group): the same bits. The input gradient sums products of order
# scale (up to 2047 here) over levels and corners in another order: max
# abs 1e-4 of the reference's largest value.
GRID_CASES = [
    # (n_dims, grid type, interpolation, features, levels, log2 hashmap,
    #  base resolution, per-level scale)
    (3, "Hash", "Linear", 4, 8, 19, 16, 2.0),       # configs/nerf/base.json
    (2, "Hash", "Linear", 2, 16, 15, 16, 2.0),      # image, the hash cut
    (3, "Hash", "Linear", 2, 16, 19, 16, 2.0),      # volume, sdf
    (3, "Tiled", "Linear", 8, 2, 19, 128, 1.0),     # nerf densegrid_1res
    (3, "Dense", "Smoothstep", 2, 4, 19, 16, 1.405),
    (2, "Tiled", "Nearest", 4, 4, 10, 8, 2.0),
    (3, "Hash", "Smoothstep", 2, 4, 12, 8, 2.0),
]
GRID_IDS = [f"{c[0]}d-{c[1]}-{c[2]}-F{c[3]}" for c in GRID_CASES]


def _grid_case(case, n, device, seed=0):
    """A grid on the card with a U(-1, 1) table, n points in [-0.05, 1.05]^d
    of which the first lie on cell faces of every level (x = m / scale,
    and 0, 1), grad_out ~ N(0, 1); from 1000 points on, the last eighth
    are a train step's padding: one position and a zero gradient (one long
    run of keys a corner, which the deposit skips)."""
    from instant_ngp_tpu_torch.ops.grid_encoding import GridEncoding

    d, gtype, interp, f, levels, log2_t, base, pls = case
    enc = GridEncoding(d, n_levels=levels, n_features_per_level=f,
                       log2_hashmap_size=log2_t, base_resolution=base,
                       per_level_scale=pls, grid_type=gtype,
                       interpolation=interp).to(device)
    rng = np.random.default_rng(seed + levels * f)
    with torch.no_grad():
        enc.params.copy_(torch.from_numpy(rng.uniform(
            -1.0, 1.0, enc.n_params).astype(np.float32)))
    x = rng.uniform(-0.05, 1.05, (n, d)).astype(np.float32)
    faces = [np.float32(m) / np.float32(s) for s, *_ in enc.levels
             for m in (1, 3, 7)] + [0.0, 1.0]
    k = min(n, len(faces))
    x[:k] = np.asarray(faces[:k], dtype=np.float32)[:, None]
    g_out = rng.normal(size=(n, enc.n_output_dims)).astype(np.float32)
    if n >= 1000:
        x[-(n // 8):] = 0.3
        g_out[-(n // 8):] = 0.0
    return enc, torch.from_numpy(x).to(device), \
        torch.from_numpy(g_out).to(device)


@pytest.mark.parametrize("n", [1, 255, 257, 100003])
@pytest.mark.parametrize("case", GRID_CASES, ids=GRID_IDS)
def test_grid_forward_matches_plain(device, case, n):
    from instant_ngp_tpu_torch.ops.grid_encoding import draw_corner_randoms
    from instant_ngp_tpu_torch.ops.kernels import grid_kernels

    enc, x, _ = _grid_case(case, n, device)
    p = enc.params.detach()
    for max_level in (None, 1.5):
        before = grid_kernels.encode_forward.launches
        out = enc._encode(p, x, max_level)
        assert grid_kernels.encode_forward.launches == before + 1
        ref = enc._encode_plain(p, x, max_level)
        torch.cuda.synchronize()
        assert out.shape == ref.shape and torch.isfinite(out).all()
        assert (out - ref).abs().max().item() <= 1e-5
        gen = torch.Generator(device=device).manual_seed(n)
        for j in range(enc.n_dims):
            draws = draw_corner_randoms(gen, n, enc.n_dims, enc.n_levels, j)
            out = enc._encode_stochastic(p, x, max_level, draws, j)
            ref = enc._encode_stochastic_plain(p, x, max_level, draws, j)
            torch.cuda.synchronize()
            assert torch.equal(out, ref), (j, max_level)


@pytest.mark.parametrize("n", [257, 100003])
@pytest.mark.parametrize("case", GRID_CASES, ids=GRID_IDS)
def test_grid_table_gradient_has_the_plain_card_paths_bits(device, case, n):
    """Every variant of the deposit (exact; j = 0; the fetched corners and
    the one sampled corner at j = 1 and 2) equals `ordered_deposit`'s card
    path (`index_put_` with accumulate) bit for bit, and repeats."""
    from instant_ngp_tpu_torch.ops.grid_encoding import draw_corner_randoms

    enc, x, g_out = _grid_case(case, n, device)
    gen = torch.Generator(device=device).manual_seed(n + 1)
    for max_level in (None, 1.5):
        runs = [enc._table_gradient(x, g_out, max_level) for _ in range(2)]
        ref = enc._table_gradient_plain(x, g_out, max_level)
        torch.cuda.synchronize()
        assert ref.abs().max().item() > 0
        assert torch.equal(runs[0], runs[1]) and torch.equal(runs[0], ref)
        for j in range(enc.n_dims):
            draws = draw_corner_randoms(gen, n, enc.n_dims, enc.n_levels, j)
            for one in ((False, True) if j else (False,)):
                enc.stochastic_bwd = one
                runs = [enc._table_gradient_stochastic(x, g_out, max_level,
                                                       draws, j)
                        for _ in range(2)]
                ref = enc._table_gradient_stochastic_plain(
                    x, g_out, max_level, draws, j)
                torch.cuda.synchronize()
                assert torch.equal(runs[0], runs[1])
                assert torch.equal(runs[0], ref), (j, one, max_level)
        enc.stochastic_bwd = False


@pytest.mark.parametrize("n", [1, 257, 100003])
@pytest.mark.parametrize("case", GRID_CASES, ids=GRID_IDS)
def test_grid_input_gradient_matches_plain_and_repeats(device, case, n):
    enc, x, g_out = _grid_case(case, n, device)
    p = enc.params.detach()
    for max_level in (None, 1.5):
        runs = [enc._input_gradient(p, x, g_out, max_level)
                for _ in range(2)]
        ref = enc._input_gradient_plain(p, x, g_out, max_level)
        torch.cuda.synchronize()
        assert runs[0].shape == (n, enc.n_dims)
        assert torch.equal(runs[0], runs[1])
        scale = ref.abs().max().item()
        if enc.interpolation == "Nearest":
            assert scale == 0 and (runs[0] == 0).all()
        else:
            assert (runs[0] - ref).abs().max().item() <= 1e-4 * scale


def _check_grid_kernels(enc, x, g_out, device, seed):
    """Every grid kernel on (x, g_out) against its plain version, with and
    without max_level: the exact forward within 1e-5 and the same in two
    runs, the stochastic forward and every deposit variant with the plain
    bits and the same bits in two runs."""
    from instant_ngp_tpu_torch.ops.grid_encoding import draw_corner_randoms

    p = enc.params.detach()
    n = x.shape[0]
    gen = torch.Generator(device=device).manual_seed(seed)
    for max_level in (None, 1.5):
        runs = [enc._encode(p, x, max_level) for _ in range(2)]
        ref = enc._encode_plain(p, x, max_level)
        torch.cuda.synchronize()
        assert torch.equal(runs[0], runs[1])
        assert (runs[0] - ref).abs().max().item() <= 1e-5
        runs = [enc._table_gradient(x, g_out, max_level) for _ in range(2)]
        ref = enc._table_gradient_plain(x, g_out, max_level)
        torch.cuda.synchronize()
        assert torch.equal(runs[0], runs[1]) and torch.equal(runs[0], ref)
        for j in range(enc.n_dims):
            draws = draw_corner_randoms(gen, n, enc.n_dims, enc.n_levels, j)
            out = enc._encode_stochastic(p, x, max_level, draws, j)
            ref = enc._encode_stochastic_plain(p, x, max_level, draws, j)
            torch.cuda.synchronize()
            assert torch.equal(out, ref), (j, max_level)
            for one in ((False, True) if j else (False,)):
                enc.stochastic_bwd = one
                runs = [enc._table_gradient_stochastic(x, g_out, max_level,
                                                       draws, j)
                        for _ in range(2)]
                ref = enc._table_gradient_stochastic_plain(
                    x, g_out, max_level, draws, j)
                torch.cuda.synchronize()
                assert torch.equal(runs[0], runs[1])
                assert torch.equal(runs[0], ref), (j, one, max_level)
            enc.stochastic_bwd = False


@pytest.mark.parametrize("what", ["one position", "all padding",
                                  "axis-0 parity", "tiled negative",
                                  "2^20 + 3"])
def test_grid_kernels_at_the_edges_of_the_sort_and_the_sum(device, what):
    """The cases the sorted deposit's tiles and passes make, and the
    forward's corner pairs: 3000 points at one position with a gradient
    (each level's rows take runs of 3000 deposits, past several tiles of
    the sum) beside spread ones; a batch that is all padding (no deposit
    left after the compaction); points whose lower corner is odd and even
    along axis 0 at every level (x = (m + 1/4) / scale); a Tiled grid of
    F = 8 at coordinates in [-1, 2) (negative ones wrap); base.json's grid
    (22-bit rows, three radix passes) at 2^20 + 3 points."""
    cases = {"one position": (GRID_CASES[0], 8192),
             "all padding": (GRID_CASES[6], 4096),
             "axis-0 parity": (GRID_CASES[1], 6000),
             "tiled negative": (GRID_CASES[3], 5000),
             "2^20 + 3": (GRID_CASES[0], (1 << 20) + 3)}
    case, n = cases[what]
    enc, x, g_out = _grid_case(case, n, device, seed=3)
    if what == "one position":
        x[:3000] = 0.4137
        g_out[:3000] = torch.randn(3000, g_out.shape[1], device=device,
                                   generator=torch.Generator(
                                       device=device).manual_seed(5))
    elif what == "all padding":
        g_out.zero_()
    elif what == "axis-0 parity":
        m = torch.arange(n, device=device) % 64
        for k, (scale, *_) in enumerate(enc.levels[:2]):
            rows = slice(k * n // 2, (k + 1) * n // 2)
            x[rows, 0] = ((m[rows] + 0.25) / scale - 0.5 / scale).float()
    elif what == "tiled negative":
        x.mul_(3.0).sub_(1.0)
    _check_grid_kernels(enc, x, g_out, device, seed=n)


def test_grid_kernels_serve_autograd_and_no_plain_call(device):
    """The encode under autograd on the card (the exact one with both
    gradients, the stochastic one with its table gradient) launches the
    kernels and calls no plain version."""
    from instant_ngp_tpu_torch.ops.grid_encoding import (GridEncoding,
                                                         draw_corner_randoms)
    from instant_ngp_tpu_torch.ops.kernels import grid_kernels

    enc, x, g_out = _grid_case(GRID_CASES[0], 4096, device)
    enc.stochastic_exact_axes, enc.stochastic_bwd = 1, True
    plain_before = GridEncoding.plain_calls_on_cuda
    before = grid_kernels.launch_counts()
    enc.params.requires_grad_(True)
    xg = x.clone().requires_grad_(True)
    out = enc(xg)
    torch.autograd.grad((out * g_out).sum(), (enc.params, xg))
    draws = draw_corner_randoms(torch.Generator(device=device).manual_seed(1),
                                4096, 3, enc.n_levels, 1)
    out = enc(x, draws=draws)
    torch.autograd.grad((out * g_out).sum(), enc.params)
    after = grid_kernels.launch_counts()
    for name in ("encode_forward[exact]", "encode_forward[stochastic]",
                 "table_gradient[exact]", "table_gradient[one_corner]",
                 "input_gradient[exact]"):
        assert after.get(name, 0) == before.get(name, 0) + 1, name
    assert GridEncoding.plain_calls_on_cuda == plain_before


def test_grid_wrappers_reject_what_the_kernels_do_not_take(device):
    from instant_ngp_tpu_torch.ops.kernels import grid_kernels

    enc, x, g_out = _grid_case(GRID_CASES[5], 64, device)
    desc, p = enc.kernel_desc, enc.params.detach()
    for call in (
            lambda: grid_kernels.encode_forward(desc, p, x.double(), 4),
            lambda: grid_kernels.encode_forward(desc, p, x.t(), 4),
            lambda: grid_kernels.encode_forward(desc, p[1:], x, 4),
            lambda: grid_kernels.encode_forward(desc, p, x, 4, None, 2),
            lambda: grid_kernels.table_gradient(desc, x, g_out[:, :3], 4),
            lambda: grid_kernels.input_gradient(desc, p, x, g_out.cpu(), 4)):
        with pytest.raises(ValueError):
            call()
