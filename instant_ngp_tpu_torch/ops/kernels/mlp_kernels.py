"""Fused forward of a bias-free MLP: the CUDA kernels under `csrc/` behind
`fused_mlp_forward`, and its plain version.

Counterpart of the TPU kernel instant_ngp_tpu/ops/pallas/mlp_kernels.py::
fused_mlp_forward. Both compute, for x (N, D_in):

    h = bf16(x)
    for each layer i:  h = h @ bf16(W_i), accumulated in float32
                       between layers: h = bf16(hidden_activation(h))
    out = output_activation(h)             (float32, (N, D_out))

Three hand-written paths, chosen by `kernel_variant` from the shape and
the activations alone, before the launch, in this order:
- `csrc/fused_mlp_mma.cu`, one instantiation per entry of `MMA_VARIANTS`
  (the shapes the configurations produce: up to 32 inputs, one hidden
  width of 64 or 128, up to 16 outputs): activations stay in registers
  between layers and the input tiles are streamed ahead of the arithmetic;
- `csrc/fused_mlp.cu`, the general path: any chain of 1-9 layers of widths
  up to 128 whose weights all fit in shared memory beside its tiles (they
  stay resident);
- `csrc/fused_mlp_stream.cu`, the streamed path: any other chain of 1-32
  layers of widths up to 256 (the 256-wide NeRF configs, the 128-wide
  6- and 8-layer SDF configs): one layer's weights at a time in shared
  memory, whatever the total.
Hidden activations None/ReLU/Sine, output activations None/ReLU/
Exponential; anything else, or a width above 256, raises, on every
device.

On a CPU tensor `fused_mlp_forward` runs `fused_mlp_forward_plain`. On a
CUDA tensor it launches a kernel or raises; it never falls back.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Sequence, Tuple

import torch

HIDDEN_ACTIVATIONS = ("None", "ReLU", "Sine")
OUTPUT_ACTIVATIONS = ("None", "ReLU", "Exponential")
_ACTIVATION_IDS = {"None": 0, "ReLU": 1, "Sine": 2, "Exponential": 3}
MAX_LAYERS = 9
MAX_WIDTH = 128
#: the streamed path's limits (csrc/fused_mlp_stream.cu)
STREAM_MAX_LAYERS = 32
STREAM_MAX_WIDTH = 256
# shared memory of one block on sm_90 (227 KB)
SMEM_LIMIT = 232448
# what the general kernel uses besides the weights: a 128-row bf16
# activation tile with rows of 136 elements, and four 16-row float32
# staging tiles with rows of 132
_SMEM_FIXED = 128 * 136 * 2 + 4 * 16 * 132 * 4
GENERAL = "general"
STREAMED = "streamed"
# what the streamed kernel uses besides one layer's weights: a 128-row
# bf16 activation tile with rows of 264, and eight 16-row float32 staging
# tiles with rows of 20
_STREAM_SMEM_FIXED = 128 * 264 * 2 + 8 * 16 * 20 * 4
# (padded input, hidden, padded output, hidden activation, output
# activation) of each instantiation; mirrors kVariants in
# csrc/fused_mlp_mma.cu
MMA_VARIANTS = (
    (32, 64, 16, "ReLU", "None"),    # NeRF density nets
    (32, 64, 8, "ReLU", "None"),     # NeRF RGB, image, SDF nets
    (16, 64, 16, "ReLU", "None"),    # density net on a one-level grid
    (32, 64, 8, "ReLU", "ReLU"),     # volume nets
    (32, 128, 16, "ReLU", "None"),   # 128-wide nets
)
_TILE_ROWS = 128
#: stages of the input ring the mma path asks for (fewer where the
#: weights leave less room)
MMA_STAGES = 3
_MMA_BARRIER_BYTES = 2 * 4 * 8


def _pad16(n: int) -> int:
    return (n + 15) // 16 * 16


def mma_shape(dims: Sequence[int]) -> Optional[Tuple[int, int, int]]:
    """(padded input, hidden, padded output) where the chain `dims` is one
    hidden width between at most 32 inputs and at most 16 outputs (a
    single layer counts as 64-wide), else None. The packing of the weights
    follows from this alone."""
    n_layers = len(dims) - 1
    if not 1 <= n_layers <= MAX_LAYERS or min(dims) < 1:
        return None
    hidden = 64 if n_layers == 1 else dims[1]
    if any(d != hidden for d in dims[2:-1]) or dims[-1] > 16:
        return None
    shape = (_pad16(dims[0]), hidden, 8 if dims[-1] <= 8 else 16)
    if not any(shape == v[:3] for v in MMA_VARIANTS):
        return None
    return shape


def _fragment_order(k_p: int, n_p: int, first: bool
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(row, column) of the padded (k_p, n_p) layer for every element of
    its packing, in the order the mma kernel's lanes read B fragments of
    mma.m16n8k16: [16-deep step][tile group][lane][tile in group][register]
    [half], a group being two 8-column tiles (one where their count is
    odd). Lane (g, t) = (lane // 4, lane % 4) holds column 8 tile + g and
    rows 16 step + 2t + 8 register + half; in the first layer rows
    16 step + 4t + 2 register + half, the order in which the kernel reads
    its input columns."""
    n_tiles = n_p // 8
    group = 2 if n_tiles % 2 == 0 else 1
    step, ng, lane, j, reg, half = torch.meshgrid(
        torch.arange(k_p // 16), torch.arange(n_tiles // group),
        torch.arange(32), torch.arange(group), torch.arange(2),
        torch.arange(2), indexing="ij")
    g, t = lane // 4, lane % 4
    within = 4 * t + 2 * reg + half if first else 2 * t + 8 * reg + half
    return ((16 * step + within).reshape(-1),
            (8 * (ng * group + j) + g).reshape(-1))


@functools.lru_cache(maxsize=None)
def _fragment_order_on(k_p: int, n_p: int, first: bool, device: str):
    return tuple(i.to(device) for i in _fragment_order(k_p, n_p, first))


@dataclasses.dataclass(frozen=True)
class FusedMLPWeights:
    """The layers of one MLP as bf16, unpadded (`layers`, what the plain
    version multiplies) and packed the way the kernels read them, the
    layers back to back in one buffer each:
    - `packed_general`: layer i a zero-padded (pad16(fan_in),
      pad16(fan_out) + 8) row-major block (the general kernel);
    - `packed`: where `mma_shape(dims)` names a shape, layer i zero-padded
      to that shape's widths in the order of `_fragment_order` (the mma
      kernel); else the same buffer as `packed_general`."""

    layers: Tuple[torch.Tensor, ...]
    packed: torch.Tensor
    packed_general: torch.Tensor
    dims: Tuple[int, ...]


def mma_layer_shapes(dims: Sequence[int]) -> Tuple[Tuple[int, int], ...]:
    """Padded (fan_in, fan_out) of every layer in the mma packing."""
    in_p, hidden, out_p = mma_shape(dims)
    widths = [in_p] + [hidden] * (len(dims) - 2) + [out_p]
    return tuple(zip(widths[:-1], widths[1:]))


def pack_weights(weights: Sequence[torch.Tensor]) -> FusedMLPWeights:
    """(fan_in, fan_out) weight matrices -> FusedMLPWeights on their device.
    Done once per parameter load, not per call."""
    if not weights:
        raise ValueError("an MLP needs at least one layer")
    dims = [int(weights[0].shape[0])]
    for w in weights:
        if w.dim() != 2 or int(w.shape[0]) != dims[-1]:
            raise ValueError(f"layer shapes do not chain: "
                             f"{[tuple(v.shape) for v in weights]}")
        dims.append(int(w.shape[1]))
    layers = tuple(w.detach().to(torch.bfloat16).contiguous()
                   for w in weights)

    def padded(w, rows, cols):
        block = torch.zeros(rows, cols, dtype=torch.bfloat16,
                            device=w.device)
        block[:w.shape[0], :w.shape[1]] = w
        return block

    general = torch.cat([padded(w, _pad16(w.shape[0]),
                                _pad16(w.shape[1]) + 8).reshape(-1)
                         for w in layers])
    packed = general
    if mma_shape(dims) is not None:
        blocks = []
        for i, (w, (k_p, n_p)) in enumerate(zip(layers,
                                                mma_layer_shapes(dims))):
            rows, cols = _fragment_order_on(k_p, n_p, i == 0, str(w.device))
            blocks.append(padded(w, k_p, n_p)[rows, cols])
        packed = torch.cat(blocks)
    return FusedMLPWeights(layers, packed, general, tuple(dims))


def general_smem_bytes(dims: Sequence[int]) -> int:
    """Shared memory the general kernel needs for a chain `dims`."""
    return _SMEM_FIXED + 2 * sum(_pad16(i) * (_pad16(o) + 8)
                                 for i, o in zip(dims[:-1], dims[1:]))


def stream_smem_bytes(dims: Sequence[int]) -> int:
    """Shared memory the streamed kernel needs for a chain `dims`: its
    tiles and the largest layer's block of the general packing."""
    return _STREAM_SMEM_FIXED + 2 * max(
        _pad16(i) * (_pad16(o) + 8) for i, o in zip(dims[:-1], dims[1:]))


def mma_smem_bytes(dims: Sequence[int], stages: int) -> int:
    """Shared memory the mma kernel needs with an input ring of `stages`:
    the ring, the output gather where the output is narrower than its
    padded width, the weights and the barriers."""
    in_p, _, out_p = mma_shape(dims)
    gather = 0 if dims[-1] == out_p else _TILE_ROWS * out_p * 4
    return (stages * _TILE_ROWS * in_p * 4 + gather + _MMA_BARRIER_BYTES
            + 2 * sum(k * n for k, n in mma_layer_shapes(dims)))


def kernel_variant(dims: Sequence[int], activation: str = "ReLU",
                   output_activation: str = "None") -> str:
    """Which hand-written path `fused_mlp_forward` takes on a CUDA tensor
    for a chain of widths `dims`: the name of an instantiation of the mma
    kernel where one fits in shared memory, else `GENERAL` where all the
    weights fit beside the general kernel's tiles, else `STREAMED`. A
    function of the shape and the activations alone. (The streamed path's
    own limits are checked by `fused_mlp_forward`, which raises beyond
    them.)"""
    dims = tuple(dims)
    shape = mma_shape(dims)
    if shape is not None and (*shape, activation,
                              output_activation) in MMA_VARIANTS \
            and mma_smem_bytes(dims, 1) <= SMEM_LIMIT:
        return "mma_{}x{}x{}_{}_{}".format(*shape, activation,
                                           output_activation)
    if len(dims) - 1 <= MAX_LAYERS and max(dims) <= MAX_WIDTH \
            and general_smem_bytes(dims) <= SMEM_LIMIT:
        return GENERAL
    return STREAMED


@functools.lru_cache(maxsize=None)
def _plan(dims: Tuple[int, ...], activation: str, output_activation: str,
          variant: Optional[str], stages: Optional[int]
          ) -> Tuple[str, int]:
    """(variant, stages of the mma kernel's ring) for a call, or the
    ValueError that says why there is no kernel for it. Cached: the render
    loop makes many small calls with the same few shapes."""
    if activation not in HIDDEN_ACTIVATIONS:
        raise ValueError(f"fused_mlp_forward: hidden activation "
                         f"{activation!r} is not one of {HIDDEN_ACTIVATIONS}")
    if output_activation not in OUTPUT_ACTIVATIONS:
        raise ValueError(f"fused_mlp_forward: output activation "
                         f"{output_activation!r} is not one of "
                         f"{OUTPUT_ACTIVATIONS}")
    n_layers = len(dims) - 1
    if not 1 <= n_layers <= STREAM_MAX_LAYERS:
        raise ValueError(f"fused_mlp_forward: {n_layers} layers, "
                         f"supported 1-{STREAM_MAX_LAYERS}")
    if max(dims) > STREAM_MAX_WIDTH:
        raise ValueError(f"fused_mlp_forward: widths {dims} exceed "
                         f"{STREAM_MAX_WIDTH}: one layer's weights would "
                         f"not fit in shared memory")
    chosen = kernel_variant(dims, activation, output_activation)
    if variant is None:
        variant = chosen
    elif variant not in (chosen, GENERAL, STREAMED):
        raise ValueError(f"fused_mlp_forward: variant {variant!r} is "
                         f"none of {chosen!r}, {GENERAL!r}, {STREAMED!r}")
    if variant == STREAMED:
        needed, stages = stream_smem_bytes(dims), 0
    elif variant == GENERAL:
        if n_layers > MAX_LAYERS or max(dims) > MAX_WIDTH:
            raise ValueError(f"fused_mlp_forward: the general kernel takes "
                             f"1-{MAX_LAYERS} layers of widths up to "
                             f"{MAX_WIDTH}, not {dims}")
        needed, stages = general_smem_bytes(dims), 0
    else:
        if stages is None:
            # the deepest ring up to MMA_STAGES that fits
            stages = next((k for k in range(MMA_STAGES, 1, -1)
                           if mma_smem_bytes(dims, k) <= SMEM_LIMIT), 1)
        elif not 1 <= stages <= 4:
            raise ValueError(f"fused_mlp_forward: a ring of {stages} stages")
        needed = mma_smem_bytes(dims, stages)
    if needed > SMEM_LIMIT:
        raise ValueError(f"fused_mlp_forward: widths {dims} need "
                         f"{needed} B of shared memory, more "
                         f"than {SMEM_LIMIT}")
    return variant, stages


def _activate(name: str, h: torch.Tensor) -> torch.Tensor:
    if name == "ReLU":
        return torch.relu(h)
    if name == "Sine":
        return torch.sin(h)
    if name == "Exponential":
        return torch.exp(h)
    return h


def fused_mlp_forward_plain(x: torch.Tensor,
                            weights: Sequence[torch.Tensor],
                            activation: str = "ReLU",
                            output_activation: str = "None"
                            ) -> torch.Tensor:
    """The plain PyTorch version: float32 products of bf16-rounded
    operands, which round like JAX's bf16 dot with f32 accumulation."""
    h = x.to(torch.bfloat16).float()
    for i, w in enumerate(weights):
        h = h @ w.to(torch.bfloat16).float()
        if i + 1 < len(weights):
            h = _activate(activation, h).to(torch.bfloat16).float()
    return _activate(output_activation, h)


def fused_mlp_forward(x: torch.Tensor, weights: FusedMLPWeights,
                      activation: str = "ReLU",
                      output_activation: str = "None",
                      variant: Optional[str] = None,
                      stages: Optional[int] = None) -> torch.Tensor:
    """x (N, D_in) float32 or bf16 -> (N, D_out) float32.

    `variant` and `stages` are for measurements: `variant=GENERAL` or
    `STREAMED` sends a shape through the general or the streamed kernel
    instead of the path `kernel_variant` names, `stages` (1-4) sets the depth of the mma kernel's
    input ring. By default the variant is `kernel_variant(...)` and the
    ring as deep as fits, up to MMA_STAGES."""
    variant, stages = _plan(weights.dims, activation, output_activation,
                            variant, stages)
    if x.device.type == "cpu":
        return fused_mlp_forward_plain(x, weights.layers, activation,
                                       output_activation)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp_forward: no kernel for {x.device}")
    if x.dim() != 2 or x.shape[1] != weights.dims[0]:
        raise ValueError(f"fused_mlp_forward: x {tuple(x.shape)} does not "
                         f"match input width {weights.dims[0]}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_mlp_forward: x dtype {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("fused_mlp_forward: x must be contiguous")
    if weights.packed.device != x.device:
        raise ValueError(f"fused_mlp_forward: weights on "
                         f"{weights.packed.device}, x on {x.device}")
    if x.shape[0] >= 1 << 31:
        raise ValueError("fused_mlp_forward: more than 2^31 rows")
    n = int(x.shape[0])
    out = torch.empty(n, weights.dims[-1], dtype=torch.float32,
                      device=x.device)
    if n == 0:
        return out
    from ._build import load_library

    lib = load_library()
    n_layers = len(weights.dims) - 1
    dims = (ctypes.c_int * (n_layers + 1))(*weights.dims)
    acts = (_ACTIVATION_IDS[activation], _ACTIVATION_IDS[output_activation])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        if variant in (GENERAL, STREAMED):
            packed = weights.packed_general
            launch = lib.fused_mlp_forward_launch if variant == GENERAL \
                else lib.fused_mlp_stream_launch
            err = launch(x.data_ptr(), int(x.dtype == torch.bfloat16),
                         packed.data_ptr(), packed.numel(), out.data_ptr(),
                         n, n_layers, dims, *acts, stream)
        else:
            err = lib.fused_mlp_mma_launch(
                x.data_ptr(), int(x.dtype == torch.bfloat16),
                weights.packed.data_ptr(), weights.packed.numel(),
                out.data_ptr(), n, n_layers, dims, *acts, stages, stream)
    if err != 0:
        raise RuntimeError(f"fused_mlp_forward: kernel launch failed with "
                           f"CUDA error {err} ({variant})")
    fused_mlp_forward.launches += 1
    fused_mlp_forward.launches_by_variant[variant] = \
        fused_mlp_forward.launches_by_variant.get(variant, 0) + 1
    return out


fused_mlp_forward.launches = 0
fused_mlp_forward.launches_by_variant = {}
