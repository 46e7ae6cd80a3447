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
- the general path: any chain of 1-9 layers of widths up to 128 whose
  weights pass the general path's shared-memory rule
  (`general_smem_bytes`);
- the streamed path: any other chain of 1-32 layers of widths up to 256
  (the 256-wide NeRF configs, the 128-wide 6- and 8-layer SDF configs).
The general and the streamed path are one kernel, `csrc/fused_mlp_wgmma.cu`
(wgmma, the activations in registers up to 128 wide and in a shared A
tile at 256, the weights in swizzled 64-deep chunks copied in bulk). Its
own plan (`wgmma_plan`) decides whether a net's chunks stay resident in
shared memory or stream through a ring; the variant names only keep the
launch counts of the two admission rules apart, so `"streamed"` counts
the launches of nets outside the general rule whether or not their
weights stream (the 1-hidden-layer 256-wide RGB nets stay resident).
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
#: the streamed path's limits (csrc/fused_mlp_wgmma.cu)
STREAM_MAX_LAYERS = 32
STREAM_MAX_WIDTH = 256
# shared memory of one block on sm_90 (227 KB)
SMEM_LIMIT = 232448
# the general path's admission rule (`general_smem_bytes`): the footprint
# of the first, wmma general kernel, a 128-row bf16 activation tile with
# rows of 136 elements and four 16-row float32 staging tiles with rows of
# 132 beside all the weights; kept as the rule so that every net keeps
# the variant it had
_SMEM_FIXED = 128 * 136 * 2 + 4 * 16 * 132 * 4
GENERAL = "general"
STREAMED = "streamed"
#: csrc/fused_mlp_wgmma.cu: K rows of a weight chunk, and the output width
#: of a narrow last layer
WGMMA_CHUNK_K = 64
WGMMA_NARROW = 16
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
    - `packed_wgmma`: where the widths allow it (up to 256), layer i
      zero-padded to `wgmma_layer_shapes(dims)[i]` and cut into chunks of
      64 rows, each the swizzled shared-memory image that the wgmma
      descriptor reads (`_sw128_offsets`; the general and the streamed
      path), else None;
    - `packed`: where `mma_shape(dims)` names a shape, layer i zero-padded
      to that shape's widths in the order of `_fragment_order` (the mma
      kernel); else the same buffer as `packed_wgmma`."""

    layers: Tuple[torch.Tensor, ...]
    packed: Optional[torch.Tensor]
    packed_wgmma: Optional[torch.Tensor]
    dims: Tuple[int, ...]


RING = "ring"
ROWS = "rows"


def mma_input_path(d_in: int, in_p: int, elem_bytes: int,
                   aligned: bool) -> str:
    """How the mma kernel brings in the rows of an x of `d_in` values of
    `elem_bytes` bytes each, padded to `in_p`: `RING` where one copy
    fetches a 128-row tile into the kernel's ring of stages (a bulk copy
    of whole padded rows, or a tensor copy that zero-fills the columns
    from d_in to in_p), which needs x 16-byte `aligned` and a row that is
    a multiple of 16 bytes; else `ROWS`, each warp loading its own rows.
    Mirrors takes_ring in csrc/fused_mlp_mma.cu."""
    if aligned and d_in <= in_p and d_in * elem_bytes % 16 == 0:
        return RING
    return ROWS


def mma_layer_shapes(dims: Sequence[int]) -> Tuple[Tuple[int, int], ...]:
    """Padded (fan_in, fan_out) of every layer in the mma packing."""
    in_p, hidden, out_p = mma_shape(dims)
    widths = [in_p] + [hidden] * (len(dims) - 2) + [out_p]
    return tuple(zip(widths[:-1], widths[1:]))


def wgmma_hidden_width(dims: Sequence[int]) -> Optional[int]:
    """The padded width NP of every hidden layer in the wgmma kernel: the
    smallest of 64, 128 and 256 that holds every hidden width, the first
    layer's 64-deep blocks and an output wider than 16; None beyond 256.
    Mirrors hidden_class in csrc/fused_mlp_wgmma.cu."""
    k = WGMMA_CHUNK_K
    need = max([-(-dims[0] // k) * k, *dims[1:-1]]
               + ([dims[-1]] if dims[-1] > WGMMA_NARROW else []))
    return next((w for w in (64, 128, 256) if need <= w), None)


def wgmma_layer_shapes(dims: Sequence[int]) -> Tuple[Tuple[int, int], ...]:
    """Padded (fan_in, fan_out) of every layer in the wgmma packing: every
    width to NP but the first layer's fan_in of a 256-wide net (to a
    multiple of 64) and a last layer of at most 16 outputs (to 16)."""
    np_ = wgmma_hidden_width(dims)
    k = WGMMA_CHUNK_K
    k0 = -(-dims[0] // k) * k if np_ == 256 else np_
    ins = [k0] + [np_] * (len(dims) - 2)
    outs = [np_] * (len(dims) - 2) + [
        WGMMA_NARROW if dims[-1] <= WGMMA_NARROW else np_]
    return tuple(zip(ins, outs))


def _sw128_offsets(k_p: int, n_p: int) -> torch.Tensor:
    """(k_p, n_p) int64: where element (k, n) of a padded layer lies in its
    packing. Chunk k // 64 holds rows 64 (k // 64) .. + 63 as n_p rows of
    128 bytes (one per output column n, K contiguous), in 8-row atoms of
    1024 bytes; the 16-byte group k % 64 // 8 of row n sits at group
    (k % 64 // 8) ^ (n % 8), the 128-byte swizzle of a K-major wgmma
    operand."""
    k = torch.arange(k_p)[:, None]
    n = torch.arange(n_p)[None, :]
    kk = k % WGMMA_CHUNK_K
    return ((k // WGMMA_CHUNK_K) * (n_p * WGMMA_CHUNK_K) + (n // 8) * 512
            + (n % 8) * 64 + ((kk // 8) ^ (n % 8)) * 8 + kk % 8)


@functools.lru_cache(maxsize=None)
def _sw128_offsets_on(k_p: int, n_p: int, device: str) -> torch.Tensor:
    return _sw128_offsets(k_p, n_p).reshape(-1).to(device)


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

    wgmma = None
    if wgmma_hidden_width(dims) is not None:
        blocks = []
        for w, (k_p, n_p) in zip(layers, wgmma_layer_shapes(dims)):
            block = torch.empty(k_p * n_p, dtype=torch.bfloat16,
                                device=w.device)
            block[_sw128_offsets_on(k_p, n_p, str(w.device))] = \
                padded(w, k_p, n_p).reshape(-1)
            blocks.append(block)
        wgmma = torch.cat(blocks)
    packed = wgmma
    if mma_shape(dims) is not None:
        blocks = []
        for i, (w, (k_p, n_p)) in enumerate(zip(layers,
                                                mma_layer_shapes(dims))):
            rows, cols = _fragment_order_on(k_p, n_p, i == 0, str(w.device))
            blocks.append(padded(w, k_p, n_p)[rows, cols])
        packed = torch.cat(blocks)
    return FusedMLPWeights(layers, packed, wgmma, tuple(dims))


def general_smem_bytes(dims: Sequence[int]) -> int:
    """The general path's admission rule for a chain `dims`: the first,
    wmma general kernel's shared memory (its tiles beside every layer as a
    zero-padded (pad16(fan_in), pad16(fan_out) + 8) block). `kernel_variant`
    keeps it so that each net keeps its variant; the wgmma kernel that
    serves the path holds a net's weights resident where they fit (every
    configuration's do) and streams them otherwise."""
    return _SMEM_FIXED + 2 * sum(_pad16(i) * (_pad16(o) + 8)
                                 for i, o in zip(dims[:-1], dims[1:]))


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
    kernel where one fits in shared memory, else `GENERAL` where the chain
    passes `general_smem_bytes`, else `STREAMED`. A
    function of the shape and the activations alone. (The streamed path's
    own limits are checked by `fused_mlp_forward`, which raises beyond
    them.) Both GENERAL and STREAMED launch the wgmma kernel, whose plan
    alone decides where the weights lie (`wgmma_plan`)."""
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
          variant: Optional[str], stages: Optional[int]) -> Tuple[str, int]:
    """(variant, stages of the mma kernel's input ring) for a call, or the
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
    if variant in (GENERAL, STREAMED):
        if variant == GENERAL and (n_layers > MAX_LAYERS
                                   or max(dims) > MAX_WIDTH
                                   or general_smem_bytes(dims)
                                   > SMEM_LIMIT):
            raise ValueError(f"fused_mlp_forward: the general path takes "
                             f"1-{MAX_LAYERS} layers of widths up to "
                             f"{MAX_WIDTH} within {SMEM_LIMIT} B of shared "
                             f"memory by its rule, not {dims}")
        if stages is not None:
            raise ValueError("fused_mlp_forward: the wgmma kernel sizes "
                             "its rings itself; `stages` is the mma "
                             "kernel's")
        # every chain of widths up to 256 fits: at 256 a ring of 5 weight
        # stages beside the A tiles, with per-row loads of x
        return variant, 0
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


def wgmma_plan(dims: Sequence[int], x_dtype: torch.dtype = torch.float32,
               aligned: bool = True) -> Tuple[bool, int, int, int]:
    """(resident, weight stages, input stages, dynamic shared-memory
    bytes) that the wgmma kernel plans on the current CUDA device for a
    chain `dims` and an x of `x_dtype`, 16-byte `aligned` or not: the
    weights resident (every chunk in shared memory, fetched once per
    block) or streamed through a ring, the rows of x bulk-copied through
    an input ring or loaded row by row (0 input stages). The kernel's own
    answer (csrc/fused_mlp_wgmma.cu::plan); needs the card."""
    from ._build import load_library

    dims = tuple(int(d) for d in dims)
    out = (ctypes.c_int * 4)()
    err = load_library().fused_mlp_wgmma_plan(
        len(dims) - 1, (ctypes.c_int * len(dims))(*dims),
        int(x_dtype == torch.bfloat16), int(aligned), out)
    if err != 0:
        raise ValueError(f"wgmma_plan: no plan for {dims} (CUDA error "
                         f"{err})")
    return bool(out[0]), out[1], out[2], out[3]


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
    `STREAMED` sends a shape through the general or the streamed path (the
    wgmma kernel) instead of the one `kernel_variant` names; `stages` sets
    the depth of the mma kernel's input ring (1-4; by default the deepest
    up to MMA_STAGES that fits)."""
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
    if weights.layers[0].device != x.device:
        raise ValueError(f"fused_mlp_forward: weights on "
                         f"{weights.layers[0].device}, x on {x.device}")
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
            packed = weights.packed_wgmma
            err = lib.fused_mlp_wgmma_launch(
                x.data_ptr(), int(x.dtype == torch.bfloat16),
                packed.data_ptr(), 2 * packed.numel(), out.data_ptr(), n,
                n_layers, dims, *acts, stream)
        else:
            path = mma_input_path(weights.dims[0], mma_shape(weights.dims)[0],
                                  x.element_size(), x.data_ptr() % 16 == 0)
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
    if variant not in (GENERAL, STREAMED):
        fused_mlp_forward.launches_by_input_path[path] = \
            fused_mlp_forward.launches_by_input_path.get(path, 0) + 1
    return out


fused_mlp_forward.launches = 0
fused_mlp_forward.launches_by_variant = {}
#: the mma kernel's launches by `mma_input_path`
fused_mlp_forward.launches_by_input_path = {}
