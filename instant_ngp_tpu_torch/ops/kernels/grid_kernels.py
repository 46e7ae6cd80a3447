"""The grid encode's CUDA kernels (`csrc/grid_encoding.cu`) behind three
wrappers: `encode_forward` (the exact and the stochastic-corner forward),
`table_gradient` (the table gradient of every variant, a repeatable
sorted deposit) and `input_gradient` (d loss / dx of the exact encode).

They stand in for the JAX package's XLA encode (instant_ngp_tpu/ops/
grid_encoding.py `apply` and `_build_stochastic_call`, which have no TPU
kernel). Their plain PyTorch versions are the `_*_plain` methods of
`ops/grid_encoding.py::GridEncoding`, whose dispatching methods call these
wrappers for CUDA tensors and the plain versions for CPU tensors. A wrapper
takes CUDA tensors only: it launches its kernel or raises, and never falls
back. Each counts its launches (`launches`, and by variant).

The table gradient launches only kernels of that file, in turn: a stable
LSD radix sort of the deposits' table rows (8-bit digits of the keys'
bits, an int32 position as payload; each pass a histogram, a scan of the
tiles' counts and a ranked scatter; the first pass computes the rows,
writes each (level, point)'s gradient row and weights level-major and
leaves out the deposits of a zero gradient, which add nothing), then
`deposit_sum` adds each row's deposits in that order (the order and
arithmetic of `index_put_` with accumulate on CUDA, which the plain
version calls). One library call launches them all; every scratch size
comes from the library (`grid_deposit_scratch`). A call counts once.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Sequence, Tuple

import torch

GRID_TYPES = {"Hash": 0, "Dense": 1, "Tiled": 2}
INTERPOLATIONS = {"Linear": 0, "Smoothstep": 1, "Nearest": 2}
#: csrc/grid_encoding.cuh::kMaxLevels, and the feature counts
#: csrc/grid_encoding.cu instantiates (those of every configuration)
MAX_LEVELS = 32
FEATURES = (2, 4, 8)
#: table-gradient modes (csrc/grid_encoding.cu): every corner weighted, the
#: one fully sampled corner, the 2^j fetched corners
EXACT, ONE_CORNER, FETCHED = 0, 1, 2
MODE_NAMES = {EXACT: "exact", ONE_CORNER: "one_corner", FETCHED: "fetched"}


@dataclasses.dataclass(frozen=True)
class GridDesc:
    """One encoding's levels as the kernels take them: `ints` = [n_dims,
    n_levels, n_features, grid type, interpolation, then per level res,
    size, offset, hashed], `scales` the f32 per-level scales."""

    n_dims: int
    n_levels: int
    n_features: int
    n_entries: int
    ints: Tuple[int, ...]
    scales: Tuple[float, ...]

    @functools.cached_property
    def c_args(self):
        return ((ctypes.c_int * len(self.ints))(*self.ints),
                (ctypes.c_float * len(self.scales))(*self.scales))


def grid_desc(n_dims: int, n_features: int, grid_type: str,
              interpolation: str,
              levels: Sequence[Tuple[float, int, int, int, bool]]
              ) -> GridDesc:
    """The `GridDesc` of a GridEncoding's `levels` ((scale, res, size,
    offset, hashed) each); raises where the kernels cannot take it."""
    if n_features not in FEATURES:
        raise ValueError(f"grid kernels: {n_features} features per level, "
                         f"instantiated for {FEATURES}")
    if not 1 <= len(levels) <= MAX_LEVELS:
        raise ValueError(f"grid kernels: {len(levels)} levels, at most "
                         f"{MAX_LEVELS}")
    n_entries = levels[-1][3] + levels[-1][2]
    if n_entries * n_features >= 1 << 31:
        raise ValueError(f"grid kernels: a table of {n_entries} rows x "
                         f"{n_features} needs 64-bit rows")
    ints = [n_dims, len(levels), n_features, GRID_TYPES[grid_type],
            INTERPOLATIONS[interpolation]]
    for _, res, size, offset, hashed in levels:
        ints += [res, size, offset, int(hashed)]
    return GridDesc(n_dims, len(levels), n_features, n_entries, tuple(ints),
                    tuple(s for s, *_ in levels))


def _lib():
    from ._build import load_library

    return load_library()


def _check(name: str, t: torch.Tensor, dtype: torch.dtype,
           shape: Tuple[int, ...], device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} is {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_points(desc: GridDesc, x: torch.Tensor) -> int:
    if x.device.type != "cuda":
        raise ValueError(f"grid kernels: no kernel for {x.device}")
    if x.dim() != 2:
        raise ValueError(f"x has shape {tuple(x.shape)}")
    n = int(x.shape[0])
    _check("x", x, torch.float32, (n, desc.n_dims), x.device)
    if n >= 1 << 31:
        raise ValueError("grid kernels: more than 2^31 points")
    return n


def _check_table(desc: GridDesc, params: torch.Tensor,
                 device: torch.device) -> None:
    _check("params", params, torch.float32,
           (desc.n_entries * desc.n_features,), device)
    if params.data_ptr() % 32:
        raise ValueError("params must be 32-byte aligned (a row is one "
                         "vector load, and an even row and the next share "
                         "one 32-byte sector)")


def _check_draws(desc: GridDesc, draws, n: int, j: int,
                 device: torch.device):
    """-> (u pointer, axis pointer, the tensors kept alive). A block of
    rows of larger draws (`CornerDraws.rows`) is copied contiguous."""
    u = draws.u.contiguous()
    _check("draws.u", u, torch.float32, (desc.n_dims, n, desc.n_levels),
           device)
    if j == 0:
        return u.data_ptr(), None, (u,)
    if draws.axis is None:
        raise ValueError(f"exact_axes={j} needs draws.axis")
    axis = draws.axis.to(torch.int64).contiguous()
    _check("draws.axis", axis, torch.int64, (n, desc.n_levels), device)
    return u.data_ptr(), axis.data_ptr(), (u, axis)


def _raise(what: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: kernel launch failed with CUDA error "
                           f"{err}")


def _count(fn, variant: str) -> None:
    fn.launches += 1
    fn.launches_by_variant[variant] = \
        fn.launches_by_variant.get(variant, 0) + 1


def encode_forward(desc: GridDesc, params: torch.Tensor, x: torch.Tensor,
                   active: int, draws=None, j: int = -1) -> torch.Tensor:
    """(N, L*F) features of x (N, d) from the flat table `params`: the
    exact encode (j < 0) or the stochastic-corner one with j exact axes
    from `draws` (a CornerDraws); levels from `active` on give zeros."""
    n = _check_points(desc, x)
    _check_table(desc, params, x.device)
    if not -1 <= j < desc.n_dims:
        raise ValueError(f"exact_axes {j}")
    out = torch.empty(n, desc.n_levels * desc.n_features,
                      dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    u = axis = None
    if j >= 0:
        u, axis, _keep = _check_draws(desc, draws, n, j, x.device)
    ints, scales = desc.c_args
    with torch.cuda.device(x.device):
        err = _lib().grid_forward_launch(
            ints, scales, x.data_ptr(), params.data_ptr(), u, axis,
            out.data_ptr(), n, int(active), int(j),
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise("grid encode_forward", err)
    _count(encode_forward, "exact" if j < 0 else "stochastic")
    return out


encode_forward.launches = 0
encode_forward.launches_by_variant = {}


def table_gradient(desc: GridDesc, x: torch.Tensor, grad_out: torch.Tensor,
                   active: int, mode: int = EXACT, draws=None,
                   j: int = 0) -> torch.Tensor:
    """d(loss)/d(params), flat like the table, from grad_out (N, L*F) over
    the `active` levels: `mode` EXACT (every corner weighted), ONE_CORNER
    (the fully sampled corner, weight 1) or FETCHED (the 2^j corners the
    stochastic forward fetched, weighted). The same bits in every run."""
    n = _check_points(desc, x)
    f = desc.n_features
    _check("grad_out", grad_out, torch.float32, (n, desc.n_levels * f),
           x.device)
    if grad_out.data_ptr() % 16:
        raise ValueError("grad_out must be 16-byte aligned")
    if mode not in MODE_NAMES or (mode == FETCHED
                                  and not 1 <= j < desc.n_dims):
        raise ValueError(f"table_gradient: mode {mode}, exact_axes {j}")
    if n == 0 or active < 1:
        return torch.zeros(desc.n_entries * f, dtype=torch.float32,
                           device=x.device)
    grad = torch.empty(desc.n_entries * f, dtype=torch.float32,
                       device=x.device)        # zeroed by the kernels
    u = axis = None
    if mode != EXACT:
        u, axis, _keep = _check_draws(desc, draws, n,
                                      j if mode == FETCHED else 0, x.device)
    lib = _lib()
    ints, scales = desc.c_args
    n_keys = lib.grid_deposit_count(desc.n_dims, n, active, mode, j)
    if n_keys >= 1 << 31:
        raise ValueError(f"table_gradient: {n_keys} deposits, the sort's "
                         f"positions are int32")
    scratch = (ctypes.c_longlong * 5)()
    lib.grid_deposit_scratch(desc.n_dims, f, desc.n_entries, n, active, mode,
                             j, scratch)
    _, n_counts, n_totals, passes, record = scratch
    # one int32 scratch: rows and positions (ping-ponged between the
    # passes where there are two or more), the tiles' counts, the digits'
    # totals and the number of deposits kept
    n_bufs = min(passes, 2)
    ints32 = torch.empty(2 * n_bufs * n_keys + n_counts + n_totals + 1,
                         dtype=torch.int32, device=x.device)
    bufs = ints32[:2 * n_bufs * n_keys].view(n_bufs, 2, n_keys)
    pairs = [(b[0].data_ptr(), b[1].data_ptr()) for b in bufs]
    k0, v0 = pairs[0]
    k1, v1 = pairs[1] if n_bufs == 2 else (None, None)
    counts, totals, n_valid = torch.split(ints32[2 * n_bufs * n_keys:],
                                          [n_counts, n_totals, 1])
    # each (level, point)'s gradient row, weights and exact axis
    rec = torch.empty(active * n * record, dtype=torch.float32,
                      device=x.device)
    with torch.cuda.device(x.device):
        err = lib.grid_table_gradient_launch(
            ints, scales, x.data_ptr(), u, axis, grad_out.data_ptr(),
            rec.data_ptr(), counts.data_ptr(), totals.data_ptr(), k0, v0,
            k1, v1, n_valid.data_ptr(), grad.data_ptr(), desc.n_entries, n,
            active, mode, j, torch.cuda.current_stream(x.device).cuda_stream)
    _raise("grid table_gradient", err)
    _count(table_gradient, MODE_NAMES[mode])
    return grad


table_gradient.launches = 0
table_gradient.launches_by_variant = {}


def input_gradient(desc: GridDesc, params: torch.Tensor, x: torch.Tensor,
                   grad_out: torch.Tensor, active: int) -> torch.Tensor:
    """d(loss)/dx (N, d) of the exact encode over the `active` levels."""
    n = _check_points(desc, x)
    _check_table(desc, params, x.device)
    _check("grad_out", grad_out, torch.float32,
           (n, desc.n_levels * desc.n_features), x.device)
    grad_x = torch.zeros(n, desc.n_dims, dtype=torch.float32,
                         device=x.device)
    if n == 0 or active < 1:
        return grad_x
    ints, scales = desc.c_args
    with torch.cuda.device(x.device):
        err = _lib().grid_input_gradient_launch(
            ints, scales, x.data_ptr(), params.data_ptr(),
            grad_out.data_ptr(), grad_x.data_ptr(), n, active,
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise("grid input_gradient", err)
    _count(input_gradient, "exact")
    return grad_x


input_gradient.launches = 0
input_gradient.launches_by_variant = {}

#: the three wrappers, for counting
WRAPPERS = (encode_forward, table_gradient, input_gradient)


def launch_counts() -> dict:
    """{"encode_forward[exact]": n, ...}: every wrapper's launches by
    variant so far."""
    return {f"{fn.__name__}[{v}]": c for fn in WRAPPERS
            for v, c in sorted(fn.launches_by_variant.items())}


def reset_counts() -> None:
    for fn in WRAPPERS:
        fn.launches = 0
        fn.launches_by_variant.clear()
