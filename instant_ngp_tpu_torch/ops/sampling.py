"""Low-discrepancy and uniform 2D samples, vectorised over a tensor of
indices (counterpart of instant_ngp_tpu/ops/sampling.py).

- `sobol`, `ld_samples`: Burley's hash-shuffled, Owen-scrambled Sobol
  sequence [Burley 2019, JCGT 9(4)], direction numbers of dims 0-4 from
  that paper;
- `halton`, `halton23`: radical inverses in base 2 and 3;
- `stratify2`: uniform samples spread over a sqrt(B) x sqrt(B) grid;
- `generate_2d_samples`: the training positions of Image mode by
  `random_mode` (Random, Halton, Sobol, Stratified);
- `ld_pixel_offset`: the per-spp subpixel jitter of a render.

The sequences are uint32 arithmetic with wraparound. torch has little
uint32 arithmetic, so the values live in int64 tensors holding 32-bit
words, masked after every operation that can leave 32 bits; products are
taken in 16-bit halves so that no int64 product overflows.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

_M32 = 0xFFFFFFFF

# Sobol direction numbers, dims 0-4 (Burley 2019, Listing 3)
_SOBOL_DIRECTIONS = (
    tuple(1 << (31 - b) for b in range(32)),
    (0x80000000, 0xc0000000, 0xa0000000, 0xf0000000,
     0x88000000, 0xcc000000, 0xaa000000, 0xff000000,
     0x80800000, 0xc0c00000, 0xa0a00000, 0xf0f00000,
     0x88880000, 0xcccc0000, 0xaaaa0000, 0xffff0000,
     0x80008000, 0xc000c000, 0xa000a000, 0xf000f000,
     0x88008800, 0xcc00cc00, 0xaa00aa00, 0xff00ff00,
     0x80808080, 0xc0c0c0c0, 0xa0a0a0a0, 0xf0f0f0f0,
     0x88888888, 0xcccccccc, 0xaaaaaaaa, 0xffffffff),
    (0x80000000, 0xc0000000, 0x60000000, 0x90000000,
     0xe8000000, 0x5c000000, 0x8e000000, 0xc5000000,
     0x68800000, 0x9cc00000, 0xee600000, 0x55900000,
     0x80680000, 0xc09c0000, 0x60ee0000, 0x90550000,
     0xe8808000, 0x5cc0c000, 0x8e606000, 0xc5909000,
     0x6868e800, 0x9c9c5c00, 0xeeee8e00, 0x5555c500,
     0x8000e880, 0xc0005cc0, 0x60008e60, 0x9000c590,
     0xe8006868, 0x5c009c9c, 0x8e00eeee, 0xc5005555),
    (0x80000000, 0xc0000000, 0x20000000, 0x50000000,
     0xf8000000, 0x74000000, 0xa2000000, 0x93000000,
     0xd8800000, 0x25400000, 0x59e00000, 0xe6d00000,
     0x78080000, 0xb40c0000, 0x82020000, 0xc3050000,
     0x208f8000, 0x51474000, 0xfbea2000, 0x75d93000,
     0xa0858800, 0x914e5400, 0xdbe79e00, 0x25db6d00,
     0x58800080, 0xe54000c0, 0x79e00020, 0xb6d00050,
     0x800800f8, 0xc00c0074, 0x200200a2, 0x50050093),
    (0x80000000, 0x40000000, 0x20000000, 0xb0000000,
     0xf8000000, 0xdc000000, 0x7a000000, 0x9d000000,
     0x5a800000, 0x2fc00000, 0xa1600000, 0xf0b00000,
     0xda880000, 0x6fc40000, 0x81620000, 0x40bb0000,
     0x22878000, 0xb3c9c000, 0xfb65a000, 0xddb2d000,
     0x78022800, 0x9c0b3c00, 0x5a0fb600, 0x2d0ddb00,
     0xa2878080, 0xf3c9c040, 0xdb65a020, 0x6db2d0b0,
     0x800228f8, 0x400b3cdc, 0x200fb67a, 0xb00ddb9d),
)


def _u32(index) -> torch.Tensor:
    """Indices (any integer tensor, array or int) -> int64 words mod 2^32."""
    return torch.as_tensor(index).to(torch.int64) & _M32


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """x * c mod 2^32 for 32-bit words x and a 32-bit constant c."""
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (hi + x * (c & 0xFFFF)) & _M32


def sobol(index, dim: int) -> torch.Tensor:
    """The raw Sobol word of each index in dimension `dim` (0-4)."""
    idx = _u32(index)
    x = torch.zeros_like(idx)
    for bit, d in enumerate(_SOBOL_DIRECTIONS[dim]):
        x = x ^ (((idx >> bit) & 1) * d)
    return x


def _reverse_bits(x: torch.Tensor) -> torch.Tensor:
    x = ((x & 0xAAAAAAAA) >> 1) | ((x & 0x55555555) << 1)
    x = ((x & 0xCCCCCCCC) >> 2) | ((x & 0x33333333) << 2)
    x = ((x & 0xF0F0F0F0) >> 4) | ((x & 0x0F0F0F0F) << 4)
    x = ((x & 0xFF00FF00) >> 8) | ((x & 0x00FF00FF) << 8)
    return ((x >> 16) | (x << 16)) & _M32


def _laine_karras_permutation(x: torch.Tensor, seed: int) -> torch.Tensor:
    x = (x + (seed & _M32)) & _M32
    for c in (0x6C50B47C, 0xB82F1E52, 0xC7AFE638, 0x8D22F6E6):
        x = x ^ _mul32(x, c)
    return x


def _nested_uniform_scramble(x: torch.Tensor, seed: int) -> torch.Tensor:
    return _reverse_bits(_laine_karras_permutation(_reverse_bits(x), seed))


def _hash_combine(seed: int, v: int) -> int:
    seed &= _M32
    return (seed ^ ((v + ((seed << 6) & _M32) + (seed >> 2)) & _M32)) & _M32


def _to_unit(x: torch.Tensor) -> torch.Tensor:
    """32-bit words -> float32 in [0, 1): the word rounded to float32, times
    2^-32 (exact), as the JAX package converts."""
    return x.to(torch.float32) * (1.0 / (1 << 32))


def ld_samples(index, seed: int, n_dims: int = 2) -> torch.Tensor:
    """(N,) sample indices -> (N, n_dims) float32 shuffled, scrambled Sobol
    points in [0, 1)^n_dims (n_dims <= 5)."""
    shuffled = _nested_uniform_scramble(_u32(index), seed)
    return torch.stack([
        _to_unit(_nested_uniform_scramble(sobol(shuffled, d),
                                          _hash_combine(seed, d)))
        for d in range(n_dims)], dim=-1)


def halton(index, base: int, n_digits: int = 0) -> torch.Tensor:
    """(N,) indices -> (N,) float32 radical inverses in `base`; n_digits 0
    takes enough digits for 2^32 indices."""
    if n_digits == 0:
        n_digits = int(np.ceil(32 / np.log2(base)))
    idx = _u32(index)
    result = torch.zeros(idx.shape, dtype=torch.float32, device=idx.device)
    f = torch.ones((), dtype=torch.float32, device=idx.device)
    for _ in range(n_digits):
        f = f / base
        result = result + f * (idx % base).to(torch.float32)
        idx = idx // base
    return result


def halton23(index) -> torch.Tensor:
    """(N,) indices -> (N, 2) Halton points in bases 2 and 3."""
    return torch.stack([halton(index, 2), halton(index, 3)], dim=-1)


def stratify2(samples: torch.Tensor, log2_batch_size: int) -> torch.Tensor:
    """(N, 2) uniform samples -> one per cell of a sqrt(B) x sqrt(B) grid:
    batch position i goes to cell (i mod s, i div s), s =
    2^(log2_batch_size / 2) (an even log2_batch_size)."""
    log2_size = log2_batch_size // 2
    size = 1 << log2_size
    i = torch.arange(samples.shape[0], device=samples.device) \
        & ((1 << log2_batch_size) - 1)
    cx = (i & (size - 1)).to(torch.float32)
    cy = (i >> log2_size).to(torch.float32)
    inv = torch.tensor(1.0 / size, dtype=torch.float32)
    return torch.stack([samples[:, 0] * inv + cx * inv,
                        samples[:, 1] * inv + cy * inv], dim=-1)


def generate_2d_samples(mode: str, n: int, step: int, seed: int,
                        uniforms: Optional[torch.Tensor] = None,
                        generator: Optional[torch.Generator] = None,
                        device=None) -> torch.Tensor:
    """The n training positions (n, 2) of one step, by `mode`: Halton and
    Sobol are the sequence from index n * step (mod 2^32), on `device`;
    Random and Stratified take `uniforms` (n, 2), or draw them from
    `generator` on its device, and Stratified spreads them with
    `stratify2` where n is a power of 4 (else they stay as drawn)."""
    if mode in ("Halton", "Sobol"):
        idx = (torch.arange(n, device=device) + n * step) & _M32
        return halton23(idx) if mode == "Halton" else ld_samples(idx, seed)
    if mode not in ("Random", "Stratified"):
        raise ValueError(f"unknown random mode: {mode}")
    if uniforms is None:
        uniforms = torch.rand(n, 2, generator=generator,
                              device=generator.device)
    log2 = int(np.log2(n))
    if mode == "Stratified" and (1 << log2) == n and log2 % 2 == 0:
        return stratify2(uniforms, log2)
    return uniforms


def ld_pixel_offset(spp: int, seed: int = 0xDEADBEEF) -> Tuple[float, float]:
    """Subpixel jitter of sample `spp`: 0.5 - ld(0) + ld(spp)."""
    base, cur = ld_samples(torch.tensor([0, spp]), seed)
    return tuple(float(v) for v in 0.5 - base + cur)
