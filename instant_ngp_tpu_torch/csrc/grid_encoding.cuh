// The multiresolution grid's index walk, shared by every kernel of
// grid_encoding.cu: a point's lower corner and interpolation weights at one
// level, a corner's table row, and the corners the exact and the
// stochastic-corner encodes fetch. Each function repeats, operation for
// operation and rounding for rounding, the plain version in
// ops/grid_encoding.py (`_level_weights`, `_index`, `_level_corners`,
// `_stochastic_corners`): every product and sum is an explicit
// round-to-nearest intrinsic, so nvcc contracts nothing into an FMA and
// the weights have the plain version's bits.
#pragma once

#include <cstdint>

namespace ngp_grid {

constexpr int kMaxLevels = 32;
constexpr int kHash = 0, kDense = 1, kTiled = 2;
constexpr int kLinear = 0, kSmoothstep = 1, kNearest = 2;
// the hash primes, multiplied in uint32 arithmetic (the plain version
// masks the int64 product to its low 32 bits, which are the same)
constexpr uint32_t kPrime1 = 2654435761u, kPrime2 = 805459861u;

// One encoding's levels (GridEncoding.levels), passed by value to every
// kernel. `scale` is the f32-rounded per-level scale the positions use.
struct Grid {
  int n_dims, n_levels, n_features, grid_type, interpolation;
  float scale[kMaxLevels];
  int res[kMaxLevels], size[kMaxLevels], offset[kMaxLevels],
      hashed[kMaxLevels];
};

// The bit of axis k in corner c: corners are enumerated as
// meshgrid(arange(2) x D, indexing="ij"), the first axis the high bit.
template <int D>
__device__ __forceinline__ int corner_bit(int c, int k) {
  return (c >> (D - 1 - k)) & 1;
}

// pos = x * scale + 0.5; pos0 = floor(pos); w = the interpolant of
// pos - pos0 (Linear, Smoothstep 3t^2 - 2t^3, Nearest round-half-even);
// dw = dw/dpos (1, 6t(1-t), 0).
template <int D>
__device__ __forceinline__ void level_point(const Grid& g, int lvl,
                                            const float* xp, int* pos0,
                                            float* w, float* dw) {
  const float s = g.scale[lvl];
#pragma unroll
  for (int k = 0; k < D; ++k) {
    const float p = __fadd_rn(__fmul_rn(xp[k], s), 0.5f);
    const float f = floorf(p);
    float t = __fsub_rn(p, f);
    pos0[k] = static_cast<int>(f);
    if (g.interpolation == kSmoothstep) {
      dw[k] = __fmul_rn(__fmul_rn(6.0f, t), __fsub_rn(1.0f, t));
      t = __fmul_rn(__fmul_rn(t, t), __fsub_rn(3.0f, __fmul_rn(2.0f, t)));
    } else if (g.interpolation == kNearest) {
      dw[k] = 0.0f;
      t = rintf(t);
    } else {
      dw[k] = 1.0f;
    }
    w[k] = t;
  }
}

// The table row of integer grid coordinates c at one level: the spatial
// hash (XOR of uint32 coordinate * prime) where the level is hashed, else
// the dense index of the clamped (Dense, Hash) or wrapped (Tiled)
// coordinates; then % size + offset. A hashed size is a power of two (a
// mask then), and a dense index is below its level's size (which is
// res^d rounded up to 8), so the divisions are skipped where they would
// change nothing: a 64-bit remainder is some 70 instructions.
template <int D>
__device__ __forceinline__ int corner_row(const Grid& g, int lvl,
                                          const int* c) {
  if (g.hashed[lvl]) {
    uint32_t h = static_cast<uint32_t>(c[0]);
    h ^= static_cast<uint32_t>(c[1]) * kPrime1;
    if (D == 3) h ^= static_cast<uint32_t>(c[D - 1]) * kPrime2;
    const uint32_t size = static_cast<uint32_t>(g.size[lvl]);
    return static_cast<int>((size & (size - 1)) == 0 ? h & (size - 1)
                                                     : h % size) +
           g.offset[lvl];
  }
  const int res = g.res[lvl];
  long long lin = 0, stride = 1;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    int ck = c[k];
    if (g.grid_type == kTiled) {
      ck %= res;
      if (ck < 0) ck += res;
    } else {
      ck = min(max(ck, 0), res - 1);
    }
    lin += static_cast<long long>(ck) * stride;
    stride *= res;
  }
  if (lin >= g.size[lvl]) lin %= g.size[lvl];
  return static_cast<int>(lin) + g.offset[lvl];
}

// The d-linear weight of corner c: the product, axis 0 first, of w or
// 1 - w by the corner's bit.
template <int D>
__device__ __forceinline__ float corner_weight(const float* w, int c) {
  float weight = corner_bit<D>(c, 0) ? w[0] : __fsub_rn(1.0f, w[0]);
#pragma unroll
  for (int k = 1; k < D; ++k)
    weight = __fmul_rn(weight,
                       corner_bit<D>(c, k) ? w[k] : __fsub_rn(1.0f, w[k]));
  return weight;
}

// Corner `combo` (0 .. 2^j - 1) of the 2^j that the stochastic-corner
// encode fetches with j exact axes: j = 1, axis a exact (it takes the
// combination's bit); j = 2, axis a sampled and the other two exact, bit 0
// to axis a + 1 and bit 1 to axis a + 2 (cyclic). The other axes take
// their sampled bit. Writes the corner's coordinates and returns its
// weight, the product of w or 1 - w over the exact axes (1 elsewhere).
template <int D>
__device__ __forceinline__ float fetched_corner(int j, int a, int combo,
                                                const int* pos0,
                                                const float* w,
                                                const int* bern, int* c) {
  float weight = 1.0f;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    const bool exact = j == 1 ? k == a : k != a;
    const bool low = j == 1 ? exact : (k - a - 1 + 2 * D) % D == 0;
    const int e_bit = low ? combo & 1 : (combo >> 1) & 1;
    c[k] = pos0[k] + (exact ? e_bit : bern[k]);
    const float wk = exact ? (e_bit ? w[k] : __fsub_rn(1.0f, w[k])) : 1.0f;
    weight = k == 0 ? wk : __fmul_rn(weight, wk);
  }
  return weight;
}

}  // namespace ngp_grid
