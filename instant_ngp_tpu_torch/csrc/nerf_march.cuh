// The NeRF march's device math, shared by the kernels that march rays
// through the cascaded occupancy grid: the stepping space of cone steps,
// the box entry, a sample's mip and the occupancy bit at a position. Each
// function repeats, operation for operation and rounding for rounding, the
// plain version as PyTorch runs it on CUDA (nerf/march.py and
// nerf/render.py::_march_start):
//   - every product, sum and quotient is an explicit round-to-nearest
//     intrinsic, so nvcc contracts nothing into an FMA (o + t*d is two
//     roundings, as two PyTorch kernels);
//   - a division of a tensor by a Python number is a product with the
//     number's f32 reciprocal (PyTorch's CUDA kernel for a CPU scalar
//     divisor), a division by a tensor a true division, `1.0 / x` the
//     reciprocal (Tensor.__rtruediv__);
//   - expf, logf, exp2f and frexpf are the library's accurate functions
//     (the build has no fast-math flag), which PyTorch's kernels call.
// The Morton index runs in uint32 arithmetic: the plain version masks its
// int64 products to their low 32 bits, which are the same.
#pragma once

#include <cstdint>

namespace ngp_march {

constexpr int kGridSize = 128;                       // cells a cascade side
constexpr uint32_t kCascadeBytes = kGridSize * kGridSize * kGridSize / 8;

// The stepping space of march.py: `cone` 0 is the uniform step
// MIN_CONE_STEPSIZE (cone_angle <= 1e-5); else log1p_c, a, b, at, bt are
// march.py::_stepping_constants as the device computed them.
struct Stepping {
  int cone;
  float min_step, max_step;    // f32 of MIN/MAX_CONE_STEPSIZE
  float inv_min, inv_max;      // their f32 reciprocals
  float log1p_c, a, b, at, bt;
};

__device__ __forceinline__ float to_stepping_space(float t,
                                                   const Stepping& s) {
  if (!s.cone) return __fmul_rn(t, s.inv_min);
  if (t <= s.at) return __fadd_rn(__fmul_rn(__fsub_rn(t, s.at), s.inv_min),
                                  s.a);
  if (t <= s.bt) return __fdiv_rn(logf(fmaxf(t, 1e-30f)), s.log1p_c);
  return __fadd_rn(__fmul_rn(__fsub_rn(t, s.bt), s.inv_max), s.b);
}

__device__ __forceinline__ float from_stepping_space(float n,
                                                     const Stepping& s) {
  if (!s.cone) return __fmul_rn(n, s.min_step);
  if (n <= s.a) return __fadd_rn(__fmul_rn(__fsub_rn(n, s.a), s.min_step),
                                 s.at);
  if (n <= s.b) return expf(__fmul_rn(fminf(fmaxf(n, s.a), s.b),
                                      s.log1p_c));
  return __fadd_rn(__fmul_rn(__fsub_rn(n, s.b), s.max_step), s.bt);
}

// calc_dt: one step on from t, minus t
__device__ __forceinline__ float calc_dt(float t, const Stepping& s) {
  return __fsub_rn(from_stepping_space(
                       __fadd_rn(to_stepping_space(t, s), 1.0f), s), t);
}

// ray_intersect_aabb, tmin clamped at 0: -> whether the ray meets the
// box (tmax >= tmin), and tmin.
__device__ __forceinline__ bool box_entry(const float o[3], const float d[3],
                                          const float lo[3],
                                          const float hi[3], float* tmin) {
  float t_in = 0.0f, t_out = 0.0f;
  for (int i = 0; i < 3; ++i) {
    const float tiny = d[i] < 0.0f ? -1e-12f : 1e-12f;
    const float idir = __frcp_rn(fabsf(d[i]) < 1e-12f ? tiny : d[i]);
    const float t1 = __fmul_rn(__fsub_rn(lo[i], o[i]), idir);
    const float t2 = __fmul_rn(__fsub_rn(hi[i], o[i]), idir);
    t_in = i ? fmaxf(t_in, fminf(t1, t2)) : fminf(t1, t2);
    t_out = i ? fminf(t_out, fmaxf(t1, t2)) : fmaxf(t1, t2);
  }
  *tmin = fmaxf(t_in, 0.0f);
  return t_out >= *tmin;
}

__device__ __forceinline__ int frexp_exponent(float x) {
  int e;
  frexpf(x, &e);
  return e;
}

// mip_from_dt(dt, pos, max_mip), clamped to [0, max_mip]: the smallest
// cascade holding pos, raised to the one whose cells match the step
__device__ __forceinline__ int mip_at(float dt, const float p[3],
                                      int max_mip) {
  const float m = fmaxf(fmaxf(fabsf(__fsub_rn(p[0], 0.5f)),
                              fabsf(__fsub_rn(p[1], 0.5f))),
                        fabsf(__fsub_rn(p[2], 0.5f)));
  int mip = min(max(frexp_exponent(m) + 1, 0), max_mip);
  const float d = __fmul_rn(__fmul_rn(dt, 2.0f), float(kGridSize));
  if (!(d < 1.0f)) mip = min(max(mip, frexp_exponent(d)), max_mip);
  return mip;
}

__device__ __forceinline__ uint32_t expand_bits(uint32_t v) {
  v = (v * 0x00010001u) & 0xFF0000FFu;
  v = (v * 0x00000101u) & 0x0F00F00Fu;
  v = (v * 0x00000011u) & 0xC30C30C3u;
  v = (v * 0x00000005u) & 0x49249249u;
  return v;
}

// density_grid_occupied_at: the bit of pos's cell in cascade `mip` of the
// bitfield (LSB first within a byte); false outside the cascade
__device__ __forceinline__ bool occupied_at(const float p[3], int mip,
                                            const uint8_t* bitfield) {
  const float scale = exp2f(-float(mip));
  uint32_t cell[3];
  for (int i = 0; i < 3; ++i) {
    const float c = floorf(__fmul_rn(
        __fadd_rn(__fmul_rn(__fsub_rn(p[i], 0.5f), scale), 0.5f),
        float(kGridSize)));
    if (!(c >= 0.0f && c < float(kGridSize))) return false;
    cell[i] = uint32_t(c);
  }
  const uint32_t idx = expand_bits(cell[0]) | (expand_bits(cell[1]) << 1) |
                       (expand_bits(cell[2]) << 2);
  const uint8_t byte =
      __ldg(bitfield + (idx >> 3) + uint32_t(mip) * kCascadeBytes);
  return (byte >> (idx & 7u)) & 1u;
}

}  // namespace ngp_march
