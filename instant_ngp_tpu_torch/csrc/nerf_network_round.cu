// The wavefront renderer's RGB-net input rows on Hopper (sm_90a): one
// kernel writes each sample's row [16 density-net outputs | 16 SH basis
// values of its ray's direction] of a network round, and the raw density
// column the composite reads.
//
// It replaces no TPU kernel. The JAX package assembles these rows with
// plain XLA (instant_ngp_tpu/nerf/model.py::apply_components and
// ops/encodings.py::sh_basis). The port's plain version is the round of
// nerf/render.py::_eval_network: the per-ray direction expanded to every
// sample and warped, the SH basis built column by column (some fifty
// elementwise PyTorch kernels) and stacked, concatenated with the density
// outputs, and the outputs concatenated again. On an H100 those copies were
// most of a frame's device time (~20 of ~38 ms on the render benchmark),
// while the work is one pass over the density outputs.
//
// What bounds it: bytes. A row reads the density net's 64 bytes and writes
// 128 bytes of row and 4 of raw density; a ray's 12 bytes of direction are
// read by its K rows and stay in the caches. Eight threads make a row: the
// first four copy a float4 of the density outputs each, the other four
// compute four SH values each, so a warp writes four whole 128-byte rows,
// and every store is a full, aligned float4 of a contiguous span.
//
// The values are the plain round's bits: the direction warped and unwarped
// as the plain round does ((d + 1) * 0.5, then * 2 - 1), then sh_basis(4)
// term by term, each product, sum and difference rounded once
// (__fmul_rn / __fadd_rn / __fsub_rn: no contraction into an FMA) in
// PyTorch's left-to-right order, each constant the float32 of the Python
// number, as PyTorch's CUDA kernels take a Python scalar.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlock = 256;
// threads a row: 4 copy the density outputs, 4 compute the SH basis
constexpr int kLanes = 8;

__device__ __forceinline__ float f32(double c) {
  return static_cast<float>(c);
}

// SH degree 4 of the unit direction (x, y, z), values 4q .. 4q + 3
// (ops/encodings.py::sh_basis, degree 4)
__device__ __forceinline__ float4 sh_quarter(float x, float y, float z,
                                             int q) {
  const float x2 = __fmul_rn(x, x), y2 = __fmul_rn(y, y),
              z2 = __fmul_rn(z, z);
  if (q == 0)
    return make_float4(f32(0.28209479177387814),
                       __fmul_rn(f32(-0.48860251190291987), y),
                       __fmul_rn(f32(0.48860251190291987), z),
                       __fmul_rn(f32(-0.48860251190291987), x));
  if (q == 1)
    return make_float4(
        __fmul_rn(f32(1.0925484305920792), __fmul_rn(x, y)),
        __fmul_rn(f32(-1.0925484305920792), __fmul_rn(y, z)),
        __fsub_rn(__fmul_rn(f32(0.94617469575755997), z2),
                  f32(0.31539156525251999)),
        __fmul_rn(f32(-1.0925484305920792), __fmul_rn(x, z)));
  // 1 - 5 z^2, as both of its terms compute it
  const float one_5z2 = __fsub_rn(1.0f, __fmul_rn(5.0f, z2));
  if (q == 2)
    return make_float4(
        __fsub_rn(__fmul_rn(f32(0.54627421529603959), x2),
                  __fmul_rn(f32(0.54627421529603959), y2)),
        __fmul_rn(__fmul_rn(f32(0.59004358992664352), y),
                  __fadd_rn(__fmul_rn(-3.0f, x2), y2)),
        __fmul_rn(__fmul_rn(__fmul_rn(f32(2.8906114426405538), x), y), z),
        __fmul_rn(__fmul_rn(f32(0.45704579946446572), y), one_5z2));
  return make_float4(
      __fmul_rn(__fmul_rn(f32(0.3731763325901154), z),
                __fsub_rn(__fmul_rn(5.0f, z2), 3.0f)),
      __fmul_rn(__fmul_rn(f32(0.45704579946446572), x), one_5z2),
      __fmul_rn(__fmul_rn(f32(1.4453057213202769), z), __fsub_rn(x2, y2)),
      __fmul_rn(__fmul_rn(f32(0.59004358992664352), x),
                __fadd_rn(-x2, __fmul_rn(3.0f, y2))));
}

// the plain round's direction: warped to [0, 1] for the encoding, which
// unwarps it
__device__ __forceinline__ float unwarp(float d) {
  return __fsub_rn(__fmul_rn(__fmul_rn(__fadd_rn(d, 1.0f), 0.5f), 2.0f),
                   1.0f);
}

__global__ void __launch_bounds__(kBlock)
    rgb_net_rows(const float4* __restrict__ density,
                 const float* __restrict__ dirs, int n_rows, int k,
                 int row0, float4* __restrict__ out,
                 float* __restrict__ raw_density) {
  const long long i = blockIdx.x * static_cast<long long>(kBlock) +
                      threadIdx.x;
  const int r = static_cast<int>(i / kLanes);
  const int lane = static_cast<int>(i % kLanes);
  if (r >= n_rows) return;
  float4 v;
  if (lane < 4) {
    v = __ldg(density + 4 * static_cast<long long>(r) + lane);
    if (lane == 0 && raw_density != nullptr) raw_density[r] = v.x;
  } else {
    const float* d = dirs + 3 * static_cast<long long>(
                                    static_cast<unsigned>(row0 + r) /
                                    static_cast<unsigned>(k));
    v = sh_quarter(unwarp(__ldg(d)), unwarp(__ldg(d + 1)),
                   unwarp(__ldg(d + 2)), lane - 4);
  }
  out[8 * static_cast<long long>(r) + lane] = v;
}

}  // namespace

// density (n_rows, 16) and out (n_rows, 32) float32, 16-byte aligned; dirs
// (n_rays, 3) float32; row r of the call is row row0 + r of the round, whose
// ray is (row0 + r) / k; raw_density (n_rows,) or null.
extern "C" int nerf_rgb_net_rows_launch(const float* density,
                                        const float* dirs, long long n_rows,
                                        long long n_rays, int k,
                                        long long row0, float* out,
                                        float* raw_density, void* stream) {
  if (n_rows < 1 || k < 1 || row0 < 0 ||
      row0 + n_rows > n_rays * static_cast<long long>(k) ||
      n_rays * static_cast<long long>(k) >= (1LL << 31) ||
      reinterpret_cast<uintptr_t>(density) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return cudaErrorInvalidValue;
  const long long blocks = (n_rows * kLanes + kBlock - 1) / kBlock;
  rgb_net_rows<<<static_cast<unsigned>(blocks), kBlock, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(density), dirs,
      static_cast<int>(n_rows), k, static_cast<int>(row0),
      reinterpret_cast<float4*>(out), raw_density);
  return cudaGetLastError();
}
