// The wavefront renderer's march and pack on Hopper (sm_90a): one thread a
// ray walks its march candidates in order and writes each emitted t into
// the next slot of the ray's packed row.
//
// It replaces no TPU kernel. The JAX package marches with plain XLA
// (instant_ngp_tpu/nerf/sampler.py::march_rays, :213, and
// nerf/render.py::_march_and_pack, :238); the port's plain version is
// nerf/render.py::WavefrontRenderer._march_and_pack_plain, which builds a
// dense (rays, n_march) candidate plane of some sixty elementwise PyTorch
// kernels a chunk of rays (each reads and writes 4-8 bytes a candidate in
// device memory), then scatters it into the packed rows. That plane was
// most of a frame's device time, while the work is small: a ray visits its
// candidates in order, and each visit is register arithmetic and one byte
// of a bitfield (2 MB at 8 cascades) that stays in the L2.
//
// What bounds it on this card: instruction issue, not bytes. A 2^19-ray
// tile of the render benchmark's shell reads ~12 MB of rays and writes 5
// bytes a kept candidate and the zero fill, ~101 MB in all (0.03 ms at
// 3.35 TB/s); its 331 M candidate visits each run a loop iteration of at
// least 154 SASS instructions (the fewest of one that reads the bitfield,
// cone 0), 1.52 ms at one warp instruction a clock on each of an SM's four
// schedulers, and the kernel takes 2.1 ms of it on an H100 (72 %). So the
// design spends nothing on memory: one thread a ray (adjacent pixels
// stop together: 99 % of a warp's lanes stay busy), the Morton index in
// 32-bit arithmetic, no shared memory. A ray stops at its max_samples-th emission
// or as soon as a candidate lies past the box's far face on some axis, in
// the axis' direction of travel (d <= 0 and p < lo, or d >= 0 and p > hi):
// t does not decrease from one candidate to the next (the stepping space
// moves by whole units; each branch of from_stepping_space is monotone and
// its exp branch moves by >= 0.19 % a step, far above expf's 2 ulp), so
// that coordinate, o + t*d rounded twice, is monotone in the candidate and
// stays outside: no later candidate is inside the box, and the rows are
// those of the full plane. Empty cells are not skipped: at the render
// benchmark's 2^19-ray tile the walk (0.33 G candidate visits) takes ~2.1 ms
// on an H100, too little of a ~50 ms frame for a skip to pay for its
// branches.
//
// The columns a round of `chunk` reads past a ray's last candidate are
// zero-filled (a non-finite t there would reach acc_depth through w * t);
// columns past that round are never read and are not written. Device math
// shared with other marches is nerf_march.cuh.

#include <cuda_runtime.h>

#include <cstdint>

#include "nerf_march.cuh"

namespace {

using namespace ngp_march;

constexpr int kBlock = 128;

__global__ void __launch_bounds__(kBlock)
    march_and_pack(const float* __restrict__ origins,
                   const float* __restrict__ dirs,
                   const uint8_t* __restrict__ bitfield,
                   const float* __restrict__ aabb_min,
                   const float* __restrict__ aabb_max, Stepping s,
                   int max_mip, int n_march, int max_samples, int n_cols,
                   int chunk, long long n_rays, float* __restrict__ ts,
                   uint8_t* __restrict__ ok, long long* __restrict__ n_cand,
                   uint8_t* __restrict__ valid) {
  const long long r = blockIdx.x * static_cast<long long>(kBlock) +
                      threadIdx.x;
  if (r >= n_rays) return;
  float o[3], d[3], lo[3], hi[3];
  for (int i = 0; i < 3; ++i) {
    o[i] = origins[3 * r + i];
    d[i] = dirs[3 * r + i];
    lo[i] = aabb_min[i];
    hi[i] = aabb_max[i];
  }
  float* row_t = ts + r * n_cols;
  uint8_t* row_ok = ok + r * n_cols;
  float tmin;
  const bool hit = box_entry(o, d, lo, hi, &tmin);
  int count = 0;
  if (hit) {
    // _march_start: half a step past the entry; candidate k sits at
    // from_stepping_space(s0 + k)
    const float s0 = to_stepping_space(
        from_stepping_space(__fadd_rn(to_stepping_space(tmin, s), 0.5f), s),
        s);
    for (int k = 0; k < n_march; ++k) {
      const float t = from_stepping_space(__fadd_rn(s0, float(k)), s);
      float p[3];
      bool inside = true, past = false;
      for (int i = 0; i < 3; ++i) {
        p[i] = __fadd_rn(o[i], __fmul_rn(t, d[i]));
        past |= (d[i] <= 0.0f && p[i] < lo[i]) ||
                (d[i] >= 0.0f && p[i] > hi[i]);
        inside &= p[i] >= lo[i] && p[i] <= hi[i];
      }
      if (past) break;
      if (!inside || !occupied_at(p, mip_at(calc_dt(t, s), p, max_mip),
                                  bitfield))
        continue;
      row_t[count] = t;
      row_ok[count] = 1;
      if (++count == max_samples) break;
    }
  }
  valid[r] = hit;
  n_cand[r] = count;
  const int end = (count + chunk - 1) / chunk * chunk;
  for (int j = count; j < end; ++j) {
    row_t[j] = 0.0f;
    row_ok[j] = 0;
  }
}

}  // namespace

// consts: the f32 [min_step, max_step, inv_min, inv_max, log1p_c, a, b, at,
// bt] of ngp_march::Stepping (the last five read only where cone != 0).
extern "C" int nerf_march_pack_launch(
    const float* origins, const float* dirs, const uint8_t* bitfield,
    const float* aabb_min, const float* aabb_max, const float* consts,
    int cone, int max_mip, int n_march, int max_samples, int n_cols,
    int chunk, long long n_rays, float* ts, uint8_t* ok, long long* n_cand,
    uint8_t* valid, void* stream) {
  if (n_rays < 1 || n_march < 0 || max_samples < 1 || chunk < 1 ||
      n_cols % chunk != 0 || max_samples > n_cols || max_mip < 0 ||
      max_mip > 7)
    return cudaErrorInvalidValue;
  const Stepping s{cone != 0, consts[0], consts[1], consts[2], consts[3],
                   consts[4], consts[5],  consts[6], consts[7], consts[8]};
  const long long blocks = (n_rays + kBlock - 1) / kBlock;
  march_and_pack<<<static_cast<unsigned>(blocks), kBlock, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      origins, dirs, bitfield, aabb_min, aabb_max, s, max_mip, n_march,
      max_samples, n_cols, chunk, n_rays, ts, ok, n_cand, valid);
  return cudaGetLastError();
}
