// The multiresolution hash/dense/tiled grid encode on Hopper (sm_90a): the
// exact and the stochastic-corner forward, the table gradient of every
// variant as a repeatable sorted deposit, and the input gradient of the
// exact encode.
//
// Stands in for the JAX package's XLA encode, instant_ngp_tpu/ops/
// grid_encoding.py: `apply` (the exact encode and its custom VJP) and
// `_build_stochastic_call` (the stochastic-corner encode and its VJP). The
// JAX package has no TPU kernel for them (its Pallas grid kernel was
// removed for reasons of the TPU alone). Their plain PyTorch versions are
// the `_*_plain` methods of ops/grid_encoding.py::GridEncoding; the
// wrappers in ops/kernels/grid_kernels.py validate every argument before
// calling the launchers below. The index walk is grid_encoding.cuh.
//
// What bounds them on this card: bytes, and in practice where the gathers
// are served from. A point at a level reads 2^d table rows of F floats at
// hashed addresses (1.07 GB gathered at 2^20 points of configs/nerf/
// base.json against 193 MB that must move); the table (46.7 MB there)
// nearly fills the 50 MB L2 by itself. So:
//   - exact forward: the work is ordered level-major, so the blocks
//     resident at any moment gather from one or two levels' slice of the
//     table (<= 16 MB there), which stays in the L2, instead of from all
//     of it; two lanes encode a point, so that a pair of corners in one
//     32-byte sector is one warp instruction's sector; a point's levels
//     that fill one 32-byte sector of its output row are written with
//     streaming stores, so the output passes the L2 in whole sectors
//     without evicting the table. A (point, level)'s arithmetic is that of
//     one thread a point: corners in order, each product and sum an
//     explicit round-to-nearest intrinsic. The stochastic forward keeps
//     one thread per (point, level): its draws are point-major;
//   - table gradient: no float atomics (their order changes between runs,
//     and Adam's eps of 1e-15 turns the difference of near-zero sums into
//     full-size steps) and no library sort. The deposits, laid out
//     [group][point][level][corner], are put in the order of their table
//     rows by a stable LSD radix sort written here: 8-bit digits of the
//     key's own bits (3 passes for base.json's 2,920,448 rows), an int32
//     position as payload, each pass a block histogram in shared memory, a
//     scan of the tiles' counts, and a scatter ranked within the block (a
//     warp's lanes with one digit find each other by atomicOr on shared
//     bins) and staged in shared memory so that each digit's run leaves
//     the block in whole sectors. The first pass computes the rows itself
//     (they are never written unsorted), writes each (level, point)'s
//     gradient row and weights level-major on the way, and leaves out the
//     deposits of a point whose gradient at that level is zero (a train
//     step's padded samples: one position, so one very long run each; they
//     add +-0, which changes no bit). The sum then stages a tile of sorted
//     deposits at a time: every thread gathers its deposits' records at
//     once and writes g * weight to shared memory, and the owner of each
//     run of equal rows adds them in order from there; a run that goes on
//     past the tile (a coarse level's row, which thousands of points share)
//     is added by one thread while the block stages the rest of it tile by
//     tile. The sorted order walks one level at a time, so the records it
//     gathers come from one level's slice.
//     Within a row that is one sequential float32 sum per group, each
//     product rounded before the add, and the groups' sums added in turn:
//     the order and the arithmetic of `index_put_` with accumulate on CUDA,
//     which the plain version calls once per level and group (the
//     stochastic j-axis deposit once per fetched corner), so the plain card
//     path's bits for 2, 4 and 8 features a level, the counts instantiated
//     here (for a one-column slice index_put_ sums long runs by a warp
//     tree);
//   - input gradient: one thread per point walks its levels and corners
//     and writes its d values once.

#include <cuda_runtime.h>

#include <cstdint>

#include "grid_encoding.cuh"

namespace {

using namespace ngp_grid;

constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;
// table-gradient modes: every corner weighted (the exact encode), the one
// fully sampled corner with weight 1 (j = 0, or `stochastic_bwd`), the 2^j
// fetched corners weighted, one group (plain `index_put_` call) each
constexpr int kExact = 0, kOneCorner = 1, kFetched = 2;
// the radix sort: digits of kRadixBits (one bucket a thread of the
// block), kItems keys a thread, so a tile of kSortTile keys a block
constexpr int kRadixBits = 8;
constexpr int kBuckets = 1 << kRadixBits;
constexpr int kItems = 16;
constexpr int kWarpItems = 32 * kItems;
constexpr int kSortTile = kBlock * kItems;
static_assert(kBuckets == kBlock, "one bucket a thread");
// the sorted deposits a block of the sum stages at a time
constexpr int kSumTile = 1024;
constexpr int kSumPerThread = kSumTile / kBlock;

template <int F>
__device__ __forceinline__ void load_row(const float* __restrict__ p,
                                         float* v) {
  if constexpr (F == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = t.x;
    v[1] = t.y;
  } else {
#pragma unroll
    for (int i = 0; i < F; i += 4) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(p + i));
      v[i] = t.x;
      v[i + 1] = t.y;
      v[i + 2] = t.z;
      v[i + 3] = t.w;
    }
  }
}

template <int F>
__device__ __forceinline__ void store_row(float* __restrict__ p,
                                          const float* v) {
  if constexpr (F == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int i = 0; i < F; i += 4)
      *reinterpret_cast<float4*>(p + i) =
          make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  }
}

// store_row with streaming (evict-first) stores: data written once and
// read by the next kernel, which should not push the table out of the L2
template <int F>
__device__ __forceinline__ void stream_row(float* __restrict__ p,
                                           const float* v) {
  if constexpr (F == 2) {
    __stcs(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
  } else {
#pragma unroll
    for (int i = 0; i < F; i += 4)
      __stcs(reinterpret_cast<float4*>(p + i),
             make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]));
  }
}

template <int D>
__device__ __forceinline__ void load_point(const float* __restrict__ x,
                                           long long pt, float* xp) {
#pragma unroll
  for (int k = 0; k < D; ++k) xp[k] = x[pt * D + k];
}

// u is (D, n, L), the sampled bit of axis k is u_k < w_k
template <int D>
__device__ __forceinline__ void sampled_bits(const float* __restrict__ u,
                                             long long n, int n_levels,
                                             long long pt, int lvl,
                                             const float* w, int* bern) {
#pragma unroll
  for (int k = 0; k < D; ++k)
    bern[k] = u[(k * n + pt) * n_levels + lvl] < w[k] ? 1 : 0;
}

// The levels one thread of the forward encodes: as many as fill one
// 32-byte sector of its output row.
template <int F>
constexpr int kLevelsPerThread = F >= 8 ? 1 : 8 / F;

// One (point, level) of the exact (j < 0) or the stochastic forward into
// acc; a level from `active` on is masked (max_level) and gives zeros.
template <int D, int F>
__device__ __forceinline__ void encode_level(
    const Grid& g, const float* __restrict__ table,
    const float* __restrict__ u, const long long* __restrict__ axis,
    long long n, long long pt, int lvl, int active, int j, const float* xp,
    float* acc) {
#pragma unroll
  for (int k = 0; k < F; ++k) acc[k] = 0.0f;
  if (lvl >= active) return;
  float w[D], dw[D], f[F];
  int pos0[D], c[D];
  level_point<D>(g, lvl, xp, pos0, w, dw);
  if (j < 0) {
#pragma unroll
    for (int corner = 0; corner < (1 << D); ++corner) {
#pragma unroll
      for (int k = 0; k < D; ++k) c[k] = pos0[k] + corner_bit<D>(corner, k);
      const float weight = corner_weight<D>(w, corner);
      load_row<F>(table + static_cast<long long>(corner_row<D>(g, lvl, c)) * F,
                  f);
#pragma unroll
      for (int k = 0; k < F; ++k)
        acc[k] = __fadd_rn(acc[k], __fmul_rn(f[k], weight));
    }
    return;
  }
  int bern[D];
  sampled_bits<D>(u, n, g.n_levels, pt, lvl, w, bern);
  if (j == 0) {
#pragma unroll
    for (int k = 0; k < D; ++k) c[k] = pos0[k] + bern[k];
    load_row<F>(table + static_cast<long long>(corner_row<D>(g, lvl, c)) * F,
                acc);
    return;
  }
  const int a = static_cast<int>(axis[pt * g.n_levels + lvl]);
  for (int combo = 0; combo < (1 << j); ++combo) {
    const float weight = fetched_corner<D>(j, a, combo, pos0, w, bern, c);
    load_row<F>(table + static_cast<long long>(corner_row<D>(g, lvl, c)) * F,
                f);
#pragma unroll
    for (int k = 0; k < F; ++k)
      acc[k] = combo == 0 ? __fmul_rn(f[k], weight)
                          : __fadd_rn(acc[k], __fmul_rn(f[k], weight));
  }
}

// The exact forward, level-major: blockIdx.y is a group of
// kLevelsPerThread levels, and blocks are dispatched x first, so the
// blocks resident at a time gather from one group's levels. Two
// neighbouring lanes encode one point: lane h of the pair fetches the
// corners whose axis-0 bit is h. Where the lower corner's axis-0
// coordinate is even (half the points of a level; the hash XORs the raw
// coordinate and the dense index adds it to a multiple of an even
// resolution, and every level's offset and hashed size is a multiple of
// 8), such two corners are neighbouring rows of one 32-byte sector, and
// the pair's two loads are one warp instruction, which the L1 serves from
// that one sector (sm_90 has no 32-byte load for one thread). Lane 0 sums
// corners 0 .. 2^(D-1) - 1 in order and hands its partial sums to lane 1,
// which adds the rest in order and writes: the arithmetic of one thread
// per point.
template <int D, int F>
__global__ void __launch_bounds__(kBlock) grid_forward_exact(
    const Grid g, const float* __restrict__ x, const float* __restrict__ table,
    float* __restrict__ out, long long n, int active) {
  constexpr int kLevels = kLevelsPerThread<F>;
  constexpr int kHalf = 1 << (D - 1);
  const long long t = blockIdx.x * static_cast<long long>(kBlock) + threadIdx.x;
  const int h = threadIdx.x & 1;
  const bool live = (t >> 1) < n;
  const long long pt = live ? t >> 1 : n - 1;   // every lane meets the shuffles
  float xp[D];
  load_point<D>(x, pt, xp);
#pragma unroll
  for (int s = 0; s < kLevels; ++s) {
    const int lvl = blockIdx.y * kLevels + s;
    if (lvl >= g.n_levels) break;
    float acc[F];
#pragma unroll
    for (int k = 0; k < F; ++k) acc[k] = 0.0f;
    if (lvl < active) {
      float w[D], dw[D], prod[kHalf][F];
      int pos0[D], c[D];
      level_point<D>(g, lvl, xp, pos0, w, dw);
#pragma unroll
      for (int m = 0; m < kHalf; ++m) {
        const int corner = h * kHalf + m;
#pragma unroll
        for (int k = 0; k < D; ++k) c[k] = pos0[k] + corner_bit<D>(corner, k);
        const float weight = corner_weight<D>(w, corner);
        float f[F];
        load_row<F>(
            table + static_cast<long long>(corner_row<D>(g, lvl, c)) * F, f);
#pragma unroll
        for (int k = 0; k < F; ++k) prod[m][k] = __fmul_rn(f[k], weight);
      }
      if (h == 0) {
#pragma unroll
        for (int m = 0; m < kHalf; ++m)
#pragma unroll
          for (int k = 0; k < F; ++k) acc[k] = __fadd_rn(acc[k], prod[m][k]);
      }
#pragma unroll
      for (int k = 0; k < F; ++k)
        acc[k] = __shfl_sync(0xffffffffu, acc[k], threadIdx.x & 30);
      if (h == 1) {
#pragma unroll
        for (int m = 0; m < kHalf; ++m)
#pragma unroll
          for (int k = 0; k < F; ++k) acc[k] = __fadd_rn(acc[k], prod[m][k]);
      }
    }
    if (live && h == 1) stream_row<F>(out + (pt * g.n_levels + lvl) * F, acc);
  }
}

// The stochastic forward, one thread per (point, level), the levels of a
// point on neighbouring threads: the draws u (D, n, L) and axis (n, L) are
// read in whole rows of a point's levels (a level-major order reads them a
// float at a time and took 2.4x as long at 2^20 points of base.json).
template <int D, int F>
__global__ void __launch_bounds__(kBlock) grid_forward_stochastic(
    const Grid g, const float* __restrict__ x, const float* __restrict__ table,
    const float* __restrict__ u, const long long* __restrict__ axis,
    float* __restrict__ out, long long n, int active, int j) {
  const long long t = blockIdx.x * static_cast<long long>(kBlock) + threadIdx.x;
  const int n_levels = g.n_levels;
  if (t >= n * n_levels) return;
  const long long pt = t / n_levels;
  const int lvl = static_cast<int>(t - pt * n_levels);
  float xp[D], acc[F];
  load_point<D>(x, pt, xp);
  encode_level<D, F>(g, table, u, axis, n, pt, lvl, active, j, xp, acc);
  stream_row<F>(out + t * F, acc);
}

// n / d for 0 <= n < 2^31 and a divisor fixed for a launch, by one
// multiply and a shift: floor(n * m / 2^(31 + s)) with s = ceil(log2 d)
// and m = ceil(2^(31 + s) / d) (<= 2^32, so n * m < 2^63) is floor(n / d)
// for every such n (Granlund and Montgomery's bound: d * m - 2^(31 + s)
// < d <= 2^s). A 64-bit division is some 70 instructions.
struct FastDiv {
  unsigned long long m;
  int shift;
};

FastDiv fast_div(unsigned d) {
  int s = 0;
  while ((1ULL << s) < d) ++s;
  return {((1ULL << (31 + s)) + d - 1) / d, 31 + s};
}

__device__ __forceinline__ unsigned quotient(unsigned n, const FastDiv& f) {
  return static_cast<unsigned>((n * f.m) >> f.shift);
}

// The deposits of one table-gradient call, laid out [group][point][level]
// [corner] over the `active` levels: K = 2^log2_k corners a (group, point,
// level), 2^D for kExact and 1 otherwise; 2^j groups for kFetched, else 1.
// A row belongs to one level, so its deposits come in the order (group,
// point, corner), which is the order of the plain version's calls. The
// layout follows grad_out, u and axis, which are point-major. K * n *
// active * groups < 2^31, so a position is an int.
struct Deposits {
  int n, active, mode, j, log2_k;
  FastDiv by_n, by_active;
};

// The floats of a (level, point)'s record, which the first pass writes
// for the sum: grad_out's row (F), the interpolation weights w (D) and the
// exact axis of the draws (1, its bits), padded to a whole vector load.
constexpr int record_floats(int n_dims, int n_features) {
  return n_features + n_dims + 1 <= 8 ? 8 : 16;
}

Deposits make_deposits(const Grid& g, long long n, int active, int mode,
                       int j) {
  return {static_cast<int>(n), active, mode, j,
          mode == kExact ? g.n_dims : 0,
          fast_div(static_cast<unsigned>(n)),
          fast_div(static_cast<unsigned>(active))};
}

__device__ __forceinline__ void decode(const Deposits& dp, unsigned e,
                                       int* group, int* lvl, long long* pt,
                                       int* corner) {
  *corner = static_cast<int>(e & ((1u << dp.log2_k) - 1u));
  const unsigned t = e >> dp.log2_k;
  const unsigned gp = quotient(t, dp.by_active);
  *lvl = static_cast<int>(t - gp * static_cast<unsigned>(dp.active));
  const unsigned grp = quotient(gp, dp.by_n);
  *pt = gp - grp * static_cast<unsigned>(dp.n);
  *group = static_cast<int>(grp);
}

template <int F>
__device__ __forceinline__ bool all_zero(const float* v) {
  bool zero = true;
#pragma unroll
  for (int k = 0; k < F; ++k) zero = zero && v[k] == 0.0f;
  return zero;
}

template <int D, int F>
constexpr int kRecord = record_floats(D, F);

// The table row of one deposit (its key); the point's weights at the
// level to w.
template <int D>
__device__ __forceinline__ int deposit_row(const Grid& g, const Deposits& dp,
                                           const float* __restrict__ x,
                                           const float* __restrict__ u,
                                           const long long* __restrict__ axis,
                                           int group, int lvl, long long pt,
                                           int corner, float* w) {
  float xp[D], dw[D];
  int pos0[D], c[D];
  load_point<D>(x, pt, xp);
  level_point<D>(g, lvl, xp, pos0, w, dw);
  if (dp.mode == kExact) {
#pragma unroll
    for (int k = 0; k < D; ++k) c[k] = pos0[k] + corner_bit<D>(corner, k);
  } else {
    int bern[D];
    sampled_bits<D>(u, dp.n, g.n_levels, pt, lvl, w, bern);
    if (dp.mode == kOneCorner) {
#pragma unroll
      for (int k = 0; k < D; ++k) c[k] = pos0[k] + bern[k];
    } else {
      fetched_corner<D>(dp.j, static_cast<int>(axis[pt * g.n_levels + lvl]),
                        group, pos0, w, bern, c);
    }
  }
  return corner_row<D>(g, lvl, c);
}

// Exclusive prefix sum of one value a thread over the block, in thread
// order; the block's total to *total. s_warp: kWarps ints of scratch.
__device__ __forceinline__ int block_exclusive_scan(int v, int* s_warp,
                                                    int* total) {
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  __syncthreads();   // the previous use of s_warp is over
  if (lane == 31) s_warp[w] = incl;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int q = 0; q < kWarps; ++q) {
    const int s = s_warp[q];
    before += q < w ? s : 0;
    all += s;
  }
  *total = all;
  return before + incl - v;
}

// Zeroes n 4-byte words (16 bytes a store where p is 16-byte aligned).
__global__ void __launch_bounds__(kBlock) zero_words(unsigned* __restrict__ p,
                                                     long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * kBlock;
  const long long first = blockIdx.x * static_cast<long long>(kBlock) +
                          threadIdx.x;
  const long long n4 = reinterpret_cast<uintptr_t>(p) % 16 ? 0 : n / 4;
  for (long long i = first; i < n4; i += stride)
    reinterpret_cast<uint4*>(p)[i] = make_uint4(0u, 0u, 0u, 0u);
  for (long long i = 4 * n4 + first; i < n; i += stride) p[i] = 0u;
}

// The first radix pass's histogram: one block a tile of kSortTile
// deposit positions. Computes each deposit's row (its sort key), counts
// the low digit of those whose gradient is not zero (counts[digit *
// n_tiles + tile]), and writes each (level, point)'s record level-major
// (rec[level][point]), so that the sum, which walks the sorted rows one
// level at a time, gathers from one level's records, with one vector load
// each.
template <int D, int F>
__global__ void __launch_bounds__(kBlock) deposit_first_hist(
    const Grid g, const Deposits dp, const float* __restrict__ x,
    const float* __restrict__ u, const long long* __restrict__ axis,
    const float* __restrict__ grad_out, float* __restrict__ rec,
    long long n_keys, int n_tiles, int* __restrict__ counts) {
  constexpr int R = kRecord<D, F>;
  __shared__ int s_hist[kBuckets];
  s_hist[threadIdx.x] = 0;
  __syncthreads();
  const long long tile = static_cast<long long>(blockIdx.x) * kSortTile;
  for (int r = 0; r < kItems; ++r) {
    const long long e = tile + r * kBlock + threadIdx.x;
    if (e >= n_keys) break;
    int group, lvl, corner;
    long long pt;
    decode(dp, static_cast<unsigned>(e), &group, &lvl, &pt, &corner);
    float record[R] = {};
    load_row<F>(grad_out + (pt * g.n_levels + lvl) * F, record);
    const int row = deposit_row<D>(g, dp, x, u, axis, group, lvl, pt, corner,
                                   record + F);
    if (group == 0 && corner == 0) {
      if (dp.mode == kFetched)
        record[F + D] = __int_as_float(
            static_cast<int>(axis[pt * g.n_levels + lvl]));
      store_row<R>(rec + (static_cast<long long>(lvl) * dp.n + pt) * R,
                   record);
    }
    if (all_zero<F>(record)) continue;
    atomicAdd(&s_hist[row & (kBuckets - 1)], 1);
  }
  __syncthreads();
  counts[static_cast<long long>(threadIdx.x) * n_tiles + blockIdx.x] =
      s_hist[threadIdx.x];
}

// A later radix pass's histogram over the first *n_valid keys.
__global__ void __launch_bounds__(kBlock) radix_hist(
    const int* __restrict__ keys, const int* __restrict__ n_valid,
    int n_tiles, int shift, int* __restrict__ counts) {
  __shared__ int s_hist[kBuckets];
  s_hist[threadIdx.x] = 0;
  __syncthreads();
  const long long nv = *n_valid;
  const long long tile = static_cast<long long>(blockIdx.x) * kSortTile;
  for (int r = 0; r < kItems; ++r) {
    const long long i = tile + r * kBlock + threadIdx.x;
    if (i >= nv) break;
    atomicAdd(&s_hist[(__ldcs(keys + i) >> shift) & (kBuckets - 1)], 1);
  }
  __syncthreads();
  counts[static_cast<long long>(threadIdx.x) * n_tiles + blockIdx.x] =
      s_hist[threadIdx.x];
}

// Block d: the exclusive prefix sum, in place, of digit d's counts over
// the tiles, and the digit's total to totals[d].
__global__ void __launch_bounds__(kBlock) radix_scan(int* __restrict__ counts,
                                                     int n_tiles,
                                                     int* __restrict__ totals) {
  __shared__ int s_warp[kWarps];
  int* c = counts + static_cast<long long>(blockIdx.x) * n_tiles;
  int carry = 0;
  for (int base = 0; base < n_tiles; base += 4 * kBlock) {
    int v[4], sum = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = base + 4 * threadIdx.x + q;
      v[q] = i < n_tiles ? c[i] : 0;
      sum += v[q];
    }
    int total;
    int run = carry + block_exclusive_scan(sum, s_warp, &total);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = base + 4 * threadIdx.x + q;
      if (i < n_tiles) c[i] = run;
      run += v[q];
    }
    carry += total;
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = carry;
}

// Writes this block's keys (kItems a thread; item r of lane l of warp w
// sits at tile position w * kWarpItems + r * 32 + l; invalid ones take no
// place) to their places in the order of digit (key >> shift) & 255, in
// tile order within a digit: the tile's start in each digit is the digits
// before it (totals, summed here) plus the tiles before it (counts,
// scanned). Ranks within a warp by the lanes' bits or-ed into a shared bin
// of their digit (cheaper than __match_any_sync), within the block by
// the warps' counts; staged in shared memory in digit order so that each
// digit's run is written by neighbouring threads. Where n_valid is given,
// block 0 writes the number of valid keys there.
__device__ __forceinline__ void rank_and_scatter(
    const int* key, const int* val, const bool* valid, int shift,
    int n_tiles, const int* __restrict__ counts,
    const int* __restrict__ totals, int* __restrict__ keys_out,
    int* __restrict__ vals_out, int* __restrict__ n_valid) {
  __shared__ unsigned short s_warp_counts[kWarps][kBuckets];  // <= kSortTile
  __shared__ unsigned s_match[kWarps][kBuckets];
  __shared__ int s_local[kBuckets];
  __shared__ int s_base[kBuckets];
  __shared__ int s_scan[kWarps];
  __shared__ int s_keys[kSortTile];
  __shared__ int s_vals[kSortTile];
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const unsigned lower = (1u << lane) - 1u;
  for (int d = lane; d < kBuckets; d += 32) {
    s_warp_counts[w][d] = 0;
    s_match[w][d] = 0;
  }
  __syncwarp();
  int digit[kItems], rank[kItems];
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    digit[r] = (key[r] >> shift) & (kBuckets - 1);
    if (valid[r]) atomicOr(&s_match[w][digit[r]], 1u << lane);
    __syncwarp();
    const unsigned peers = valid[r] ? s_match[w][digit[r]] : 0u;
    const int before = valid[r] ? s_warp_counts[w][digit[r]] : 0;
    __syncwarp();
    if (valid[r] && (peers & lower) == 0) {   // the digit's first lane
      s_warp_counts[w][digit[r]] =
          static_cast<unsigned short>(before + __popc(peers));
      s_match[w][digit[r]] = 0;
    }
    __syncwarp();
    rank[r] = before + __popc(peers & lower);
  }
  __syncthreads();
  // thread d: digit d's start in each warp and in the block, and its place
  // in the output
  const int d = threadIdx.x;
  int in_block = 0;
#pragma unroll
  for (int v = 0; v < kWarps; ++v) {
    const int c = s_warp_counts[v][d];
    s_warp_counts[v][d] = static_cast<unsigned short>(in_block);
    in_block += c;
  }
  int n_here, n_all;
  s_local[d] = block_exclusive_scan(in_block, s_scan, &n_here);
  s_base[d] = block_exclusive_scan(totals[d], s_scan, &n_all) +
              counts[static_cast<long long>(d) * n_tiles + blockIdx.x];
  if (n_valid != nullptr && blockIdx.x == 0 && d == 0) *n_valid = n_all;
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    if (!valid[r]) continue;
    const int p = s_local[digit[r]] + s_warp_counts[w][digit[r]] + rank[r];
    s_keys[p] = key[r];
    s_vals[p] = val[r];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_here; i += kBlock) {
    const int k = s_keys[i];
    const int dg = (k >> shift) & (kBuckets - 1);
    const int p = s_base[dg] + i - s_local[dg];
    keys_out[p] = k;
    vals_out[p] = s_vals[i];
  }
}

// The first radix pass's scatter: the rows of the tile's deposits whose
// gradient is not zero, sorted by their low digit, with their positions as
// payload; the number of such deposits to n_valid.
template <int D, int F>
__global__ void __launch_bounds__(kBlock) deposit_first_scatter(
    const Grid g, const Deposits dp, const float* __restrict__ x,
    const float* __restrict__ u, const long long* __restrict__ axis,
    const float* __restrict__ grad_out, long long n_keys, int n_tiles,
    const int* __restrict__ counts, const int* __restrict__ totals,
    int* __restrict__ keys_out, int* __restrict__ vals_out,
    int* __restrict__ n_valid) {
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long base = static_cast<long long>(blockIdx.x) * kSortTile +
                         w * kWarpItems + lane;
  int key[kItems], val[kItems];
  bool valid[kItems];
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const long long e = base + r * 32;
    key[r] = 0;
    val[r] = static_cast<int>(e);
    valid[r] = false;
    if (e >= n_keys) continue;
    int group, lvl, corner;
    long long pt;
    decode(dp, static_cast<unsigned>(e), &group, &lvl, &pt, &corner);
    float gv[F], w[D];
    load_row<F>(grad_out + (pt * g.n_levels + lvl) * F, gv);
    if (all_zero<F>(gv)) continue;
    key[r] = deposit_row<D>(g, dp, x, u, axis, group, lvl, pt, corner, w);
    valid[r] = true;
  }
  rank_and_scatter(key, val, valid, 0, n_tiles, counts, totals, keys_out,
                   vals_out, n_valid);
}

// A later radix pass's scatter of the first *n_valid (key, position)
// pairs by digit (key >> shift) & 255.
__global__ void __launch_bounds__(kBlock) radix_scatter(
    const int* __restrict__ keys_in, const int* __restrict__ vals_in,
    const int* __restrict__ n_valid, int n_tiles, int shift,
    const int* __restrict__ counts, const int* __restrict__ totals,
    int* __restrict__ keys_out, int* __restrict__ vals_out) {
  const long long nv = *n_valid;
  if (static_cast<long long>(blockIdx.x) * kSortTile >= nv) return;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long base = static_cast<long long>(blockIdx.x) * kSortTile +
                         w * kWarpItems + lane;
  int key[kItems], val[kItems];
  bool valid[kItems];
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const long long i = base + r * 32;
    valid[r] = i < nv;
    key[r] = valid[r] ? __ldcs(keys_in + i) : 0;
    val[r] = valid[r] ? __ldcs(vals_in + i) : 0;
  }
  rank_and_scatter(key, val, valid, shift, n_tiles, counts, totals, keys_out,
                   vals_out, nullptr);
}

// The deposit at position e of the layout: writes g * weight (g alone for
// kOneCorner) to v and returns its group; g, the weights and the exact
// axis from the (level, point)'s record.
template <int D, int F>
__device__ __forceinline__ int deposit_value(const Deposits& dp,
                                             const float* __restrict__ rec,
                                             int e, float* v) {
  constexpr int R = kRecord<D, F>;
  int group, lvl, corner;
  long long pt;
  decode(dp, static_cast<unsigned>(e), &group, &lvl, &pt, &corner);
  float r[R];
  load_row<R>(rec + (static_cast<long long>(lvl) * dp.n + pt) * R, r);
  float weight = 1.0f;
  if (dp.mode == kExact) {
    weight = corner_weight<D>(r + F, corner);
  } else if (dp.mode == kFetched) {
    int pos0[D] = {}, c[D], bern[D] = {};
    weight = fetched_corner<D>(dp.j, __float_as_int(r[F + D]), group, pos0,
                               r + F, bern, c);
  }
#pragma unroll
  for (int k = 0; k < F; ++k)
    v[k] = dp.mode == kOneCorner ? r[k] : __fmul_rn(r[k], weight);
  return group;
}

// Adds one deposit to a row's sum in order: a group's deposits into acc,
// acc into total where the group changes (one plain index_put_ call each).
template <int F>
__device__ __forceinline__ void add_in_order(int group, const float* v,
                                             int& current, float* total,
                                             float* acc) {
  if (group != current) {
    if (current >= 0) {
#pragma unroll
      for (int k = 0; k < F; ++k) {
        total[k] = __fadd_rn(total[k], acc[k]);
        acc[k] = 0.0f;
      }
    }
    current = group;
  }
#pragma unroll
  for (int k = 0; k < F; ++k) acc[k] = __fadd_rn(acc[k], v[k]);
}

// A row's sum starts from 0.
template <int F>
__device__ __forceinline__ void start_row(float* total, float* acc,
                                          int& current) {
#pragma unroll
  for (int k = 0; k < F; ++k) total[k] = acc[k] = 0.0f;
  current = -1;
}

// Adds the last group's sum to the total and writes the row.
template <int F>
__device__ __forceinline__ void finish_row(float* row, float* total,
                                           const float* acc) {
#pragma unroll
  for (int k = 0; k < F; ++k) total[k] = __fadd_rn(total[k], acc[k]);
  store_row<F>(row, total);
}

// Stages the deposits at sorted positions [p0, p0 + m), m <= kSumTile,
// into shared memory: their values (g * weight) in s_v, their groups in
// s_group. A thread's positions, then their records, are loaded all at
// once, so kSumPerThread gathers of each are in flight together.
template <int D, int F>
__device__ __forceinline__ void stage_values(
    const Deposits& dp, const float* __restrict__ rec,
    const int* __restrict__ perm, long long p0, int m, float* s_v,
    unsigned char* s_group) {
  int e[kSumPerThread];
#pragma unroll
  for (int q = 0; q < kSumPerThread; ++q) {
    const int i = threadIdx.x + q * kBlock;
    e[q] = i < m ? __ldcs(perm + p0 + i) : -1;
  }
#pragma unroll
  for (int q = 0; q < kSumPerThread; ++q) {
    if (e[q] < 0) continue;
    const int i = threadIdx.x + q * kBlock;
    float v[F];
    s_group[i] = static_cast<unsigned char>(
        deposit_value<D, F>(dp, rec, e[q], v));
#pragma unroll
    for (int k = 0; k < F; ++k) s_v[i * F + k] = v[k];
  }
}

// The ordered sum over the first *n_valid sorted keys (table rows), `perm`
// holding each one's position in the deposit layout: one block a tile of
// kSumTile positions. The block stages the
// tile's values; the thread whose positions hold the head of a run of
// equal keys adds the run from shared memory and writes the row once. The
// tile's last run, where it goes on past the tile, its owner's thread 0
// adds while the block finds where it ends (a tile of keys compared at
// once) and stages the rest of it a tile at a time. Either way one
// sequential float32 sum per group, the groups' sums added to the total in
// turn.
template <int D, int F>
__global__ void __launch_bounds__(kBlock) deposit_sum(
    const Deposits dp, const float* __restrict__ rec,
    const int* __restrict__ sorted, const int* __restrict__ perm,
    const int* __restrict__ n_valid, float* __restrict__ grad) {
  __shared__ __align__(16) float s_v[kSumTile * F];
  __shared__ int s_key[kSumTile];
  __shared__ unsigned char s_group[kSumTile];
  __shared__ int s_cross;
  const long long hi = *n_valid;
  const long long t0 = static_cast<long long>(blockIdx.x) * kSumTile;
  if (t0 >= hi) return;
  const int cnt = static_cast<int>(min(static_cast<long long>(kSumTile),
                                       hi - t0));
  const int prev = t0 > 0 ? sorted[t0 - 1] : -1;
  const int next = t0 + cnt < hi ? sorted[t0 + cnt] : -1;
  if (threadIdx.x == 0) s_cross = -1;
  for (int i = threadIdx.x; i < cnt; i += kBlock)
    s_key[i] = __ldcs(sorted + t0 + i);
  stage_values<D, F>(dp, rec, perm, t0, cnt, s_v, s_group);
  __syncthreads();
  float total[F], acc[F];
  int current;
  for (int q = 0; q < kSumPerThread; ++q) {
    const int i = threadIdx.x * kSumPerThread + q;
    if (i >= cnt) break;
    const int key = s_key[i];
    if (key == (i == 0 ? prev : s_key[i - 1])) continue;   // not a head
    int end = i + 1;
    while (end < cnt && s_key[end] == key) ++end;
    if (end == cnt && next == key) {   // goes on past the tile
      s_cross = i;
      continue;
    }
    float* out = grad + static_cast<long long>(key) * F;
    start_row<F>(total, acc, current);
    for (int p = i; p < end; ++p)
      add_in_order<F>(s_group[p], s_v + p * F, current, total, acc);
    finish_row<F>(out, total, acc);
  }
  __syncthreads();
  const int head = s_cross;
  if (head < 0) return;
  const int key = s_key[head];
  float* out = grad + static_cast<long long>(key) * F;
  if (threadIdx.x == 0) {
    start_row<F>(total, acc, current);
    for (int p = head; p < cnt; ++p)
      add_in_order<F>(s_group[p], s_v + p * F, current, total, acc);
  }
  for (long long p0 = t0 + cnt;; p0 += kSumTile) {
    const int m = static_cast<int>(min(static_cast<long long>(kSumTile),
                                       hi - p0));
    __syncthreads();   // thread 0 is done with s_v and s_cross
    if (threadIdx.x == 0) s_cross = m;
    __syncthreads();
    // the run's end in this tile of positions: its first other key
#pragma unroll
    for (int q = 0; q < kSumPerThread; ++q) {
      const int i = threadIdx.x + q * kBlock;
      if (i < m && __ldcs(sorted + p0 + i) != key) atomicMin(&s_cross, i);
    }
    __syncthreads();
    const int stop = s_cross;
    stage_values<D, F>(dp, rec, perm, p0, stop, s_v, s_group);
    __syncthreads();
    if (threadIdx.x == 0)
      for (int p = 0; p < stop; ++p)
        add_in_order<F>(s_group[p], s_v + p * F, current, total, acc);
    if (stop < m || p0 + m >= hi) break;
  }
  if (threadIdx.x == 0) finish_row<F>(out, total, acc);
}

// One thread per point: d(loss)/dx = sum over levels and corners of
// (grad . feature) * d(weight)/dx_k, d(weight)/dx_k being
// (+-dw_k * scale) times the other axes' w or 1 - w; each level's sum is
// added to the point's in turn, as the plain version adds them.
template <int D, int F>
__global__ void __launch_bounds__(kBlock) grid_input_gradient(
    const Grid g, const float* __restrict__ x, const float* __restrict__ table,
    const float* __restrict__ grad_out, float* __restrict__ grad_x,
    long long n, int active) {
  const long long pt = blockIdx.x * static_cast<long long>(kBlock) + threadIdx.x;
  if (pt >= n) return;
  const int n_out = g.n_levels * F;
  float xp[D], gx[D];
  load_point<D>(x, pt, xp);
#pragma unroll
  for (int k = 0; k < D; ++k) gx[k] = 0.0f;
  for (int lvl = 0; lvl < active; ++lvl) {
    float w[D], dw[D], f[F], gv[F], level[D];
    int pos0[D], c[D];
    level_point<D>(g, lvl, xp, pos0, w, dw);
    load_row<F>(grad_out + pt * n_out + lvl * F, gv);
#pragma unroll
    for (int k = 0; k < D; ++k) level[k] = 0.0f;
#pragma unroll
    for (int corner = 0; corner < (1 << D); ++corner) {
#pragma unroll
      for (int k = 0; k < D; ++k) c[k] = pos0[k] + corner_bit<D>(corner, k);
      load_row<F>(table + static_cast<long long>(corner_row<D>(g, lvl, c)) * F,
                  f);
      float dweight = __fmul_rn(f[0], gv[0]);
#pragma unroll
      for (int k = 1; k < F; ++k)
        dweight = __fadd_rn(dweight, __fmul_rn(f[k], gv[k]));
#pragma unroll
      for (int k = 0; k < D; ++k) {
        const int b = corner_bit<D>(corner, k);
        float term = __fmul_rn(dweight,
                               __fmul_rn(b ? dw[k] : -dw[k], g.scale[lvl]));
#pragma unroll
        for (int m = 0; m < D; ++m)
          if (m != k)
            term = __fmul_rn(term, corner_bit<D>(corner, m)
                                       ? w[m]
                                       : __fsub_rn(1.0f, w[m]));
        level[k] = __fadd_rn(level[k], term);
      }
    }
#pragma unroll
    for (int k = 0; k < D; ++k) gx[k] = __fadd_rn(gx[k], level[k]);
  }
#pragma unroll
  for (int k = 0; k < D; ++k) grad_x[pt * D + k] = gx[k];
}

// The Grid of a ctypes call: ints = [n_dims, n_levels, n_features,
// grid_type, interpolation, then per level res, size, offset, hashed],
// scales = the per-level f32 scales. False where it is out of range.
bool make_grid(const int* ints, const float* scales, Grid* g) {
  g->n_dims = ints[0];
  g->n_levels = ints[1];
  g->n_features = ints[2];
  g->grid_type = ints[3];
  g->interpolation = ints[4];
  if ((g->n_dims != 2 && g->n_dims != 3) || g->n_levels < 1 ||
      g->n_levels > kMaxLevels)
    return false;
  for (int l = 0; l < g->n_levels; ++l) {
    g->scale[l] = scales[l];
    g->res[l] = ints[5 + 4 * l];
    g->size[l] = ints[6 + 4 * l];
    g->offset[l] = ints[7 + 4 * l];
    g->hashed[l] = ints[8 + 4 * l];
    if (g->size[l] < 1 || g->res[l] < 1) return false;
  }
  return true;
}

unsigned int blocks_for(long long threads) {
  return static_cast<unsigned int>((threads + kBlock - 1) / kBlock);
}

unsigned int blocks(long long n) { return static_cast<unsigned int>(n); }

// Runs the statement with D and F as the constants of the grid's (n_dims,
// n_features); the error of the launch, or cudaErrorInvalidValue where
// there is no instantiation.
#define GRID_DISPATCH(g, ...)                                  \
  do {                                                         \
    switch ((g).n_dims * 16 + (g).n_features) {                \
      case 2 * 16 + 2: { constexpr int D = 2, F = 2; __VA_ARGS__; } break; \
      case 2 * 16 + 4: { constexpr int D = 2, F = 4; __VA_ARGS__; } break; \
      case 2 * 16 + 8: { constexpr int D = 2, F = 8; __VA_ARGS__; } break; \
      case 3 * 16 + 2: { constexpr int D = 3, F = 2; __VA_ARGS__; } break; \
      case 3 * 16 + 4: { constexpr int D = 3, F = 4; __VA_ARGS__; } break; \
      case 3 * 16 + 8: { constexpr int D = 3, F = 8; __VA_ARGS__; } break; \
      default: return cudaErrorInvalidValue;                   \
    }                                                          \
    return cudaGetLastError();                                 \
  } while (0)


}  // namespace

// Plain C entry points for ctypes. Each returns 0 or a cudaError_t,
// launches on `stream` and never synchronises. Arrays are contiguous:
// x (n, D), table (n_entries * F), u (D, n, L), axis (n, L) int64 (both
// may be null where unused), out (n, L * F), grad_out (n, L * F).

// j < 0: the exact encode; j = 0, 1, 2: the stochastic-corner encode with
// j exact axes from the draws u and axis.
extern "C" int grid_forward_launch(const int* ints, const float* scales,
                                   const float* x, const float* table,
                                   const float* u, const long long* axis,
                                   float* out, long long n, int active, int j,
                                   void* stream) {
  Grid g;
  if (!make_grid(ints, scales, &g) || n < 1 || j >= g.n_dims ||
      (j > 0 && axis == nullptr) || (j >= 0 && u == nullptr))
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (j < 0) {
    GRID_DISPATCH(g, grid_forward_exact<D, F><<<
                         dim3(blocks_for(2 * n),
                              (g.n_levels + kLevelsPerThread<F> - 1) /
                                  kLevelsPerThread<F>),
                         kBlock, 0, s>>>(g, x, table, out, n, active));
  }
  GRID_DISPATCH(g, grid_forward_stochastic<D, F><<<blocks_for(n * g.n_levels),
                                                   kBlock, 0, s>>>(
                       g, x, table, u, axis, out, n, active, j));
}

// The number of deposits of a table-gradient call.
extern "C" long long grid_deposit_count(int n_dims, long long n, int active,
                                        int mode, int j) {
  const long long groups = mode == kFetched ? (1LL << j) : 1;
  const long long k = mode == kExact ? (1LL << n_dims) : 1;
  return groups * active * n * k;
}

// The scratch of a table-gradient call (grid_deposit_count's arguments)
// on a table of n_entries rows of F floats: out = [tiles of the sort, ints
// of `counts` (buckets x tiles), ints of `totals`, radix passes (8-bit
// digits of the rows' bits), floats of a (level, point)'s record].
extern "C" void grid_deposit_scratch(int n_dims, int n_features,
                                     long long n_entries, long long n,
                                     int active, int mode, int j,
                                     long long* out) {
  const long long n_keys = grid_deposit_count(n_dims, n, active, mode, j);
  int bits = 1;
  while (bits < 62 && (1LL << bits) < n_entries) ++bits;
  const long long tiles = (n_keys + kSortTile - 1) / kSortTile;
  out[0] = tiles;
  out[1] = tiles * kBuckets;
  out[2] = kBuckets;
  out[3] = (bits + kRadixBits - 1) / kRadixBits;
  out[4] = record_floats(n_dims, n_features);
}

namespace {

// Launches one kernel and returns its launch error.
#define LAUNCH(...)                               \
  do {                                            \
    __VA_ARGS__;                                  \
    const cudaError_t err_ = cudaGetLastError();  \
    if (err_ != cudaSuccess) return err_;         \
  } while (0)

// Every launch of a table gradient in turn: the output zeroed; pass 1
// (the histogram of the rows' low digit, which also writes the records,
// the scan, the scatter of the rows and positions of the deposits whose
// gradient is not zero, their number to n_valid); the later passes over
// the first *n_valid, ping-ponged between keys[0 / 1] and vals[0 / 1];
// the ordered sum.
template <int D, int F>
cudaError_t table_gradient(const Grid& g, const Deposits& dp, const float* x,
                           const float* u, const long long* axis,
                           const float* grad_out, float* rec, int* counts,
                           int* totals, int* const* keys, int* const* vals,
                           int* n_valid, float* grad, long long n_words,
                           long long n_keys, int passes, cudaStream_t s) {
  const long long tiles = (n_keys + kSortTile - 1) / kSortTile;
  const int nt = static_cast<int>(tiles);
  const long long fill = (n_words / 4 + kBlock - 1) / kBlock;
  LAUNCH(zero_words<<<blocks(fill < 1 ? 1 : fill > 1024 ? 1024 : fill),
                      kBlock, 0, s>>>(reinterpret_cast<unsigned*>(grad),
                                      n_words));
  LAUNCH(deposit_first_hist<D, F><<<blocks(tiles), kBlock, 0, s>>>(
      g, dp, x, u, axis, grad_out, rec, n_keys, nt, counts));
  LAUNCH(radix_scan<<<kBuckets, kBlock, 0, s>>>(counts, nt, totals));
  LAUNCH(deposit_first_scatter<D, F><<<blocks(tiles), kBlock, 0, s>>>(
      g, dp, x, u, axis, grad_out, n_keys, nt, counts, totals, keys[0],
      vals[0], n_valid));
  for (int p = 1; p < passes; ++p) {
    const int* k_in = keys[(p - 1) % 2];
    const int* v_in = vals[(p - 1) % 2];
    const int shift = kRadixBits * p;
    LAUNCH(radix_hist<<<blocks(tiles), kBlock, 0, s>>>(k_in, n_valid, nt,
                                                         shift, counts));
    LAUNCH(radix_scan<<<kBuckets, kBlock, 0, s>>>(counts, nt, totals));
    LAUNCH(radix_scatter<<<blocks(tiles), kBlock, 0, s>>>(
        k_in, v_in, n_valid, nt, shift, counts, totals, keys[p % 2],
        vals[p % 2]));
  }
  const int last = (passes - 1) % 2;
  LAUNCH(deposit_sum<D, F><<<blocks((n_keys + kSumTile - 1) / kSumTile),
                             kBlock, 0, s>>>(dp, rec, keys[last], vals[last],
                                             n_valid, grad));
  return cudaSuccess;
}

}  // namespace

// The table gradient into `grad` (n_entries * F floats; rows no deposit
// names are zero): `mode` 0 exact, 1 the one fully sampled corner, 2 the
// 2^j fetched ones; n_keys = grid_deposit_count(...) < 2^31, and the
// scratch as grid_deposit_scratch says: rec active * n records, counts and
// totals, keys0 / vals0 n_keys ints each, keys1 / vals1 as many where the
// sort takes more than one pass (else null), n_valid one int.
extern "C" int grid_table_gradient_launch(
    const int* ints, const float* scales, const float* x, const float* u,
    const long long* axis, const float* grad_out, float* rec, int* counts,
    int* totals, int* keys0, int* vals0, int* keys1, int* vals1,
    int* n_valid, float* grad, long long n_entries, long long n, int active,
    int mode, int j, void* stream) {
  Grid g;
  if (!make_grid(ints, scales, &g) || n < 1 || active < 1 ||
      active > g.n_levels || mode < kExact || mode > kFetched ||
      (mode != kExact && u == nullptr) ||
      (mode == kFetched && (j < 1 || j >= g.n_dims || axis == nullptr)))
    return cudaErrorInvalidValue;
  const long long n_keys = grid_deposit_count(g.n_dims, n, active, mode, j);
  long long scratch[5];
  grid_deposit_scratch(g.n_dims, g.n_features, n_entries, n, active, mode, j,
                       scratch);
  const int passes = static_cast<int>(scratch[3]);
  if (n_keys >= (1LL << 31) || kRadixBits * passes > 32 ||
      (passes > 1 && (keys1 == nullptr || vals1 == nullptr)))
    return cudaErrorInvalidValue;
  int* const keys[2] = {keys0, keys1};
  int* const vals[2] = {vals0, vals1};
  const Deposits dp = make_deposits(g, n, active, mode, j);
  auto s = static_cast<cudaStream_t>(stream);
  GRID_DISPATCH(g, return table_gradient<D, F>(
                       g, dp, x, u, axis, grad_out, rec, counts, totals,
                       keys, vals, n_valid, grad, n_entries * F, n_keys,
                       passes, s));
}

// d(loss)/dx (n, D) of the exact encode over the `active` levels.
extern "C" int grid_input_gradient_launch(const int* ints, const float* scales,
                                          const float* x, const float* table,
                                          const float* grad_out, float* grad_x,
                                          long long n, int active,
                                          void* stream) {
  Grid g;
  if (!make_grid(ints, scales, &g) || n < 1 || active < 0 ||
      active > g.n_levels)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  GRID_DISPATCH(g, grid_input_gradient<D, F><<<blocks_for(n), kBlock, 0,
                                                 s>>>(g, x, table, grad_out,
                                                      grad_x, n, active));
}
