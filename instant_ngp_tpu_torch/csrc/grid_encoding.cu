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
// What bounds them on this card: bytes, and in practice the latency of
// the gathers. A point at a level reads 2^d table rows of F floats at
// hashed addresses (1.07 GB gathered at 2^20 points of configs/nerf/
// base.json against 193 MB that must move), so the design keeps every
// gather one vector load and as many of them in flight as it can:
//   - forward: one thread per (point, level), neighbouring threads on the
//     levels of one point, so the output is written in whole runs; a
//     row's F features are one 8-, 16- or two 16-byte loads in the
//     interleaved layout;
//   - table gradient: no float atomics (their order changes between runs,
//     and Adam's eps of 1e-15 turns the difference of near-zero sums into
//     full-size steps). `grid_deposit_keys` writes one int32 key, the
//     table row, per deposited (group, level, point, corner), and kSkip for
//     the deposits of a point whose gradient at that level is zero (a train
//     step's padded samples: one position, so one very long run each); the
//     wrapper orders the keys with a stable sort, once for all levels; and
//     `grid_deposit_sum` gives each run of equal keys to the thread at its
//     head, or to that thread's warp where the run is long, and recomputes
//     every deposit g * weight from x and the draws (the (N, C, F)
//     deposits are never stored) and adds them in that order, each product
//     rounded before the add. That is the order and the arithmetic of
//     `index_put_` with accumulate on CUDA, which the plain version calls
//     once per level and group: within a row, one sequential float32 sum
//     per group (the stochastic j-axis deposit calls it once per fetched
//     corner), and the groups' sums added in turn: the plain card path's
//     bits for 2, 4 and 8 features a level, the counts instantiated here
//     (for a one-column slice index_put_ sums long runs by a warp tree);
//   - input gradient: one thread per point walks its levels and corners
//     and writes its d values once.

#include <cuda_runtime.h>

#include <cstdint>

#include "grid_encoding.cuh"

namespace {

using namespace ngp_grid;

constexpr int kBlock = 256;
// table-gradient modes: every corner weighted (the exact encode), the one
// fully sampled corner with weight 1 (j = 0, or `stochastic_bwd`), the 2^j
// fetched corners weighted, one group (plain `index_put_` call) each
constexpr int kExact = 0, kOneCorner = 1, kFetched = 2;
// the key of a deposit that adds nothing (its point's gradient at that
// level is zero): above every table row, so it sorts last and is skipped
constexpr int kSkip = 0x7fffffff;
// the longest run of equal keys one thread sums alone
constexpr long long kLongRun = 16;

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

// Exact (j < 0) or stochastic forward; levels from `active` on are masked
// (max_level) and give zeros.
template <int D, int F>
__global__ void __launch_bounds__(kBlock) grid_forward(
    const Grid g, const float* __restrict__ x, const float* __restrict__ table,
    const float* __restrict__ u, const long long* __restrict__ axis,
    float* __restrict__ out, long long n, int active, int j) {
  const long long t = blockIdx.x * static_cast<long long>(kBlock) + threadIdx.x;
  const int n_levels = g.n_levels;
  if (t >= n * n_levels) return;
  const long long pt = t / n_levels;
  const int lvl = static_cast<int>(t - pt * n_levels);
  float acc[F];
#pragma unroll
  for (int k = 0; k < F; ++k) acc[k] = 0.0f;
  if (lvl < active) {
    float xp[D], w[D], dw[D], f[F];
    int pos0[D], c[D];
    load_point<D>(x, pt, xp);
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
    } else {
      int bern[D];
      sampled_bits<D>(u, n, n_levels, pt, lvl, w, bern);
      if (j == 0) {
#pragma unroll
        for (int k = 0; k < D; ++k) c[k] = pos0[k] + bern[k];
        load_row<F>(table + static_cast<long long>(corner_row<D>(g, lvl, c)) * F,
                    acc);
      } else {
        const int a = static_cast<int>(axis[pt * n_levels + lvl]);
        for (int combo = 0; combo < (1 << j); ++combo) {
          const float weight = fetched_corner<D>(j, a, combo, pos0, w, bern, c);
          load_row<F>(
              table + static_cast<long long>(corner_row<D>(g, lvl, c)) * F, f);
#pragma unroll
          for (int k = 0; k < F; ++k)
            acc[k] = combo == 0 ? __fmul_rn(f[k], weight)
                                : __fadd_rn(acc[k], __fmul_rn(f[k], weight));
        }
      }
    }
  }
  store_row<F>(out + t * F, acc);
}

// The deposits of one table-gradient call, laid out [group][level][point]
// [corner] over the `active` levels: K corners a (group, level, point),
// 2^D for kExact and 1 otherwise; 2^j groups for kFetched, else 1.
struct Deposits {
  long long n;
  int active, mode, j, groups, k;
};

__device__ __forceinline__ void decode(const Deposits& dp, long long e,
                                       int* group, int* lvl, long long* pt,
                                       int* corner) {
  *corner = static_cast<int>(e % dp.k);
  const long long t = e / dp.k;
  *pt = t % dp.n;
  const long long gl = t / dp.n;
  *lvl = static_cast<int>(gl % dp.active);
  *group = static_cast<int>(gl / dp.active);
}

// True where every feature of grad_out's row for (point, level) is zero.
// Such a point adds +-0 at that level to every row it touches, which
// leaves each float32 sum of the plain version's order with the bits it
// has without them (a sum from +0 never becomes -0, and x + (+-0) = x), so
// its deposits get the key kSkip and no thread adds them. A train step's
// padded samples (the tail of its fixed batch) are such points.
template <int F>
__device__ __forceinline__ bool zero_gradient(const float* __restrict__ grad_out,
                                              long long pt, int n_levels,
                                              int lvl) {
  float gv[F];
  load_row<F>(grad_out + (pt * n_levels + lvl) * F, gv);
  bool zero = true;
#pragma unroll
  for (int k = 0; k < F; ++k) zero = zero && gv[k] == 0.0f;
  return zero;
}

// One thread per (group, level, point): the keys (table rows, or kSkip)
// of its K deposits.
template <int D, int F>
__global__ void __launch_bounds__(kBlock) grid_deposit_keys(
    const Grid g, const Deposits dp, const float* __restrict__ x,
    const float* __restrict__ u, const long long* __restrict__ axis,
    const float* __restrict__ grad_out, int* __restrict__ keys) {
  const long long t = blockIdx.x * static_cast<long long>(kBlock) + threadIdx.x;
  if (t >= dp.n * dp.active * dp.groups) return;
  const long long pt = t % dp.n;
  const long long gl = t / dp.n;
  const int lvl = static_cast<int>(gl % dp.active);
  const int group = static_cast<int>(gl / dp.active);
  if (zero_gradient<F>(grad_out, pt, g.n_levels, lvl)) {
    for (int corner = 0; corner < dp.k; ++corner)
      keys[t * dp.k + corner] = kSkip;
    return;
  }
  float xp[D], w[D], dw[D];
  int pos0[D], c[D];
  load_point<D>(x, pt, xp);
  level_point<D>(g, lvl, xp, pos0, w, dw);
  if (dp.mode == kExact) {
#pragma unroll
    for (int corner = 0; corner < (1 << D); ++corner) {
#pragma unroll
      for (int k = 0; k < D; ++k) c[k] = pos0[k] + corner_bit<D>(corner, k);
      keys[t * (1 << D) + corner] = corner_row<D>(g, lvl, c);
    }
    return;
  }
  int bern[D];
  sampled_bits<D>(u, dp.n, g.n_levels, pt, lvl, w, bern);
  if (dp.mode == kOneCorner) {
#pragma unroll
    for (int k = 0; k < D; ++k) c[k] = pos0[k] + bern[k];
  } else {
    fetched_corner<D>(dp.j, static_cast<int>(axis[pt * g.n_levels + lvl]),
                      group, pos0, w, bern, c);
  }
  keys[t] = corner_row<D>(g, lvl, c);
}

// The deposit at position e of the layout: writes g * weight (g alone for
// kOneCorner) to v and returns its group.
template <int D, int F>
__device__ __forceinline__ int deposit_value(
    const Grid& g, const Deposits& dp, const float* __restrict__ x,
    const long long* __restrict__ axis, const float* __restrict__ grad_out,
    long long e, float* v) {
  int group, lvl, corner;
  long long pt;
  decode(dp, e, &group, &lvl, &pt, &corner);
  float weight = 1.0f;
  if (dp.mode != kOneCorner) {
    float xp[D], w[D], dw[D];
    int pos0[D];
    load_point<D>(x, pt, xp);
    level_point<D>(g, lvl, xp, pos0, w, dw);
    if (dp.mode == kExact) {
      weight = corner_weight<D>(w, corner);
    } else {
      int c[D], bern[D] = {};
      weight = fetched_corner<D>(
          dp.j, static_cast<int>(axis[pt * g.n_levels + lvl]), group, pos0, w,
          bern, c);
    }
  }
  load_row<F>(grad_out + (pt * g.n_levels + lvl) * F, v);
  if (dp.mode != kOneCorner) {
#pragma unroll
    for (int k = 0; k < F; ++k) v[k] = __fmul_rn(v[k], weight);
  }
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

// The end of the run of `key` that starts at p: a galloping search, then
// a binary one.
__device__ __forceinline__ long long run_end(const int* __restrict__ sorted,
                                             long long p, long long n_keys,
                                             int key) {
  long long lo = p, hi = p + 1, step = 1;   // sorted[lo] == key
  while (hi < n_keys && sorted[hi] == key) {
    lo = hi;
    step <<= 1;
    hi = lo + step;
  }
  hi = min(hi, n_keys);                     // hi == n_keys or != key
  while (hi - lo > 1) {
    const long long mid = lo + (hi - lo) / 2;
    if (sorted[mid] == key) lo = mid; else hi = mid;
  }
  return hi;
}

// One thread per position of the stably sorted keys (`sorted`, and
// `perm`, each sorted key's position in the deposit layout); the thread at
// the head of a run of equal keys owns the run. A run of up to kLongRun
// deposits its owner sums alone; a longer one (a coarse level's row, that
// many points share) the owner's whole warp sums: each lane computes one
// deposit of every 32 and the lanes add the 32 in order through shuffles,
// so 32 gathers are in flight and the sum is the same sequence. Either way
// the sum is sequential in the sorted order, one partial sum a group added
// to the total in turn, and written once to the key's table row.
template <int D, int F>
__global__ void __launch_bounds__(kBlock) grid_deposit_sum(
    const Grid g, const Deposits dp, const float* __restrict__ x,
    const long long* __restrict__ axis, const float* __restrict__ grad_out,
    const int* __restrict__ sorted, const long long* __restrict__ perm,
    long long n_keys, float* __restrict__ grad) {
  const long long p = blockIdx.x * static_cast<long long>(kBlock) + threadIdx.x;
  const int lane = threadIdx.x % 32;
  const int key = p < n_keys ? sorted[p] : kSkip;
  const bool head = key != kSkip && (p == 0 || sorted[p - 1] != key);
  const long long end = head ? run_end(sorted, p, n_keys, key) : p;
  const bool long_run = end - p > kLongRun;
  float total[F], acc[F], v[F];
  int current = -1;
  if (head && !long_run) {
#pragma unroll
    for (int k = 0; k < F; ++k) total[k] = acc[k] = 0.0f;
    for (long long q = p; q < end; ++q) {
      const int group =
          deposit_value<D, F>(g, dp, x, axis, grad_out, perm[q], v);
      add_in_order<F>(group, v, current, total, acc);
    }
#pragma unroll
    for (int k = 0; k < F; ++k) total[k] = __fadd_rn(total[k], acc[k]);
    store_row<F>(grad + static_cast<long long>(key) * F, total);
  }
  // every lane takes part: the warp sums its lanes' long runs one by one
  unsigned owners = __ballot_sync(0xffffffffu, long_run);
  while (owners) {
    const int src = __ffs(owners) - 1;
    owners &= owners - 1;
    const long long rp = __shfl_sync(0xffffffffu, p, src);
    const long long rend = __shfl_sync(0xffffffffu, end, src);
    const int rkey = __shfl_sync(0xffffffffu, key, src);
#pragma unroll
    for (int k = 0; k < F; ++k) total[k] = acc[k] = 0.0f;
    current = -1;
    for (long long base = rp; base < rend; base += 32) {
      int group = 0;
      if (base + lane < rend)
        group = deposit_value<D, F>(g, dp, x, axis, grad_out,
                                    perm[base + lane], v);
      const int count = static_cast<int>(min(32LL, rend - base));
      for (int i = 0; i < count; ++i) {
        float vi[F];
#pragma unroll
        for (int k = 0; k < F; ++k) vi[k] = __shfl_sync(0xffffffffu, v[k], i);
        add_in_order<F>(__shfl_sync(0xffffffffu, group, i), vi, current, total,
                        acc);
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < F; ++k) total[k] = __fadd_rn(total[k], acc[k]);
      store_row<F>(grad + static_cast<long long>(rkey) * F, total);
    }
  }
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
  GRID_DISPATCH(g, grid_forward<D, F><<<blocks_for(n * g.n_levels), kBlock,
                                          0, s>>>(g, x, table, u, axis, out, n,
                                                  active, j));
}

// The number of keys of a table-gradient call (the length of `keys`).
extern "C" long long grid_deposit_count(int n_dims, long long n, int active,
                                        int mode, int j) {
  const long long groups = mode == kFetched ? (1LL << j) : 1;
  const long long k = mode == kExact ? (1LL << n_dims) : 1;
  return groups * active * n * k;
}

// Writes the int32 keys of every deposit of one table-gradient call:
// `mode` 0 exact, 1 the one fully sampled corner, 2 the 2^j fetched ones.
extern "C" int grid_deposit_keys_launch(const int* ints, const float* scales,
                                        const float* x, const float* u,
                                        const long long* axis,
                                        const float* grad_out, int* keys,
                                        long long n, int active, int mode,
                                        int j, void* stream) {
  Grid g;
  if (!make_grid(ints, scales, &g) || n < 1 || active < 1 ||
      active > g.n_levels || mode < kExact || mode > kFetched ||
      (mode != kExact && u == nullptr) ||
      (mode == kFetched && (j < 1 || j >= g.n_dims || axis == nullptr)))
    return cudaErrorInvalidValue;
  const Deposits dp{n, active, mode, j, mode == kFetched ? 1 << j : 1,
                    mode == kExact ? 1 << g.n_dims : 1};
  auto s = static_cast<cudaStream_t>(stream);
  GRID_DISPATCH(g, grid_deposit_keys<D, F><<<blocks_for(n * active *
                                                        dp.groups),
                                             kBlock, 0, s>>>(
                       g, dp, x, u, axis, grad_out, keys));
}

// Sums the deposits into `grad` (n_entries * F, zeroed by the caller; rows
// no key names stay zero) from the keys sorted stably (`sorted`) and the
// position of each in the deposit layout (`perm`).
extern "C" int grid_deposit_sum_launch(const int* ints, const float* scales,
                                       const float* x, const long long* axis,
                                       const float* grad_out,
                                       const int* sorted,
                                       const long long* perm, float* grad,
                                       long long n, int active, int mode,
                                       int j, void* stream) {
  Grid g;
  if (!make_grid(ints, scales, &g) || n < 1 || active < 1 ||
      active > g.n_levels || mode < kExact || mode > kFetched ||
      (mode == kFetched && (j < 1 || j >= g.n_dims || axis == nullptr)))
    return cudaErrorInvalidValue;
  const Deposits dp{n, active, mode, j, mode == kFetched ? 1 << j : 1,
                    mode == kExact ? 1 << g.n_dims : 1};
  const long long n_keys = grid_deposit_count(g.n_dims, n, active, mode, j);
  auto s = static_cast<cudaStream_t>(stream);
  GRID_DISPATCH(g, grid_deposit_sum<D, F><<<blocks_for(n_keys), kBlock, 0,
                                              s>>>(g, dp, x, axis, grad_out,
                                                   sorted, perm, n_keys,
                                                   grad));
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
