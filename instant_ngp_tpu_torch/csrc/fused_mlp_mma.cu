// Fused forward of a bias-free MLP on Hopper (sm_90a): the instantiations
// for the shapes the configurations produce, with the activations held in
// registers from the first layer to the last.
//
// Replaces the TPU kernel instant_ngp_tpu/ops/pallas/mlp_kernels.py::
// fused_mlp_forward, like fused_mlp.cu (the general path, which takes every
// shape that has no instantiation here). For x (N, D_in), f32 or bf16:
//     h = bf16(x); per layer h = h @ W_i (bf16 operands, f32 sums);
//     between layers h = bf16(hidden_act(h)); out = out_act(h) as f32.
// Its plain PyTorch version is ops/kernels/mlp_kernels.py::
// fused_mlp_forward_plain; the wrapper there picks the path from the shape
// and validates every argument before calling fused_mlp_mma_launch below.
//
// What bounds it on this card: bytes. A row of the NeRF nets (density
// 32->64->16, RGB 32->64->64->3) costs 6-13 kFLOP but moves 128 B in and
// 64 or 12 B out, 20-30 FLOP/B against the ~295 FLOP/B where an H100's
// tensor cores take over. The least time is the rows over 3.35 TB/s, so the
// design spends as few instructions and as little shared-memory traffic per
// row as it can, and keeps the input stream ahead of the arithmetic:
//   - widths and activations are template parameters (the hidden-layer
//     count is a loop bound), so every fragment array stays in registers;
//   - a warp owns 16 or 32 rows. A layer is mma.sync.m16n8k16 (bf16 x bf16,
//     f32 sums); the accumulators of two neighbouring 8-column tiles hold,
//     lane for lane, the A operand of one 16-deep step of the next layer,
//     so activation + bf16 rounding turn them into that operand in place:
//     no shared-memory round trip and no sync between layers;
//   - the weights are packed on the host in the order the B fragments are
//     read (ops/kernels/mlp_kernels.py::pack_weights): one conflict-free
//     16-byte load per lane brings two fragments, used for every 16-row
//     group the warp owns;
//   - x is contiguous, so a 128-row tile is one run of bytes: one elected
//     thread fetches it with cp.async.bulk into a ring of shared-memory
//     stages, one mbarrier per stage, 1-3 tiles ahead of the arithmetic.
//     A stage is released as soon as its rows sit in registers. Where x
//     is not 16-byte aligned or narrower than its padded width, each warp
//     loads its own rows with plain coalesced loads instead;
//   - full-width outputs are stored from the accumulators (8 bytes a lane,
//     whole 32-byte sectors); narrow ones (RGB's 3 floats a row) are
//     gathered in shared memory and written as the warp's contiguous run;
//   - the grid is the resident blocks, each staging the weights once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

namespace {

constexpr int kMaxLayers = 9;
constexpr int kTileRows = 128;
constexpr int kMaxStages = 4;
// a wait that lasts this long is a fault of the pipeline: trap, not hang
constexpr unsigned long long kWaitLimitNs = 2000000000ull;

enum Activation { kNone = 0, kRelu = 1, kSine = 2, kExp = 3 };

template <int ACT>
__device__ __forceinline__ float activate(float v) {
  if constexpr (ACT == kRelu) return fmaxf(v, 0.f);
  else if constexpr (ACT == kSine) return sinf(v);
  else if constexpr (ACT == kExp) return expf(v);
  else return v;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Returns once the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  unsigned long long t0 = 0;
  for (uint32_t spins = 1;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if ((spins & 1023u) == 0) {
      unsigned long long now;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
      if (t0 == 0) t0 = now;
      else if (now - t0 > kWaitLimitNs) __trap();
    }
  }
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[m][n] = a[m][.] x W for a layer of KS 16-deep steps and NT 8-column
// tiles, W in fragment order in shared memory: the lanes' 16 bytes (two
// tiles' fragments) of one (step, tile pair) lie back to back, so a warp's
// load is one conflict-free run; an odd tile count packs 8 bytes a lane.
template <int MT, int KS, int NT>
__device__ __forceinline__ void layer(const uint32_t (&a)[MT][KS][4],
                                      float (&acc)[MT][NT][4],
                                      const __nv_bfloat16* w, int lane) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][n][i] = 0.f;
  if constexpr (NT % 2 == 0) {
    const uint4* wp = reinterpret_cast<const uint4*>(w) + lane;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int ng = 0; ng < NT / 2; ++ng) {
        const uint4 b = wp[(ks * (NT / 2) + ng) * 32];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          mma_bf16(acc[m][2 * ng], a[m][ks], b.x, b.y);
          mma_bf16(acc[m][2 * ng + 1], a[m][ks], b.z, b.w);
        }
      }
  } else {
    const uint2* wp = reinterpret_cast<const uint2*>(w) + lane;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const uint2 b = wp[(ks * NT + n) * 32];
#pragma unroll
        for (int m = 0; m < MT; ++m) mma_bf16(acc[m][n], a[m][ks], b.x, b.y);
      }
  }
}

// The accumulators of column tiles 2k and 2k+1, activated and rounded to
// bf16, are the A operand of the next layer's k-th step, lane for lane.
template <int ACT, int MT, int NT>
__device__ __forceinline__ void to_operand(const float (&acc)[MT][NT][4],
                                           uint32_t (&a)[MT][NT / 2][4]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int ks = 0; ks < NT / 2; ++ks)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi)
#pragma unroll
        for (int half = 0; half < 2; ++half)
          a[m][ks][half + 2 * hi] =
              pack_bf16(activate<ACT>(acc[m][2 * ks + hi][2 * half]),
                        activate<ACT>(acc[m][2 * ks + hi][2 * half + 1]));
}

// A operands of the first layer from float32 rows in shared memory (row
// stride IN_P floats). Lane (g, t) reads columns 16 ks + 4t .. + 3 of rows
// g and g + 8 with one 16-byte load each: its two k slots of a step hold
// columns 4t + {0, 1} and 4t + {2, 3}, and the first layer's weights are
// packed with the same permutation. With an even number of steps the rows
// are a multiple of 128 bytes apart, so odd rows read the two steps of a
// pair in the other order to keep the eight lanes of a quarter warp on
// different banks.
template <int MT, int IN_P>
__device__ __forceinline__ void load_rows_f32(const float* rows, int lane,
                                              uint32_t (&a)[MT][IN_P / 16][4]) {
  constexpr int KS = IN_P / 16;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float* r = rows + (m * 16 + g + 8 * half) * IN_P + 4 * t;
      if constexpr (KS % 2 == 0) {
        const bool odd = g & 1;
#pragma unroll
        for (int p = 0; p < KS / 2; ++p) {
          const float4 u =
              *reinterpret_cast<const float4*>(r + 16 * (2 * p + (odd ? 1 : 0)));
          const float4 v =
              *reinterpret_cast<const float4*>(r + 16 * (2 * p + (odd ? 0 : 1)));
          const uint32_t u0 = pack_bf16(u.x, u.y), u1 = pack_bf16(u.z, u.w);
          const uint32_t v0 = pack_bf16(v.x, v.y), v1 = pack_bf16(v.z, v.w);
          a[m][2 * p][half] = odd ? v0 : u0;
          a[m][2 * p][half + 2] = odd ? v1 : u1;
          a[m][2 * p + 1][half] = odd ? u0 : v0;
          a[m][2 * p + 1][half + 2] = odd ? u1 : v1;
        }
      } else {
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          const float4 u = *reinterpret_cast<const float4*>(r + 16 * ks);
          a[m][ks][half] = pack_bf16(u.x, u.y);
          a[m][ks][half + 2] = pack_bf16(u.z, u.w);
        }
      }
    }
}

// The same from bf16 rows (row stride IN_P elements): 8 bytes a lane.
template <int MT, int IN_P>
__device__ __forceinline__ void load_rows_bf16(const __nv_bfloat16* rows,
                                               int lane,
                                               uint32_t (&a)[MT][IN_P / 16][4]) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const __nv_bfloat16* r = rows + (m * 16 + g + 8 * half) * IN_P + 4 * t;
#pragma unroll
      for (int ks = 0; ks < IN_P / 16; ++ks) {
        const uint2 u = *reinterpret_cast<const uint2*>(r + 16 * ks);
        a[m][ks][half] = u.x;
        a[m][ks][half + 2] = u.y;
      }
    }
}

// One block walks over 128-row tiles; a warp owns 16 * MT of a tile's rows.
// Dynamic shared memory: [n_stages input stages][output gather, only where
// d_out < OUT_P][weights][2 * kMaxStages mbarriers].
template <int IN_P, int HID, int OUT_P, int HACT, int OACT, int MT>
__global__ void __launch_bounds__(kTileRows / (16 * MT) * 32, MT == 2 ? 4 : 1)
fused_mlp_mma_kernel(const void* __restrict__ x, int x_is_bf16, int use_bulk,
                     const __nv_bfloat16* __restrict__ w, int w_elems,
                     float* __restrict__ out, int n_rows, int d_in, int d_out,
                     int n_layers, int n_stages) {
  constexpr int kWarps = kTileRows / (16 * MT);
  constexpr int kWarpRows = 16 * MT;
  constexpr int KS_IN = IN_P / 16, KS_H = HID / 16;
  constexpr int NT_H = HID / 8, NT_O = OUT_P / 8;
  constexpr int kStageBytes = kTileRows * IN_P * 4;

  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* stages = smem;
  float* gather = reinterpret_cast<float*>(smem + n_stages * kStageBytes);
  const int gather_bytes = d_out == OUT_P ? 0 : kTileRows * OUT_P * 4;
  __nv_bfloat16* w_s = reinterpret_cast<__nv_bfloat16*>(
      smem + n_stages * kStageBytes + gather_bytes);
  uint64_t* bars = reinterpret_cast<uint64_t*>(w_s + w_elems);
  const uint32_t full0 = smem_addr(bars);
  const uint32_t empty0 = smem_addr(bars + kMaxStages);

  {
    const int4* src = reinterpret_cast<const int4*>(w);
    int4* dst = reinterpret_cast<int4*>(w_s);
    for (int i = threadIdx.x; i < w_elems / 8; i += blockDim.x) dst[i] = src[i];
  }
  if (use_bulk && threadIdx.x == 0) {
    for (int s = 0; s < n_stages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int n_tiles = (n_rows + kTileRows - 1) / kTileRows;
  const int n_mine = (n_tiles - int(blockIdx.x) + int(gridDim.x) - 1) / int(gridDim.x);
  const size_t row_bytes = size_t(IN_P) * (x_is_bf16 ? 2 : 4);
  const unsigned char* xb = reinterpret_cast<const unsigned char*>(x);

  // producer state (thread 0): the next tile to fetch, its stage, and how
  // often the ring has wrapped; consumer state: stage and phase parity
  int p_next = 0, p_stage = 0, p_wraps = 0;
  int c_stage = 0;
  uint32_t c_parity = 0;

  auto fetch = [&]() {
    if (p_wraps > 0) mbar_wait(empty0 + 8 * p_stage, (p_wraps - 1) & 1);
    // the warps' reads of this stage come before the copy's writes
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    const long long row0 =
        (long long)(blockIdx.x + (long long)p_next * gridDim.x) * kTileRows;
    const long long left = n_rows - row0;
    const uint32_t bytes =
        uint32_t((left < kTileRows ? left : kTileRows) * row_bytes);
    mbar_expect_tx(full0 + 8 * p_stage, bytes);
    bulk_load(smem_addr(stages + p_stage * kStageBytes), xb + row0 * row_bytes,
              bytes, full0 + 8 * p_stage);
    ++p_next;
    if (++p_stage == n_stages) { p_stage = 0; ++p_wraps; }
  };

  if (use_bulk && threadIdx.x == 0)
    while (p_next < n_stages - 1 && p_next < n_mine) fetch();

  for (int it = 0; it < n_mine; ++it) {
    const long long row0 =
        (long long)(blockIdx.x + (long long)it * gridDim.x) * kTileRows +
        warp * kWarpRows;
    uint32_t a_in[MT][KS_IN][4];

    if (use_bulk) {
      if (threadIdx.x == 0 && p_next < n_mine) fetch();
      __syncwarp();
      mbar_wait(full0 + 8 * c_stage, c_parity);
      const unsigned char* mine =
          stages + c_stage * kStageBytes + warp * kWarpRows * row_bytes;
      if (x_is_bf16)
        load_rows_bf16<MT, IN_P>(reinterpret_cast<const __nv_bfloat16*>(mine),
                                 lane, a_in);
      else
        load_rows_f32<MT, IN_P>(reinterpret_cast<const float*>(mine), lane, a_in);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * c_stage);
      if (++c_stage == n_stages) { c_stage = 0; c_parity ^= 1; }
    } else {
      // this warp's rows only: no other warp reads or writes them
      float* mine = reinterpret_cast<float*>(stages) + warp * kWarpRows * IN_P;
      __syncwarp();
#pragma unroll 8
      for (int r = 0; r < kWarpRows; ++r) {
        const long long gr = row0 + r;
#pragma unroll
        for (int c = lane; c < IN_P; c += 32) {
          float v = 0.f;
          if (gr < n_rows && c < d_in)
            v = x_is_bf16
                    ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(
                          x)[gr * d_in + c])
                    : reinterpret_cast<const float*>(x)[gr * d_in + c];
          mine[r * IN_P + c] = v;
        }
      }
      __syncwarp();
      load_rows_f32<MT, IN_P>(mine, lane, a_in);
    }

    float acc_o[MT][NT_O][4];
    if (n_layers == 1) {
      layer<MT, KS_IN, NT_O>(a_in, acc_o, w_s, lane);
    } else {
      float acc[MT][NT_H][4];
      uint32_t a_h[MT][KS_H][4];
      layer<MT, KS_IN, NT_H>(a_in, acc, w_s, lane);
      to_operand<HACT, MT, NT_H>(acc, a_h);
      const __nv_bfloat16* wl = w_s + IN_P * HID;
      for (int l = 2; l < n_layers; ++l) {
        layer<MT, KS_H, NT_H>(a_h, acc, wl, lane);
        to_operand<HACT, MT, NT_H>(acc, a_h);
        wl += HID * HID;
      }
      layer<MT, KS_H, NT_O>(a_h, acc_o, wl, lane);
    }

    if (d_out == OUT_P) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const long long gr = row0 + m * 16 + g + 8 * half;
          if (gr < n_rows) {
#pragma unroll
            for (int n = 0; n < NT_O; ++n)
              *reinterpret_cast<float2*>(out + gr * OUT_P + n * 8 + 2 * t) =
                  make_float2(activate<OACT>(acc_o[m][n][2 * half]),
                              activate<OACT>(acc_o[m][n][2 * half + 1]));
          }
        }
    } else {
      float* mine = gather + warp * kWarpRows * OUT_P;
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int n = 0; n < NT_O; ++n)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int c = n * 8 + 2 * t + j;
              if (c < d_out)
                mine[(m * 16 + g + 8 * half) * d_out + c] =
                    activate<OACT>(acc_o[m][n][2 * half + j]);
            }
      __syncwarp();
      const long long left = n_rows - row0;
      const int count = int(left < kWarpRows ? (left < 0 ? 0 : left) : kWarpRows) * d_out;
      float* dst = out + row0 * d_out;
      for (int e = lane; e < count; e += 32) dst[e] = mine[e];
      __syncwarp();
    }
  }
}

struct Variant {
  int in_p, hid, out_p, hact, oact, threads;
  const void* fn;
};

#define MLP_VARIANT(IN_P, HID, OUT_P, HACT, OACT, MT)                      \
  {                                                                        \
    IN_P, HID, OUT_P, HACT, OACT, kTileRows / (16 * MT) * 32,              \
        reinterpret_cast<const void*>(                                     \
            &fused_mlp_mma_kernel<IN_P, HID, OUT_P, HACT, OACT, MT>)       \
  }

// Mirrored by MMA_VARIANTS in ops/kernels/mlp_kernels.py. A 64-wide net's
// warp takes 32 rows (each weight fragment feeds two row groups); a
// 128-wide one takes 16, to stay inside the register file.
const Variant kVariants[] = {
    MLP_VARIANT(32, 64, 16, kRelu, kNone, 2),   // NeRF density nets
    MLP_VARIANT(32, 64, 8, kRelu, kNone, 2),    // NeRF RGB, image, SDF nets
    MLP_VARIANT(16, 64, 16, kRelu, kNone, 2),   // density net, one-level grid
    MLP_VARIANT(32, 64, 8, kRelu, kRelu, 2),    // volume nets
    MLP_VARIANT(32, 128, 16, kRelu, kNone, 1),  // 128-wide nets
};

// (padded input, hidden, padded output) of a chain, or false where the
// chain is not one hidden width of 64 or 128 between <= 32 inputs and
// <= 16 outputs. A single layer counts as 64-wide.
bool shape_of(int n_layers, const int* dims, int* in_p, int* hid, int* out_p) {
  if (n_layers < 1 || n_layers > kMaxLayers) return false;
  for (int i = 0; i <= n_layers; ++i)
    if (dims[i] < 1) return false;
  *in_p = (dims[0] + 15) / 16 * 16;
  *hid = n_layers == 1 ? 64 : dims[1];
  for (int i = 2; i < n_layers; ++i)
    if (dims[i] != *hid) return false;
  const int d_out = dims[n_layers];
  *out_p = d_out <= 8 ? 8 : 16;
  return d_out <= 16;
}

const Variant* find_variant(int n_layers, const int* dims, int hact, int oact) {
  int in_p, hid, out_p;
  if (!shape_of(n_layers, dims, &in_p, &hid, &out_p)) return nullptr;
  for (const Variant& v : kVariants)
    if (v.in_p == in_p && v.hid == hid && v.out_p == out_p && v.hact == hact &&
        v.oact == oact)
      return &v;
  return nullptr;
}

// The most resident blocks of `fn` with `smem` bytes of dynamic shared
// memory on the current device. The attribute (set once per function and
// device, at the opt-in maximum), the SM count and the occupancy are
// queried once per (function, device, smem), not per launch: the render
// loop makes many small calls. ctypes releases the GIL, so the cache is
// guarded.
cudaError_t resident_blocks(const Variant& v, size_t smem, int* grid) {
  struct Entry { const void* fn; int device; size_t smem; int grid; };
  static std::mutex mu;
  static Entry cache[256];
  static int n_cached = 0;

  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  bool attr_set = false;
  for (int i = 0; i < n_cached; ++i) {
    if (cache[i].fn != v.fn || cache[i].device != device) continue;
    attr_set = true;
    if (cache[i].smem == smem) {
      *grid = cache[i].grid;
      return cudaSuccess;
    }
  }
  if (!attr_set) {
    int optin = 0;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 device);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(v.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
    if (err != cudaSuccess) return err;
  }
  int n_sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, v.fn, v.threads,
                                                      smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *grid = n_sms * per_sm;
  if (n_cached < 256) cache[n_cached++] = {v.fn, device, smem, *grid};
  return cudaSuccess;
}

}  // namespace

// 1 where (dims, activations) has an instantiation here, else 0.
extern "C" int fused_mlp_mma_has_variant(int n_layers, const int* dims,
                                         int hidden_act, int out_act) {
  return find_variant(n_layers, dims, hidden_act, out_act) != nullptr;
}

// Plain C entry point for ctypes. `w` is the fragment-order packing of
// pack_weights, `n_stages` the depth of the input ring (1-4). Returns 0 or
// a cudaError_t; launches on `stream` and never synchronises.
extern "C" int fused_mlp_mma_launch(const void* x, int x_is_bf16, const void* w,
                                    int w_elems, void* out, int n_rows,
                                    int n_layers, const int* dims,
                                    int hidden_act, int out_act, int n_stages,
                                    void* stream) {
  const Variant* v = find_variant(n_layers, dims, hidden_act, out_act);
  if (v == nullptr || n_stages < 1 || n_stages > kMaxStages)
    return cudaErrorInvalidValue;
  int d_in = dims[0], d_out = dims[n_layers];
  const int expect = n_layers == 1
                         ? v->in_p * v->out_p
                         : v->in_p * v->hid + (n_layers - 2) * v->hid * v->hid +
                               v->hid * v->out_p;
  if (expect != w_elems) return cudaErrorInvalidValue;

  // the bulk copy needs 16-byte aligned runs of whole padded rows
  int use_bulk = d_in == v->in_p && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (!use_bulk) n_stages = 1;
  const size_t smem = size_t(n_stages) * kTileRows * v->in_p * 4 +
                      (d_out == v->out_p ? 0 : kTileRows * v->out_p * 4) +
                      size_t(w_elems) * 2 + 2 * kMaxStages * 8;

  int resident = 0;
  cudaError_t err = resident_blocks(*v, smem, &resident);
  if (err != cudaSuccess) return err;
  const int n_tiles = (n_rows + kTileRows - 1) / kTileRows;
  const int grid = n_tiles < resident ? n_tiles : resident;
  if (grid == 0) return cudaSuccess;

  const __nv_bfloat16* wp = static_cast<const __nv_bfloat16*>(w);
  float* op = static_cast<float*>(out);
  void* args[] = {&x,      &x_is_bf16, &use_bulk, &wp,       &w_elems, &op,
                  &n_rows, &d_in,      &d_out,    &n_layers, &n_stages};
  return int(cudaLaunchKernel(v->fn, dim3(grid), dim3(v->threads), args, smem,
                              static_cast<cudaStream_t>(stream)));
}
