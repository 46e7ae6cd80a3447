// Fused forward of a bias-free MLP on Hopper (sm_90a) with warpgroup MMA:
// the streamed path (nets whose weights do not fit in shared memory at
// once: the 256-wide NeRF configs frequency.json and none.json, the
// 128-wide 6- and 8-layer SDF configs) and the general path (any other
// chain without an instantiation in fused_mlp_mma.cu, such as the 36-wide
// RGB net of a capture with latent dims or the Image configs' 64-wide
// input). Widths up to 256, 1-32 layers, any total weight size.
//
// Replaces the TPU kernel instant_ngp_tpu/ops/pallas/mlp_kernels.py::
// fused_mlp_forward for those shapes. For x (N, D_in), f32 or bf16:
//     h = bf16(x); per layer h = h @ W_i (bf16 operands, f32 sums);
//     between layers h = bf16(hidden_act(h)); out = out_act(h) as f32.
// Its plain PyTorch version is ops/kernels/mlp_kernels.py::
// fused_mlp_forward_plain; the wrapper there packs the weights
// (pack_weights: `packed_wgmma`) and validates every argument before
// calling fused_mlp_wgmma_launch below.
//
// What bounds it on this card: at 96-256x7-16 a row costs 0.84 MFLOP and
// moves 448 B, so the tensor cores set the bound (0.89 ms at 2^20 rows);
// the 1-hidden-layer RGB nets and the general path's 64-wide nets move
// more bytes than they compute. The design:
//   - a persistent block per SM walks 128-row tiles with three
//     warpgroups: two consumers that own 64 rows each and run
//     wgmma.mma_async m64nNk16 (N the layer's padded width NP = 64, 128 or
//     256 in one instruction; bf16 in, f32 sums), and a producer whose
//     two threads stream the weights and the input tiles;
//   - up to 128 wide the activations never leave the registers: the
//     input rows are loaded into A fragments, and the accumulator of a
//     layer, activated and rounded to bf16, is lane for lane the register A
//     operand of the next layer's 16-deep steps (the layout of
//     mma.m16n8k16 per warp). A 256-wide layer's sums take 128 registers a
//     thread, so its epilogue writes them, activated and rounded, into a
//     swizzled 64-row A tile in shared memory that the next layer's wgmma
//     reads (fence.proxy.async, then a named barrier of the warpgroup), and
//     setmaxnreg moves registers from the producer (40) to the consumers
//     (232);
//   - the weights are cut into chunks of 64 K-rows by the layer's padded
//     width. pack_weights lays out every chunk on the host as the exact
//     shared-memory image the wgmma descriptor reads (K-major, 128-byte
//     swizzle: 8-row atoms of 1024 bytes, 16-byte groups XORed with the
//     row), so one cp.async.bulk per chunk fills a stage of a ring with
//     full and empty mbarriers, ahead of the products;
//   - where every chunk of a net fits (the general path's nets, the
//     1-hidden-layer RGB nets) the chunks lie back to back, fetched once
//     per block; else they stream through the ring, tile after tile;
//   - where rows of x are a multiple of 16 bytes, the input tiles come
//     through a ring of 1-2 bulk-copied stages, else each warp loads its
//     rows;
//   - no C++ branch sits between wgmma instructions in flight (ptxas then
//     serializes them): barrier waits are one asm loop each, arrives are
//     predicated, every layer of a net up to 128 wide has the same number
//     of chunks (the first one padded), and the 256-wide first layer's
//     chunk count picks one of four unrolled pipelines;
//   - every barrier wait traps after 2 s, so a fault of the pipeline is a
//     CUDA error, not a hang.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <limits>
#include <mutex>

namespace {

constexpr int kTileRows = 128;
constexpr int kConsumerThreads = 256;  // two consumer warpgroups
constexpr int kThreads = kConsumerThreads + 128;   // and a producer one
constexpr int kMaxLayers = 32;
constexpr int kMaxStages = 16;
constexpr int kMaxInStages = 2;
constexpr int kNarrow = 16;            // output width of the narrow last layer
constexpr int kNarrowChunkBytes = kNarrow * 128;
constexpr int kAlign = 1024;           // a 128-byte swizzle atom
constexpr unsigned long long kWaitLimitNs = 2000000000ull;
// how long a waiting thread may sleep in try_wait before it looks again
// (the barrier's completion wakes it earlier)
constexpr uint32_t kSuspendNs = 10000000;

enum Activation { kNone = 0, kRelu = 1, kSine = 2, kExp = 3 };

struct WgShape {
  int n_layers, d_in, d_out;
  int kb0;          // 64-deep K blocks of the first layer
  int narrow;       // the last layer is 16 wide (d_out <= 16)
  int n_chunks;     // weight chunks a tile consumes
  int resident;     // every chunk has its own stage, fetched once
  int n_stages;
  int x_vec;        // x rows allow paired loads (even width, aligned)
  int in_stages;    // stages of the input ring (0: each warp loads its rows)
  int row_bytes;    // bytes of a row of x
  int ring_bytes;   // of the weight ring (resident: every chunk back to back)
  int out_act;
  int sine;         // the hidden activation is Sine, else
  float floor;      // max(v, floor): 0 (ReLU) or -inf (None)
};

// The hidden activation without a branch: sin, or max(v, floor) (ReLU
// with a floor of 0, None with -inf). A branch between the wgmma
// instructions that touches their registers would make ptxas serialize
// them.
template <bool SINE>
__device__ __forceinline__ float activate_hidden(float v, float floor) {
  if constexpr (SINE) return sinf(v);
  else return fmaxf(v, floor);
}

__device__ __forceinline__ float activate_out(float v, int act) {
  return act == kRelu ? fmaxf(v, 0.f) : act == kExp ? expf(v) : v;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Lane 0 of the warp arrives on `bar` (predicated, not branched: see
// mbar_wait).
__device__ __forceinline__ void mbar_arrive(uint32_t bar, int lane) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.eq.s32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n"
      "}" ::"r"(bar),
      "r"(lane)
      : "memory");
}

// Returns once the phase of parity `parity` of `bar` has completed; traps
// after kWaitLimitNs. One asm statement, loop and all: a branch in C++
// between the wgmma instructions would make ptxas serialize them.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done, late;\n"
      ".reg .u64 t0, t1;\n"
      "mov.u64 t0, %%globaltimer;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1, %2;\n"
      "@done bra DONE;\n"
      "mov.u64 t1, %%globaltimer;\n"
      "sub.u64 t1, t1, t0;\n"
      "setp.gt.u64 late, t1, %3;\n"
      "@late trap;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}" ::"r"(bar),
      "r"(parity), "r"(kSuspendNs), "l"(kWaitLimitNs)
      : "memory");
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

// Descriptor of a K-major operand with the 128-byte swizzle: 8-row atoms
// of 1024 bytes stacked along N (stride 1024), the start advanced by 32
// bytes per 16-deep step inside the 64-deep atom row.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) |
         (uint64_t(kAlign >> 4) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A (registers, 64 x 16) x B (16 x N, descriptor), f32 sums in the
// m64nN accumulator layout. The FIRST step of a layer writes the sums
// (scale-d 0) and reads none, so the accumulators are dead from one
// layer's epilogue to the next layer's first product.
template <bool FIRST>
__device__ __forceinline__ void wgmma_rs_n16(float* d, const uint32_t (&a)[4],
                                              uint64_t db) {
  if constexpr (FIRST) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]),
          "=f"(d[6]), "=f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(0));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
}

template <bool FIRST>
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t (&a)[4],
                                              uint64_t db) {
  if constexpr (FIRST) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]),
          "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
          "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]),
          "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
          "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]),
          "=f"(d[30]), "=f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(0));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
}

template <bool FIRST>
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t (&a)[4],
                                              uint64_t db) {
  if constexpr (FIRST) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]),
          "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
          "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]),
          "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
          "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]),
          "=f"(d[30]), "=f"(d[31]), "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]),
          "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]), "=f"(d[40]), "=f"(d[41]),
          "=f"(d[42]), "=f"(d[43]), "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
          "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]),
          "=f"(d[54]), "=f"(d[55]), "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]),
          "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(0));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
}

template <int N, bool FIRST>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 16) wgmma_rs_n16<FIRST>(d, a, db);
  else if constexpr (N == 64) wgmma_rs_n64<FIRST>(d, a, db);
  else wgmma_rs_n128<FIRST>(d, a, db);
}

// The same with A in shared memory (descriptor da): the 256-wide layers.
template <bool FIRST>
__device__ __forceinline__ void wgmma_ss_n16(float* d, uint64_t da, uint64_t db) {
  if constexpr (FIRST) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]),
          "=f"(d[6]), "=f"(d[7])
        : "l"(da), "l"(db), "r"(0));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(1));
  }
}

template <bool FIRST>
__device__ __forceinline__ void wgmma_ss_n256(float* d, uint64_t da, uint64_t db) {
  if constexpr (FIRST) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]),
          "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
          "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]),
          "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
          "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]),
          "=f"(d[30]), "=f"(d[31]), "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]),
          "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]), "=f"(d[40]), "=f"(d[41]),
          "=f"(d[42]), "=f"(d[43]), "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
          "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]),
          "=f"(d[54]), "=f"(d[55]), "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]),
          "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63]), "=f"(d[64]), "=f"(d[65]),
          "=f"(d[66]), "=f"(d[67]), "=f"(d[68]), "=f"(d[69]), "=f"(d[70]), "=f"(d[71]),
          "=f"(d[72]), "=f"(d[73]), "=f"(d[74]), "=f"(d[75]), "=f"(d[76]), "=f"(d[77]),
          "=f"(d[78]), "=f"(d[79]), "=f"(d[80]), "=f"(d[81]), "=f"(d[82]), "=f"(d[83]),
          "=f"(d[84]), "=f"(d[85]), "=f"(d[86]), "=f"(d[87]), "=f"(d[88]), "=f"(d[89]),
          "=f"(d[90]), "=f"(d[91]), "=f"(d[92]), "=f"(d[93]), "=f"(d[94]), "=f"(d[95]),
          "=f"(d[96]), "=f"(d[97]), "=f"(d[98]), "=f"(d[99]), "=f"(d[100]), "=f"(d[101]),
          "=f"(d[102]), "=f"(d[103]), "=f"(d[104]), "=f"(d[105]), "=f"(d[106]), "=f"(d[107]),
          "=f"(d[108]), "=f"(d[109]), "=f"(d[110]), "=f"(d[111]), "=f"(d[112]), "=f"(d[113]),
          "=f"(d[114]), "=f"(d[115]), "=f"(d[116]), "=f"(d[117]), "=f"(d[118]), "=f"(d[119]),
          "=f"(d[120]), "=f"(d[121]), "=f"(d[122]), "=f"(d[123]), "=f"(d[124]), "=f"(d[125]),
          "=f"(d[126]), "=f"(d[127])
        : "l"(da), "l"(db), "r"(0));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
          "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
          "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
          "+f"(d[126]), "+f"(d[127])
        : "l"(da), "l"(db), "r"(1));
  }
}

template <int N, bool FIRST>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db) {
  if constexpr (N == 16) wgmma_ss_n16<FIRST>(d, da, db);
  else wgmma_ss_n256<FIRST>(d, da, db);
}

// The A fragments of a warp's 16 rows of x, from global memory: lane
// (g, t) holds, of 16-deep step ks, rows g and g + 8 at columns
// col0 + 16 ks + 2t + {0, 1} and + 8 + {0, 1} (zero beyond the width and
// the last row).
template <int KS>
__device__ __forceinline__ void load_input(const void* x, int x_is_bf16, int x_vec,
                                           long long row0, int n_rows, int d_in, int col0,
                                           int n_steps, int lane,
                                           uint32_t (&a)[KS][4]) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const long long r = row0 + g + 8 * half;
    const bool row_ok = r < n_rows;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int c = col0 + 16 * ks + 8 * hi + 2 * t;
        uint32_t v = 0;
        if (ks < n_steps && row_ok && c < d_in) {
          const long long e = r * d_in + c;
          const bool pair = c + 1 < d_in;
          if (x_is_bf16) {
            const __nv_bfloat16* xb = reinterpret_cast<const __nv_bfloat16*>(x);
            if (x_vec) {
              v = __ldg(reinterpret_cast<const unsigned int*>(xb + e));
            } else {
              const __nv_bfloat16 lo = xb[e];
              const __nv_bfloat16 up = pair ? xb[e + 1] : __float2bfloat16(0.f);
              v = uint32_t(*reinterpret_cast<const unsigned short*>(&lo)) |
                  (uint32_t(*reinterpret_cast<const unsigned short*>(&up)) << 16);
            }
          } else {
            const float* xf = reinterpret_cast<const float*>(x);
            if (x_vec) {
              const float2 u = __ldg(reinterpret_cast<const float2*>(xf + e));
              v = pack_bf16(u.x, u.y);
            } else {
              v = pack_bf16(__ldg(xf + e), pair ? __ldg(xf + e + 1) : 0.f);
            }
          }
        }
        a[ks][half + 2 * hi] = v;
      }
  }
}

// The same from the warp's rows in the input ring (rows of `row_bytes`, a
// multiple of 16, so the width is even and a pair is whole).
template <int KS>
__device__ __forceinline__ void load_input_smem(const unsigned char* rows, int x_is_bf16,
                                                int row_bytes, int d_in, int n_steps,
                                                int lane, uint32_t (&a)[KS][4]) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const unsigned char* r = rows + (g + 8 * half) * row_bytes;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int c = 16 * ks + 8 * hi + 2 * t;
        uint32_t v = 0;
        if (ks < n_steps && c < d_in) {
          if (x_is_bf16) {
            v = *reinterpret_cast<const uint32_t*>(r + 2 * c);
          } else {
            const float2 u = *reinterpret_cast<const float2*>(r + 4 * c);
            v = pack_bf16(u.x, u.y);
          }
        }
        a[ks][half + 2 * hi] = v;
      }
  }
}

// 8-column tile T of the accumulators holds, in lane (g, t), rows g and
// g + 8 at columns 8T + 2t, + 1 (registers 4T .. 4T + 3): tiles 2ks and
// 2ks + 1, activated and rounded, are the next layer's step ks.
template <bool SINE, int NP>
__device__ __forceinline__ void to_operand(const float (&acc)[NP / 2],
                                           uint32_t (&a)[NP / 16][4], float floor) {
#pragma unroll
  for (int ks = 0; ks < NP / 16; ++ks)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = 4 * (2 * ks + hi) + 2 * half;
        a[ks][half + 2 * hi] = pack_bf16(activate_hidden<SINE>(acc[r], floor),
                                         activate_hidden<SINE>(acc[r + 1], floor));
      }
}

// Bytes and offset in the packed buffer of chunk c of a tile's sequence:
// every chunk is NP x 64 but those of a narrow last layer (16 x 64).
struct ChunkMap {
  int first_last, wide_bytes, narrow;
  __device__ __forceinline__ uint32_t bytes(int c) const {
    return narrow && c >= first_last ? kNarrowChunkBytes : wide_bytes;
  }
  __device__ __forceinline__ long long offset(int c) const {
    return narrow && c >= first_last
               ? (long long)first_last * wide_bytes +
                     (long long)(c - first_last) * kNarrowChunkBytes
               : (long long)c * wide_bytes;
  }
};

// The 256-wide layers keep their activations in shared memory (their
// sums take 128 registers a thread, and a block of three warpgroups may
// hold 168): byte offset of columns 8T .. 8T + 7 of row m (0-63) in a
// warpgroup's 64-row A tile (bf16, K-major, the 128-byte swizzle of the
// weight chunks: 64-deep blocks of 8 KB, 8-row atoms of 1024 bytes, the
// 16-byte group XORed with the row).
__device__ __forceinline__ uint32_t a_offset(int m, int T) {
  return (T / 8) * 8192 + (m / 8) * 1024 + (m % 8) * 128 + ((T % 8) ^ (m % 8)) * 16;
}

// The A fragments of a warp's 16 rows of x (load_input or
// load_input_smem, 4 steps of 16 columns at a time) into the warpgroup's
// A tile: register half + 2 hi of step ks holds row g + 8 half, columns
// 16 ks + 8 hi + 2t, + 1.
__device__ __forceinline__ void store_fragments(const uint32_t (&a)[4][4], int kb, int warp,
                                                int lane, unsigned char* a_tile) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int reg = 0; reg < 4; ++reg) {
      const int m = 16 * warp + g + 8 * (reg % 2);
      const int T = 2 * (4 * kb + ks) + reg / 2;
      *reinterpret_cast<uint32_t*>(a_tile + a_offset(m, T) + 4 * t) = a[ks][reg];
    }
}

// The sums of a 256-wide layer, activated and rounded to bf16, into the A
// tile of the next: 8-column tile T of the accumulator holds, in lane
// (g, t), rows g and g + 8 of the warp at columns 8T + 2t, + 1.
template <bool SINE>
__device__ __forceinline__ void store_operand(const float (&acc)[128], int warp, int lane,
                                              unsigned char* a_tile, float floor) {
  const int g = lane >> 2, t = lane & 3;
  const int m = 16 * warp + g;
#pragma unroll
  for (int T = 0; T < 32; ++T) {
    *reinterpret_cast<uint32_t*>(a_tile + a_offset(m, T) + 4 * t) =
        pack_bf16(activate_hidden<SINE>(acc[4 * T], floor),
                  activate_hidden<SINE>(acc[4 * T + 1], floor));
    *reinterpret_cast<uint32_t*>(a_tile + a_offset(m + 8, T) + 4 * t) =
        pack_bf16(activate_hidden<SINE>(acc[4 * T + 2], floor),
                  activate_hidden<SINE>(acc[4 * T + 3], floor));
  }
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// The four warps of consumer warpgroup wg (named barrier 1 + wg).
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
}

// A consumer warp's view of the weight ring: the next chunk's stage and
// phase, and whether stages are released (streamed) or kept (resident).
struct Ring {
  uint32_t full0, base;
  int n_stages, resident;
  int first_narrow;   // the first chunk of 16 x 64 (resident: packed tight)
  int stage;
  uint32_t parity;

  template <int NP>
  __device__ __forceinline__ uint32_t addr(int st) const {
    if (!resident || st < first_narrow) return base + st * (NP * 128);
    return base + first_narrow * (NP * 128) + (st - first_narrow) * kNarrowChunkBytes;
  }

  __device__ __forceinline__ int next(int c) const { return resident ? c : stage; }
  __device__ __forceinline__ void wait(int st) const {
    mbar_wait(full0 + 8 * st, resident ? 0 : parity);
  }
  __device__ __forceinline__ void advance() {
    if (!resident && ++stage == n_stages) { stage = 0; parity ^= 1; }
  }
  // this warp is done with stage st
  __device__ __forceinline__ void release(int st, int lane) const {
    if (resident) return;
    __syncwarp();
    mbar_arrive(full0 + 8 * (kMaxStages + st), lane);
  }
};

// One layer's products for a warp's 16 rows of its warpgroup's 64: per
// 64-deep chunk of the layer's weights (KB of them, chunk c0 onwards), 4
// steps of wgmma with B from the chunk's stage and A from registers (`a`)
// or, for a 256-wide net, from the warpgroup's A tile. A chunk's stage is
// released once the next chunk's products are issued and its own have
// completed. KB is a template argument: a wgmma under a run-time
// condition inside the pipeline would make ptxas serialize them all.
template <bool NARROW, int KB, int NP, int KS>
__device__ __forceinline__ void layer_chunks(float (&acc)[NP / 2], const uint32_t (&a)[KS][4],
                                             uint32_t a_tile, int c0, Ring& ring, int lane) {
  constexpr int N = NARROW ? kNarrow : NP;
  int prev = -1;
#pragma unroll
  for (int kb = 0; kb < KB; ++kb) {
    const int st = ring.next(c0 + kb);
    ring.wait(st);
    if (kb == 0) wgmma_fence();
    const uint32_t b_addr = ring.addr<NP>(st);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const uint64_t db = sw128_desc(b_addr + 32 * ks);
      if constexpr (NP == 256) {
        const uint64_t da = sw128_desc(a_tile + kb * 8192 + 32 * ks);
        if (kb == 0 && ks == 0) wgmma_ss<N, true>(acc, da, db);
        else wgmma_ss<N, false>(acc, da, db);
      } else {
        if (kb == 0 && ks == 0) wgmma_rs<N, true>(acc, a[4 * kb + ks], db);
        else wgmma_rs<N, false>(acc, a[4 * kb + ks], db);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();
    if (kb > 0) ring.release(prev, lane);
    prev = st;
    ring.advance();
  }
  wgmma_wait<0>();
  fence_regs(acc);
  ring.release(prev, lane);
}

// layer_chunks for `kbs` chunks, known at run time (1 .. NP / 64; NP / 64
// below NP = 256).
template <bool NARROW, int NP, int KS>
__device__ __forceinline__ void layer_products(float (&acc)[NP / 2], const uint32_t (&a)[KS][4],
                                               uint32_t a_tile, int kbs, int c0, Ring& ring,
                                               int lane) {
  if constexpr (NP < 256) {
    // every layer is NP deep (the first one padded): one trip count, as a
    // second pipeline beside it makes ptxas serialize the wgmma of both
    layer_chunks<NARROW, NP / 64, NP>(acc, a, a_tile, c0, ring, lane);
  } else {
    if (kbs == 4) layer_chunks<NARROW, 4, NP>(acc, a, a_tile, c0, ring, lane);
    else if (kbs == 1) layer_chunks<NARROW, 1, NP>(acc, a, a_tile, c0, ring, lane);
    else if (kbs == 2) layer_chunks<NARROW, 2, NP>(acc, a, a_tile, c0, ring, lane);
    else layer_chunks<NARROW, 3, NP>(acc, a, a_tile, c0, ring, lane);
  }
}

// NP: the padded width of every hidden layer (64, 128 or 256). A tile is
// 128 rows; consumer warpgroup wg owns rows 64 wg .. 64 wg + 63, warp w of
// it rows 16 w .. 16 w + 15 of those. Dynamic shared memory: [1024-byte
// alignment][n_stages weight stages of NP x 64 bf16][NP == 256: the two
// warpgroups' A tiles, 32 KB each][in_stages input stages of a tile's
// rows][mbarriers: weights full and empty, input full and empty].
template <int NP>
__global__ void __launch_bounds__(kThreads, 1)
fused_mlp_wgmma_kernel(const void* __restrict__ x, int x_is_bf16,
                       const unsigned char* __restrict__ w,
                       float* __restrict__ out, int n_rows, WgShape s) {
  constexpr int NCH = NP / 64;    // 64-deep K blocks of a hidden layer
  constexpr int KS = NP == 256 ? 4 : NP / 16;   // steps of A held in registers
  constexpr int kStageBytes = NP * 128;
  constexpr int kATiles = NP == 256 ? 2 * 64 * 256 * 2 : 0;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring_s = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kAlign - 1) & ~uintptr_t(kAlign - 1));
  unsigned char* a_s = ring_s + s.ring_bytes;
  unsigned char* in_s = a_s + kATiles;
  const int in_stage_bytes = kTileRows * s.row_bytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(in_s + s.in_stages * in_stage_bytes);
  const uint32_t full0 = smem_addr(bars);
  const uint32_t empty0 = full0 + 8 * kMaxStages;
  const uint32_t in_full0 = empty0 + 8 * kMaxStages;
  const uint32_t in_empty0 = in_full0 + 8 * kMaxInStages;

  if (threadIdx.x == 0) {
    for (int st = 0; st < s.n_stages; ++st) {
      mbar_init(full0 + 8 * st, 1);
      mbar_init(empty0 + 8 * st, 8);   // every consumer warp
    }
    for (int st = 0; st < s.in_stages; ++st) {
      mbar_init(in_full0 + 8 * st, 1);
      mbar_init(in_empty0 + 8 * st, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int n_tiles = (n_rows + kTileRows - 1) / kTileRows;
  const int block = int(blockIdx.x), n_blocks = int(gridDim.x);
  const int n_iters = block < n_tiles ? (n_tiles - block + n_blocks - 1) / n_blocks : 0;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x >= kConsumerThreads) {
    // ---- the producer warpgroup gives its registers to the consumers; one
    // thread streams the weight chunks of every tile in order (once where
    // resident), another the input tiles
    if constexpr (NP == 256) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (threadIdx.x == kConsumerThreads && n_iters > 0) {
      const int kb_last = s.n_layers == 1 ? s.kb0 : NCH;
      const ChunkMap map{s.n_chunks - kb_last, kStageBytes, s.narrow};
      int stage = 0, wraps = 0;
      const int rounds = s.resident ? 1 : n_iters;
      for (int it = 0; it < rounds; ++it)
        for (int c = 0; c < s.n_chunks; ++c) {
          const int st = s.resident ? c : stage;
          if (!s.resident && wraps > 0) mbar_wait(empty0 + 8 * st, (wraps - 1) & 1);
          const uint32_t bytes = map.bytes(c);
          const uint32_t full = full0 + 8 * st;
          const uint32_t dst = smem_addr(ring_s) + uint32_t(s.resident ? map.offset(c)
                                                                   : st * kStageBytes);
          mbar_expect_tx(full, bytes);
          bulk_load(dst, w + map.offset(c), bytes, full);
          if (!s.resident && ++stage == s.n_stages) { stage = 0; ++wraps; }
        }
    } else if (threadIdx.x == kConsumerThreads + 32 && s.in_stages > 0) {
      const unsigned char* xb = static_cast<const unsigned char*>(x);
      int stage = 0, wraps = 0;
      for (int it = 0; it < n_iters; ++it) {
        const long long tile = block + (long long)it * n_blocks;
        if (wraps > 0) mbar_wait(in_empty0 + 8 * stage, (wraps - 1) & 1);
        const long long row0 = tile * kTileRows;
        const long long left = n_rows - row0;
        const uint32_t bytes = uint32_t((left < kTileRows ? left : kTileRows) * s.row_bytes);
        const uint32_t full = in_full0 + 8 * stage;
        mbar_expect_tx(full, bytes);
        bulk_load(smem_addr(in_s + stage * in_stage_bytes), xb + row0 * s.row_bytes,
                  bytes, full);
        if (++stage == s.in_stages) { stage = 0; ++wraps; }
      }
    }
    __syncwarp();
    return;
  }

  // ---- consumers: a 256-wide net's sums take 128 registers a thread, so
  // its consumers take 232 (2 x 128 x 232 + 128 x 40 of the register
  // file); the narrower nets fit in the 168 of a block of 384 threads
  if constexpr (NP == 256) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int g = lane >> 2, t = lane & 3;
  unsigned char* a_tile = a_s + wg * (kATiles / 2);
  const uint32_t a_addr = smem_addr(a_tile);
  const int kb_last = s.n_layers == 1 ? s.kb0 : NCH;
  Ring ring{full0, smem_addr(ring_s), s.n_stages, s.resident,
            s.narrow ? s.n_chunks - kb_last : s.n_chunks, 0, 0u};
  int in_stage = 0;
  uint32_t in_parity = 0;
  for (int it = 0; it < n_iters; ++it) {
    const long long tile = block + (long long)it * n_blocks;
    // every tile is real (the grid is at most the tile count), but without
    // this guard on the rows load_input reads, ptxas serializes the
    // 64-wide kernel's wgmma (C7511 in build.log)
    const bool active = tile < n_tiles;
    const int local0 = wg * 64 + warp * 16;   // this warp's first row
    const long long row0 = tile * kTileRows + local0;
    // the input's A fragments, in registers; a 256-wide net's go to the
    // A tile in steps of 64 columns (its first layer is at most 256 deep)
    uint32_t a[KS][4];
    if constexpr (NP == 256) warpgroup_sync(wg);   // the last tile's products are done
    const unsigned char* rows = nullptr;
    if (s.in_stages > 0) {
      mbar_wait(in_full0 + 8 * in_stage, in_parity);
      rows = in_s + in_stage * in_stage_bytes + local0 * s.row_bytes;
    }
#pragma unroll
    for (int kb = 0; kb < (NP == 256 ? 4 : 1); ++kb) {
      if (NP == 256 && kb >= s.kb0) break;
      const int col0 = 64 * kb;
      if (rows != nullptr)
        load_input_smem<KS>(rows + col0 * (x_is_bf16 ? 2 : 4), x_is_bf16, s.row_bytes,
                            s.d_in - col0, NP == 256 ? 4 : 4 * s.kb0, lane, a);
      else
        load_input<KS>(x, x_is_bf16, s.x_vec, row0, active ? n_rows : 0, s.d_in, col0,
                       NP == 256 ? 4 : 4 * s.kb0, lane, a);
      if constexpr (NP == 256) store_fragments(a, kb, warp, lane, a_tile);
    }
    if (rows != nullptr) {
      __syncwarp();
      mbar_arrive(in_empty0 + 8 * in_stage, lane);
      if (++in_stage == s.in_stages) { in_stage = 0; in_parity ^= 1; }
    }
    if constexpr (NP == 256) {
      fence_proxy_async();
      warpgroup_sync(wg);
    }

    float acc[NP / 2];
    int c0 = 0;
    for (int l = 0; l < s.n_layers; ++l) {
      const bool last = l + 1 == s.n_layers;
      const int kbs = l == 0 ? s.kb0 : NCH;
      if (last && s.narrow)
        layer_products<true, NP>(acc, a, a_addr, kbs, c0, ring, lane);
      else
        layer_products<false, NP>(acc, a, a_addr, kbs, c0, ring, lane);
      c0 += kbs;
      if (last) break;
      if constexpr (NP == 256) {
        // every warp's products have read the A tile before it changes
        warpgroup_sync(wg);
        if (s.sine) store_operand<true>(acc, warp, lane, a_tile, s.floor);
        else store_operand<false>(acc, warp, lane, a_tile, s.floor);
        fence_proxy_async();
        warpgroup_sync(wg);
      } else {
        if (s.sine) to_operand<true, NP>(acc, a, s.floor);
        else to_operand<false, NP>(acc, a, s.floor);
      }
    }
    // rows g and g + 8 of the warp, columns 8T + 2t, + 1
    const int n_cols = s.narrow ? kNarrow : NP;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long r = row0 + g + 8 * half;
      if (r >= n_rows) continue;
      float* dst = out + r * s.d_out;
#pragma unroll
      for (int T = 0; T < NP / 8; ++T) {
        const int col = 8 * T + 2 * t;
        if (col >= n_cols || col >= s.d_out) continue;
        const float v0 = activate_out(acc[4 * T + 2 * half], s.out_act);
        const float v1 = activate_out(acc[4 * T + 2 * half + 1], s.out_act);
        if (col + 1 < s.d_out) {
          if ((s.d_out & 1) == 0)
            *reinterpret_cast<float2*>(dst + col) = make_float2(v0, v1);
          else { dst[col] = v0; dst[col + 1] = v1; }
        } else {
          dst[col] = v0;
        }
      }
    }
  }
}

using KernelFn = void (*)(const void*, int, const unsigned char*, float*, int, WgShape);

// The padded hidden width of a chain: the smallest of 64, 128, 256 that
// holds every hidden width, the first layer's 64-deep K blocks and an
// output wider than 16; 0 beyond 256.
int hidden_class(int n_layers, const int* dims) {
  int need = (dims[0] + 63) / 64 * 64;
  for (int i = 1; i < n_layers; ++i) need = need > dims[i] ? need : dims[i];
  if (dims[n_layers] > kNarrow && dims[n_layers] > need) need = dims[n_layers];
  return need <= 64 ? 64 : need <= 128 ? 128 : need <= 256 ? 256 : 0;
}

struct Launch {
  KernelFn fn;
  int device;
  size_t smem;
  int grid;   // resident blocks
};

// The most resident blocks of `fn` with `smem` bytes, queried once per
// (function, device, smem); the shared-memory attribute is set once per
// (function, device). ctypes releases the GIL, so the cache is guarded.
cudaError_t resident_grid(KernelFn fn, size_t smem, int* grid) {
  static std::mutex mu;
  static Launch cache[256];
  static int n_cached = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  bool attr_set = false;
  for (int i = 0; i < n_cached; ++i) {
    const Launch& e = cache[i];
    if (e.fn != fn || e.device != device) continue;
    attr_set = true;
    if (e.smem == smem) {
      *grid = e.grid;
      return cudaSuccess;
    }
  }
  if (!attr_set) {
    int optin = 0;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 device);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(reinterpret_cast<const void*>(fn),
                               cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return err;
  }
  int n_sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, reinterpret_cast<const void*>(fn), kThreads, smem);
  if (err != cudaSuccess) return err;
  *grid = n_sms * per_sm;
  if (*grid < 1) return cudaErrorInvalidConfiguration;
  if (n_cached < 256) cache[n_cached++] = {fn, device, smem, *grid};
  return cudaSuccess;
}

// The kernel's plan for a chain on the current device: its padded width
// NP, the shape `s` (chunks, the weight ring, the input ring) and the
// dynamic shared memory. Every chunk back to back and fetched once per
// block (resident) where they fit beside the input ring, else a ring of
// >= 3 weight stages beside it; without an input ring (rows of x not a
// multiple of 16 bytes, or x not 16-byte `aligned`, or no room), resident
// or >= 2 stages. The input ring has 2 stages where they fit, else 1.
cudaError_t plan(int n_layers, const int* dims, int x_is_bf16, int aligned, WgShape* sp,
                 int* np_out, size_t* smem_out) {
  if (n_layers < 1 || n_layers > kMaxLayers) return cudaErrorInvalidValue;
  for (int i = 0; i <= n_layers; ++i)
    if (dims[i] < 1) return cudaErrorInvalidValue;
  const int np = hidden_class(n_layers, dims);
  if (np == 0) return cudaErrorInvalidValue;
  WgShape& s = *sp;
  s.n_layers = n_layers;
  s.d_in = dims[0];
  s.d_out = dims[n_layers];
  // the first layer is NP deep where NP <= 128 (its wgmma then run with
  // the trip count of every other layer), else pad64(d_in) deep
  s.kb0 = np <= 128 ? np / 64 : (dims[0] + 63) / 64;
  s.narrow = s.d_out <= kNarrow;
  s.n_chunks = s.kb0 + (n_layers - 1) * (np / 64);
  s.row_bytes = s.d_in * (x_is_bf16 ? 2 : 4);
  const int stage_bytes = np * 128;
  const int kb_last = n_layers == 1 ? s.kb0 : np / 64;
  const long long w_bytes =
      (long long)(s.n_chunks - kb_last) * stage_bytes +
      (long long)kb_last * (s.narrow ? kNarrowChunkBytes : stage_bytes);
  const long long in_stage_bytes = (long long)kTileRows * s.row_bytes;

  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  // the 256-wide layers' A tiles: two warpgroups x 64 rows x 256 bf16
  const long long fixed =
      kAlign + (np == 256 ? 2 * 64 * 256 * 2 : 0) + 2 * (kMaxStages + kMaxInStages) * 8;
  // bytes, and weight stages, that fit beside `in` input stages
  auto room = [&](int in) {
    const long long left = optin - fixed - in * in_stage_bytes;
    return left < 0 ? 0ll : left;
  };
  auto fit = [&](int in) {
    const long long n = room(in) / stage_bytes;
    return int(n < kMaxStages ? n : kMaxStages);
  };
  const long long held = (w_bytes + kAlign - 1) / kAlign * kAlign;
  s.in_stages = -1;
  for (int in = s.row_bytes % 16 == 0 && aligned ? kMaxInStages : 0;
       in >= 0 && s.in_stages < 0; --in) {
    if (s.n_chunks <= kMaxStages && room(in) >= held) {
      s.in_stages = in;
      s.resident = 1;
      s.n_stages = s.n_chunks;
    } else if (fit(in) >= (in > 0 ? 3 : 2)) {
      s.in_stages = in;
      s.resident = 0;
      s.n_stages = fit(in);
    }
  }
  if (s.in_stages < 0) return cudaErrorInvalidValue;
  s.ring_bytes = int(s.resident ? held : (long long)s.n_stages * stage_bytes);
  *np_out = np;
  *smem_out = size_t(fixed + s.in_stages * in_stage_bytes + s.ring_bytes);
  return cudaSuccess;
}

}  // namespace

// The plan fused_mlp_wgmma_launch makes for a chain of `n_layers` layers
// of widths `dims` and an x of bf16 or f32 that is 16-byte `aligned` or
// not: out[0..4] = (resident, weight stages, input stages, dynamic shared
// memory bytes). Returns 0 or a cudaError_t.
extern "C" int fused_mlp_wgmma_plan(int n_layers, const int* dims, int x_is_bf16,
                                    int aligned, int* out) {
  WgShape s;
  int np = 0;
  size_t smem = 0;
  const cudaError_t err = plan(n_layers, dims, x_is_bf16, aligned, &s, &np, &smem);
  if (err != cudaSuccess) return int(err);
  out[0] = s.resident;
  out[1] = s.n_stages;
  out[2] = s.in_stages;
  out[3] = int(smem);
  return 0;
}

// Plain C entry point for ctypes. `w` is pack_weights' `packed_wgmma`
// (w_bytes long): layer i padded to (K_i, N_i) = (pad64(d_in) or NP,
// NP or 16 for a last layer of <= 16 outputs), cut into 64-deep chunks,
// each the swizzled shared-memory image of its N_i x 64 bf16. The weights
// stay resident or stream through a ring, and the rows of x come through
// an input ring or per-row loads, as `plan` decides. Returns 0 or a
// cudaError_t; launches on `stream` and never synchronises.
extern "C" int fused_mlp_wgmma_launch(const void* x, int x_is_bf16, const void* w,
                                      long long w_bytes, void* out, int n_rows,
                                      int n_layers, const int* dims, int hidden_act,
                                      int out_act, void* stream) {
  WgShape s;
  int np = 0;
  size_t smem = 0;
  cudaError_t err = plan(n_layers, dims, x_is_bf16,
                         reinterpret_cast<uintptr_t>(x) % 16 == 0, &s, &np, &smem);
  if (err != cudaSuccess) return int(err);
  const int stage_bytes = np * 128;
  const int kb_last = n_layers == 1 ? s.kb0 : np / 64;
  if ((long long)(s.n_chunks - kb_last) * stage_bytes +
          (long long)kb_last * (s.narrow ? kNarrowChunkBytes : stage_bytes) !=
      w_bytes)
    return cudaErrorInvalidValue;
  s.sine = hidden_act == kSine;
  s.floor = hidden_act == kRelu ? 0.f : -std::numeric_limits<float>::infinity();
  s.out_act = out_act;
  s.x_vec = (s.d_in % 2 == 0) &&
            reinterpret_cast<uintptr_t>(x) % (x_is_bf16 ? 4 : 8) == 0;

  const KernelFn fn = np == 64    ? fused_mlp_wgmma_kernel<64>
                      : np == 128 ? fused_mlp_wgmma_kernel<128>
                                  : fused_mlp_wgmma_kernel<256>;
  int resident = 0;
  err = resident_grid(fn, smem, &resident);
  if (err != cudaSuccess) return int(err);
  const int n_tiles = (n_rows + kTileRows - 1) / kTileRows;
  const int grid = n_tiles < resident ? n_tiles : resident;
  if (grid == 0) return cudaSuccess;
  const unsigned char* wp = static_cast<const unsigned char*>(w);
  float* op = static_cast<float*>(out);
  void* args[] = {&x, &x_is_bf16, &wp, &op, &n_rows, &s};
  err = cudaLaunchKernel(reinterpret_cast<const void*>(fn), dim3(grid), dim3(kThreads), args,
                         smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}
