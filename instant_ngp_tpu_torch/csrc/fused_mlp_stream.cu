// Fused forward of a bias-free MLP on Hopper (sm_90a), bf16 tensor-core MMA
// with float32 accumulation: the streamed path, for the nets whose weights
// do not fit in shared memory all at once (the 256-wide NeRF configs
// frequency.json and none.json, the 128-wide 6- and 8-layer SDF configs).
// Widths up to 256, up to 32 layers, any total weight size.
//
// Replaces the TPU kernel instant_ngp_tpu/ops/pallas/mlp_kernels.py::
// fused_mlp_forward for those shapes. For x (N, D_in), f32 or bf16:
//     h = bf16(x); per layer h = h @ W_i (bf16 operands, f32 sums);
//     between layers h = bf16(hidden_act(h)); out = out_act(h) as f32.
// Its plain PyTorch version is ops/kernels/mlp_kernels.py::
// fused_mlp_forward_plain; the wrapper there validates every argument
// before calling fused_mlp_stream_launch below.
//
// What bounds it on this card: at 96-256x7-16 a row costs ~0.84 MFLOP and
// moves 384 B in and 64 B out, so the tensor cores, not the memory, set
// the bound (~0.9 ms at 2^20 rows). The design is the simple one:
//   - a block keeps a 128-row tile of bf16 activations in shared memory
//     (rows of 256 + 8 elements) and walks the layers; for each layer it
//     copies that layer's weight block (at most 256 x 264 bf16, 135 KB)
//     from global memory (L2 after the first tile) into shared memory,
//     syncs, and multiplies;
//   - each of its 8 warps owns 16 rows and keeps the float32 sums of ALL
//     of its output columns in registers (up to 16 wmma accumulators), so
//     the layer's output can overwrite its input rows in place;
//   - the sums pass through a 16x16 per-warp staging tile, get the
//     activation and return to the activation tile as bf16 (or, after
//     the last layer, go to the output rows).
// Weights are read again from L2 for every tile and the copy is not
// overlapped with the products: making it fast is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <mutex>

using namespace nvcuda;

namespace {

constexpr int kMaxLayers = 32;
constexpr int kMaxWidth = 256;
constexpr int kTileRows = 128;
constexpr int kWarps = 8;
constexpr int kWarpRows = kTileRows / kWarps;  // 16
constexpr int kMaxNTiles = kMaxWidth / 16;     // 16
constexpr int kActLd = kMaxWidth + 8;          // bf16 per activation row
constexpr int kStageLd = 16 + 4;               // floats per staging row
constexpr size_t kActBytes = size_t(kTileRows) * kActLd * 2;
constexpr size_t kStageBytes = size_t(kWarps) * 16 * kStageLd * 4;

enum Activation { kNone = 0, kRelu = 1, kSine = 2, kExp = 3 };

struct StreamShape {
  int n_layers;
  int dims[kMaxLayers + 1];    // true widths
  int padded[kMaxLayers + 1];  // widths rounded up to 16
  int w_offset[kMaxLayers];    // element offset of layer i's block, whose
                               // rows are padded[i + 1] + 8 long
};

__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case kRelu: return fmaxf(v, 0.f);
    case kSine: return sinf(v);
    case kExp: return expf(v);
    default: return v;
  }
}

__global__ void __launch_bounds__(kWarps * 32, 1)
fused_mlp_stream_kernel(const void* __restrict__ x, int x_is_bf16,
                        const __nv_bfloat16* __restrict__ w,
                        float* __restrict__ out, int n_rows,
                        StreamShape shape, int hidden_act, int out_act) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* act_s = reinterpret_cast<__nv_bfloat16*>(smem);
  float* stage_s = reinterpret_cast<float*>(smem + kActBytes);
  __nv_bfloat16* w_s =
      reinterpret_cast<__nv_bfloat16*>(smem + kActBytes + kStageBytes);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  __nv_bfloat16* my_act = act_s + warp * kWarpRows * kActLd;
  float* my_stage = stage_s + warp * 16 * kStageLd;
  const int d_in = shape.dims[0];
  const int in_p = shape.padded[0];
  const int d_out = shape.dims[shape.n_layers];
  const int n_tiles = (n_rows + kTileRows - 1) / kTileRows;
  const float* xf = reinterpret_cast<const float*>(x);
  const __nv_bfloat16* xb = reinterpret_cast<const __nv_bfloat16*>(x);

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long row0 = (long long)tile * kTileRows + warp * kWarpRows;

    // this warp's rows of the input, zero beyond the true width and the
    // last row (padded weight rows are zero, so padded columns add 0)
    for (int e = lane; e < kWarpRows * in_p; e += 32) {
      const int r = e / in_p, c = e % in_p;
      const long long gr = row0 + r;
      float v = 0.f;
      if (gr < n_rows && c < d_in)
        v = x_is_bf16 ? __bfloat162float(xb[gr * d_in + c]) : xf[gr * d_in + c];
      my_act[r * kActLd + c] = __float2bfloat16(v);
    }

    for (int layer = 0; layer < shape.n_layers; ++layer) {
      const int kp = shape.padded[layer];
      const int np = shape.padded[layer + 1];
      const int ldw = np + 8;
      const int nt = np / 16;
      const bool last = layer + 1 == shape.n_layers;

      // every warp is done with the previous layer's weights
      __syncthreads();
      {
        const int4* src = reinterpret_cast<const int4*>(w + shape.w_offset[layer]);
        int4* dst = reinterpret_cast<int4*>(w_s);
        const int n_vec = kp * ldw / 8;
        for (int i = threadIdx.x; i < n_vec; i += blockDim.x) dst[i] = src[i];
      }
      __syncthreads();

      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kMaxNTiles];
#pragma unroll
      for (int n = 0; n < kMaxNTiles; ++n) wmma::fill_fragment(acc[n], 0.f);
      for (int k = 0; k < kp / 16; ++k) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a;
        wmma::load_matrix_sync(a, my_act + k * 16, kActLd);
        const __nv_bfloat16* wk = w_s + k * 16 * ldw;
#pragma unroll
        for (int n = 0; n < kMaxNTiles; ++n) {
          if (n < nt) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                           wmma::row_major> b;
            wmma::load_matrix_sync(b, wk + n * 16, ldw);
            wmma::mma_sync(acc[n], a, b, acc[n]);
          }
        }
      }
      // every column's sum is in registers before any input row is
      // overwritten with the layer's output
      __syncwarp();
#pragma unroll
      for (int n = 0; n < kMaxNTiles; ++n) {
        if (n < nt) {
          wmma::store_matrix_sync(my_stage, acc[n], kStageLd,
                                  wmma::mem_row_major);
          __syncwarp();
          for (int e = lane; e < 16 * 16; e += 32) {
            const int r = e / 16, c = e % 16;
            const float v = my_stage[r * kStageLd + c];
            if (!last) {
              my_act[r * kActLd + n * 16 + c] =
                  __float2bfloat16(activate(v, hidden_act));
            } else {
              const int col = n * 16 + c;
              const long long gr = row0 + r;
              if (col < d_out && gr < n_rows)
                out[gr * d_out + col] = activate(v, out_act);
            }
          }
          __syncwarp();
        }
      }
    }
  }
}

// The most resident blocks for a launch with `smem` bytes of shared memory
// on the current device, cached per (device, smem); ctypes releases the
// GIL, so the cache is guarded.
cudaError_t max_grid(size_t smem, int* grid) {
  struct Entry { int device; size_t smem; int grid; };
  static std::mutex mu;
  static Entry cache[64];
  static int n_cached = 0;
  static bool attr_set[64] = {};

  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n_cached; ++i) {
    if (cache[i].device == device && cache[i].smem == smem) {
      *grid = cache[i].grid;
      return cudaSuccess;
    }
  }
  if (device >= 64) return cudaErrorInvalidDevice;
  if (!attr_set[device]) {
    int optin = 0;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 device);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(fused_mlp_stream_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return err;
    attr_set[device] = true;
  }
  int n_sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, fused_mlp_stream_kernel, kWarps * 32, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *grid = n_sms * per_sm;
  if (n_cached < 64) cache[n_cached++] = {device, smem, *grid};
  return cudaSuccess;
}

}  // namespace

// Plain C entry point for ctypes. `w` is the general packing (layer i a
// zero-padded (pad16(in), pad16(out) + 8) row-major block, back to back).
// Returns 0 or a cudaError_t; launches on `stream` and never synchronises.
extern "C" int fused_mlp_stream_launch(const void* x, int x_is_bf16,
                                       const void* w, long long w_elems,
                                       void* out, int n_rows, int n_layers,
                                       const int* dims, int hidden_act,
                                       int out_act, void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers) return cudaErrorInvalidValue;
  StreamShape shape;
  shape.n_layers = n_layers;
  for (int i = 0; i <= n_layers; ++i) {
    if (dims[i] < 1 || dims[i] > kMaxWidth) return cudaErrorInvalidValue;
    shape.dims[i] = dims[i];
    shape.padded[i] = (dims[i] + 15) / 16 * 16;
  }
  long long offset = 0;
  size_t layer_bytes = 0;
  for (int i = 0; i < n_layers; ++i) {
    const long long elems = (long long)shape.padded[i] * (shape.padded[i + 1] + 8);
    if (offset > 0x7fffffff) return cudaErrorInvalidValue;
    shape.w_offset[i] = int(offset);
    offset += elems;
    if (size_t(elems) * 2 > layer_bytes) layer_bytes = size_t(elems) * 2;
  }
  if (offset != w_elems) return cudaErrorInvalidValue;
  const size_t smem = kActBytes + kStageBytes + layer_bytes;

  int resident = 0;
  cudaError_t err = max_grid(smem, &resident);
  if (err != cudaSuccess) return err;

  const int n_tiles = (n_rows + kTileRows - 1) / kTileRows;
  const int grid = n_tiles < resident ? n_tiles : resident;
  if (grid == 0) return cudaSuccess;
  fused_mlp_stream_kernel<<<grid, kWarps * 32, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      x, x_is_bf16, static_cast<const __nv_bfloat16*>(w),
      static_cast<float*>(out), n_rows, shape, hidden_act, out_act);
  return int(cudaGetLastError());
}
