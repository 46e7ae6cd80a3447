// Fused forward of a bias-free MLP on Hopper (sm_90a), bf16 tensor-core MMA
// with float32 accumulation: the general path, for any chain of widths up
// to 128. The shapes the configurations produce have instantiations of the
// faster kernel in fused_mlp_mma.cu; the wrapper picks the path from the
// shape alone.
//
// Replaces the TPU kernel instant_ngp_tpu/ops/pallas/mlp_kernels.py::
// fused_mlp_forward. For x (N, D_in), f32 or bf16:
//     h = bf16(x); per layer h = h @ W_i (bf16 operands, f32 sums);
//     between layers h = bf16(hidden_act(h)); out = out_act(h) as f32.
// Its plain PyTorch version is ops/kernels/mlp_kernels.py::
// fused_mlp_forward_plain, and the wrapper there validates every argument
// before calling fused_mlp_forward_launch below.
//
// What bounds it on this card: at the NeRF widths (density 32->64->16, RGB
// 32->64->64->3) a row costs ~6-12 kFLOP but moves 128 B in and 64 or 12 B
// out, far below the ~295 FLOP/B at which an H100 stops being memory
// bound; launch cost matters for the small calls of the render loop. So
// the design keeps everything but the input and output rows on chip, as
// the TPU kernel keeps them in VMEM:
//   - a block stages ALL layers' bf16 weights in shared memory once and
//     then walks over 128-row tiles (grid = resident blocks, not tiles);
//   - each of its 4 warps owns 32 rows; a layer's product runs as
//     16x16x16 wmma tiles, the f32 sums pass through a per-warp staging
//     tile, get the activation, and return to the same rows of the bf16
//     activation tile, so no activation between layers reaches HBM;
//   - feature dims are padded to multiples of 16 (not to 128 lanes); the
//     3-wide RGB output is computed padded and stored unpadded.
// Widths, layer count and activations are run-time values here, so every
// layer's activations pass through shared memory and the input is not
// streamed ahead; fused_mlp_mma.cu is the design that removes both.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <mutex>

using namespace nvcuda;

namespace {

constexpr int kMaxLayers = 9;
constexpr int kTileRows = 128;
constexpr int kWarps = 4;
constexpr int kWarpRows = kTileRows / kWarps;  // 32
constexpr int kActLd = 128 + 8;   // bf16 per activation row (max width + skew)
constexpr int kStageLd = 128 + 4; // floats per staging row
constexpr size_t kActBytes = size_t(kTileRows) * kActLd * 2;
constexpr size_t kStageBytes = size_t(kWarps) * 16 * kStageLd * 4;

enum Activation { kNone = 0, kRelu = 1, kSine = 2, kExp = 3 };

struct MlpShape {
  int n_layers;
  int dims[kMaxLayers + 1];    // true widths
  int padded[kMaxLayers + 1];  // widths rounded up to 16
  int w_ld[kMaxLayers];        // row length of layer i's weight block
  int w_offset[kMaxLayers];    // element offset of layer i's block
};

__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case kRelu: return fmaxf(v, 0.f);
    case kSine: return sinf(v);
    case kExp: return expf(v);
    default: return v;
  }
}

__global__ void __launch_bounds__(kWarps * 32)
fused_mlp_kernel(const void* __restrict__ x, int x_is_bf16,
                 const __nv_bfloat16* __restrict__ w, int w_elems,
                 float* __restrict__ out, int n_rows, MlpShape shape,
                 int hidden_act, int out_act) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* act_s = reinterpret_cast<__nv_bfloat16*>(smem);
  float* stage_s = reinterpret_cast<float*>(smem + kActBytes);
  __nv_bfloat16* w_s =
      reinterpret_cast<__nv_bfloat16*>(smem + kActBytes + kStageBytes);

  // all layers' weights, once per block, in 16-byte vectors (the packed
  // buffer is a multiple of 16 elements and 16-byte aligned)
  {
    const int4* src = reinterpret_cast<const int4*>(w);
    int4* dst = reinterpret_cast<int4*>(w_s);
    for (int i = threadIdx.x; i < w_elems / 8; i += blockDim.x) dst[i] = src[i];
  }
  __syncthreads();

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

  // warps never share rows, so after the weights are staged each warp
  // runs its rows through every layer with warp-level syncs only
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long row0 = (long long)tile * kTileRows + warp * kWarpRows;

    for (int e = lane; e < kWarpRows * in_p; e += 32) {
      const int r = e / in_p, c = e % in_p;
      const long long gr = row0 + r;
      float v = 0.f;
      if (gr < n_rows && c < d_in)
        v = x_is_bf16 ? __bfloat162float(xb[gr * d_in + c]) : xf[gr * d_in + c];
      my_act[r * kActLd + c] = __float2bfloat16(v);
    }
    __syncwarp();

    for (int layer = 0; layer < shape.n_layers; ++layer) {
      const int kp = shape.padded[layer];
      const int np = shape.padded[layer + 1];
      const int ldw = shape.w_ld[layer];
      const __nv_bfloat16* wl = w_s + shape.w_offset[layer];
      const bool last = layer + 1 == shape.n_layers;

      for (int m = 0; m < kWarpRows / 16; ++m) {
        __nv_bfloat16* rows = my_act + m * 16 * kActLd;
        for (int n = 0; n < np / 16; ++n) {
          wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
          wmma::fill_fragment(acc, 0.f);
          for (int k = 0; k < kp / 16; ++k) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                           wmma::row_major> a;
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                           wmma::row_major> b;
            wmma::load_matrix_sync(a, rows + k * 16, kActLd);
            wmma::load_matrix_sync(b, wl + k * 16 * ldw + n * 16, ldw);
            wmma::mma_sync(acc, a, b, acc);
          }
          wmma::store_matrix_sync(my_stage + n * 16, acc, kStageLd,
                                  wmma::mem_row_major);
        }
        // every column tile of these 16 rows is summed before any of the
        // rows is overwritten with the layer's output
        __syncwarp();
        if (!last) {
          for (int e = lane; e < 16 * np; e += 32) {
            const int r = e / np, c = e % np;
            rows[r * kActLd + c] =
                __float2bfloat16(activate(my_stage[r * kStageLd + c], hidden_act));
          }
        } else {
          for (int e = lane; e < 16 * d_out; e += 32) {
            const int r = e / d_out, c = e % d_out;
            const long long gr = row0 + m * 16 + r;
            if (gr < n_rows)
              out[gr * d_out + c] = activate(my_stage[r * kStageLd + c], out_act);
          }
        }
        __syncwarp();
      }
    }
  }
}

// The most resident blocks for a launch with `smem` bytes of shared memory
// on the current device. The attribute, SM count and occupancy queries run
// once per (device, smem), not per launch: the render loop makes many small
// calls. ctypes releases the GIL, so the cache is guarded.
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
  // the largest opt-in size, once per device, so any later smem fits
  if (device >= 64) return cudaErrorInvalidDevice;
  if (!attr_set[device]) {
    int optin = 0;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 device);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(fused_mlp_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return err;
    attr_set[device] = true;
  }
  int n_sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, fused_mlp_kernel, kWarps * 32, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *grid = n_sms * per_sm;
  if (n_cached < 64) cache[n_cached++] = {device, smem, *grid};
  return cudaSuccess;
}

}  // namespace

// Plain C entry point for ctypes. Returns 0 or a cudaError_t; launches on
// `stream` and never synchronises.
extern "C" int fused_mlp_forward_launch(const void* x, int x_is_bf16,
                                        const void* w, int w_elems, void* out,
                                        int n_rows, int n_layers,
                                        const int* dims, int hidden_act,
                                        int out_act, void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers) return cudaErrorInvalidValue;
  MlpShape shape;
  shape.n_layers = n_layers;
  for (int i = 0; i <= n_layers; ++i) {
    if (dims[i] < 1 || dims[i] > 128) return cudaErrorInvalidValue;
    shape.dims[i] = dims[i];
    shape.padded[i] = (dims[i] + 15) / 16 * 16;
  }
  int offset = 0;
  for (int i = 0; i < n_layers; ++i) {
    shape.w_ld[i] = shape.padded[i + 1] + 8;
    shape.w_offset[i] = offset;
    offset += shape.padded[i] * shape.w_ld[i];
  }
  if (offset != w_elems) return cudaErrorInvalidValue;
  const size_t smem = kActBytes + kStageBytes + size_t(w_elems) * 2;

  int resident = 0;
  cudaError_t err = max_grid(smem, &resident);
  if (err != cudaSuccess) return err;

  const int n_tiles = (n_rows + kTileRows - 1) / kTileRows;
  const int grid = n_tiles < resident ? n_tiles : resident;
  if (grid == 0) return cudaSuccess;
  fused_mlp_kernel<<<grid, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      x, x_is_bf16, static_cast<const __nv_bfloat16*>(w), w_elems,
      static_cast<float*>(out), n_rows, shape, hidden_act, out_act);
  return int(cudaGetLastError());
}
