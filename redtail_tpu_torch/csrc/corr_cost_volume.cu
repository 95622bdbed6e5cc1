// Correlation cost volume for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the TPU kernel `redtail_tpu/kernels/cost_volume_pallas.py:43`
// (`_corr_kernel`, launched by `_corr_pallas_nhwc`, public entry
// `corr_cost_volume_pallas`). It computes, with fp32 accumulation,
//
//     out[n, h, x, d] = sum_c L[n, h, x, c] * R[n, h, x - d, c],
//     zero where x < d,
//
// from NHWC feature maps, in one of two layouts:
//   - disparity-last (N, H, W, D) in fp32: what the ResNet18-2D model feeds
//     to its soft-argmax (`ops/cost_volume.py:corr_cost_volume_dlast`);
//   - (N, H, D, W) in the input dtype: the Pallas kernel's own contract.
//
// What bounds it: memory. At the flagship shape (L and R (1, 161, 513, 32)
// bf16, D = 48) a frame reads about 10.6 MB of features and writes 15.9 MB
// of fp32 volume, against 0.25 GFLOP of fp32 multiply-adds: about 7.9 us of
// HBM traffic at 3.35 TB/s against about 3.7 us of fp32 arithmetic at
// 67 TFLOP/s on an H100 SXM.
//
// Design (simple first; fusing the soft-argmax so the volume never reaches
// device memory is later work):
//   - one block of TX threads per (n, h, tile of TX columns); W need not be
//     a multiple of anything (the ragged last tile is masked);
//   - the block stages the L tile (TX x C) and the R tile widened by Dp - 1
//     columns to the left ((TX + Dp - 1) x C, Dp = D rounded up to DB) in
//     shared memory as fp32, zero outside [0, W); rows are padded to an odd
//     stride so neighbouring threads (neighbouring x) hit distinct banks;
//   - thread t owns column x0 + t and walks the disparities DB at a time:
//     each L value read from shared memory is used against DB R values;
//   - the masked edge x < d is written as an explicit zero (as the Pallas
//     kernel's `jnp.where` does), not left to the zero padding;
//   - disparity-last: each DB-wide chunk of results is staged in shared
//     memory and written back so that a warp fills whole 32-byte sectors;
//     (N, H, D, W): neighbouring threads write neighbouring x directly.
// The Python wrapper (`redtail_tpu_torch/kernels/corr_cost_volume.py`)
// checks the inputs, allocates the output, launches on PyTorch's current
// stream and counts launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TX = 128;  // columns of a tile, one thread each
constexpr int DB = 8;    // disparities computed together by one thread

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as XLA's convert
}

template <typename T, bool DLAST>
__global__ void __launch_bounds__(TX)
corr_kernel(const T* __restrict__ left, const T* __restrict__ right,
            void* __restrict__ out_ptr, int H, int W, int C, int D) {
  extern __shared__ float smem[];
  const int Dp = (D + DB - 1) / DB * DB;
  const int cs = C | 1;  // odd row stride in floats
  float* ls = smem;                            // TX rows
  float* rs = ls + TX * cs;                    // TX + Dp - 1 rows
  float* os = rs + (TX + Dp - 1) * cs;         // TX x (DB + 1), DLAST only

  const int t = threadIdx.x;
  const int x0 = blockIdx.x * TX;
  const int h = blockIdx.y;
  const int n = blockIdx.z;
  const int64_t nh = (int64_t)n * H + h;
  const T* lrow = left + nh * W * C;
  const T* rrow = right + nh * W * C;

  // Stage L columns [x0, x0 + TX): the tile is one contiguous run of the
  // input, so consecutive threads read consecutive elements.
  for (int i = t; i < TX * C; i += TX) {
    const int xr = i / C, c = i - xr * C;
    const int x = x0 + xr;
    ls[xr * cs + c] = x < W ? to_f32(lrow[(int64_t)x * C + c]) : 0.f;
  }
  // Stage R columns [x0 - (Dp - 1), x0 + TX).
  const int rx0 = x0 - (Dp - 1);
  const int rrows = TX + Dp - 1;
  for (int i = t; i < rrows * C; i += TX) {
    const int xr = i / C, c = i - xr * C;
    const int x = rx0 + xr;
    rs[xr * cs + c] =
        (x >= 0 && x < W) ? to_f32(rrow[(int64_t)x * C + c]) : 0.f;
  }
  __syncthreads();

  const int x = x0 + t;
  const float* lp = ls + t * cs;
  for (int d0 = 0; d0 < Dp; d0 += DB) {
    // R row of (x, d) is t - d + Dp - 1; rp is that of d = d0.
    const float* rp = rs + (t - d0 + Dp - 1) * cs;
    float acc[DB];
#pragma unroll
    for (int k = 0; k < DB; ++k) acc[k] = 0.f;
    for (int c = 0; c < C; ++c) {
      const float l = lp[c];
#pragma unroll
      for (int k = 0; k < DB; ++k) acc[k] = fmaf(l, rp[c - k * cs], acc[k]);
    }
    if (DLAST) {
      float* out = static_cast<float*>(out_ptr);
#pragma unroll
      for (int k = 0; k < DB; ++k)
        os[t * (DB + 1) + k] = x >= d0 + k ? acc[k] : 0.f;
      __syncthreads();
      for (int i = t; i < TX * DB; i += TX) {
        const int xr = i / DB, k = i - xr * DB;
        const int xo = x0 + xr, d = d0 + k;
        if (xo < W && d < D)
          out[(nh * W + xo) * D + d] = os[xr * (DB + 1) + k];
      }
      __syncthreads();
    } else if (x < W) {
      T* out = static_cast<T*>(out_ptr);
#pragma unroll
      for (int k = 0; k < DB; ++k) {
        const int d = d0 + k;
        if (d < D) store(out + (nh * D + d) * W + x, x >= d ? acc[k] : 0.f);
      }
    }
  }
}

template <typename T, bool DLAST>
cudaError_t launch(const void* left, const void* right, void* out, int N,
                   int H, int W, int C, int D, cudaStream_t stream) {
  const int Dp = (D + DB - 1) / DB * DB;
  const size_t floats = (size_t)(2 * TX + Dp - 1) * (C | 1) +
                        (DLAST ? (size_t)TX * (DB + 1) : 0);
  const size_t smem = floats * sizeof(float);
  if (smem > 48 * 1024) {
    // Above 48 KB only as opted-in dynamic shared memory; past the
    // card's per-block limit this call fails and the error is returned.
    const cudaError_t e = cudaFuncSetAttribute(
        corr_kernel<T, DLAST>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((W + TX - 1) / TX, H, N);
  corr_kernel<T, DLAST><<<grid, TX, smem, stream>>>(
      static_cast<const T*>(left), static_cast<const T*>(right), out, H, W,
      C, D);
  return cudaGetLastError();
}

}  // namespace

// left, right: (N, H, W, C) contiguous, fp32 (bf16 == 0) or bf16 (bf16 == 1).
// out: (N, H, W, D) fp32 when dlast == 1, else (N, H, D, W) in the input
// dtype. Returns the cudaError_t of the launch (0 on success).
extern "C" int corr_cost_volume_launch(const void* left, const void* right,
                                       void* out, int n, int h, int w, int c,
                                       int max_disp, int bf16, int dlast,
                                       int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    e = dlast ? launch<__nv_bfloat16, true>(left, right, out, n, h, w, c,
                                            max_disp, s)
              : launch<__nv_bfloat16, false>(left, right, out, n, h, w, c,
                                             max_disp, s);
  } else {
    e = dlast ? launch<float, true>(left, right, out, n, h, w, c, max_disp, s)
              : launch<float, false>(left, right, out, n, h, w, c, max_disp,
                                     s);
  }
  return (int)e;
}

extern "C" const char* corr_cost_volume_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
