// Backward of the concat cost volume for Hopper (sm_90a), bound to Python
// with ctypes.
//
// The TPU kernel `redtail_tpu/kernels/cost_volume_pallas.py:158`
// (`_concat_kernel`) has no VJP: the JAX package trains through
// `ops/cost_volume.py:cost_volume` and lets XLA differentiate its shifted
// slices. This is that gradient. From the cotangent g (N, D, H, W, 2C) of
// the volume it writes
//
//     dL[n, h, x, c] = sum_d g[n, d, h, x, c]
//     dR[n, h, y, c] = sum_d g[n, d, h, y + d, C + c]    (y + d < W)
//
// summed in fp32 and rounded once to the input dtype.
//
// What bounds it: the read of g. At NVSmall's training shape (the 160x512
// crop: features (4, 80, 256, 32) bf16, D = 48) g is 251.7 MB against
// 10.5 MB written: about 0.078 ms of HBM traffic at 3.35 TB/s.
//
// Design (simple first): one thread per (n, h, x, c) computes both sums,
// each a loop over d in ascending order (fp32 adds; deterministic, no
// atomics). Neighbouring threads take neighbouring channels, so each d
// step of a warp reads contiguous runs of g: the x's left halves for dL,
// the (x + d)'s right halves for dR; each element of g is read once. The
// Python wrapper (`redtail_tpu_torch/kernels/cost_volume_concat.py`)
// checks the inputs, allocates the outputs, launches on PyTorch's current
// stream and counts launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as XLA's convert
}

// total = N * H * W * C threads.
template <typename T>
__global__ void __launch_bounds__(THREADS)
concat_grad_kernel(const T* __restrict__ g, T* __restrict__ dleft,
                   T* __restrict__ dright, int H, int W, int C, int D,
                   int64_t total) {
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= total) return;
  const int c = (int)(i % C);
  const int64_t px = i / C;  // (n * H + h) * W + x
  const int x = (int)(px % W);
  const int64_t nh = px / W;
  const int64_t n = nh / H, h = nh - n * H;
  const int64_t step = (int64_t)H * W * 2 * C;  // one disparity of g
  const T* g0 = g + ((n * D * H + h) * W) * 2 * C;  // (n, d = 0, h, x = 0)

  float a = 0.f;
  const T* gl = g0 + (int64_t)x * 2 * C + c;
  for (int d = 0; d < D; ++d) a += ld(gl + d * step);
  st(dleft + i, a);

  float b = 0.f;
  const T* gr = g0 + (int64_t)x * 2 * C + C + c;
  const int dr = min(D, W - x);
  for (int d = 0; d < dr; ++d) b += ld(gr + d * (step + 2 * C));
  st(dright + i, b);
}

template <typename T>
cudaError_t launch(const void* g, void* dleft, void* dright, int N, int H,
                   int W, int C, int D, cudaStream_t stream) {
  const int64_t total = (int64_t)N * H * W * C;
  const int64_t blocks = (total + THREADS - 1) / THREADS;
  if (blocks > INT32_MAX) return cudaErrorInvalidConfiguration;
  concat_grad_kernel<T><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(g), static_cast<T*>(dleft),
      static_cast<T*>(dright), H, W, C, D, total);
  return cudaGetLastError();
}

}  // namespace

// g: (N, D, H, W, 2C) contiguous; dleft, dright: (N, H, W, C) contiguous;
// all fp32 (bf16 == 0) or all bf16 (bf16 == 1). Returns the cudaError_t of
// the launch (0 on success).
extern "C" int cost_volume_concat_bwd_launch(const void* g, void* dleft,
                                             void* dright, int n, int h,
                                             int w, int c, int max_disp,
                                             int bf16, int device,
                                             void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  e = bf16 ? launch<__nv_bfloat16>(g, dleft, dright, n, h, w, c, max_disp, s)
           : launch<float>(g, dleft, dright, n, h, w, c, max_disp, s);
  return (int)e;
}

extern "C" const char* cost_volume_concat_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
