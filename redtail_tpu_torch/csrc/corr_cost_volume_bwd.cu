// Backward of the correlation cost volume for Hopper (sm_90a), bound to
// Python with ctypes.
//
// Replaces the VJP of the TPU kernel, `redtail_tpu/kernels/
// cost_volume_pallas.py:113` (`_corr_bwd` of the `custom_vjp` `_corr_core`,
// whose forward is `_corr_kernel` at :43), and what XLA derives for
// `ops/cost_volume.py:corr_cost_volume_dlast` followed by
// `ops/softargmax.py`. With the volume
//
//     vol[x, d] = sum_c L[x, c] * R[x - d, c],  zero where x < d
//
// of each row (n, h) and its cotangent g[x, d], it writes
//
//     dL[x, c] = sum_d g[x, d] * R[x - d, c]           (x - d >= 0)
//     dR[y, c] = sum_d g[y + d, d] * L[y + d, c]       (y + d < W)
//
// summed in fp32 and rounded once to the input dtype, as `_corr_bwd` does.
// The cotangent comes in one of three forms (`mode`):
//   - `hdw` (0): g (N, H, D, W) in the input dtype, the Pallas contract;
//   - `dlast` (1): g (N, H, W, D) fp32;
//   - `softargmax` (2): g (N, H, W) fp32, the cotangent of the fused
//     soft-argmax epilogue. The volume is not kept by the forward (its
//     point is that the volume never reaches device memory), so a first
//     kernel recomputes each x's D entries, p = softmax over all D of them
//     (the masked zeros x < d take part, as the values 0 they are) and
//     mu = sum_d p_d d, and writes g_vol[x, d] = g[x] p_d (d - mu) to a
//     scratch (N, H, W, D) fp32 buffer the wrapper allocates; the second
//     kernel then reads it as a `dlast` cotangent. Entries x < d are never
//     read: the masked zeros pass no gradient to either feature map.
//
// What bounds it: at the training shape (L and R (4, 80, 256, 32) bf16,
// D = 48, the 160x512 crop) the inputs and outputs move 21 MB (6.3 us at
// 3.35 TB/s), against 0.7 GFLOP (0.7 us on bf16 tensor cores), so memory;
// the `softargmax` form adds the scratch volume (15.7 MB written, read
// twice, mostly from L2).
//
// Design (simple first: right before fast; times in PERF.md):
//   - recompute (softargmax only): one warp per column x of a row; its
//     lanes take the disparities d = lane, lane + 32, ..., each summing
//     its dot product over C in fp32 (L[x] is one broadcast row, R[x - d]
//     a row per lane, served by L1), writing it to the scratch and
//     keeping the lane's max; a warp max, then the lane's sum of exp and
//     d-weighted sum of exp over its entries (`expf`), two warp sums, and
//     each lane overwrites its entries with g_vol;
//   - gradient: one thread per (n, h, x, c) computes both dL[x, c] and
//     dR[x, c], each a loop over d in ascending order with fp32 FMAs:
//     neighbouring threads take neighbouring channels, so the feature
//     reads are coalesced and the cotangent entry g[x, d] is one
//     broadcast per warp. No shared memory, no atomics, no block barrier:
//     the sums are deterministic, so a recompute (remat) gives the same
//     bits.
// The Python wrapper (`redtail_tpu_torch/kernels/corr_cost_volume.py`)
// checks the inputs, allocates the outputs and the scratch, launches on
// PyTorch's current stream and counts launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

enum Mode { HDW = 0, DLAST = 1, SOFTARGMAX = 2 };

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as XLA's convert
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// g_vol of the fused soft-argmax: one warp per (n, h, x); ``units`` =
// N * H * W. gvol (N, H, W, D) fp32 is written in full for x >= d.
template <typename T>
__global__ void __launch_bounds__(THREADS)
softargmax_grad_kernel(const T* __restrict__ left,
                       const T* __restrict__ right,
                       const float* __restrict__ g, float* __restrict__ gvol,
                       int W, int C, int D, int64_t units) {
  const int lane = threadIdx.x & 31;
  const int64_t unit = (int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (unit >= units) return;  // whole warps leave: no barrier follows
  const int64_t nh = unit / W;
  const int x = (int)(unit - nh * W);
  const T* lrow = left + (nh * W + x) * C;
  float* out = gvol + unit * D;

  float m = -FLT_MAX;
  for (int d = lane; d < D; d += 32) {
    float v = 0.f;
    if (d <= x) {
      const T* rrow = right + (nh * W + x - d) * C;
      for (int c = 0; c < C; ++c) v = fmaf(ld(lrow + c), ld(rrow + c), v);
    }
    out[d] = v;
    m = fmaxf(m, v);
  }
  m = warp_max(m);
  float s = 0.f, ws = 0.f;
  for (int d = lane; d < D; d += 32) {
    const float e = expf(out[d] - m);
    s += e;
    ws = fmaf((float)d, e, ws);
  }
  s = warp_sum(s);
  ws = warp_sum(ws);
  const float mu = ws / s, gx = g[unit] / s;
  for (int d = lane; d < D; d += 32)
    out[d] = gx * expf(out[d] - m) * ((float)d - mu);
}

// dL and dR from the cotangent g: one thread per (n, h, x, c); ``total`` =
// N * H * W * C. g's entry (x, d) of row nh is at nh * W * D + x * gx +
// d * gd.
template <typename T, typename G>
__global__ void __launch_bounds__(THREADS)
grad_kernel(const T* __restrict__ left, const T* __restrict__ right,
            const G* __restrict__ g, T* __restrict__ dleft,
            T* __restrict__ dright, int W, int C, int D, int gx, int gd,
            int64_t total) {
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= total) return;
  const int c = (int)(i % C);
  const int64_t px = i / C;  // nh * W + x
  const int64_t nh = px / W;
  const int x = (int)(px - nh * W);
  const T* lrow = left + nh * W * C + c;
  const T* rrow = right + nh * W * C + c;
  const G* grow = g + nh * W * D;

  float a = 0.f;
  const int dl = min(D, x + 1);
  for (int d = 0; d < dl; ++d)
    a = fmaf(ld(grow + (int64_t)x * gx + (int64_t)d * gd),
             ld(rrow + (int64_t)(x - d) * C), a);
  st(dleft + i, a);

  float b = 0.f;
  const int dr = min(D, W - x);
  for (int d = 0; d < dr; ++d)
    b = fmaf(ld(grow + (int64_t)(x + d) * gx + (int64_t)d * gd),
             ld(lrow + (int64_t)(x + d) * C), b);
  st(dright + i, b);
}

template <typename T>
cudaError_t launch(int mode, const void* left, const void* right,
                   const void* g, void* scratch, void* dleft, void* dright,
                   int N, int H, int W, int C, int D, cudaStream_t stream) {
  const T* l = static_cast<const T*>(left);
  const T* r = static_cast<const T*>(right);
  T* dl = static_cast<T*>(dleft);
  T* dr = static_cast<T*>(dright);
  const int64_t total = (int64_t)N * H * W * C;
  const int64_t blocks = (total + THREADS - 1) / THREADS;
  if (blocks > INT32_MAX) return cudaErrorInvalidConfiguration;
  if (mode == HDW) {
    grad_kernel<T, T><<<(unsigned)blocks, THREADS, 0, stream>>>(
        l, r, static_cast<const T*>(g), dl, dr, W, C, D, 1, W, total);
    return cudaGetLastError();
  }
  const float* gv = static_cast<const float*>(g);
  if (mode == SOFTARGMAX) {
    const int64_t units = (int64_t)N * H * W;
    const int64_t wblocks = (units + WARPS - 1) / WARPS;
    if (wblocks > INT32_MAX) return cudaErrorInvalidConfiguration;
    softargmax_grad_kernel<T><<<(unsigned)wblocks, THREADS, 0, stream>>>(
        l, r, gv, static_cast<float*>(scratch), W, C, D, units);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    gv = static_cast<const float*>(scratch);
  } else if (mode != DLAST) {
    return cudaErrorInvalidValue;
  }
  grad_kernel<T, float><<<(unsigned)blocks, THREADS, 0, stream>>>(
      l, r, gv, dl, dr, W, C, D, D, 1, total);
  return cudaGetLastError();
}

}  // namespace

// left, right, dleft, dright: (N, H, W, C) contiguous, fp32 (bf16 == 0) or
// bf16 (bf16 == 1). mode 0 (`hdw`): g (N, H, D, W) in the input dtype;
// 1 (`dlast`): g (N, H, W, D) fp32; 2 (`softargmax`): g (N, H, W) fp32 and
// scratch (N, H, W, D) fp32 (unused otherwise). Returns the cudaError_t of
// the launches (0 on success).
extern "C" int corr_cost_volume_bwd_launch(const void* left,
                                           const void* right, const void* g,
                                           void* scratch, void* dleft,
                                           void* dright, int n, int h, int w,
                                           int c, int max_disp, int bf16,
                                           int mode, int device,
                                           void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  e = bf16 ? launch<__nv_bfloat16>(mode, left, right, g, scratch, dleft,
                                   dright, n, h, w, c, max_disp, s)
           : launch<float>(mode, left, right, g, scratch, dleft, dright, n,
                           h, w, c, max_disp, s);
  return (int)e;
}

extern "C" const char* corr_cost_volume_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
