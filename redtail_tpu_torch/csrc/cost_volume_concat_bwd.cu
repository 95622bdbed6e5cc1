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
// What bounds it: the read of g, each element once. At NVTiny's training
// shape (the 160x512 crop: features (4, 80, 256, 8) bf16, D = 24) g is
// 62.9 MB against 2.6 MB written (0.0196 ms at 3.35 TB/s); at NVSmall's
// (C = 32, D = 48) 503 MB (0.153 ms). g is larger than the 50 MB L2, so a
// record of g whose halves are fetched at different times comes from HBM
// twice. The first port of this backward (a thread per channel, 2-byte
// loads, the dL loop over all d before the dR loop) reached 0.46 of the
// bound at C = 8.
//
// Design (the plan is `kernels/cost_volume_concat.py:bwd_tile_plan`, which
// the CPU tests emulate): a thread owns one word (16 bytes where C * elt
// allows: 8 bf16 or 4 fp32 channels; else 8, 4 or 2 bytes) of column y of
// one row (n, h) and writes both dL[y] and dR[y] there, as one word each.
// For each d in ascending order it reads the word of the left half of
// record (d, y) and, where y + d < W, that of the right half of record
// (d, y + d), and adds them to its fp32 sums. Both halves of record
// (d, x) are read in the same step d, by the threads of columns x and
// x - d of the same block or the one before, so the record's sectors come
// from HBM once and the second half is an L1 hit; the threads of a warp
// read whole words of neighbouring records. Each output is one thread's
// fixed-order sum: no shared memory, no barrier, no atomics, the same bits
// every launch. The Python wrapper (`redtail_tpu_torch/kernels/
// cost_volume_concat.py`) checks the inputs, allocates the outputs,
// launches on PyTorch's current stream and counts launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

template <int BYTES> struct Word;
template <> struct Word<16> { using type = uint4; };
template <> struct Word<8> { using type = uint2; };
template <> struct Word<4> { using type = uint32_t; };
template <> struct Word<2> { using type = uint16_t; };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f(float& out, float v) { out = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16& out, float v) {
  out = __float2bfloat16(v);  // round to nearest even, as XLA's convert
}

// V channels of T as one word
template <typename T, int V>
union Vec {
  typename Word<V * sizeof(T)>::type w;
  T e[V];
};

template <typename T, int V>
__device__ __forceinline__ void add(const T* p, float* acc) {
  Vec<T, V> v;
  v.w = __ldg(reinterpret_cast<const typename Word<V * sizeof(T)>::type*>(p));
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] += to_f(v.e[i]);
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const float* acc) {
  Vec<T, V> v;
#pragma unroll
  for (int i = 0; i < V; ++i) from_f(v.e[i], acc[i]);
  *reinterpret_cast<typename Word<V * sizeof(T)>::type*>(p) = v.w;
}

// units = N * H * W * (C / V) threads: v fastest, then y, then (n, h).
template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
concat_bwd_kernel(const T* __restrict__ g, T* __restrict__ dleft,
                  T* __restrict__ dright, int H, int W, int C, int D,
                  int64_t units) {
  const int64_t u = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (u >= units) return;
  const int vh = C / V;  // words a half
  const int64_t px = u / vh;  // (n * H + h) * W + y
  const int c = (int)(u - px * vh) * V;
  const int y = (int)(px % W);
  const int64_t nh = px / W;
  const int64_t n = nh / H, h = nh - n * H;
  const int64_t step = (int64_t)H * W * 2 * C;  // one disparity of g
  // left half of record (d = 0, y); the right half of record (d, y + d)
  // lies C + d * (step + 2C) past it
  const T* gl = g + ((n * D * H + h) * W + y) * 2 * C + c;
  const T* gr = gl + C;
  const int dr = min(D, W - y);
  float a[V], b[V];
#pragma unroll
  for (int i = 0; i < V; ++i) a[i] = b[i] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    add<T, V>(gl + d * step, a);
    if (d < dr) add<T, V>(gr + d * (step + 2 * C), b);
  }
  store<T, V>(dleft + px * C + c, a);
  store<T, V>(dright + px * C + c, b);
}

template <typename T, int V>
cudaError_t start(const void* g, void* dleft, void* dright, int N, int H,
                  int W, int C, int D, cudaStream_t stream) {
  const int64_t units = (int64_t)N * H * W * (C / V);
  const int64_t blocks = (units + THREADS - 1) / THREADS;
  if (blocks > INT32_MAX) return cudaErrorInvalidConfiguration;
  concat_bwd_kernel<T, V><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(g), static_cast<T*>(dleft),
      static_cast<T*>(dright), H, W, C, D, units);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* g, void* dleft, void* dright, int N, int H,
                   int W, int C, int D, int word, cudaStream_t stream) {
  constexpr int E = sizeof(T);
  if (word < E || word > 16 || (C * E) % word) return cudaErrorInvalidValue;
  switch (word) {
    case 16: return start<T, 16 / E>(g, dleft, dright, N, H, W, C, D, stream);
    case 8: return start<T, 8 / E>(g, dleft, dright, N, H, W, C, D, stream);
    case 4: return start<T, 4 / E>(g, dleft, dright, N, H, W, C, D, stream);
    case 2:
      if constexpr (E == 2)
        return start<T, 1>(g, dleft, dright, N, H, W, C, D, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// g: (N, D, H, W, 2C) contiguous; dleft, dright: (N, H, W, C) contiguous;
// all fp32 (bf16 == 0) or all bf16 (bf16 == 1); word: the bytes a thread
// reads and writes at once (16, 8, 4 or 2; a divisor of C * elt, pointers
// aligned to it). Returns the cudaError_t of the launch (0 on success).
extern "C" int cost_volume_concat_bwd_launch(const void* g, void* dleft,
                                             void* dright, int n, int h,
                                             int w, int c, int max_disp,
                                             int bf16, int word, int device,
                                             void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  e = bf16 ? launch<__nv_bfloat16>(g, dleft, dright, n, h, w, c, max_disp,
                                   word, s)
           : launch<float>(g, dleft, dright, n, h, w, c, max_disp, word, s);
  return (int)e;
}

extern "C" const char* cost_volume_concat_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
