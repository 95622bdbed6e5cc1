// Fused cost volume + conv3D_1: the per-disparity assembly, for Hopper
// (sm_90a), bound to Python with ctypes.
//
// Replaces the TPU kernel `redtail_tpu/kernels/fused_cv_emit_pallas.py:65`
// (`_emit_kernel`, entry `emit_dh_shifted_pallas`) in the unpacked layout
// that the port's 3D stack consumes. The first 3x3x3 conv over the concat
// cost volume factors into 2D convs of the feature maps
// (`redtail_tpu/ops/fused_cost_volume_conv.py`); cuDNN computes them, and
// this kernel assembles conv3D_1's output from them without the volume:
//
//   la (N, H, W, 3K): a_i  = conv2d(left,  w_left[i]),  i = 0, 1, 2
//   rb (N, H, W, 6K): bk_i = conv2d(right, w_right[i]), then
//                     cc_i = conv2d(right, w_right[i][:, 2:3]) (column only)
//
//   S[x]   = bk0[x + 1] + bk1[x] + bk2[x - 1]            (zero outside [0, W))
//   out[d, h, x, k] = elu(a_sum[x] + S[x - d]           (zero where x < d)
//       - [d == 0]     (a0[x] + bk0[x + 1])             depth tap d - 1 < 0
//       - [d == D - 1] (a2[x] + bk2[x - d - 1])         depth tap d + 1 = D
//       + [x == d - 1] bk0[0]                           shift-composition fix
//       + sum over taps i with dp = d + i - 1 in [1, D - 1], dp < W of
//           [x == dp - 1] cc_i[0] - [x == W - 1] cc_i[W - dp]
//       + bias)
//
// which is `d_slices` (`fused_cost_volume_conv.py:121-174`) and the
// per-value function of the Pallas kernel, accumulated in fp32 and rounded
// once to the output dtype. ELU is fp32 `expm1f` (the Pallas kernel's
// exp - 1 was a Mosaic limitation).
//
// What bounds it: the write. At NVSmall's shape (K = 32, (1, 161, 513)
// maps, D = 48, bf16) the output is 253.7 MB against 15.9 MB of maps read:
// about 0.079 ms of HBM traffic at 3.35 TB/s on an H100 SXM.
//
// Design (simple first):
//   - one block per (n, h, tile of TX columns); no padding of W, odd D,
//     D >= W and any batch work (the Pallas kernel needed even D and batch
//     1 for its packed layout);
//   - the block forms a_sum for its tile once, and for each chunk of DC
//     disparities the S window those disparities read (TX + DC - 1
//     columns, zero outside [0, W)), both fp32 in shared memory: each map
//     is read from device memory about twice however large D is;
//   - for each d the tile's TX * K outputs are one contiguous run of the
//     (N, D, H, W, K) output, written by neighbouring threads; the d = 0 /
//     D - 1 corrections and the single-column fix-ups read their few
//     values from device memory (they touch 2 of D slices and 4 columns).
// The output is (N, D, H, W, K) contiguous: `torch.channels_last_3d`
// memory of the (N, K, D, H, W) view that conv3D_2 consumes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TX = 64;        // columns of a tile
constexpr int DC = 32;        // disparities sharing one staged S window
constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
emit_kernel(const T* __restrict__ la, const T* __restrict__ rb,
            const float* __restrict__ bias, T* __restrict__ out, int H,
            int W, int K, int D, int apply_elu) {
  extern __shared__ float smem[];
  float* as = smem;            // a_sum, TX x K
  float* ss = as + TX * K;     // S window, (TX + DC - 1) x K

  const int t = threadIdx.x;
  const int x0 = blockIdx.x * TX;
  const int h = blockIdx.y;
  const int n = blockIdx.z;
  const int nt = min(TX, W - x0);
  const int64_t nh = (int64_t)n * H + h;
  const int k3 = 3 * K, k6 = 6 * K;
  const T* lrow = la + nh * W * k3;   // a0 | a1 | a2
  const T* rrow = rb + nh * W * k6;   // bk0 | bk1 | bk2 | cc0 | cc1 | cc2

  for (int i = t; i < nt * K; i += THREADS) {
    const int xr = i / K, k = i - xr * K;
    const T* p = lrow + (int64_t)(x0 + xr) * k3 + k;
    as[i] = to_f32(p[0]) + to_f32(p[K]) + to_f32(p[2 * K]);
  }

  for (int d0 = 0; d0 < D; d0 += DC) {
    // S columns [x0 - d0 - (DC - 1), x0 + nt - d0), zero outside [0, W).
    const int sx0 = x0 - d0 - (DC - 1);
    const int sn = nt + DC - 1;
    __syncthreads();  // a_sum is staged / the previous chunk's reads are done
    for (int i = t; i < sn * K; i += THREADS) {
      const int xr = i / K, k = i - xr * K;
      const int x = sx0 + xr;
      float s = 0.f;
      if (x >= 0 && x < W) {
        const T* p = rrow + (int64_t)x * k6 + k;
        s = to_f32(p[K]);                           // bk1[x]
        if (x + 1 < W) s += to_f32(p[k6]);          // bk0[x + 1]
        if (x >= 1) s += to_f32(p[2 * K - k6]);     // bk2[x - 1]
      }
      ss[i] = s;
    }
    __syncthreads();
    const int dn = min(DC, D - d0);
    for (int dd = 0; dd < dn; ++dd) {
      const int d = d0 + dd;
      T* orow = out + (((int64_t)n * D + d) * H + h) * W * K +
                (int64_t)x0 * K;
      for (int i = t; i < nt * K; i += THREADS) {
        const int xr = i / K, k = i - xr * K;
        const int x = x0 + xr;
        // column x - d of S is staged row xr - dd + DC - 1
        float acc = as[i] + ss[(xr - dd + DC - 1) * K + k];
        if (d == 0) {
          acc -= to_f32(lrow[(int64_t)x * k3 + k]);
          if (x + 1 < W) acc -= to_f32(rrow[(int64_t)(x + 1) * k6 + k]);
        }
        if (d == D - 1) {
          acc -= to_f32(lrow[(int64_t)x * k3 + 2 * K + k]);
          if (x - d - 1 >= 0)
            acc -= to_f32(rrow[(int64_t)(x - d - 1) * k6 + 2 * K + k]);
        }
        if (x == d - 1) acc += to_f32(rrow[k]);  // bk0 at column 0
        if ((x >= d - 2 && x <= d) || x == W - 1) {
#pragma unroll
          for (int tap = 0; tap < 3; ++tap) {
            const int dp = d + tap - 1;
            if (dp < 1 || dp > D - 1 || dp >= W) continue;
            const int c = (3 + tap) * K + k;
            if (x == dp - 1) acc += to_f32(rrow[c]);
            if (x == W - 1) acc -= to_f32(rrow[(int64_t)(W - dp) * k6 + c]);
          }
        }
        acc += bias[k];
        if (apply_elu) acc = acc > 0.f ? acc : expm1f(acc);
        store(orow + i, acc);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* la, const void* rb, const float* bias,
                   void* out, int N, int H, int W, int K, int D,
                   int apply_elu, cudaStream_t stream) {
  const size_t smem = (size_t)(2 * TX + DC - 1) * K * sizeof(float);
  if (smem > 48 * 1024) {
    // Above 48 KB only as opted-in dynamic shared memory; past the card's
    // per-block limit this call fails and the error is returned.
    const cudaError_t e = cudaFuncSetAttribute(
        emit_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((W + TX - 1) / TX, H, N);
  emit_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(la), static_cast<const T*>(rb), bias,
      static_cast<T*>(out), H, W, K, D, apply_elu);
  return cudaGetLastError();
}

}  // namespace

// la: (N, H, W, 3K), rb: (N, H, W, 6K), out: (N, D, H, W, K), all
// contiguous and of one dtype, fp32 (bf16 == 0) or bf16 (bf16 == 1);
// bias: K fp32 values. Returns the cudaError_t of the launch (0 on
// success).
extern "C" int fused_cv_emit_launch(const void* la, const void* rb,
                                    const void* bias, void* out, int n,
                                    int h, int w, int k, int max_disp,
                                    int apply_elu, int bf16, int device,
                                    void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  e = bf16 ? launch<__nv_bfloat16>(la, rb, b, out, n, h, w, k, max_disp,
                                   apply_elu, s)
           : launch<float>(la, rb, b, out, n, h, w, k, max_disp, apply_elu,
                           s);
  return (int)e;
}

extern "C" const char* fused_cv_emit_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
