// Fused cost volume + conv3D_1: the per-disparity assembly, for Hopper
// (sm_90a), bound to Python with ctypes.
//
// Replaces the TPU kernel `redtail_tpu/kernels/fused_cv_emit_pallas.py:65`
// (`_emit_kernel`, entry `emit_dh_shifted_pallas`). The first 3x3x3 conv
// over the concat cost volume factors into 2D convs of the feature maps
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
// Two output layouts, one pass each:
//   full (packed == 0): (N, D, H, W, K) contiguous, `torch.channels_last_3d`
//     memory of the (N, K, D, H, W) view that the unpacked conv3D_2 takes;
//   dh-shifted (packed == 1): the packed 3D head's input, (N, (D + 1) / 2 + 1,
//     (H + 1) / 2 + 1, W, 4K) with channel groups (qh, qd, k): depth slot
//     ad holds d = 2 ad - 1 + qd, row slot hq holds row 2 hq - 1 + qh, and
//     every value whose d or row lies outside [0, D) x [0, H) is exactly
//     zero (after bias and ELU: those are the layout's TF-SAME padding).
//     This is the Pallas kernel's output, written straight from the two
//     cuDNN maps with no separate pack pass.
//
// What bounds it: the write. At NVSmall's shape (K = 32, (1, 161, 513)
// maps, D = 48, bf16) the full output is 253.7 MB and the dh-shifted one
// 269.2 MB, against 47.6 MB of maps read: about 0.090 and 0.095 ms of HBM
// traffic at 3.35 TB/s on an H100 SXM.
//
// Design (simple first):
//   - full: one block per (n, h, tile of TX columns); dh-shifted: one block
//     per (n, row slot, tile), which computes both of the slot's rows. No
//     padding of W; odd D, D >= W and any batch work (the Pallas kernel
//     needed even D and batch 1);
//   - the block forms a_sum for its tile once per row, and for each chunk
//     of DC disparities the S window those disparities read (TX + DC - 1
//     columns, zero outside [0, W)), both fp32 in shared memory: each map
//     is read from device memory about twice however large D is;
//   - the outputs of one (d or depth slot, row or row slot, tile) are one
//     contiguous run of the output, written by neighbouring threads; the
//     d = 0 / D - 1 corrections and the single-column fix-ups read their
//     few values from device memory (they touch 2 of D slices and 4
//     columns).

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

// Stage a_sum[x0 .. x0 + nt) of one row: as[xr * K + k].
template <typename T>
__device__ __forceinline__ void stage_a_sum(float* as, const T* lrow, int x0,
                                            int nt, int K) {
  for (int i = threadIdx.x; i < nt * K; i += THREADS) {
    const int xr = i / K, k = i - xr * K;
    const T* p = lrow + (int64_t)(x0 + xr) * 3 * K + k;
    as[i] = to_f32(p[0]) + to_f32(p[K]) + to_f32(p[2 * K]);
  }
}

// Stage S at columns [sx0, sx0 + sn) of one row, zero outside [0, W).
template <typename T>
__device__ __forceinline__ void stage_s(float* ss, const T* rrow, int sx0,
                                        int sn, int W, int K) {
  const int k6 = 6 * K;
  for (int i = threadIdx.x; i < sn * K; i += THREADS) {
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
}

// One output value from a_sum[x] + S[x - d] (``acc``) and the row's maps:
// the boundary taps, the column fix-ups, the bias and the ELU.
template <typename T>
__device__ __forceinline__ float finish(float acc, const T* lrow,
                                        const T* rrow, int x, int k, int d,
                                        int W, int K, int D,
                                        const float* bias, int apply_elu) {
  const int k3 = 3 * K, k6 = 6 * K;
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
  return acc;
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
  const T* lrow = la + nh * W * 3 * K;   // a0 | a1 | a2
  const T* rrow = rb + nh * W * 6 * K;   // bk0 | bk1 | bk2 | cc0 | cc1 | cc2

  stage_a_sum(as, lrow, x0, nt, K);
  for (int d0 = 0; d0 < D; d0 += DC) {
    __syncthreads();  // a_sum is staged / the previous chunk's reads are done
    // S columns [x0 - d0 - (DC - 1), x0 + nt - d0)
    stage_s(ss, rrow, x0 - d0 - (DC - 1), nt + DC - 1, W, K);
    __syncthreads();
    const int dn = min(DC, D - d0);
    for (int dd = 0; dd < dn; ++dd) {
      const int d = d0 + dd;
      T* orow = out + (((int64_t)n * D + d) * H + h) * W * K +
                (int64_t)x0 * K;
      for (int i = t; i < nt * K; i += THREADS) {
        const int xr = i / K, k = i - xr * K;
        // column x - d of S is staged row xr - dd + DC - 1
        const float acc = as[i] + ss[(xr - dd + DC - 1) * K + k];
        store(orow + i, finish(acc, lrow, rrow, x0 + xr, k, d, W, K, D, bias,
                               apply_elu));
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
emit_packed_kernel(const T* __restrict__ la, const T* __restrict__ rb,
                   const float* __restrict__ bias, T* __restrict__ out, int H,
                   int W, int K, int D, int apply_elu) {
  // per row parity qh: a_sum (TX x K), then the S window ((TX + DC - 1) x K)
  extern __shared__ float smem[];
  const int per = (2 * TX + DC - 1) * K;

  const int t = threadIdx.x;
  const int x0 = blockIdx.x * TX;
  const int hq = blockIdx.y;        // row slot: rows 2 hq - 1 and 2 hq
  const int n = blockIdx.z;
  const int Hq = gridDim.y;
  const int Dq = (D + 1) / 2 + 1;   // depth slots
  const int nt = min(TX, W - x0);
  const int k4 = 4 * K;

  for (int qh = 0; qh < 2; ++qh) {
    const int h = 2 * hq - 1 + qh;
    if (h >= 0 && h < H)
      stage_a_sum(smem + qh * per, la + ((int64_t)n * H + h) * W * 3 * K, x0,
                  nt, K);
  }
  // chunks of DC / 2 depth slots: disparities [2 ad0 - 1, 2 ad0 + DC - 1)
  for (int ad0 = 0; ad0 < Dq; ad0 += DC / 2) {
    const int dlo = 2 * ad0 - 1;
    __syncthreads();  // a_sum is staged / the previous chunk's reads are done
    for (int qh = 0; qh < 2; ++qh) {
      const int h = 2 * hq - 1 + qh;
      if (h >= 0 && h < H)
        stage_s(smem + qh * per + TX * K,
                rb + ((int64_t)n * H + h) * W * 6 * K, x0 - dlo - (DC - 1),
                nt + DC - 1, W, K);
    }
    __syncthreads();
    const int an = min(DC / 2, Dq - ad0);
    for (int aa = 0; aa < an; ++aa) {
      const int ad = ad0 + aa;
      T* orow = out + (((int64_t)n * Dq + ad) * Hq + hq) * W * k4 +
                (int64_t)x0 * k4;
      for (int i = t; i < nt * k4; i += THREADS) {
        const int xr = i / k4, rem = i - xr * k4;
        const int g = rem / K, k = rem - g * K;
        const int qh = g >> 1, d = 2 * ad - 1 + (g & 1);
        const int h = 2 * hq - 1 + qh;
        float v = 0.f;  // padding slots and rows stay exactly zero
        if (h >= 0 && h < H && d >= 0 && d < D) {
          const float* as = smem + qh * per;
          const float* ss = as + TX * K;
          const int64_t nh = (int64_t)n * H + h;
          // column x - d of S is staged row xr - (d - dlo) + DC - 1
          v = finish(as[xr * K + k] + ss[(xr - (d - dlo) + DC - 1) * K + k],
                     la + nh * W * 3 * K, rb + nh * W * 6 * K, x0 + xr, k, d,
                     W, K, D, bias, apply_elu);
        }
        store(orow + i, v);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* la, const void* rb, const float* bias,
                   void* out, int N, int H, int W, int K, int D,
                   int apply_elu, int packed, cudaStream_t stream) {
  const size_t smem =
      (size_t)(packed ? 2 : 1) * (2 * TX + DC - 1) * K * sizeof(float);
  const void* fn = packed ? (const void*)emit_packed_kernel<T>
                          : (const void*)emit_kernel<T>;
  if (smem > 48 * 1024) {
    // Above 48 KB only as opted-in dynamic shared memory; past the card's
    // per-block limit this call fails and the error is returned.
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const T* l = static_cast<const T*>(la);
  const T* r = static_cast<const T*>(rb);
  T* o = static_cast<T*>(out);
  if (packed) {
    const dim3 grid((W + TX - 1) / TX, (H + 1) / 2 + 1, N);
    emit_packed_kernel<T><<<grid, THREADS, smem, stream>>>(l, r, bias, o, H,
                                                           W, K, D, apply_elu);
  } else {
    const dim3 grid((W + TX - 1) / TX, H, N);
    emit_kernel<T><<<grid, THREADS, smem, stream>>>(l, r, bias, o, H, W, K, D,
                                                    apply_elu);
  }
  return cudaGetLastError();
}

}  // namespace

// la: (N, H, W, 3K), rb: (N, H, W, 6K), out: (N, D, H, W, K) (packed == 0)
// or (N, (D + 1) / 2 + 1, (H + 1) / 2 + 1, W, 4K) (packed == 1), all
// contiguous and of one dtype, fp32 (bf16 == 0) or bf16 (bf16 == 1);
// bias: K fp32 values. Returns the cudaError_t of the launch (0 on
// success).
extern "C" int fused_cv_emit_launch(const void* la, const void* rb,
                                    const void* bias, void* out, int n,
                                    int h, int w, int k, int max_disp,
                                    int apply_elu, int bf16, int packed,
                                    int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  e = bf16 ? launch<__nv_bfloat16>(la, rb, b, out, n, h, w, k, max_disp,
                                   apply_elu, packed, s)
           : launch<float>(la, rb, b, out, n, h, w, k, max_disp, apply_elu,
                           packed, s);
  return (int)e;
}

extern "C" const char* fused_cv_emit_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
