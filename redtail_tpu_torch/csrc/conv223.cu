// The dense (2, 2, 3) conv of the packed 3D head, for Hopper (sm_90a),
// bound to Python with ctypes.
//
// Replaces the TPU kernel `redtail_tpu/kernels/conv223_pallas.py:60`
// (`_conv223_kernel`, entry `conv223_pallas`). In the packed 3D head a
// stride-1 3x3x3 conv whose input holds D and H pairs in channels, in the
// shifted convention, is one dense conv with 2 taps along the depth slots,
// 2 along the row slots and 3 along W (`ops/packed3d.py:conv3d_packed`):
//
//   out[n, d, h, x, :] = b + sum over td, th in {0, 1}, tw in {0, 1, 2} of
//                        xp[n, d + td, h + th, x + tw - 1, :] . k[td, th, tw]
//
// xp (N, Dp, Hp, W, C) and k (2, 2, 3, C, K) contiguous, zero outside
// [0, W) along x; out (N, Dp - 1, Hp - 1, W, K) in xp's dtype. Products
// are summed in fp32, the bias is added in the accumulator and the sum is
// rounded once, as the Pallas kernel does. The boundary-slot masks stay in
// `conv3d_packed`.
//
// What bounds it: operations. At NVSmall's conv3D_2, xp (1, 25, 82, 513,
// 128) x k (2, 2, 3, 128, 128) -> (1, 24, 81, 513, 128) in bf16, the conv
// is 392.1 GFLOP: 0.3965 ms at the H100 SXM's data-sheet 989 TFLOP/s of
// dense bf16 (700 W), against 524.9 MB of input and output, 0.157 ms at
// 3.35 TB/s.
//
// Design (simple first; a wgmma/TMA pipeline is later work):
//   bf16: an implicit GEMM on the tensor cores through `nvcuda::wmma`
//     (16x16x16, fp32 accumulators). A block computes a tile of TH = 2
//     output rows x TW = 64 columns (M = 128 output pixels) for up to
//     KC = 128 output channels. It stages the input window those pixels
//     read, 2 depth slots x 3 rows x 66 columns, for a chunk of CC input
//     channels in shared memory (zeros outside [0, W) and past Hp), and
//     for each of the 12 taps that tap's (CC, KC) weight slice; the 8
//     warps each hold 2 x 4 accumulator tiles (warps 4 along M, 2 along
//     N). Each tap's A tile is the staged window read at a column offset,
//     so the 12 taps need no im2col copy. The weights are read once per
//     block from L2 (393 KB at C = K = 128); a larger M per block would
//     read them less often.
//   fp32: CUDA-core FMAs, so fp32 stays exact (no TF32). A block stages
//     the 4 x (32 + 2) x C window of one output row and 32 columns; each
//     thread sums 8 columns of one output channel, reading the weights from
//     L1/L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

// ------------------------------------------------------------- bf16 path

constexpr int TW = 64;      // output columns of a block tile
constexpr int TH = 2;       // output rows of a block tile
constexpr int KC = 128;     // output channels of one pass
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int PAD = 16;     // bf16 row padding: rows stay 32-byte aligned

__host__ __device__ inline int win_elems(int cc) {
  return 2 * (TH + 1) * (TW + 2) * (cc + PAD);
}

__global__ void __launch_bounds__(THREADS)
conv223_bf16(const __nv_bfloat16* __restrict__ xp,
             const __nv_bfloat16* __restrict__ k,
             const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
             int Dp, int Hp, int W, int C, int K, int CC) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int ldw = CC + PAD;                 // window row stride (elements)
  const int ldb = KC + PAD;                 // weight row stride (elements)
  __nv_bfloat16* win = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* bsm = win + win_elems(CC);
  float* scratch = reinterpret_cast<float*>(bsm + CC * ldb);

  const int Dout = Dp - 1, Hout = Hp - 1;
  const int x0 = blockIdx.x * TW;
  const int h0 = blockIdx.y * TH;
  const int n = blockIdx.z / Dout, d = blockIdx.z - n * Dout;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1;           // M tiles 2 wm, 2 wm + 1
  const int wn = warp & 1;            // N tiles wn, wn + 2, wn + 4, wn + 6
  const int r = wm >> 1;              // output row of the warp's M tiles
  const int col0 = (wm & 1) * 32;     // first column of the warp's M tiles

  for (int kc0 = 0; kc0 < K; kc0 += KC) {
    const int nt = min(KC, K - kc0) / 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

    for (int cc0 = 0; cc0 < C; cc0 += CC) {
      __syncthreads();  // the previous window's readers are done
      // window[td][rr][col][c] = xp[n, d + td, h0 + rr, x0 - 1 + col,
      // cc0 + c], 16-byte words, zero outside the input
      const int vec = CC / 8;
      const int total = 2 * (TH + 1) * (TW + 2) * vec;
      for (int i = tid; i < total; i += THREADS) {
        const int v = i % vec;
        int rest = i / vec;
        const int col = rest % (TW + 2);
        rest /= TW + 2;
        const int rr = rest % (TH + 1), td = rest / (TH + 1);
        const int hh = h0 + rr, xx = x0 - 1 + col;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (hh < Hp && xx >= 0 && xx < W)
          val = *reinterpret_cast<const uint4*>(
              xp + ((((int64_t)n * Dp + d + td) * Hp + hh) * W + xx) * C +
              cc0 + v * 8);
        *reinterpret_cast<uint4*>(
            win + ((td * (TH + 1) + rr) * (TW + 2) + col) * ldw + v * 8) = val;
      }

      for (int tap = 0; tap < 12; ++tap) {
        const int td = tap / 6, th = (tap / 3) & 1, tw = tap % 3;
        __syncthreads();  // the window is staged / the last tap's B is used
        const int bvec = nt * 2;  // 16-byte words of one weight row
        for (int i = tid; i < CC * bvec; i += THREADS) {
          const int c = i / bvec, v = i - c * bvec;
          *reinterpret_cast<uint4*>(bsm + c * ldb + v * 8) =
              *reinterpret_cast<const uint4*>(
                  k + (int64_t)(tap * C + cc0 + c) * K + kc0 + v * 8);
        }
        __syncthreads();
        // A[m][c] = window[td][r + th][col0 + m + tw][c]: the tap's column
        // offset is a row offset of the staged window
        const __nv_bfloat16* arow =
            win + ((td * (TH + 1) + r + th) * (TW + 2) + col0 + tw) * ldw;
        for (int cs = 0; cs < CC; cs += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> a0, a1;
          wmma::load_matrix_sync(a0, arow + cs, ldw);
          wmma::load_matrix_sync(a1, arow + 16 * ldw + cs, ldw);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int t = wn + 2 * j;
            if (t < nt) {
              wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                             wmma::row_major> b;
              wmma::load_matrix_sync(b, bsm + cs * ldb + t * 16, ldb);
              wmma::mma_sync(acc[0][j], a0, b, acc[0][j]);
              wmma::mma_sync(acc[1][j], a1, b, acc[1][j]);
            }
          }
        }
      }
    }

    // epilogue through a per-warp 16x16 fp32 scratch: bias, one rounding
    float* sc = scratch + warp * 256;
    const int hh = h0 + r;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = wn + 2 * j;
        if (t >= nt) continue;  // uniform across the warp
        wmma::store_matrix_sync(sc, acc[i][j], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int m = e >> 4, ch = e & 15;
          const int x = x0 + col0 + 16 * i + m;
          const int kk = kc0 + t * 16 + ch;
          if (hh < Hout && x < W)
            out[((((int64_t)n * Dout + d) * Hout + hh) * W + x) * K + kk] =
                __float2bfloat16(sc[e] + bias[kk]);  // round to nearest even
        }
        __syncwarp();
      }
    }
  }
}

cudaError_t launch_bf16(const void* xp, const void* k, const float* bias,
                        void* out, int N, int Dp, int Hp, int W, int C, int K,
                        cudaStream_t stream) {
  const int CC = C % 64 == 0 ? 64 : C % 32 == 0 ? 32 : 16;
  const size_t smem = (size_t)win_elems(CC) * sizeof(__nv_bfloat16) +
                      (size_t)CC * (KC + PAD) * sizeof(__nv_bfloat16) +
                      (size_t)WARPS * 256 * sizeof(float);
  const cudaError_t e = cudaFuncSetAttribute(
      conv223_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int Hout = Hp - 1;
  const dim3 grid((W + TW - 1) / TW, (Hout + TH - 1) / TH, N * (Dp - 1));
  conv223_bf16<<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(xp),
      static_cast<const __nv_bfloat16*>(k), bias,
      static_cast<__nv_bfloat16*>(out), Dp, Hp, W, C, K, CC);
  return cudaGetLastError();
}

// ------------------------------------------------------------- fp32 path

constexpr int FTW = 32;        // output columns of a block tile
constexpr int FXJ = 8;         // columns summed by one thread
constexpr int FTHREADS = 256;

__global__ void __launch_bounds__(FTHREADS)
conv223_f32(const float* __restrict__ xp, const float* __restrict__ k,
            const float* __restrict__ bias, float* __restrict__ out, int Dp,
            int Hp, int W, int C, int K) {
  extern __shared__ float fwin[];  // [td * 2 + th][FTW + 2][C]
  const int Dout = Dp - 1, Hout = Hp - 1;
  const int x0 = blockIdx.x * FTW, h = blockIdx.y;
  const int n = blockIdx.z / Dout, d = blockIdx.z - n * Dout;
  const int tid = threadIdx.x;

  const int total = 4 * (FTW + 2) * C;
  for (int i = tid; i < total; i += FTHREADS) {
    const int c = i % C;
    const int rest = i / C;
    const int col = rest % (FTW + 2), row = rest / (FTW + 2);
    const int xx = x0 - 1 + col;
    float v = 0.f;
    if (xx >= 0 && xx < W)
      v = xp[((((int64_t)n * Dp + d + (row >> 1)) * Hp + h + (row & 1)) * W +
              xx) * C + c];
    fwin[i] = v;
  }
  __syncthreads();

  const int items = (FTW / FXJ) * K;
  for (int o = tid; o < items; o += FTHREADS) {
    const int kk = o % K, xg = o / K;
    float acc[FXJ];
#pragma unroll
    for (int j = 0; j < FXJ; ++j) acc[j] = 0.f;
    for (int tap = 0; tap < 12; ++tap) {
      // tap = (td * 2 + th) * 3 + tw: window row tap / 3, column offset tw
      const float* wrow = fwin + ((tap / 3) * (FTW + 2) + xg * FXJ + tap % 3) * C;
      const float* kp = k + (int64_t)tap * C * K + kk;
      for (int c = 0; c < C; ++c) {
        const float wv = kp[(int64_t)c * K];
#pragma unroll
        for (int j = 0; j < FXJ; ++j) acc[j] = fmaf(wrow[j * C + c], wv, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < FXJ; ++j) {
      const int x = x0 + xg * FXJ + j;
      if (x < W)
        out[((((int64_t)n * Dout + d) * Hout + h) * W + x) * K + kk] =
            acc[j] + bias[kk];
    }
  }
}

cudaError_t launch_f32(const void* xp, const void* k, const float* bias,
                       void* out, int N, int Dp, int Hp, int W, int C, int K,
                       cudaStream_t stream) {
  const size_t smem = (size_t)4 * (FTW + 2) * C * sizeof(float);
  const cudaError_t e = cudaFuncSetAttribute(
      conv223_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((W + FTW - 1) / FTW, Hp - 1, N * (Dp - 1));
  conv223_f32<<<grid, FTHREADS, smem, stream>>>(
      static_cast<const float*>(xp), static_cast<const float*>(k), bias,
      static_cast<float*>(out), Dp, Hp, W, C, K);
  return cudaGetLastError();
}

}  // namespace

// xp: (N, Dp, Hp, W, C), k: (2, 2, 3, C, K), out: (N, Dp - 1, Hp - 1, W,
// K), all contiguous and of one dtype, fp32 (bf16 == 0) or bf16
// (bf16 == 1), 32-byte aligned; bias: K fp32 values; C and K multiples of
// 16, C <= 256. Returns the cudaError_t of the launch (0 on success).
extern "C" int conv223_launch(const void* xp, const void* k, const void* bias,
                              void* out, int n, int dp, int hp, int w, int c,
                              int kk, int bf16, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  e = bf16 ? launch_bf16(xp, k, b, out, n, dp, hp, w, c, kk, s)
           : launch_f32(xp, k, b, out, n, dp, hp, w, c, kk, s);
  return (int)e;
}

extern "C" const char* conv223_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
