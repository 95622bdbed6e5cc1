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
// xp (N, Dp, Hp, W, C) contiguous, zero outside [0, W) along x; out (N,
// Dp - 1, Hp - 1, W, K) in xp's dtype. Products are summed in fp32, the
// bias is added in the accumulator and the sum is rounded once, as the
// Pallas kernel does. The boundary-slot masks stay in `conv3d_packed`.
//
// What bounds it: operations. At NVSmall's conv3D_2, xp (1, 25, 82, 513,
// 128) x k (2, 2, 3, 128, 128) -> (1, 24, 81, 513, 128) in bf16, the conv
// is 392.1 GFLOP: 0.3965 ms at the H100 SXM's data-sheet 989 TFLOP/s of
// dense bf16 (700 W), against 524.9 MB of input and output, 0.157 ms at
// 3.35 TB/s.
//
// bf16 design: the (T = 2, P = 0, CH = 64, no ELU) instances of the
// warp-specialised, persistent `wgmma` implicit GEMM in `conv_wgmma.cuh`
// (design notes there), which conv3d_k3.cu shares. At this conv: one tile
// of BN = 128 output channels (64 when K <= 64; K > 128 takes several N
// tiles), K-steps of (64-channel chunk, td, th), 4 x ceil(C / 64) of them;
// 128 fp32 accumulator registers a thread at BN = 128; the weights read
// from L2 once per 256 pixels, about 1.8 GB at NVSmall's call; each
// K-step's slab 33.8 KB and its weight slab 48 KB at BN = 128, in a ring of
// 2 stages (3 at BN = 64). TMA's zero fill gives the W padding, the rows
// past Hp and the channels past C (C = 16, 32 or 48 run one zero-padded
// chunk). `ops/packed3d.py:prepare` stores the kernel as (2, 2, 3, K, C)
// once, at load (`kernels/conv223.py:kernel_weights`). At W % 64 = 1 (W =
// 513, 257) an edge tile is 81 rows, one a plane, of two live m64 blocks;
// the dead blocks cost ~4% at NVSmall's call.
// fp32 design: CUDA-core FMAs, so fp32 stays exact (no TF32). A block
// stages the 4 x (32 + 2) x C window of one output row and 32 columns; each
// thread sums 8 columns of one output channel, reading the weights, in
// (2, 2, 3, C, K) form, from L1/L2.
//
// Registers, shared memory, spills (`-Xptxas -v`, nvcc 12.8-12.9, written
// to `build/conv223.log`): conv_wgmma<2, 128, 64, 2, false> and <2, 64,
// 64, 2, false> 168 registers at launch (384 threads, one block per SM),
// 40 / 232 after `setmaxnreg`, no stack, no spills, and no serialised
// `wgmma` (ptxas notes C7519 / C7520 would say so); dynamic shared memory
// 166,944 B at BN = 128 (2 stages of 82,944 B, the 1024-byte alignment,
// the barriers) and 176,176 B at BN = 64 (3 stages of 58,368 B).
// conv223_f32: 40 registers, no spills, 4 x 34 x C x 4 B of shared memory
// (69,632 B at C = 128).
// On an H100 SXM (700 W) at NVSmall's call: 0.638 ms, 62% of the bound,
// against cuDNN's 0.926 ms and the previous kernel's 3.564 ms (PERF.md).

#include "conv_wgmma.cuh"

namespace {

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

// xp: (N, Dp, Hp, W, C), out: (N, Dp - 1, Hp - 1, W, K), contiguous, of one
// dtype, 32-byte aligned; bias: K fp32 values; C and K multiples of 16,
// C <= 256. fp32 (bf16 == 0): k (2, 2, 3, C, K), fp32. bf16 (bf16 == 1):
// k (2, 2, 3, K, C), bf16; bn (64 or 128), edge_rows and grid (the
// persistent blocks) from `kernels/conv223.py:tile_plan`. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int conv223_launch(const void* xp, const void* k, const void* bias,
                              void* out, int n, int dp, int hp, int w, int c,
                              int kk, int bf16, int bn, int edge_rows,
                              int grid, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  if (!bf16)
    e = launch_f32(xp, k, b, out, n, dp, hp, w, c, kk, s);
  else if (bn == 128)
    e = wgconv::launch<2, 128, 64, 2, false>(xp, k, b, out, n, dp, hp, w, c,
                                             kk, edge_rows, grid, s);
  else if (bn == 64)
    e = wgconv::launch<2, 64, 64, 2, false>(xp, k, b, out, n, dp, hp, w, c,
                                            kk, edge_rows, grid, s);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}

extern "C" const char* conv223_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
