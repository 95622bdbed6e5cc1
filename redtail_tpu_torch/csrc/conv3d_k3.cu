// The 3D encoder's stride-1 conv with its ELU, for Hopper (sm_90a), bound
// to Python with ctypes.
//
// Replaces no TPU kernel: the JAX package leaves its 3D convs to XLA
// (`redtail_tpu/ops/convolution.py:conv3d`). It was added because the
// port's 3D encoder ran each stride-1 layer, `elu(conv3d(x))` in bf16, as
// five launches on fp32 carriers (a widening copy, cuDNN's TF32 conv, the
// fp32 bias, the rounding, the ELU): about half of a served frame's device
// time at 7% of the bf16 peak. One launch computes the same function:
//
//   out[n, d, h, x, :] = elu(bf16(b + sum over td, th, tw in {0, 1, 2} of
//                        x[n, d + td - 1, h + th - 1, x + tw - 1, :]
//                        . k[td, th, tw]))
//
// x (N, D, H, W, C) bf16 contiguous (NDHWC), zero outside the tensor
// (TF-SAME at stride 1), out (N, D, H, W, K) bf16. Products are summed in
// fp32 (every bf16 product is exact in fp32, as on the fp32 carriers),
// the bias is added in the accumulator, the sum is rounded once to bf16,
// and the ELU (v > 0 ? v : expm1f(v)) runs in fp32 on the rounded value,
// rounded again: the two roundings of the bf16 conv and the bf16 ELU.
// Only the order of summation differs from cuDNN's.
//
// Design: the (T = 3, P = 1, ELU) instances of the implicit GEMM in
// `conv_wgmma.cuh` (design notes there), which conv223 shares: K-steps of
// (chunk, td, th), 9 a chunk; the slab's boxes start at -1 in D, H and W,
// so TMA's zero fill gives the SAME padding and no padded copy is made.
// Instances by shape (`kernels/conv3d_k3.py:tile_plan`): BN = 32, 64 or 128
// output channels a tile (K = 16 and 32 take 32), and CH = 32-channel
// chunks with a 64-byte swizzle for C <= 32 (C = 16 zero-filled to 32), 64
// with a 128-byte swizzle above; tiles of 8 rows at BN = 32, else 4. The
// weights are stored (3, 3, 3, K, C) once, at load
// (`kernels/conv3d_k3.py:kernel_weights`).
//
// What bounds it, each call of the served models (operations at 989 TFLOP/s
// dense bf16, bytes of input, output and weights at 3.35 TB/s, H100 SXM,
// 700 W): NVSmall's conv3D_2, 32 -> 32 at (48, 161, 513), 219.2 GFLOP,
// 0.2217 ms (507.5 MB, 0.1515 ms); conv3D_4 / _5, 64 -> 64 at (24, 81,
// 257), 110.5 GFLOP, 0.1117 ms (128.1 MB, 0.0382 ms); conv3D_7 / _8, 128 ->
// 128 at (12, 41, 129), 56.2 GFLOP, 0.0568 ms. ResNet-18 3D's conv3D_1b,
// 32 -> 32 at (68, 161, 513), 310.6 GFLOP, 0.3140 ms (718.9 MB, 0.2146
// ms); conv3D_2a / 2b 64 -> 64 at (34, 81, 257), 156.6 GFLOP, 0.1583 ms;
// conv3D_3a-5b 19.9, 2.7 and 1.6 GFLOP a call. Operations bound every call.
// Measured (H100 SXM, 700 W, PERF.md): the 64- and 128-channel calls at
// 31-35% of their bound, the C = K = 32 calls at 21%. There a K-step's
// n32 products are few for the slab it stages: 8-row tiles, half the
// staged bytes a product, gained 9%; keeping two steps' products in
// flight, or handing stages back a K-step later, moved nothing. What
// bounds them is not established: no hardware counters were read.
//
// Registers, shared memory, spills (`-Xptxas -v`, nvcc 12.8, written to
// `build/conv3d_k3.log`): all six instances 168 registers at launch (384
// threads, one block per SM), 40 / 232 after `setmaxnreg`, no stack, no
// spills, and no serialised `wgmma` (no ptxas note C7519 / C7520). Dynamic
// shared memory, (BN, CH, rows): (32, 32, 8) 5 stages of 39,936 B, 200,784
// B in all; (64, 32, 4) 6 of 29,696, 179,296 B; (128, 32, 4) 4 of 41,984,
// 169,024 B; (32, 64, 8) 2 of 79,872, 160,800 B; (64, 64, 4) 3 of 58,368,
// 176,176 B; (128, 64, 4) 2 of 82,944, 166,944 B.

#include "conv_wgmma.cuh"

namespace {

// 8-row tiles (4 m64 blocks a consumer warpgroup) at BN = 32, where a
// K-step's n32 products are few for the slab it stages (9% faster at
// NVSmall's conv3D_2 than 4 rows; no gain at BN = 64, whose ring then holds
// 2 stages), else 4 rows
template <int BN, int CH>
cudaError_t launch_k3(const void* x, const void* kt, const float* bias,
                      void* out, int n, int d, int h, int w, int c, int k,
                      int edge_rows, int grid, cudaStream_t stream) {
  return wgconv::launch<3, BN, CH, BN == 32 ? 4 : 2, true>(
      x, kt, bias, out, n, d, h, w, c, k, edge_rows, grid, stream);
}

}  // namespace

// x: (N, D, H, W, C), out: (N, D, H, W, K), bf16, contiguous, 32-byte
// aligned; kt: (3, 3, 3, K, C) bf16; bias: K fp32 values; C and K
// multiples of 16. bn (32, 64 or 128), chunk (32 or 64), edge_rows and grid
// (the persistent blocks) from `kernels/conv3d_k3.py:tile_plan`. Returns
// the cudaError_t of the launch (0 on success).
extern "C" int conv3d_k3_launch(const void* x, const void* kt,
                                const void* bias, void* out, int n, int d,
                                int h, int w, int c, int k, int bn, int chunk,
                                int edge_rows, int grid, int device,
                                void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  if (chunk == 32 && bn == 32)
    e = launch_k3<32, 32>(x, kt, b, out, n, d, h, w, c, k, edge_rows, grid, s);
  else if (chunk == 32 && bn == 64)
    e = launch_k3<64, 32>(x, kt, b, out, n, d, h, w, c, k, edge_rows, grid, s);
  else if (chunk == 32 && bn == 128)
    e = launch_k3<128, 32>(x, kt, b, out, n, d, h, w, c, k, edge_rows, grid,
                           s);
  else if (chunk == 64 && bn == 32)
    e = launch_k3<32, 64>(x, kt, b, out, n, d, h, w, c, k, edge_rows, grid, s);
  else if (chunk == 64 && bn == 64)
    e = launch_k3<64, 64>(x, kt, b, out, n, d, h, w, c, k, edge_rows, grid, s);
  else if (chunk == 64 && bn == 128)
    e = launch_k3<128, 64>(x, kt, b, out, n, d, h, w, c, k, edge_rows, grid,
                           s);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}

extern "C" const char* conv3d_k3_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
