// Concat cost volume for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the TPU kernel `redtail_tpu/kernels/cost_volume_pallas.py:158`
// (`_concat_kernel`, public entry `cost_volume_pallas`). From NHWC feature
// maps L and R it writes the (N, D, H, W, 2C) volume
//
//     out[n, d, h, x, 0:C]  = L[n, h, x, :]
//     out[n, d, h, x, C:2C] = R[n, h, x - d, :],  zero where x < d,
//
// in the input dtype. It is a pure copy, so it is bit-exact against its
// plain PyTorch version: the kernel moves bytes and never looks at them.
//
// What bounds it: the write. At NVSmall's shape (L and R (1, 161, 513, 32)
// bf16, D = 48) the volume is 507.5 MB against 10.6 MB of features read:
// about 0.155 ms of HBM traffic at 3.35 TB/s on an H100 SXM.
//
// Design (simple first):
//   - one block per (n, h, tile of TX columns); W need not be a multiple of
//     anything (the ragged last tile is masked);
//   - the block stages its L tile (TX x C) once, and for each chunk of DC
//     disparities the R window those disparities read (TX + DC - 1
//     columns), zero outside [0, W), in shared memory; so each input byte
//     is read from device memory about twice however large D is, and the
//     x < d zeros come from the staged zero columns;
//   - the element type does not matter to a copy: the kernel moves words
//     of V bytes (16 where C * sizeof(T) allows it, else 8, 4 or 2), and
//     for each d the tile's TX * 2C output elements are one contiguous run
//     of the volume, so neighbouring threads store neighbouring 16-byte
//     words and a warp fills whole 32-byte sectors.
// The Python wrapper (`redtail_tpu_torch/kernels/cost_volume_concat.py`)
// checks the inputs, allocates the output, launches on PyTorch's current
// stream and counts launches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TX = 64;        // columns of a tile
constexpr int DC = 32;        // disparities sharing one staged R window
constexpr int THREADS = 256;

// cv: words of V per pixel of one map (C * sizeof(T) / sizeof(V)).
template <typename V>
__global__ void __launch_bounds__(THREADS)
concat_kernel(const V* __restrict__ left, const V* __restrict__ right,
              V* __restrict__ out, int H, int W, int cv, int D) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  V* ls = reinterpret_cast<V*>(smem_raw);  // TX pixels
  V* rs = ls + TX * cv;                     // TX + DC - 1 pixels

  const int t = threadIdx.x;
  const int x0 = blockIdx.x * TX;
  const int h = blockIdx.y;
  const int n = blockIdx.z;
  const int nt = min(TX, W - x0);  // columns in this tile
  const int64_t nh = (int64_t)n * H + h;
  const V* lrow = left + nh * W * cv;
  const V* rrow = right + nh * W * cv;

  // L columns [x0, x0 + nt): one contiguous run of the input.
  for (int i = t; i < nt * cv; i += THREADS) ls[i] = lrow[(int64_t)x0 * cv + i];

  const int ov = 2 * cv;  // output words per pixel
  for (int d0 = 0; d0 < D; d0 += DC) {
    // R columns [x0 - d0 - (DC - 1), x0 + nt - d0), zero outside [0, W).
    const int rx0 = x0 - d0 - (DC - 1);
    const int rn = nt + DC - 1;
    __syncthreads();  // the previous chunk's reads of rs are done
    for (int i = t; i < rn * cv; i += THREADS) {
      const int xr = i / cv;
      const int x = rx0 + xr;
      rs[i] = (x >= 0 && x < W) ? rrow[(int64_t)x * cv + (i - xr * cv)]
                                : V{};
    }
    __syncthreads();
    const int dn = min(DC, D - d0);
    for (int dd = 0; dd < dn; ++dd) {
      // Column x - d of R is staged row (x - x0) - dd + DC - 1.
      V* orow = out + ((((int64_t)n * D + d0 + dd) * H + h) * W + x0) * ov;
      for (int i = t; i < nt * ov; i += THREADS) {
        const int xr = i / ov;
        const int j = i - xr * ov;
        orow[i] = j < cv ? ls[xr * cv + j]
                         : rs[(xr - dd + DC - 1) * cv + (j - cv)];
      }
    }
  }
}

template <typename V>
cudaError_t launch(const void* left, const void* right, void* out, int N,
                   int H, int W, int cv, int D, cudaStream_t stream) {
  const size_t smem = (size_t)(2 * TX + DC - 1) * cv * sizeof(V);
  if (smem > 48 * 1024) {
    // Above 48 KB only as opted-in dynamic shared memory; past the card's
    // per-block limit this call fails and the error is returned.
    const cudaError_t e = cudaFuncSetAttribute(
        concat_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((W + TX - 1) / TX, H, N);
  concat_kernel<V><<<grid, THREADS, smem, stream>>>(
      static_cast<const V*>(left), static_cast<const V*>(right),
      static_cast<V*>(out), H, W, cv, D);
  return cudaGetLastError();
}

}  // namespace

// left, right: (N, H, W, C) contiguous, pixel_bytes = C * sizeof(element).
// out: (N, D, H, W, 2C) contiguous, same element type. word is the copy
// width in bytes (16, 8, 4 or 2); it must divide pixel_bytes and the three
// pointers must be aligned to it. Returns the cudaError_t of the launch
// (0 on success).
extern "C" int cost_volume_concat_launch(const void* left, const void* right,
                                         void* out, int n, int h, int w,
                                         int pixel_bytes, int max_disp,
                                         int word, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cv = pixel_bytes / word;
  switch (word) {
    case 16: return (int)launch<uint4>(left, right, out, n, h, w, cv, max_disp, s);
    case 8: return (int)launch<uint2>(left, right, out, n, h, w, cv, max_disp, s);
    case 4: return (int)launch<uint32_t>(left, right, out, n, h, w, cv, max_disp, s);
    case 2: return (int)launch<uint16_t>(left, right, out, n, h, w, cv, max_disp, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* cost_volume_concat_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
