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
// bf16 design: an implicit GEMM on `wgmma`, warp-specialised and
// persistent. M is output pixels, N the output channels (one tile of BN =
// 128, or 64 when K <= 64; K > 128 takes several N tiles), the reduction
// walks K-steps of (64-channel chunk, td, th): 4 x ceil(C / 64) steps.
//   - A tile is 4 rows x 64 columns of one (n, d) plane: M = 256 pixels,
//     two consumer warpgroups of two m64 blocks each, 128 fp32 accumulator
//     registers a thread. The weights are read from L2 once per 256 pixels
//     (the previous kernel: once per 128), about 1.8 GB at NVSmall's call.
//   - Each K-step's input slab, 4 rows x 66 columns x 64 channels (33.8 KB),
//     and its weight slab, the 3 tw taps' (BN x 64) slices (48 KB at BN =
//     128), arrive by TMA (`cp.async.bulk.tensor`) into a ring of stages
//     (2 at BN = 128, 3 at BN = 64), each completed on an `mbarrier` and
//     released by the consumers on another. One thread of a producer
//     warpgroup (its registers cut to 40 with `setmaxnreg`) keeps the ring
//     full while the two consumer warpgroups (raised to 232) compute: no
//     block barrier in the main loop, where the previous kernel restaged
//     each tap's weights behind two.
//   - TMA's zero fill of boxes past the tensor gives the W padding (the
//     slab starts at column x0 - 1, possibly -1), the rows past Hp and the
//     channels past C (C = 16, 32 or 48 run one zero-padded chunk).
//   - A comes from registers: `ldmatrix` from the 128-byte-swizzled slab at
//     the tap's pixel offset tw (0, 1 or 2 rows of 128 bytes), so the 3 tw
//     taps read one slab and no im2col copy is made; a descriptor could not
//     start one pixel (128 bytes) into a 1024-byte swizzle atom. B, the
//     weights, is read by `wgmma` from shared memory through a descriptor,
//     K-major: `ops/packed3d.py:prepare` stores the kernel as (2, 2, 3, K,
//     C) once, at load (`kernels/conv223.py:kernel_weights`).
//   - Persistent: one block per SM (166 KB of shared memory) walks the
//     tiles in the order (N tile, n, d, row tile, column tile), so the ~132
//     tiles in flight are neighbours that share input rows in L2.
//   - The ragged W: W = 513 and 257 are 1 more than a multiple of 64. The
//     columns past the last full 64 (W % 64 of them) form edge tiles of
//     their own: edge_rows rows x (W % 64) columns of one plane, with
//     edge_rows * (W % 64 + 2) <= 264 staged pixels and edge_rows * (W %
//     64) <= 256 outputs (at W % 64 = 1: 81 rows, one tile per plane of
//     two live m64 blocks). An m64 block with no live pixel (the rows past
//     Hout of the last row tile, an edge tile's tail) still runs its
//     products, on a live pixel's data, and stores nothing: a branch around
//     `wgmma` made ptxas serialise every product (C7520), which costs more
//     than the ~4% of dead blocks at NVSmall's call. The plan is
//     `kernels/conv223.py:tile_plan`.
//   - Epilogue: bias added to the fp32 accumulators, one round to bf16,
//     stored from registers as bf16 pairs.
// fp32 design: CUDA-core FMAs, so fp32 stays exact (no TF32). A block
// stages the 4 x (32 + 2) x C window of one output row and 32 columns; each
// thread sums 8 columns of one output channel, reading the weights, in
// (2, 2, 3, C, K) form, from L1/L2.
//
// Registers, shared memory, spills (`-Xptxas -v`, nvcc 12.9, written to
// `build/conv223.log`): conv223_wgmma<128> and <64> 168 registers at
// launch (384 threads, one block per SM), 40 / 232 after `setmaxnreg`, no
// stack, no spills, and no serialised `wgmma` (ptxas notes C7519 / C7520
// would say so); dynamic shared memory 166,944 B at BN = 128 (2 stages of
// 82,944 B, the 1024-byte alignment, the barriers) and 176,176 B at BN =
// 64 (3 stages of 58,368 B). conv223_f32: 40 registers, no spills,
// 4 x 34 x C x 4 B of shared memory (69,632 B at C = 128).
// On an H100 SXM (700 W) at NVSmall's call: 0.638 ms, 62% of the bound,
// against cuDNN's 0.926 ms and the previous kernel's 3.564 ms (PERF.md).

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes through
                   // the runtime, so the library needs no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ------------------------------------------------------------- bf16 path

constexpr int TH = 4;                    // output rows of a tile
constexpr int TW = 64;                   // output columns of a tile
constexpr int SLAB_PIX = TH * (TW + 2);  // staged pixels of one K-step
constexpr int A_BYTES = SLAB_PIX * 128;  // 64 bf16 channels a pixel
constexpr int CONSUMERS = 2;             // warpgroups
constexpr int THREADS = (CONSUMERS + 1) * 128;  // + the producer's

template <int BN>
struct Cfg {
  static constexpr int B_BYTES = 3 * BN * 128;
  static constexpr int STAGE = A_BYTES + B_BYTES;  // a multiple of 1024
  static constexpr int STAGES = BN == 128 ? 2 : 3;
  static constexpr int SMEM = STAGES * STAGE + 1024 + 2 * STAGES * 8;
};

struct Plan {
  int Dout, Hout, W, K, steps;
  int col_tiles, rem, edge_rows, row_tiles, per_plane, planes, tiles;
  int edge_bytes;
};

struct Tile {
  int n, d, h0, xs, cols, npx, n0, edge;
};

// Tile ``t`` of the plan (`kernels/conv223.py:tile_plan` mirrors it).
__device__ __forceinline__ Tile decode(const Plan& p, int t, int bn) {
  Tile tl;
  const int nt = t / (p.planes * p.per_plane);
  t -= nt * p.planes * p.per_plane;
  const int plane = t / p.per_plane;
  int r = t - plane * p.per_plane;
  tl.n = plane / p.Dout;
  tl.d = plane - tl.n * p.Dout;
  tl.n0 = nt * bn;
  int rows;
  if (r < p.row_tiles * p.col_tiles) {
    const int rt = r / p.col_tiles;
    tl.h0 = rt * TH;
    tl.xs = (r - rt * p.col_tiles) * TW;
    tl.cols = TW;
    rows = TH;
    tl.edge = 0;
  } else {
    r -= p.row_tiles * p.col_tiles;
    tl.h0 = r * p.edge_rows;
    tl.xs = p.col_tiles * TW;
    tl.cols = p.rem;
    rows = p.edge_rows;
    tl.edge = 1;
  }
  tl.npx = min(rows, p.Hout - tl.h0) * tl.cols;
  return tl;
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the barrier's phase differs from ``parity``. A phase that
// never completes (a fault in the pipeline) traps after 2^22 polls, each
// a hardware-suspended wait of a few microseconds, rather than hanging the
// card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    asm volatile(
        "{\n"
        ".reg .pred P1;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
        "selp.u32 %0, 1, 0, P1;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (polls == (1u << 22)) __trap();
  }
}

__device__ __forceinline__ void tma_load_5d(uint32_t dst, const void* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(c4), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const void* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// K-major operand of 128-byte rows in 1024-byte, 128-byte-swizzled atoms.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)1 << 16 |
         (uint64_t)(1024 >> 4) << 32 | (uint64_t)1 << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accumulator reads and writes across the
// asynchronous products.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define F8(i)                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),        \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 128, fp32) += a (64 x 16, bf16, registers) . b (16 x 128, bf16,
// shared memory, K-major).
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : F8(0), F8(8), F8(16), F8(24), F8(32), F8(40), F8(48), F8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d (64 x 64) += a (64 x 16) . b (16 x 64).
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : F8(0), F8(8), F8(16), F8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

#undef F8

template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
conv223_wgmma(const __grid_constant__ CUtensorMap a_map,
              const __grid_constant__ CUtensorMap a_edge_map,
              const __grid_constant__ CUtensorMap b_map,
              const float* __restrict__ bias,
              __nv_bfloat16* __restrict__ out, const Plan p) {
  using C = Cfg<BN>;
  extern __shared__ unsigned char smem_raw[];
  // stages at a 1024-byte boundary (the 128-byte swizzle's atom), then the
  // barriers: full[s] (the producer's TMA bytes), empty[s] (one arrival
  // per consumer warp)
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t full = base + C::STAGES * C::STAGE;
  const uint32_t empty = full + C::STAGES * 8;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS * 128) {
    // ---- producer warpgroup: one thread keeps the ring of stages full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == CONSUMERS * 128) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
        const Tile tl = decode(p, t, BN);
        const void* amap = tl.edge ? (const void*)&a_edge_map
                                   : (const void*)&a_map;
        const uint32_t bytes = (tl.edge ? p.edge_bytes : A_BYTES) +
                               C::B_BYTES;
        for (int st = 0; st < p.steps; ++st) {
          const int cc = st >> 2, td = (st >> 1) & 1, th = st & 1;
          mbar_wait(empty + 8 * stage, phase ^ 1);
          const uint32_t dst = base + stage * C::STAGE;
          mbar_expect_tx(full + 8 * stage, bytes);
          // xp box (64 channels, cols + 2 columns, rows, 1, 1) from
          // (cc * 64, xs - 1, h0 + th, d + td, n)
          tma_load_5d(dst, amap, full + 8 * stage, cc * 64, tl.xs - 1,
                      tl.h0 + th, tl.d + td, tl.n);
          // weight box (64 channels, BN outputs, 3 tw taps, 1)
          tma_load_4d(dst + A_BYTES, &b_map, full + 8 * stage, cc * 64, tl.n0,
                      0, td * 2 + th);
          if (++stage == C::STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- two consumer warpgroups: 2 m64 blocks each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = threadIdx.x >> 7;
    const int warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31;
    // ldmatrix.x4: lane gives row (lane & 7) + 8 ((lane >> 3) & 1) of the
    // warp's 16, at k half lane >> 4: registers a0a1, a2a3, a4a5, a6a7 of
    // the wgmma A fragment
    const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;
    const int khalf = lane >> 4;
    const int g = lane >> 2, q = lane & 3;  // accumulator row, column pair
    float acc[2][BN / 2];
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
      const Tile tl = decode(p, t, BN);
      // slab row of this lane's ldmatrix pixel in each m64 block (tap 0)
      int prow[2];
#pragma unroll
      for (int mb = 0; mb < 2; ++mb) {
        int m = wg * 128 + mb * 64 + warp * 16 + lrow;
        if (m >= tl.npx) m = 0;  // a dead row reads a live pixel
        const int r = m / tl.cols;
        prow[mb] = r * (tl.cols + 2) + (m - r * tl.cols);
      }
#pragma unroll
      for (int mb = 0; mb < 2; ++mb)
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[mb][i] = 0.f;
      fence_acc(acc[0]);
      fence_acc(acc[1]);

      for (int st = 0; st < p.steps; ++st) {
        mbar_wait(full + 8 * stage, phase);
        const uint32_t a_base = base + stage * C::STAGE;
        const uint32_t b_base = a_base + A_BYTES;
        uint32_t frag[2][2][4];  // [buffer][m64 block]
#pragma unroll
        for (int u = 0; u < 12; ++u) {  // (tw, 16-channel step)
          const int tw = u >> 2, s = u & 3, buf = u & 1;
          if (u >= 2) wgmma_wait<1>();  // the buffer's last products are done
#pragma unroll
          for (int mb = 0; mb < 2; ++mb) {
            const int row = prow[mb] + tw;
            ldmatrix_x4(a_base + row * 128 +
                            ((((s << 1) | khalf) ^ (row & 7)) << 4),
                        frag[buf][mb]);
          }
          wgmma_fence();
          const uint64_t desc = smem_desc(b_base + tw * BN * 128 + s * 32);
#pragma unroll
          for (int mb = 0; mb < 2; ++mb) wgmma_rs(acc[mb], frag[buf][mb], desc);
          wgmma_commit();
        }
        wgmma_wait<0>();
        fence_acc(acc[0]);
        fence_acc(acc[1]);
        if (lane == 0) mbar_arrive(empty + 8 * stage);
        if (++stage == C::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }

      // epilogue: bias in fp32, one rounding, bf16 pairs
#pragma unroll
      for (int mb = 0; mb < 2; ++mb) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int m = wg * 128 + mb * 64 + warp * 16 + g + 8 * half;
          if (m >= tl.npx) continue;
          const int r = m / tl.cols;
          const int h = tl.h0 + r, x = tl.xs + m - r * tl.cols;
          __nv_bfloat16* o =
              out + ((((int64_t)tl.n * p.Dout + tl.d) * p.Hout + h) * p.W +
                     x) * p.K;
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
            const int col = tl.n0 + 8 * j + 2 * q;
            if (col < p.K)
              *reinterpret_cast<__nv_bfloat162*>(o + col) =
                  __floats2bfloat162_rn(acc[mb][4 * j + 2 * half] + bias[col],
                                        acc[mb][4 * j + 2 * half + 1] +
                                            bias[col + 1]);
          }
        }
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
#if CUDART_VERSION >= 12050
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr,
                                         12000, cudaEnableDefault,
                                         &status) == cudaSuccess &&
        status == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                cudaEnableDefault) == cudaSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
#endif
  }
  return fn;
}

// A bf16 tensor map of ``rank`` dims (innermost first), 128-byte swizzle,
// zero fill outside the tensor.
bool encode(CUtensorMap* map, const void* ptr, int rank,
            const cuuint64_t* dims, const cuuint32_t* box) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  cuuint64_t strides[4];
  cuuint64_t stride = 2;
  for (int i = 0; i + 1 < rank; ++i) strides[i] = stride *= dims[i];
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank,
            const_cast<void*>(ptr), dims, strides, box, ones,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN>
cudaError_t launch_wgmma(const void* xp, const void* kt, const float* bias,
                         void* out, int N, int Dp, int Hp, int W, int C,
                         int K, int edge_rows, int grid,
                         cudaStream_t stream) {
  Plan p;
  p.Dout = Dp - 1;
  p.Hout = Hp - 1;
  p.W = W;
  p.K = K;
  p.steps = 4 * ((C + 63) / 64);
  p.col_tiles = W / TW;
  p.rem = W % TW;
  p.edge_rows = p.rem ? edge_rows : 1;
  p.row_tiles = (p.Hout + TH - 1) / TH;
  p.per_plane = p.row_tiles * p.col_tiles +
                (p.rem ? (p.Hout + p.edge_rows - 1) / p.edge_rows : 0);
  p.planes = N * p.Dout;
  p.tiles = (K + BN - 1) / BN * p.planes * p.per_plane;
  p.edge_bytes = 128 * (p.rem + 2) * p.edge_rows;
  if (p.rem && (p.edge_rows < 1 || p.edge_rows > 256 ||
                p.edge_bytes > A_BYTES || p.edge_rows * p.rem > 256))
    return cudaErrorInvalidValue;

  CUtensorMap a_map, a_edge_map, b_map;
  const cuuint64_t xdims[5] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)Hp,
                               (cuuint64_t)Dp, (cuuint64_t)N};
  const cuuint32_t abox[5] = {64, TW + 2, TH, 1, 1};
  const cuuint32_t ebox[5] = {64, (cuuint32_t)(p.rem + 2),
                              (cuuint32_t)p.edge_rows, 1, 1};
  const cuuint64_t kdims[4] = {(cuuint64_t)C, (cuuint64_t)K, 3, 4};
  const cuuint32_t bbox[4] = {64, BN, 3, 1};
  if (!encode(&a_map, xp, 5, xdims, abox) ||
      !encode(&a_edge_map, xp, 5, xdims, p.rem ? ebox : abox) ||
      !encode(&b_map, kt, 4, kdims, bbox))
    return cudaErrorInvalidValue;

  const cudaError_t e = cudaFuncSetAttribute(
      conv223_wgmma<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Cfg<BN>::SMEM);
  if (e != cudaSuccess) return e;
  conv223_wgmma<BN><<<grid, THREADS, Cfg<BN>::SMEM, stream>>>(
      a_map, a_edge_map, b_map, bias, static_cast<__nv_bfloat16*>(out), p);
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
    e = launch_wgmma<128>(xp, k, b, out, n, dp, hp, w, c, kk, edge_rows, grid,
                          s);
  else if (bn == 64)
    e = launch_wgmma<64>(xp, k, b, out, n, dp, hp, w, c, kk, edge_rows, grid,
                         s);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}

extern "C" const char* conv223_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
