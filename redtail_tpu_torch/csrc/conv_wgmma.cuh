// The bf16 implicit-GEMM pipeline shared by the stride-1 3D conv kernels
// for Hopper (sm_90a): conv223 (`conv223.cu`, the packed head's dense
// (2, 2, 3) conv) and conv3d_k3 (`conv3d_k3.cu`, the 3D encoder's TF-SAME
// 3x3x3 conv with the ELU in its epilogue). Its pieces (the tile plan and
// `decode`, TMA, the mbarrier ring, `ldmatrix`, the `wgmma` products) also
// build `deconv3d_s2.cu`, the 3D decoder's transposed conv, a kernel of its
// own. One algorithm, instantiated per shape class:
//
//   out[n, d, h, x, :] = epi(b + sum over td, th < T, tw < 3 of
//                        xp[n, d + td - P, h + th - P, x + tw - 1, :]
//                        . k[td, th, tw])
//
// with T = 2 and P = 0 for conv223 (xp (N, Dp, Hp, W, C) -> (N, Dp - 1,
// Hp - 1, W, K)), T = 3 and P = 1 for conv3d_k3 (x (N, D, H, W, C) -> (N,
// D, H, W, K), TF-SAME padding), and xp zero outside the tensor. Products
// are summed in fp32, the bias is added in the accumulator and the sum is
// rounded once to bf16; epi is that rounding, or (ELU) the rounding, then
// v > 0 ? v : expm1f(v) on the rounded value in fp32, rounded again: the
// two roundings of a bf16 conv followed by a bf16 ELU.
//
// Design: a warp-specialised, persistent `wgmma` implicit GEMM. M is output
// pixels, N the output channels (a tile of BN = 32, 64 or 128; K > BN takes
// several N tiles), the reduction walks K-steps of (CH-channel chunk, td,
// th): T * T * ceil(C / CH) steps.
//   - A tile is ROWS rows x 64 columns of one (n, d) plane, two consumer
//     warpgroups of MB m64 blocks each: 4 rows (M = 256, MB = 2), or 8
//     rows (M = 512, MB = 4), which halves the slab staged per product.
//   - Each K-step's input slab, ROWS x 66 columns x CH channels, and its
//     weight slab, the 3 tw taps' (BN x CH) slices, arrive by TMA
//     (`cp.async.bulk.tensor`) into a ring of stages, each completed on an
//     `mbarrier` and released by the consumers on another. One thread of a
//     producer warpgroup (its registers cut to 40 with `setmaxnreg`) keeps
//     the ring full while the two consumer warpgroups (raised to 232)
//     compute: no block barrier in the main loop.
//   - TMA's zero fill of boxes past the tensor gives every padding: the
//     slab starts at column x0 - 1 (possibly -1), at row h0 + th - P and
//     depth d + td - P (possibly -1 or past the end), and channels past C
//     up to the chunk are zero (C = 16 runs one 32-channel chunk).
//   - A pixel's CH channels are one CH * 2-byte row of the slab, swizzled
//     by TMA in CH * 2-byte atoms (128 B at CH = 64, 64 B at CH = 32).
//     A comes from registers: `ldmatrix` from the swizzled slab at the
//     tap's pixel offset tw, so the 3 tw taps read one slab and no im2col
//     copy is made; a descriptor could not start one pixel into a swizzle
//     atom. B, the weights, is read by `wgmma` from shared memory through
//     a descriptor, K-major: the weights are stored (T, T, 3, K, C) once,
//     at load.
//   - Persistent: one block per SM walks the tiles in the order (N tile,
//     n, d, row tile, column tile), so the ~132 tiles in flight are
//     neighbours that share input rows in L2.
//   - The ragged W: the columns past the last full 64 (W % 64 of them)
//     form edge tiles of their own: edge_rows rows x (W % 64) columns of
//     one plane, with edge_rows * (W % 64 + 2) <= ROWS * 66 staged pixels
//     and edge_rows * (W % 64) <= ROWS * 64 outputs. An m64 block with no
//     live pixel still runs its products, on a live pixel's data, and
//     stores nothing: a branch around `wgmma` made ptxas serialise every
//     product (C7520). The plan is `kernels/conv223.py:tile_plan` (`plan`).
//   - Epilogue: bias added to the fp32 accumulators, the rounding (and
//     ELU), stored from registers as bf16 pairs.
//
// The (T = 2, CH = 64, MB = 2, no ELU) instances are conv223's, unchanged.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes through
                   // the runtime, so the library needs no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wgconv {

constexpr int TW = 64;                   // output columns of a tile
constexpr int CONSUMERS = 2;             // warpgroups
constexpr int THREADS = (CONSUMERS + 1) * 128;  // + the producer's
constexpr int SMEM_BUDGET = 200 * 1024;  // the ring's shared memory at most

// T taps along D and H, BN output channels a tile, CH channels a chunk, MB
// m64 blocks a consumer warpgroup (a tile is ROWS = 2 MB rows of TW).
template <int T, int BN, int CH, int MB>
struct Cfg {
  static constexpr int PAD = T == 3 ? 1 : 0;
  static constexpr int ROWS = 2 * MB;
  static constexpr int SLAB = ROWS * (TW + 2);  // staged pixels of a K-step
  static constexpr int TILE = ROWS * TW;        // output pixels of a tile
  static constexpr int ROW = CH * 2;  // bytes of a pixel (or a weight row)
  static constexpr int KS = CH / 16;  // k16 steps of a chunk
  // each a multiple of 1024 bytes, the largest swizzle's atom
  static constexpr int A_BYTES = (SLAB * ROW + 1023) & ~1023;
  static constexpr int B_BYTES = (3 * BN * ROW + 1023) & ~1023;
  static constexpr int STAGE = A_BYTES + B_BYTES;  // a multiple of 1024
  static constexpr int STAGES =
      SMEM_BUDGET / STAGE < 8 ? SMEM_BUDGET / STAGE : 8;
  static constexpr int SMEM = STAGES * STAGE + 1024 + 2 * STAGES * 8;
  static_assert(T == 2 || T == 3, "2 or 3 taps along D and H");
  static_assert(CH == 32 || CH == 64, "a chunk is 32 or 64 channels");
  static_assert(BN == 32 || BN == 64 || BN == 128, "BN is 32, 64 or 128");
  static_assert(MB == 2 || MB == 4, "2 or 4 m64 blocks a warpgroup");
  static_assert(STAGES >= 2, "a ring of at least two stages");
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
__device__ __forceinline__ Tile decode(const Plan& p, int t, int bn,
                                       int main_rows) {
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
    tl.h0 = rt * main_rows;
    tl.xs = (r - rt * p.col_tiles) * TW;
    tl.cols = TW;
    rows = main_rows;
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

// K-major operand of ROW-byte rows in 8-row, ROW-byte-swizzled atoms
// (layout type 1: 128 B, 2: 64 B).
template <int ROW>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)1 << 16 |
         (uint64_t)((8 * ROW) >> 4) << 32 |
         (uint64_t)(ROW == 128 ? 1 : 2) << 62;
}

// The swizzled address of 16-byte unit ``j`` of slab row ``row``: TMA's
// ROW-byte swizzle XORs the unit index with the address bits above 128 B.
template <int ROW>
__device__ __forceinline__ uint32_t swizzled(int row, int j) {
  const uint32_t off = row * ROW;
  return off + ((j ^ ((off >> 7) & (ROW / 16 - 1))) << 4);
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

// d (64 x 32) += a (64 x 16) . b (16 x 32).
__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4],
                                         uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n"
      "}\n"
      : F8(0), F8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d (64 x 16) += a (64 x 16) . b (16 x 16) (the transposed conv's
// `deconv3d_s2.cu`).
__device__ __forceinline__ void wgmma_rs(float (&d)[8],
                                         const uint32_t (&a)[4],
                                         uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n"
      "}\n"
      : F8(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d (64 x 8) += a (64 x 16) . b (16 x 8).
__device__ __forceinline__ void wgmma_rs(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

#undef F8

// The epilogue's value of one output: the biased sum rounded once, or that
// rounded value through the ELU in fp32, rounded again.
template <bool ELU>
__device__ __forceinline__ float epilogue(float v) {
  if (!ELU) return v;
  const float r = __bfloat162float(__float2bfloat16_rn(v));
  return r > 0.f ? r : expm1f(r);
}

template <int T, int BN, int CH, int MB, bool ELU>
__global__ void __launch_bounds__(THREADS, 1)
conv_wgmma(const __grid_constant__ CUtensorMap a_map,
           const __grid_constant__ CUtensorMap a_edge_map,
           const __grid_constant__ CUtensorMap b_map,
           const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
           const Plan p) {
  using C = Cfg<T, BN, CH, MB>;
  extern __shared__ unsigned char smem_raw[];
  // stages at a 1024-byte boundary (the largest swizzle's atom), then the
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
        const Tile tl = decode(p, t, BN, C::ROWS);
        const void* amap = tl.edge ? (const void*)&a_edge_map
                                   : (const void*)&a_map;
        const uint32_t bytes =
            (tl.edge ? p.edge_bytes : C::SLAB * C::ROW) + 3 * BN * C::ROW;
        for (int st = 0; st < p.steps; ++st) {
          const int cc = st / (T * T), tap = st - cc * T * T;
          const int td = tap / T, th = tap - td * T;
          mbar_wait(empty + 8 * stage, phase ^ 1);
          const uint32_t dst = base + stage * C::STAGE;
          mbar_expect_tx(full + 8 * stage, bytes);
          // xp box (CH channels, cols + 2 columns, rows, 1, 1) from
          // (cc * CH, xs - 1, h0 + th - P, d + td - P, n)
          tma_load_5d(dst, amap, full + 8 * stage, cc * CH, tl.xs - 1,
                      tl.h0 + th - C::PAD, tl.d + td - C::PAD, tl.n);
          // weight box (CH channels, BN outputs, 3 tw taps, 1)
          tma_load_4d(dst + C::A_BYTES, &b_map, full + 8 * stage, cc * CH,
                      tl.n0, 0, tap);
          if (++stage == C::STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- two consumer warpgroups: MB m64 blocks each
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
    float acc[MB][BN / 2];
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
      const Tile tl = decode(p, t, BN, C::ROWS);
      // slab row of this lane's ldmatrix pixel in each m64 block (tap 0)
      int prow[MB];
#pragma unroll
      for (int mb = 0; mb < MB; ++mb) {
        int m = (wg * MB + mb) * 64 + warp * 16 + lrow;
        if (m >= tl.npx) m = 0;  // a dead row reads a live pixel
        const int r = m / tl.cols;
        prow[mb] = r * (tl.cols + 2) + (m - r * tl.cols);
      }
#pragma unroll
      for (int mb = 0; mb < MB; ++mb)
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[mb][i] = 0.f;
#pragma unroll
      for (int mb = 0; mb < MB; ++mb) fence_acc(acc[mb]);

      for (int st = 0; st < p.steps; ++st) {
        mbar_wait(full + 8 * stage, phase);
        const uint32_t a_base = base + stage * C::STAGE;
        const uint32_t b_base = a_base + C::A_BYTES;
        uint32_t frag[2][MB][4];  // [buffer][m64 block]
#pragma unroll
        for (int u = 0; u < 3 * C::KS; ++u) {  // (tw, 16-channel step)
          const int tw = u / C::KS, s = u % C::KS, buf = u & 1;
          if (u >= 2) wgmma_wait<1>();  // the buffer's last products are done
#pragma unroll
          for (int mb = 0; mb < MB; ++mb)
            ldmatrix_x4(a_base + swizzled<C::ROW>(prow[mb] + tw,
                                                  (s << 1) | khalf),
                        frag[buf][mb]);
          wgmma_fence();
          const uint64_t desc =
              smem_desc<C::ROW>(b_base + tw * BN * C::ROW + s * 32);
#pragma unroll
          for (int mb = 0; mb < MB; ++mb)
            wgmma_rs(acc[mb], frag[buf][mb], desc);
          wgmma_commit();
        }
        wgmma_wait<0>();
#pragma unroll
        for (int mb = 0; mb < MB; ++mb) fence_acc(acc[mb]);
        if (lane == 0) mbar_arrive(empty + 8 * stage);
        if (++stage == C::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }

      // epilogue: bias in fp32, the rounding (and ELU), bf16 pairs
#pragma unroll
      for (int mb = 0; mb < MB; ++mb) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int m = (wg * MB + mb) * 64 + warp * 16 + g + 8 * half;
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
                  __floats2bfloat162_rn(
                      epilogue<ELU>(acc[mb][4 * j + 2 * half] + bias[col]),
                      epilogue<ELU>(acc[mb][4 * j + 2 * half + 1] +
                                    bias[col + 1]));
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

inline EncodeTiled encode_tiled() {
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

// A bf16 tensor map of ``rank`` dims (innermost first), ``row``-byte
// swizzle (128 or 64), zero fill outside the tensor.
inline bool encode(CUtensorMap* map, const void* ptr, int rank,
                   const cuuint64_t* dims, const cuuint32_t* box, int row) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  cuuint64_t strides[4];
  cuuint64_t stride = 2;
  for (int i = 0; i + 1 < rank; ++i) strides[i] = stride *= dims[i];
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank,
            const_cast<void*>(ptr), dims, strides, box, ones,
            CU_TENSOR_MAP_INTERLEAVE_NONE,
            row == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                       : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// One launch of the (T, BN, CH, MB, ELU) instance: x (N, Dp, Hp, W, C) bf16,
// kt (T, T, 3, K, C) bf16, bias K fp32, out (N, Dout, Hout, W, K) bf16
// with Dout = Dp + 2P - T + 1 (Hout likewise); edge_rows and grid from the
// tile plan.
template <int T, int BN, int CH, int MB, bool ELU>
cudaError_t launch(const void* xp, const void* kt, const float* bias,
                   void* out, int N, int Dp, int Hp, int W, int C, int K,
                   int edge_rows, int grid, cudaStream_t stream) {
  using Cf = Cfg<T, BN, CH, MB>;
  Plan p;
  p.Dout = Dp + 2 * Cf::PAD - T + 1;
  p.Hout = Hp + 2 * Cf::PAD - T + 1;
  p.W = W;
  p.K = K;
  p.steps = T * T * ((C + CH - 1) / CH);
  p.col_tiles = W / TW;
  p.rem = W % TW;
  p.edge_rows = p.rem ? edge_rows : 1;
  p.row_tiles = (p.Hout + Cf::ROWS - 1) / Cf::ROWS;
  p.per_plane = p.row_tiles * p.col_tiles +
                (p.rem ? (p.Hout + p.edge_rows - 1) / p.edge_rows : 0);
  p.planes = N * p.Dout;
  p.tiles = (K + BN - 1) / BN * p.planes * p.per_plane;
  p.edge_bytes = Cf::ROW * (p.rem + 2) * p.edge_rows;
  if (p.Dout < 1 || p.Hout < 1 ||
      (p.rem && (p.edge_rows < 1 || p.edge_rows > 256 ||
                 p.edge_bytes > Cf::SLAB * Cf::ROW ||
                 p.edge_rows * p.rem > Cf::TILE)))
    return cudaErrorInvalidValue;

  CUtensorMap a_map, a_edge_map, b_map;
  const cuuint64_t xdims[5] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)Hp,
                               (cuuint64_t)Dp, (cuuint64_t)N};
  const cuuint32_t abox[5] = {CH, TW + 2, Cf::ROWS, 1, 1};
  const cuuint32_t ebox[5] = {CH, (cuuint32_t)(p.rem + 2),
                              (cuuint32_t)p.edge_rows, 1, 1};
  const cuuint64_t kdims[4] = {(cuuint64_t)C, (cuuint64_t)K, 3,
                               (cuuint64_t)(T * T)};
  const cuuint32_t bbox[4] = {CH, BN, 3, 1};
  if (!encode(&a_map, xp, 5, xdims, abox, Cf::ROW) ||
      !encode(&a_edge_map, xp, 5, xdims, p.rem ? ebox : abox, Cf::ROW) ||
      !encode(&b_map, kt, 4, kdims, bbox, Cf::ROW))
    return cudaErrorInvalidValue;

  const cudaError_t e = cudaFuncSetAttribute(
      conv_wgmma<T, BN, CH, MB, ELU>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Cf::SMEM);
  if (e != cudaSuccess) return e;
  conv_wgmma<T, BN, CH, MB, ELU><<<grid, THREADS, Cf::SMEM, stream>>>(
      a_map, a_edge_map, b_map, bias, static_cast<__nv_bfloat16*>(out), p);
  return cudaGetLastError();
}

}  // namespace wgconv
