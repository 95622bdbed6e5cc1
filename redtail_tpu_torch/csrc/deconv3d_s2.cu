// The 3D decoder's stride-2 transposed conv with its layer's tail, for
// Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces no TPU kernel: the JAX package leaves its transposed convs to
// XLA (`redtail_tpu/ops/convolution.py:conv3d_transpose`). It was added
// because the port's fused head ran each decoder layer,
// `elu(conv3d_transpose(y) + skip)` in bf16, as six to eight device
// operations on fp32 carriers (a widening copy, cuDNN's TF32 dgrad over
// the whole uncropped output with a layout conversion, the crop and fp32
// bias, the rounding, the skip add, the ELU): about 60% of a served
// frame's device time, at ~4% of its memory bound. One launch computes:
//
//   out = elu(bf16(bf16(b + conv3d_transpose(y, w)) + skip))  (c_out >= 16)
//   out = bf16(b + conv3d_transpose(y, w))                    (c_out == 1)
//
// TF `conv3d_transpose`, k = 3, stride 2, SAME: y (N, Dy, Hy, Wy, C) bf16
// NDHWC, out and skip (N, Xd, Xh, Xw, c_out) with Y = ceil(X / 2) on each
// axis, whose TF low pad is lo = 2 Y - X (0 or 1). Products are summed in
// fp32, the bias added in the accumulator, then exactly the model's
// roundings: the biased sum to bf16, the skip added in fp32 and rounded,
// the ELU (u > 0 ? u : expm1f(u)) in fp32 on that, rounded. Only the
// order of summation differs from the route it replaces.
//
// The split by output parity (sub-pixel decomposition). Along one axis,
// out[o] = sum over j, t with o = 2 j + t - lo of y[j] w[t]. Write o =
// 2 m - lo + c for a window position m in [0, Y) and a class c in {0, 1}:
// class 0 takes y[m - 1] . w[2] + y[m] . w[0], class 1 takes y[m] . w[1].
// So with window offsets a = 0 (reads y[m - 1]) and a = 1 (reads y[m]),
// offset a feeds class c unless a = 0 and c = 1, with tap (a, c) -> 2, 0,
// 1 for (0, 0), (1, 0), (1, 1). In 3D the 8 window offsets feed the 8
// classes in 27 (offset, class) pairs, one per tap of the kernel, none of
// them zero; lo only moves where a class's output lands (o = 2 m - lo + c;
// o = -1, lo = 1's class 0 at m = 0, is not written). This is
// `ops/convolution.py:_shuffle`'s decomposition (`_parity_taps`,
// `shuffle_weights`, parity r = c xor lo) without its zero taps.
//
// Design: conv223's pipeline pieces (`conv_wgmma.cuh`: TMA, the mbarrier
// ring, the persistent walk, `wgmma` with A from registers), with M = the
// window positions, i.e. the input's positions:
//   - A tile is ROWS rows x 64 columns of one (n, depth) plane of y. A
//     K-step is (C-chunk, depth offset ad): its slab, ROWS + 1 rows x 65
//     columns from (row h0 - 1, column x0 - 1, depth d + ad - 1), arrives
//     by TMA (zero fill outside the tensor is the SAME pad); the row
//     offset ah and the column offset aw are the slab's pixel offsets
//     (ah (cols + 1) + aw) at which `ldmatrix` reads A, so the 4 (ah, aw)
//     offsets of a depth offset read one slab.
//   - c_out >= 16: every (offset, class) pair is one `wgmma` with N = BN
//     output channels into that class's fp32 accumulator (8 of them):
//     27 products a 16-channel step, not the 64 of the dense k = 2 form
//     with its zero taps. BN = 32 (16 where C = 128, so the weights fit,
//     or where c_out = 16); c_out > BN takes several N tiles, each a
//     fixed set of persistent blocks. A tile is 2 rows (one m64 block a
//     consumer warpgroup: 8 accumulators of BN / 2 registers).
//   - c_out == 1: the 8 classes are the N = 8 columns of one product an
//     offset (the dense shuffle form, zero taps included: cheap at C <=
//     32), and a tile is 8 rows (4 m64 blocks a warpgroup).
//   - The weights stay in shared memory for the whole launch: one TMA at
//     the block's start, (slots, BN, chunk) K-major, 27 slots (c_out >= 16)
//     or 8 (c_out == 1, each 8 class rows), at most 108 KiB; the ring of
//     slab stages takes the rest.
//   - Epilogue from registers: each class's output written to the voxel
//     it lands on, with its skip read there (c_out >= 16), bf16 pairs; the
//     tile's skip is prefetched into L2 before its products.
//   - Ragged W: the columns past the last full 64 form edge tiles of
//     edge_rows rows (`kernels/deconv3d_s2.py:tile_plan`, the shared
//     `kernels/conv223.py:plan` with one halo row and one halo column).
//
// What bounds it (H100 SXM, 700 W: 3.35 TB/s, 989 TFLOP/s dense bf16):
// bytes, at every layer of the served models (9 to 25 operations a byte,
// under the card's ~295). Reading y and the skip once and writing the
// output once: NVSmall's deconv3D_1 144.6 MB (0.043 ms), deconv3D_2 571.5
// MB (0.171 ms), deconv3D_3 316.9 MB (0.095 ms); ResNet-18 3D's
// deconv3D_4 809.6 MB (0.242 ms), deconv3D_5 448.9 MB (0.134 ms). The
// design moves no other device-memory bytes: no fp32 intermediate, no
// layout conversion, no padded copy; slabs are restaged from L2.
// Measured (H100 SXM, 700 W; PERF.md): the c_out == 1 layers at 42% of
// their bound, the skip layers at 14-21%. What holds those is the
// epilogue, 32K outputs a 2-row tile (bias, two roundings, the skip add,
// `expm1f`) on 8 consumer warps an SM: at NVSmall's deconv3D_2, 0.80 ms in
// all, 0.39 without the ELU, 0.19 storing one class in eight, 0.76 without
// the products; an accurate branch-free expm1 was no faster, the L2
// prefetch of the skip gained 4-10%.
//
// Registers, shared memory, spills (`-Xptxas -v`, nvcc 12.8, written to
// `build/deconv3d_s2.log`): all six instances 168 registers at launch (384
// threads, one block per SM), 40 / 232 after `setmaxnreg`, no stack, no
// spills.

#include "conv_wgmma.cuh"

namespace {

using namespace wgconv;

constexpr int BUDGET = 220 * 1024;  // the weights and the ring at most
constexpr int MAX_STAGES = 8;

// Along one axis, window offset a feeds class c unless a = 0 and c = 1.
__host__ __device__ constexpr bool fed(int a, int c) { return a || !c; }

// The sparse form's weight slot of offset (ad, ah, aw) and class (cd, ch,
// cw): the 27 fed pairs in the order of (offset, class), offsets
// row-major, classes row-major among the fed ones
// (`kernels/deconv3d_s2.py:slot`).
__host__ __device__ constexpr int slot(int ad, int ah, int aw, int cd, int ch,
                                       int cw) {
  return 9 * ad + 3 * (1 + ad) * ah + (1 + ad) * (1 + ah) * aw +
         (cd * (1 + ah) + ch) * (1 + aw) + cw;
}

__device__ __forceinline__ void prefetch_l2(const void* ptr) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(ptr));
}

// BN output channels a tile (8: the shuffle form's 8 class columns, c_out
// == 1), CH channels a chunk.
template <int BN, int CH>
struct DCfg {
  static constexpr bool SHUFFLE = BN == 8;
  static constexpr int MB = SHUFFLE ? 4 : 1;   // m64 blocks a warpgroup
  static constexpr int ROWS = 2 * MB;          // rows of a main tile
  static constexpr int TILE = ROWS * TW;       // window positions of a tile
  static constexpr int SLAB = (ROWS + 1) * (TW + 1);  // staged pixels
  static constexpr int ROW = CH * 2;  // bytes of a pixel (or a weight row)
  static constexpr int KS = CH / 16;  // k16 steps of a chunk
  static constexpr int SLOTS = SHUFFLE ? 8 : 27;
  static constexpr int NACC = SHUFFLE ? 1 : 8;  // accumulators (classes)
  static constexpr int SLOT_BYTES = BN * ROW;   // a multiple of 512
  static constexpr int A_BYTES = (SLAB * ROW + 1023) & ~1023;
  static_assert(CH == 32 || CH == 64, "a chunk is 32 or 64 channels");
  static_assert(BN == 8 || BN == 16 || BN == 32, "BN is 8, 16 or 32");
};

struct DPlan {
  Plan p;  // tiles of y's positions: Dout, Hout, W are y's D, H, W
  int Xd, Xh, Xw, lod, loh, low;  // the output's extents and low pads
  int chunks, stages, n_tiles, bpn;  // bpn: persistent blocks an N tile
};

template <int BN, int CH>
__global__ void __launch_bounds__(THREADS, 1)
deconv_wgmma(const __grid_constant__ CUtensorMap a_map,
             const __grid_constant__ CUtensorMap a_edge_map,
             const __grid_constant__ CUtensorMap w_map,
             const float* __restrict__ bias,
             const __nv_bfloat16* __restrict__ skip,
             __nv_bfloat16* __restrict__ out, const DPlan dp) {
  using C = DCfg<BN, CH>;
  const Plan& p = dp.p;
  extern __shared__ unsigned char smem_raw[];
  // the weights at a 1024-byte boundary (the largest swizzle's atom), the
  // ring's stages, then the barriers: full[s] (the producer's TMA bytes),
  // empty[s] (one arrival per consumer thread), wbar (the weights)
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t chunk_bytes = C::SLOTS * C::SLOT_BYTES;
  const uint32_t ring = base + dp.chunks * chunk_bytes;
  const uint32_t full = ring + dp.stages * C::A_BYTES;
  const uint32_t empty = full + dp.stages * 8;
  const uint32_t wbar = empty + dp.stages * 8;
  const int nt = blockIdx.x % dp.n_tiles;  // this block's N tile
  const int first = blockIdx.x / dp.n_tiles;
  if (threadIdx.x == 0) {
    for (int s = 0; s < dp.stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS * 128);
    }
    mbar_init(wbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS * 128) {
    // ---- producer warpgroup: one thread loads the weights once, then
    // keeps the ring of slab stages full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == CONSUMERS * 128) {
      mbar_expect_tx(wbar, dp.chunks * chunk_bytes);
      // weight box (CH channels, BN rows, all slots, 1) of each chunk
      for (int cc = 0; cc < dp.chunks; ++cc)
        tma_load_4d(base + cc * chunk_bytes, &w_map, wbar, cc * CH, nt * BN,
                    0, 0);
      int stage = 0;
      uint32_t phase = 0;
      for (int t = first; t < p.tiles; t += dp.bpn) {
        const Tile tl = decode(p, t, BN, C::ROWS);
        const void* amap = tl.edge ? (const void*)&a_edge_map
                                   : (const void*)&a_map;
        const uint32_t bytes = tl.edge ? p.edge_bytes : C::SLAB * C::ROW;
        for (int st = 0; st < p.steps; ++st) {  // (chunk, ad)
          const int cc = st >> 1, ad = st & 1;
          mbar_wait(empty + 8 * stage, phase ^ 1);
          mbar_expect_tx(full + 8 * stage, bytes);
          // y box (CH channels, cols + 1 columns, rows + 1 rows, 1, 1) from
          // (cc * CH, xs - 1, h0 - 1, d + ad - 1, n)
          tma_load_5d(ring + stage * C::A_BYTES, amap, full + 8 * stage,
                      cc * CH, tl.xs - 1, tl.h0 - 1, tl.d + ad - 1, tl.n);
          if (++stage == dp.stages) {
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
    // warp's 16, at k half lane >> 4
    const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;
    const int khalf = lane >> 4;
    const int g = lane >> 2, q = lane & 3;  // accumulator row, column pair
    const int n0 = nt * BN;
    float acc[C::MB][C::NACC][BN / 2];
    // this thread's bias values: columns n0 + 8 j + 2 q (+ 1), or the one
    float bv[BN / 8][2];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        bv[j][e] = bias[C::SHUFFLE ? 0 : n0 + 8 * j + 2 * q + e];
    int stage = 0;
    uint32_t phase = 0;
    mbar_wait(wbar, 0);
    for (int t = first; t < p.tiles; t += dp.bpn) {
      const Tile tl = decode(p, t, BN, C::ROWS);
      // slab pixel of this lane's ldmatrix row in each m64 block at offset
      // (ah, aw) = (0, 0); (ah, aw) adds ah (cols + 1) + aw
      int prow[C::MB];
#pragma unroll
      for (int mb = 0; mb < C::MB; ++mb) {
        int m = (wg * C::MB + mb) * 64 + warp * 16 + lrow;
        if (m >= tl.npx) m = 0;  // a dead row reads a live pixel
        const int r = m / tl.cols;
        prow[mb] = r * (tl.cols + 1) + (m - r * tl.cols);
      }
      const int row_step = tl.cols + 1;
      // the voxel class k of this thread's accumulator row (mb, half) lands
      // on, or -1: a dead row, or o = -1 (lo = 1's class 0 at m = 0)
      auto voxel = [&](int mb, int half, int k) -> int64_t {
        const int m = (wg * C::MB + mb) * 64 + warp * 16 + g + 8 * half;
        const int r = m / tl.cols;
        const int h = tl.h0 + r, x = tl.xs + m - r * tl.cols;
        const int od = 2 * tl.d - dp.lod + (k >> 2);
        const int oh = 2 * h - dp.loh + ((k >> 1) & 1);
        const int ow = 2 * x - dp.low + (k & 1);
        if (m >= tl.npx || od < 0 || oh < 0 || ow < 0 || od >= dp.Xd ||
            oh >= dp.Xh || ow >= dp.Xw)
          return -1;
        return (((int64_t)tl.n * dp.Xd + od) * dp.Xh + oh) * dp.Xw + ow;
      };
      if constexpr (!C::SHUFFLE) {
        // the tile's skip into L2 ahead of the epilogue, which reads it:
        // this thread's first and last 16-byte pieces of each voxel
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            const int64_t v = voxel(0, half, k);
            const __nv_bfloat16* at = skip + (v < 0 ? 0 : v) * p.K + n0 +
                                      2 * q;
            prefetch_l2(at);
            if (BN > 16) prefetch_l2(at + BN - 8);
          }
      }
#pragma unroll
      for (int mb = 0; mb < C::MB; ++mb)
#pragma unroll
        for (int k = 0; k < C::NACC; ++k) {
#pragma unroll
          for (int i = 0; i < BN / 2; ++i) acc[mb][k][i] = 0.f;
          fence_acc(acc[mb][k]);
        }

      for (int cc = 0; cc < dp.chunks; ++cc) {
        const uint32_t wc = base + cc * chunk_bytes;
#pragma unroll
        for (int ad = 0; ad < 2; ++ad) {
          mbar_wait(full + 8 * stage, phase);
          const uint32_t a_base = ring + stage * C::A_BYTES;
          uint32_t frag[2][C::MB][4];  // [buffer][m64 block]
#pragma unroll
          for (int u = 0; u < 4 * C::KS; ++u) {  // (ah, aw, k16 step)
            const int ah = u / (2 * C::KS), aw = (u / C::KS) & 1;
            const int s = u % C::KS, buf = u & 1;
            wgmma_wait<1>();  // the buffer's last products are done
#pragma unroll
            for (int mb = 0; mb < C::MB; ++mb)
              ldmatrix_x4(a_base + swizzled<C::ROW>(
                                       prow[mb] + ah * row_step + aw,
                                       (s << 1) | khalf),
                          frag[buf][mb]);
            wgmma_fence();
            if constexpr (C::SHUFFLE) {
              const uint64_t desc = smem_desc<C::ROW>(
                  wc + (4 * ad + 2 * ah + aw) * C::SLOT_BYTES + s * 32);
#pragma unroll
              for (int mb = 0; mb < C::MB; ++mb)
                wgmma_rs(acc[mb][0], frag[buf][mb], desc);
            } else {
#pragma unroll
              for (int k = 0; k < 8; ++k) {
                const int cd = k >> 2, ch = (k >> 1) & 1, cw = k & 1;
                if (!(fed(ad, cd) && fed(ah, ch) && fed(aw, cw))) continue;
                const uint64_t desc = smem_desc<C::ROW>(
                    wc + slot(ad, ah, aw, cd, ch, cw) * C::SLOT_BYTES +
                    s * 32);
#pragma unroll
                for (int mb = 0; mb < C::MB; ++mb)
                  wgmma_rs(acc[mb][k], frag[buf][mb], desc);
              }
            }
            wgmma_commit();
          }
          // the stage's slab is in registers, read by the products just
          // issued: every consumer thread hands it back
          mbar_arrive(empty + 8 * stage);
          if (++stage == dp.stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int mb = 0; mb < C::MB; ++mb)
#pragma unroll
        for (int k = 0; k < C::NACC; ++k) fence_acc(acc[mb][k]);

      // epilogue: each class's outputs to the voxels they land on, one
      // block of independent chains (a dead output reads a live address
      // and stores nothing), so the schedule interleaves them
#pragma unroll
      for (int mb = 0; mb < C::MB; ++mb) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
#pragma unroll
          for (int k = 0; k < (C::SHUFFLE ? 2 : 8); ++k) {
            // the shuffle form's thread holds classes 2q and 2q + 1
            const int cls = C::SHUFFLE ? 2 * q + k : k;
            const int64_t v = voxel(mb, half, cls);
            if constexpr (C::SHUFFLE) {
              const __nv_bfloat16 o =
                  __float2bfloat16_rn(acc[mb][0][2 * half + k] + bv[0][0]);
              if (v >= 0) out[v] = o;
            } else {
              const int64_t at = (v < 0 ? 0 : v) * p.K + n0 + 2 * q;
              const __nv_bfloat162* src =
                  reinterpret_cast<const __nv_bfloat162*>(skip + at);
              __nv_bfloat162* dst =
                  reinterpret_cast<__nv_bfloat162*>(out + at);
#pragma unroll
              for (int j = 0; j < BN / 8; ++j) {
                const float2 s = __bfloat1622float2(__ldg(src + 4 * j));
                float o[2];
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  // the biased sum rounded; the skip added, rounded; the
                  // ELU on that, rounded below
                  const float y = __bfloat162float(__float2bfloat16_rn(
                      acc[mb][k][4 * j + 2 * half + e] + bv[j][e]));
                  const float u = __bfloat162float(
                      __float2bfloat16_rn(y + (e ? s.y : s.x)));
                  o[e] = u > 0.f ? u : expm1f(u);
                }
                if (v >= 0) dst[4 * j] = __floats2bfloat162_rn(o[0], o[1]);
              }
            }
          }
        }
      }
    }
  }
}

// One launch of the (BN, CH) instance: y (N, Dy, Hy, Wy, C) bf16, kt
// (slots, rows, C) bf16 (rows: c_out, or 8 classes where c_out == 1), bias
// c_out fp32, skip (c_out >= 16) and out (N, Xd, Xh, Xw, c_out) bf16;
// edge_rows and grid from the tile plan, grid a multiple of the N tiles.
template <int BN, int CH>
cudaError_t launch_deconv(const void* y, const void* kt, const float* bias,
                   const void* skip, void* out, int N, int Dy, int Hy, int Wy,
                   int C, int K, int Xd, int Xh, int Xw, int edge_rows,
                   int grid, cudaStream_t stream) {
  using Cf = DCfg<BN, CH>;
  DPlan dp;
  Plan& p = dp.p;
  p.Dout = Dy;
  p.Hout = Hy;
  p.W = Wy;
  p.K = K;
  dp.chunks = (C + CH - 1) / CH;
  p.steps = 2 * dp.chunks;
  p.col_tiles = Wy / TW;
  p.rem = Wy % TW;
  p.edge_rows = p.rem ? edge_rows : 1;
  p.row_tiles = (Hy + Cf::ROWS - 1) / Cf::ROWS;
  p.per_plane = p.row_tiles * p.col_tiles +
                (p.rem ? (Hy + p.edge_rows - 1) / p.edge_rows : 0);
  p.planes = N * Dy;
  p.tiles = p.planes * p.per_plane;  // the N tiles are blocks' own
  p.edge_bytes = Cf::ROW * (p.rem + 1) * (p.edge_rows + 1);
  dp.Xd = Xd;
  dp.Xh = Xh;
  dp.Xw = Xw;
  dp.lod = 2 * Dy - Xd;
  dp.loh = 2 * Hy - Xh;
  dp.low = 2 * Wy - Xw;
  dp.n_tiles = Cf::SHUFFLE ? 1 : K / BN;
  const int wbytes = dp.chunks * Cf::SLOTS * Cf::SLOT_BYTES;
  dp.stages = (BUDGET - wbytes) / Cf::A_BYTES;
  if (dp.stages > MAX_STAGES) dp.stages = MAX_STAGES;
  if (N < 1 || Dy < 1 || Hy < 1 || Wy < 1 || dp.lod < 0 || dp.lod > 1 ||
      dp.loh < 0 || dp.loh > 1 || dp.low < 0 || dp.low > 1 ||
      (Cf::SHUFFLE ? K != 1 : K % BN != 0) || dp.stages < 2 ||
      grid < dp.n_tiles || grid % dp.n_tiles ||
      (p.rem && (p.edge_rows < 1 || p.edge_rows + 1 > 256 ||
                 (p.edge_rows + 1) * (p.rem + 1) > Cf::SLAB ||
                 p.edge_rows * p.rem > Cf::TILE)))
    return cudaErrorInvalidValue;
  dp.bpn = grid / dp.n_tiles;

  CUtensorMap a_map, a_edge_map, w_map;
  const cuuint64_t ydims[5] = {(cuuint64_t)C, (cuuint64_t)Wy, (cuuint64_t)Hy,
                               (cuuint64_t)Dy, (cuuint64_t)N};
  const cuuint32_t abox[5] = {CH, TW + 1, Cf::ROWS + 1, 1, 1};
  const cuuint32_t ebox[5] = {CH, (cuuint32_t)(p.rem + 1),
                              (cuuint32_t)(p.edge_rows + 1), 1, 1};
  const cuuint64_t wdims[4] = {(cuuint64_t)C,
                               (cuuint64_t)(Cf::SHUFFLE ? 8 : K),
                               (cuuint64_t)Cf::SLOTS, 1};
  const cuuint32_t wbox[4] = {CH, BN, Cf::SLOTS, 1};
  if (!encode(&a_map, y, 5, ydims, abox, Cf::ROW) ||
      !encode(&a_edge_map, y, 5, ydims, p.rem ? ebox : abox, Cf::ROW) ||
      !encode(&w_map, kt, 4, wdims, wbox, Cf::ROW))
    return cudaErrorInvalidValue;

  const int smem = wbytes + dp.stages * Cf::A_BYTES + 1024 +
                   (2 * dp.stages + 1) * 8;
  const cudaError_t e = cudaFuncSetAttribute(
      deconv_wgmma<BN, CH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return e;
  deconv_wgmma<BN, CH><<<grid, THREADS, smem, stream>>>(
      a_map, a_edge_map, w_map, bias,
      static_cast<const __nv_bfloat16*>(skip),
      static_cast<__nv_bfloat16*>(out), dp);
  return cudaGetLastError();
}

}  // namespace

// y: (N, Dy, Hy, Wy, C), out (and skip, c_out >= 16): (N, Xd, Xh, Xw,
// c_out), bf16, contiguous, 32-byte aligned, Y = ceil(X / 2); kt: the
// kernel form of `kernels/deconv3d_s2.py:kernel_weights`, (27, c_out, C)
// or, where c_out == 1, (8, 8, C) bf16; bias: c_out fp32 values; C in 16,
// 32, 64, 128, c_out in 1, 16, 32, 64. bn (8 where c_out == 1, else 16 or
// 32), chunk (32 or 64), edge_rows and grid (the persistent blocks, a
// multiple of c_out / bn) from `kernels/deconv3d_s2.py:tile_plan`. Returns
// the cudaError_t of the launch (0 on success).
extern "C" int deconv3d_s2_launch(const void* y, const void* kt,
                                  const void* bias, const void* skip,
                                  void* out, int n, int dy, int hy, int wy,
                                  int c, int k, int xd, int xh, int xw,
                                  int bn, int chunk, int edge_rows, int grid,
                                  int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  if ((k == 1) != (bn == 8) || (k > 1 && skip == nullptr))
    return (int)cudaErrorInvalidValue;
#define DECONV_LAUNCH(BN, CH)                                                \
  launch_deconv<BN, CH>(y, kt, b, skip, out, n, dy, hy, wy, c, k, xd, xh, xw,       \
                 edge_rows, grid, s)
  if (chunk == 32 && bn == 8)
    e = DECONV_LAUNCH(8, 32);
  else if (chunk == 64 && bn == 8)
    e = DECONV_LAUNCH(8, 64);
  else if (chunk == 32 && bn == 16)
    e = DECONV_LAUNCH(16, 32);
  else if (chunk == 64 && bn == 16)
    e = DECONV_LAUNCH(16, 64);
  else if (chunk == 32 && bn == 32)
    e = DECONV_LAUNCH(32, 32);
  else if (chunk == 64 && bn == 32)
    e = DECONV_LAUNCH(32, 64);
  else
    e = cudaErrorInvalidValue;
#undef DECONV_LAUNCH
  return (int)e;
}

extern "C" const char* deconv3d_s2_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
