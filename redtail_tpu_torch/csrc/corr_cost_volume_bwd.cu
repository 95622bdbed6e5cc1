// Backward of the correlation cost volume for Hopper (sm_90a), bound to
// Python with ctypes.
//
// Replaces the VJP of the TPU kernel, `redtail_tpu/kernels/
// cost_volume_pallas.py:113` (`_corr_bwd` of the `custom_vjp` `_corr_core`,
// whose forward is `_corr_kernel` at :43), and what XLA derives for
// `ops/cost_volume.py:corr_cost_volume_dlast` followed by
// `ops/softargmax.py`. With the volume
//
//     vol[x, d] = sum_c L[x, c] * R[x - d, c],  zero where x < d
//
// of each row (n, h) and its cotangent g[x, d], it writes
//
//     dL[x, c] = sum_d g[x, d] * R[x - d, c]           (x - d >= 0)
//     dR[y, c] = sum_d g[y + d, d] * L[y + d, c]       (y + d < W)
//
// summed in fp32 (fp32 products of the fp32 cotangent, as `_corr_bwd`'s
// einsums) and rounded once to the input dtype. The cotangent comes in one
// of three forms (`mode`):
//   - `hdw` (0): g (N, H, D, W) in the input dtype, the Pallas contract;
//   - `dlast` (1): g (N, H, W, D) fp32;
//   - `softargmax` (2): g (N, H, W) fp32, the cotangent of the fused
//     soft-argmax epilogue. The forward keeps no volume, so this kernel
//     recomputes it, takes p = softmax over all D entries of each x (the
//     masked zeros x < d take part, as the values 0 they are) and
//     mu = sum_d p_d d, and forms g_vol[x, d] = g[x] p_d (d - mu), in
//     shared memory only. Entries x < d pass no gradient.
// One launch for every form; nothing but dL and dR is written to device
// memory.
//
// What bounds it: at the training shape (L and R (4, 80, 256, 32) bf16,
// D = 48, the 160x512 crop) the `softargmax` form moves 21.3 MB (6.4 us at
// 3.35 TB/s) against 0.46 GFLOP of fp32 gradient products for dL and dR
// (6.8 us at 67 TFLOP/s on CUDA cores) and 0.23 GFLOP of bf16 recompute on
// the tensor cores (0.2 us): about evenly bytes and fp32 operations. The
// first port of this backward (two launches, a 15.7 MB fp32 scratch g_vol
// written once and read twice, 2-byte scalar loads) took 0.385 ms there on
// an H100. This design is held by latency rather than by either bound:
// short phases between block barriers (stage and fill, then sum), each
// waiting on its loads, with 2 (`softargmax`, up to 128 registers) or 4
// (`dlast`, `hdw`, 64) blocks an SM; PERF.md has its times.
//
// Design (the tiling is `kernels/corr_cost_volume.py:bwd_tile_plan`, which
// the CPU tests emulate):
//   - a block of 256 threads owns a segment of `seg` columns [s0, s0 + seg)
//     of one row (n, h) and writes dL and dR there and nowhere else; seg is
//     a multiple of 8 sized so that each thread owns exactly one unit (8
//     columns by tc channels of dL or of dR). `softargmax` takes tc = 4:
//     each staged g_vol value then serves 4 products a load, and at C = 32
//     a segment is 128 columns, so the D - 1 columns of recompute halo are
//     shared by twice the outputs; `dlast` / `hdw` take tc = 2 (64-column
//     segments, 64 registers, 4 blocks an SM), which ran faster for them;
//   - disparities go in chunks of up to DC = 64 (one for D <= 64). A chunk
//     [d0, d0 + dc) stages in shared memory, fp32: the chunk's g_vol twice,
//     as gvL[d][x - s0] for the segment's x (dL's rows) and as
//     gvR[d][y - s0] = g_vol[y + d, d] for the segment's y (dR's diagonal),
//     so both sums read 16-byte aligned runs; R for y in [s0 - d0 - db + 1,
//     s0 + seg - d0) and L for x in [s0 + d0, s0 + seg + d0 + db - 1), the
//     D - 1 columns past the segment being its halo; zero outside [0, W);
//   - `softargmax`: warps recompute the chunk's volume for x in [s0, s0 +
//     seg + d0 + dc - 1) as the forward does (`mma.sync` m16n8k16 bf16 with
//     fp32 accumulation, 16-byte fragment loads; the fp32 path fills the
//     same fragments with FMAs), 4 y tiles at a time to bound registers.
//     A first sweep takes each x's max, sum of exp and d-weighted sum
//     across the 4 lanes of its row, as the forward's epilogue does (for
//     D > 64 a pass over all chunks keeps them in shared memory); a second
//     recomputes the volume and scatters g_vol = g p (d - mu) from the
//     fragments into gvL / gvR, 0 for the masked zeros x < d and for
//     x >= W. (A raw scatter then an element-wise pass over the staged
//     entries ran as fast and needs one barrier more.) `dlast` / `hdw`
//     read each element of g once, coalesced, 4 loads in flight a thread,
//     and write every staged entry (0 where x < d or x >= W);
//   - gradient: a dL unit (x0 = s0 + 8 t, channels tc u .. tc u + tc - 1)
//     keeps 8 x tc fp32 sums; per group of 4 disparities it holds R[x0 - d
//     - 3 .. x0 + 7 - d] in an 11-row register window (4 new rows a group,
//     the rest shifted), and per disparity reads its 8 g_vol values as two
//     16-byte loads and makes 8 tc FMAs; a dR unit the same with the L
//     window L[y0 + d .. y0 + d + 10] and gvR. Each output is one
//     thread's fixed-order sum over ascending d: no atomics, so a remat
//     recompute or a repeated step gives the same bits.
// The Python wrapper (`redtail_tpu_torch/kernels/corr_cost_volume.py`)
// checks the inputs, computes the plan, allocates dL and dR (no scratch),
// launches on PyTorch's current stream and counts launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int WX = 16;                         // recompute: columns x a warp
constexpr int DC = 64;                         // disparities a chunk
constexpr int NH = 4;                          // y tiles a recompute part holds
constexpr int TX = 8;                          // columns of a unit
constexpr int WIN = TX + 3;                    // rows of a unit's window
constexpr int SMEM_MAX = 232448;               // opt-in limit of a block
constexpr int FILL = 4;                        // loads in flight a thread
constexpr float LOG2E = 1.4426950408889634f;

enum Mode { HDW = 0, DLAST = 1, SOFTARGMAX = 2 };

__host__ __device__ constexpr int y_tiles(int dc) {
  return (dc + WX - 1 + 7) / 8;
}

// Channels of a unit: 4 for `softargmax` (each staged g_vol value serves
// twice the products, and 128-column segments halve its recompute halo),
// 2 for the volume forms (64-column segments, 64 registers, 4 blocks an SM).
__host__ __device__ constexpr int unit_channels(int mode) {
  return mode == SOFTARGMAX ? 4 : 2;
}

struct Params {
  const void* left;
  const void* right;
  const void* g;
  void* dleft;
  void* dright;
  int W, C, D;
  int vec;       // 16-byte feature loads: C a multiple of 16 bytes, aligned
  int seg;       // columns of a block's segment, a multiple of TX
  int segs;      // segments a row, ceil(W / seg)
  int cg;        // channel groups, ceil(C / unit_channels(mode))
  int db;        // staged disparity rows, min(round4(D), DC)
  int d_chunks;  // ceil(D / DC)
  int units;     // 2 * (seg / TX) * cg: the dL units, then the dR units
  int passes;    // ceil(units / THREADS)
};

// Shared-memory layout of a block, in floats: gvL and gvR (db rows of
// seg + 4), Ls and Rs (seg + db rows of tc cg), the per-x softmax state
// (3 runs of sp; `softargmax` with D > DC).
__host__ __device__ inline int gv_pitch(int seg) { return seg + 4; }
__host__ __device__ inline int stats_pitch(int seg, int d) {
  return (seg + d + 3) & ~3;
}
__host__ __device__ inline int64_t smem_floats(int seg, int cg, int tc,
                                               int db, int d) {
  return 2LL * db * gv_pitch(seg) + 2LL * (seg + db) * (tc * cg) +
         3LL * stats_pitch(seg, d);
}

// 2^x, flushing results below 2^-126 to 0 (MUFU.EX2 alone)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

// 16 bytes of row x of a (W, C) map at channel c (8 bf16 or 4 fp32), zero
// outside [0, W) and past C (the forward kernel's loader).
template <bool VEC, typename T>
__device__ __forceinline__ uint4 load16(const T* map, int x, int c,
                                        const Params& p) {
  constexpr int V = 16 / sizeof(T);
  union {
    uint4 u;
    T e[V];
  } v;
  v.u = make_uint4(0, 0, 0, 0);
  if (x < 0 || x >= p.W || c >= p.C) return v.u;
  const T* src = map + (x * p.C + c);  // W * C < 2^31 (launch)
  if (VEC) return __ldg(reinterpret_cast<const uint4*>(src));
#pragma unroll
  for (int i = 0; i < V; ++i)
    if (c + i < p.C) v.e[i] = src[i];
  return v.u;
}

__device__ __forceinline__ void mma_bf16(float* c, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The forward kernel's recompute step (`csrc/corr_cost_volume.cu`): one
// chunk of channels from c0 into acc[j], the warp's 16 x rows from x0 by y
// tile j's 8 columns from yb + 8 j, in the m16n8 fragment layout (lane:
// rows g, g + 8; columns 2t, 2t + 1).
template <int NT, bool VEC>
__device__ __forceinline__ void accumulate(const __nv_bfloat16* lmap,
                                           const __nv_bfloat16* rmap,
                                           const Params& p, int x0, int yb,
                                           int nt, int c0, float (*acc)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int c = c0 + 8 * t;
  const uint4 lo = load16<VEC>(lmap, x0 + g, c, p);
  const uint4 hi = load16<VEC>(lmap, x0 + g + 8, c, p);
  uint4 b[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j)
    b[j] = j < nt ? load16<VEC>(rmap, yb + 8 * j + g, c, p)
                  : make_uint4(0, 0, 0, 0);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j < nt) {
      mma_bf16(acc[j], lo.x, hi.x, lo.y, hi.y, b[j].x, b[j].y);
      mma_bf16(acc[j], lo.z, hi.z, lo.w, hi.w, b[j].z, b[j].w);
    }
  }
}

template <int NT, bool VEC>
__device__ __forceinline__ void accumulate(const float* lmap,
                                           const float* rmap,
                                           const Params& p, int x0, int yb,
                                           int nt, int c0, float (*acc)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const uint4 lo = load16<VEC>(lmap, x0 + g, c0, p);
  const uint4 hi = load16<VEC>(lmap, x0 + g + 8, c0, p);
  const float* a0 = reinterpret_cast<const float*>(&lo);
  const float* a1 = reinterpret_cast<const float*>(&hi);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j < nt) {
      const uint4 r0 = load16<VEC>(rmap, yb + 8 * j + 2 * t, c0, p);
      const uint4 r1 = load16<VEC>(rmap, yb + 8 * j + 2 * t + 1, c0, p);
      const float* b0 = reinterpret_cast<const float*>(&r0);
      const float* b1 = reinterpret_cast<const float*>(&r1);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[j][0] = fmaf(a0[i], b0[i], acc[j][0]);
        acc[j][1] = fmaf(a0[i], b1[i], acc[j][1]);
        acc[j][2] = fmaf(a1[i], b0[i], acc[j][2]);
        acc[j][3] = fmaf(a1[i], b1[i], acc[j][3]);
      }
    }
  }
}

// Tiles [j0, j0 + NH) of chunk [d0, d0 + dc)'s volume for the warp's 16
// columns from x0 (the band's y tiles start at yb; nt of them).
template <bool VEC, typename T>
__device__ __forceinline__ void recompute_part(const T* lmap, const T* rmap,
                                               const Params& p, int x0,
                                               int yb, int nt, int j0,
                                               float (*acc)[4]) {
  constexpr int CK = sizeof(T) == 2 ? 32 : 4;  // channels a load step
#pragma unroll
  for (int j = 0; j < NH; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll 1
  for (int c0 = 0; c0 < p.C; c0 += CK)
    accumulate<NH, VEC>(lmap, rmap, p, x0, yb + 8 * j0, min(NH, nt - j0),
                        c0, acc);
}

// Entry (j, r) of a lane's fragments: row g + 8 (r >> 1), column y = yb +
// 8 j + 2t + (r & 1), chunk disparity base[r] - 8 j, in the band when in
// [0, dc).
__device__ __forceinline__ void band_base(int nt, int* base) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 4; ++r)
    base[r] = g + 8 * (r >> 1) - 2 * t - (r & 1) + 8 * nt - WX;
}

// The running softmax state of rows g and g + 8 (max, sum of exp, sum of
// d exp) updated with a part's band entries, as the forward's epilogue.
__device__ __forceinline__ void part_stats(const float (*acc)[4],
                                           const int* base, int j0, int nt,
                                           int dc, int d0, float* m,
                                           float* s, float* ws) {
  float cm[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < NH; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if (j0 + j < nt && (unsigned)(base[r] - 8 * (j0 + j)) < (unsigned)dc)
        cm[r >> 1] = fmaxf(cm[r >> 1], acc[j][r]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float scale = exp2_ftz((m[h] - cm[h]) * LOG2E);
    s[h] *= scale;
    ws[h] *= scale;
    m[h] = cm[h];
  }
#pragma unroll
  for (int j = 0; j < NH; ++j) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int dd = base[r] - 8 * (j0 + j);
      if (j0 + j < nt && (unsigned)dd < (unsigned)dc) {
        const float e =
            exp2_ftz(fmaf(acc[j][r], LOG2E, -m[r >> 1] * LOG2E));
        s[r >> 1] += e;
        ws[r >> 1] = fmaf((float)(d0 + dd), e, ws[r >> 1]);
      }
    }
  }
}

// Merge the state of the 4 lanes of each row (t = 0..3); every lane of the
// quad ends with the row's totals.
__device__ __forceinline__ void merge_quad(float* m, float* s, float* ws) {
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[h], o);
      const float so = __shfl_xor_sync(0xffffffffu, s[h], o);
      const float wo = __shfl_xor_sync(0xffffffffu, ws[h], o);
      const float mn = fmaxf(m[h], mo);
      const float a = exp2_ftz((m[h] - mn) * LOG2E);
      const float b = exp2_ftz((mo - mn) * LOG2E);
      s[h] = s[h] * a + so * b;
      ws[h] = ws[h] * a + wo * b;
      m[h] = mn;
    }
  }
}

// Lane t = 0 of each row writes its softmax state for x < xe: m log2e,
// g[x] / s and mu at x - s0 of the three runs of stats.
__device__ __forceinline__ void put_stats(float* stats, int sp, int s0,
                                          int x0, int xe, const float* grow,
                                          const float* m, const float* s,
                                          const float* ws) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int x = x0 + g + 8 * h;
    if (t == 0 && x < xe) {
      stats[x - s0] = m[h] * LOG2E;
      stats[sp + x - s0] = grow[x] / s[h];
      stats[2 * sp + x - s0] = ws[h] / s[h];
    }
  }
}

// D > DC: every x in [s0, xe)'s softmax state over all D, into stats.
template <bool VEC, typename T>
__device__ void stats_pass(const T* lmap, const T* rmap, const float* grow,
                           float* stats, int sp, int s0, const Params& p) {
  const int warp = threadIdx.x >> 5;
  const int xe = min(p.W, s0 + p.seg + p.D - 1);
  const int groups = (xe - s0 + WX - 1) / WX;
#pragma unroll 1
  for (int xg = warp; xg < groups; xg += WARPS) {
    const int x0 = s0 + xg * WX;
    float m[2] = {-FLT_MAX, -FLT_MAX}, s[2] = {0.f, 0.f}, ws[2] = {0.f, 0.f};
#pragma unroll 1
    for (int d0 = 0; d0 < p.D; d0 += DC) {
      const int dc = min(DC, p.D - d0), nt = y_tiles(dc);
      const int yb = x0 + WX - d0 - 8 * nt;
      int base[4];
      band_base(nt, base);
#pragma unroll 1
      for (int j0 = 0; j0 < nt; j0 += NH) {
        float acc[NH][4];
        recompute_part<VEC>(lmap, rmap, p, x0, yb, nt, j0, acc);
        part_stats(acc, base, j0, nt, dc, d0, m, s, ws);
      }
    }
    merge_quad(m, s, ws);
    put_stats(stats, sp, s0, x0, xe, grow, m, s, ws);
  }
}

// `softargmax`: g_vol[x, d] = (g[x] / s) exp(v - m) (d - mu) of chunk
// [d0, d0 + dc) into every entry of gvL (x in the segment) and gvR (y =
// x - d in it), the masked zeros (x < d) and x >= W as 0. Per 16 columns
// a warp first takes each x's softmax state from a sweep over the volume
// (one chunk) or from stats (the stats pass), then recomputes the volume a
// part at a time and scatters g_vol.
template <bool VEC, typename T>
__device__ void fill_softargmax(float* gvL, float* gvR, const float* stats,
                                int sp, const T* lmap, const T* rmap,
                                const float* grow, int s0, int d0, int dc,
                                const Params& p) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int gp = gv_pitch(p.seg), nt = y_tiles(dc);
  const int xe = s0 + p.seg + d0 + dc - 1;  // past it no entry is staged
  const int groups = (xe - s0 + WX - 1) / WX;
#pragma unroll 1
  for (int xg = warp; xg < groups; xg += WARPS) {
    const int x0 = s0 + xg * WX;
    const int yb = x0 + WX - d0 - 8 * nt;
    int base[4];
    band_base(nt, base);
    float ml[2], gs[2], mu[2];
    if (p.d_chunks == 1) {
      float m[2] = {-FLT_MAX, -FLT_MAX}, s[2] = {0.f, 0.f};
      float ws[2] = {0.f, 0.f};
#pragma unroll 1
      for (int j0 = 0; j0 < nt; j0 += NH) {
        float acc[NH][4];
        recompute_part<VEC>(lmap, rmap, p, x0, yb, nt, j0, acc);
        part_stats(acc, base, j0, nt, dc, d0, m, s, ws);
      }
      merge_quad(m, s, ws);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int x = x0 + g + 8 * h;
        ml[h] = m[h] * LOG2E;
        gs[h] = x < p.W ? grow[x] / s[h] : 0.f;
        mu[h] = ws[h] / s[h];
      }
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int xr = min(x0 + g + 8 * h, p.W - 1) - s0;
        ml[h] = stats[xr];
        gs[h] = x0 + g + 8 * h < p.W ? stats[sp + xr] : 0.f;
        mu[h] = stats[2 * sp + xr];
      }
    }
#pragma unroll 1
    for (int j0 = 0; j0 < nt; j0 += NH) {
      float acc[NH][4];
      recompute_part<VEC>(lmap, rmap, p, x0, yb, nt, j0, acc);
#pragma unroll
      for (int j = 0; j < NH; ++j) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int dd = base[r] - 8 * (j0 + j);
          const int h = r >> 1, x = x0 + g + 8 * h;
          if (j0 + j < nt && (unsigned)dd < (unsigned)dc && x < xe) {
            const int y = yb + 8 * (j0 + j) + 2 * t + (r & 1);
            // the masked zeros (y < 0) join the softmax but pass no
            // gradient; gs is 0 past W
            const float v = y < 0 ? 0.f
                                  : gs[h] *
                                        exp2_ftz(fmaf(acc[j][r], LOG2E,
                                                      -ml[h])) *
                                        ((float)(d0 + dd) - mu[h]);
            const int xr = x - s0, yr = y - s0;
            if (xr < p.seg) gvL[dd * gp + xr] = v;
            if (yr >= 0 && yr < p.seg) gvR[dd * gp + yr] = v;
          }
        }
      }
    }
  }
}

// One element (x, d = d0 + dd) of g, v (0 for x >= W), into gvL (x in the
// segment; 0 where d > x, the masked zeros) and gvR (y = x - d in it).
__device__ __forceinline__ void put(float* gvL, float* gvR, float v, int x,
                                    int dd, int s0, int d0, int gp,
                                    const Params& p) {
  const int xr = x - s0, yr = xr - d0 - dd;
  if (xr < p.seg) gvL[dd * gp + xr] = d0 + dd <= x ? v : 0.f;
  if (yr >= 0 && yr < p.seg) gvR[dd * gp + yr] = v;
}

// `dlast`: g (W, D) fp32 of the row into every entry of gvL / gvR's chunk
// rows: warps take columns x in [s0, xe) (0 past W), lanes the chunk's
// disparities, FILL columns' loads in flight before their stores; each
// element read once.
__device__ void fill_dlast(float* gvL, float* gvR, const float* grow, int s0,
                           int d0, int dc, const Params& p) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gp = gv_pitch(p.seg), xe = s0 + p.seg + d0 + dc - 1;
  for (int x = s0 + warp; x < xe; x += WARPS * FILL) {
    float v[FILL][2];
#pragma unroll
    for (int k = 0; k < FILL; ++k)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int xk = x + WARPS * k, dd = lane + 32 * h;
        v[k][h] = xk < p.W && dd < dc
                      ? __ldg(grow + (int64_t)xk * p.D + d0 + dd)
                      : 0.f;
      }
#pragma unroll
    for (int k = 0; k < FILL; ++k)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int xk = x + WARPS * k, dd = lane + 32 * h;
        if (xk < xe && dd < dc)
          put(gvL, gvR, v[k][h], xk, dd, s0, d0, gp, p);
      }
  }
}

// `hdw`: g (D, W) of the row, in the input dtype, into every entry of gvL /
// gvR's chunk rows: warps take the chunk's disparities, lanes the columns
// in [s0, xe) (0 past W), FILL loads in flight before their stores; each
// element read once.
template <typename T>
__device__ void fill_hdw(float* gvL, float* gvR, const T* grow, int s0,
                         int d0, int dc, const Params& p) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gp = gv_pitch(p.seg), xe = s0 + p.seg + d0 + dc - 1;
  for (int dd = warp; dd < dc; dd += WARPS) {
    const T* gd = grow + (int64_t)(d0 + dd) * p.W;
    for (int x = s0 + lane; x < xe; x += 32 * FILL) {
      float v[FILL];
#pragma unroll
      for (int k = 0; k < FILL; ++k)
        v[k] = x + 32 * k < p.W ? ld(gd + x + 32 * k) : 0.f;
#pragma unroll
      for (int k = 0; k < FILL; ++k)
        if (x + 32 * k < xe)
          put(gvL, gvR, v[k], x + 32 * k, dd, s0, d0, gp, p);
    }
  }
}

// Rows [x_first, x_first + rows) of a (W, C) map into sm (rows x cp, fp32),
// zero outside [0, W) and past C; FILL loads in flight before their stores.
template <bool VEC, typename T>
__device__ void stage(float* sm, const T* map, int x_first, int rows, int cp,
                      const Params& p) {
  if (VEC) {  // cp == C, a multiple of V
    constexpr int V = 16 / sizeof(T);
    const int per_row = p.C / V, n = rows * per_row;
    union Word {
      uint4 u;
      T e[V];
    };
    for (int i0 = threadIdx.x; i0 < n; i0 += THREADS * FILL) {
      Word in[FILL];
#pragma unroll
      for (int k = 0; k < FILL; ++k) {
        const int i = i0 + THREADS * k, r = i / per_row;
        const int x = x_first + r;
        in[k].u = make_uint4(0, 0, 0, 0);
        if (i < n && x >= 0 && x < p.W)
          in[k].u = __ldg(reinterpret_cast<const uint4*>(
              map + (int64_t)x * p.C + (i - r * per_row) * V));
      }
#pragma unroll
      for (int k = 0; k < FILL; ++k) {
        const int i = i0 + THREADS * k, r = i / per_row;
        if (i >= n) break;
        float* out = sm + r * cp + (i - r * per_row) * V;
#pragma unroll
        for (int e = 0; e < V; e += 4)
          *reinterpret_cast<float4*>(out + e) =
              make_float4(to_f(in[k].e[e]), to_f(in[k].e[e + 1]),
                          to_f(in[k].e[e + 2]), to_f(in[k].e[e + 3]));
      }
    }
  } else {
    for (int i = threadIdx.x; i < rows * cp; i += THREADS) {
      const int r = i / cp, c = i - r * cp, x = x_first + r;
      sm[i] = x >= 0 && x < p.W && c < p.C
                  ? ld(map + (int64_t)x * p.C + c)
                  : 0.f;
    }
  }
}

// N floats of a staged row (8- or 16-byte aligned) into registers.
template <int N>
__device__ __forceinline__ void ld_row(const float* q, float* out) {
  if constexpr (N == 4) {
    const float4 v = *reinterpret_cast<const float4*>(q);
    out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;
  } else {
    const float2 v = *reinterpret_cast<const float2*>(q);
    out[0] = v.x, out[1] = v.y;
  }
}

// One unit's sums over the chunk's dbc rows (a multiple of 4): dL with
// gv = gvL and the R window (win[j] = R[x0 - d - 3 + j] at the group's
// first d), dR with gv = gvR and the L window (win[j] = L[y0 + d + j]).
template <bool DL, int TC>
__device__ __forceinline__ void grad_chunk(const float* gv, const float* fw,
                                           int gp, int cp, int dbc,
                                           float (*acc)[TC]) {
  float win[WIN][TC];
#pragma unroll
  for (int j = 0; j < WIN; ++j) ld_row<TC>(fw + j * cp, win[j]);
  for (int k = 0;;) {
#pragma unroll
    for (int dd = 0; dd < 4; ++dd) {
      const float4 ga = *reinterpret_cast<const float4*>(gv + (k + dd) * gp);
      const float4 gb =
          *reinterpret_cast<const float4*>(gv + (k + dd) * gp + 4);
      const float v[TX] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z, gb.w};
#pragma unroll
      for (int i = 0; i < TX; ++i)
#pragma unroll
        for (int c = 0; c < TC; ++c)
          acc[i][c] = fmaf(v[i], win[DL ? i - dd + 3 : i + dd][c], acc[i][c]);
    }
    k += 4;
    if (k >= dbc) break;
    if (DL) {  // R[x0 - d - 3 + j] moves 4 rows up
#pragma unroll
      for (int j = WIN - 1; j >= 4; --j)
#pragma unroll
        for (int c = 0; c < TC; ++c) win[j][c] = win[j - 4][c];
#pragma unroll
      for (int j = 0; j < 4; ++j) ld_row<TC>(fw + (j - k) * cp, win[j]);
    } else {  // L[y0 + d + j] moves 4 rows down
#pragma unroll
      for (int j = 0; j < WIN - 4; ++j)
#pragma unroll
        for (int c = 0; c < TC; ++c) win[j][c] = win[j + 4][c];
#pragma unroll
      for (int j = WIN - 4; j < WIN; ++j)
        ld_row<TC>(fw + (k + j) * cp, win[j]);
    }
  }
}

// One chunk's staging: gvL / gvR filled with g_vol (for `softargmax` made
// from the recomputed volume), Ls and Rs staged.
template <typename T, int MODE, bool VEC>
__device__ __forceinline__ void prepare(float* gvL, float* gvR, float* Ls,
                                        float* Rs, float* stats, int sp,
                                        const T* lmap, const T* rmap,
                                        const void* grow, int s0, int d0,
                                        int dc, const Params& p) {
  constexpr int TC = unit_channels(MODE);
  const int gp = gv_pitch(p.seg), cp = TC * p.cg, rows = p.seg + p.db;
  // the fills write every entry of rows [0, dc); the rows up to a
  // multiple of 4 that the sums also read are zeroed here
  for (int i = threadIdx.x; i < 2 * gp * (((dc + 3) & ~3) - dc);
       i += THREADS) {
    const int r = i / (2 * gp), k = i - r * 2 * gp;
    (k < gp ? gvL : gvR)[(dc + r) * gp + k % gp] = 0.f;
  }
  if (MODE == SOFTARGMAX)
    fill_softargmax<VEC>(gvL, gvR, stats, sp, lmap, rmap,
                       static_cast<const float*>(grow), s0, d0, dc, p);
  else if (MODE == DLAST)
    fill_dlast(gvL, gvR, static_cast<const float*>(grow), s0, d0, dc, p);
  else
    fill_hdw<T>(gvL, gvR, static_cast<const T*>(grow), s0, d0, dc, p);
  stage<VEC>(Ls, lmap, s0 + d0, rows, cp, p);
  stage<VEC>(Rs, rmap, s0 - d0 - p.db + 1, rows, cp, p);
  __syncthreads();
}

// A unit's sums over one chunk (rows dbc, a multiple of 4).
template <int TC>
__device__ __forceinline__ void grad(bool is_dl, const float* gvL,
                                     const float* gvR, const float* Ls,
                                     const float* Rs, int tile, int cgi,
                                     int dbc, const Params& p,
                                     float (*acc)[TC]) {
  const int gp = gv_pitch(p.seg), cp = TC * p.cg;
  if (is_dl)
    grad_chunk<true, TC>(gvL + tile * TX,
                         Rs + (tile * TX + p.db - 4) * cp + TC * cgi, gp, cp,
                         dbc, acc);
  else
    grad_chunk<false, TC>(gvR + tile * TX, Ls + tile * TX * cp + TC * cgi,
                          gp, cp, dbc, acc);
}

// A unit's TC sums of one column into q: one 16- or 8-byte store where
// all TC channels exist and C is a multiple of TC, else one element at a
// time.
template <int TC>
__device__ __forceinline__ void put_unit(float* q, const float* a, int n,
                                         bool whole) {
  if (whole) {
    if constexpr (TC == 4)
      *reinterpret_cast<float4*>(q) = make_float4(a[0], a[1], a[2], a[3]);
    else
      *reinterpret_cast<float2*>(q) = make_float2(a[0], a[1]);
  } else {
#pragma unroll
    for (int k = 0; k < TC; ++k)
      if (k < n) q[k] = a[k];
  }
}
template <int TC>
__device__ __forceinline__ void put_unit(__nv_bfloat16* q, const float* a,
                                         int n, bool whole) {
  // round to nearest even, as XLA's convert
  if (whole) {
    __nv_bfloat162* q2 = reinterpret_cast<__nv_bfloat162*>(q);
#pragma unroll
    for (int k = 0; k < TC; k += 2)
      q2[k / 2] = __floats2bfloat162_rn(a[k], a[k + 1]);
  } else {
#pragma unroll
    for (int k = 0; k < TC; ++k)
      if (k < n) q[k] = __float2bfloat16(a[k]);
  }
}

template <typename T, int MODE, bool VEC>
__global__ void __launch_bounds__(THREADS, MODE == SOFTARGMAX ? 2 : 4)
corr_bwd_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  constexpr int TC = unit_channels(MODE);
  const int gp = gv_pitch(p.seg), cp = TC * p.cg, rows = p.seg + p.db;
  const int sp = stats_pitch(p.seg, p.D);
  float* gvL = smem;
  float* gvR = gvL + p.db * gp;
  float* Ls = gvR + p.db * gp;
  float* Rs = Ls + rows * cp;
  float* stats = Rs + rows * cp;
  const int64_t nh = blockIdx.x / p.segs;
  const int s0 = (int)(blockIdx.x - nh * p.segs) * p.seg;
  const T* lmap = static_cast<const T*>(p.left) + nh * p.W * p.C;
  const T* rmap = static_cast<const T*>(p.right) + nh * p.W * p.C;
  const void* grow =
      MODE == SOFTARGMAX
          ? static_cast<const void*>(static_cast<const float*>(p.g) +
                                     nh * p.W)
          : MODE == DLAST
                ? static_cast<const void*>(static_cast<const float*>(p.g) +
                                           nh * p.W * p.D)
                : static_cast<const void*>(static_cast<const T*>(p.g) +
                                           nh * p.D * p.W);
  const int half = p.units / 2;

  for (int pass = 0; pass < p.passes; ++pass) {
    const int unit = pass * THREADS + threadIdx.x;
    const bool active = unit < p.units, is_dl = unit < half;
    const int u = is_dl ? unit : unit - half;
    const int tile = u / p.cg, cgi = u - tile * p.cg;
    if (MODE == SOFTARGMAX && p.d_chunks > 1) {
      stats_pass<VEC>(lmap, rmap, static_cast<const float*>(grow), stats,
                      sp, s0, p);
      __syncthreads();
    }
    // chunk 0 apart, so that the unit's sums are not live across its fill
    int dc = min(DC, p.D);
    prepare<T, MODE, VEC>(gvL, gvR, Ls, Rs, stats, sp, lmap, rmap, grow, s0,
                          0, dc, p);
    float acc[TX][TC];
#pragma unroll
    for (int i = 0; i < TX; ++i)
#pragma unroll
      for (int k = 0; k < TC; ++k) acc[i][k] = 0.f;
    if (active)
      grad<TC>(is_dl, gvL, gvR, Ls, Rs, tile, cgi, (dc + 3) & ~3, p, acc);
    for (int d0 = DC; d0 < p.D; d0 += DC) {
      __syncthreads();
      dc = min(DC, p.D - d0);
      prepare<T, MODE, VEC>(gvL, gvR, Ls, Rs, stats, sp, lmap, rmap, grow,
                            s0, d0, dc, p);
      if (active)
        grad<TC>(is_dl, gvL, gvR, Ls, Rs, tile, cgi, (dc + 3) & ~3, p, acc);
    }

    if (active) {
      T* out = static_cast<T*>(is_dl ? p.dleft : p.dright) + nh * p.W * p.C;
      const int x0 = s0 + tile * TX, c = TC * cgi;
      const bool whole = p.C % TC == 0;
#pragma unroll
      for (int i = 0; i < TX; ++i)
        if (x0 + i < p.W && c < p.C)
          put_unit<TC>(out + (int64_t)(x0 + i) * p.C + c, acc[i], p.C - c,
                       whole);
    }
    __syncthreads();
  }
}

template <typename T, int MODE, bool VEC>
cudaError_t start(const Params& p, int blocks, size_t smem,
                  cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        corr_bwd_kernel<T, MODE, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  corr_bwd_kernel<T, MODE, VEC><<<blocks, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(int mode, const void* left, const void* right,
                   const void* g, void* dleft, void* dright, int N, int H,
                   int W, int C, int D, int seg, cudaStream_t stream) {
  if (seg < TX || seg % TX || N < 1 || H < 1 || W < 1 || C < 1 || D < 1)
    return cudaErrorInvalidValue;
  Params p;
  p.left = left;
  p.right = right;
  p.g = g;
  p.dleft = dleft;
  p.dright = dright;
  p.W = W;
  p.C = C;
  p.D = D;
  const auto aligned = [](const void* q) {
    return reinterpret_cast<uintptr_t>(q) % 16 == 0;
  };
  p.vec = (C * sizeof(T)) % 16 == 0 && aligned(left) && aligned(right);
  p.seg = seg;
  p.segs = (W + seg - 1) / seg;
  const int tc = unit_channels(mode);
  p.cg = (C + tc - 1) / tc;
  p.db = D < DC ? (D + 3) & ~3 : DC;
  p.d_chunks = (D + DC - 1) / DC;
  p.units = 2 * (seg / TX) * p.cg;
  p.passes = (p.units + THREADS - 1) / THREADS;
  const int64_t blocks = (int64_t)N * H * p.segs;
  if (blocks > INT_MAX || (int64_t)W * C > INT_MAX)
    return cudaErrorInvalidConfiguration;
  const int64_t smem = 4 * smem_floats(seg, p.cg, tc, p.db, D);
  if (smem > SMEM_MAX) return cudaErrorInvalidConfiguration;
  switch (mode * 2 + p.vec) {
    case 2 * HDW: return start<T, HDW, false>(p, (int)blocks, smem, stream);
    case 2 * HDW + 1: return start<T, HDW, true>(p, (int)blocks, smem, stream);
    case 2 * DLAST:
      return start<T, DLAST, false>(p, (int)blocks, smem, stream);
    case 2 * DLAST + 1:
      return start<T, DLAST, true>(p, (int)blocks, smem, stream);
    case 2 * SOFTARGMAX:
      return start<T, SOFTARGMAX, false>(p, (int)blocks, smem, stream);
    case 2 * SOFTARGMAX + 1:
      return start<T, SOFTARGMAX, true>(p, (int)blocks, smem, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// left, right, dleft, dright: (N, H, W, C) contiguous, fp32 (bf16 == 0) or
// bf16 (bf16 == 1). mode 0 (`hdw`): g (N, H, D, W) in the input dtype;
// 1 (`dlast`): g (N, H, W, D) fp32; 2 (`softargmax`): g (N, H, W) fp32.
// seg: the columns a block owns (`bwd_tile_plan`). Returns the cudaError_t
// of the launch (0 on success).
extern "C" int corr_cost_volume_bwd_launch(const void* left,
                                           const void* right, const void* g,
                                           void* dleft, void* dright, int n,
                                           int h, int w, int c, int max_disp,
                                           int bf16, int mode, int seg,
                                           int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  e = bf16 ? launch<__nv_bfloat16>(mode, left, right, g, dleft, dright, n, h,
                                   w, c, max_disp, seg, s)
           : launch<float>(mode, left, right, g, dleft, dright, n, h, w, c,
                           max_disp, seg, s);
  return (int)e;
}

extern "C" const char* corr_cost_volume_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
