// Correlation cost volume for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the TPU kernel `redtail_tpu/kernels/cost_volume_pallas.py:43`
// (`_corr_kernel`, launched by `_corr_pallas_nhwc`, public entry
// `corr_cost_volume_pallas`). It computes, with fp32 accumulation,
//
//     vol[n, h, x, d] = sum_c L[n, h, x, c] * R[n, h, x - d, c],
//     an explicit zero where x < d,
//
// from NHWC feature maps, and ends in one of three epilogues:
//   - `dlast`: the volume (N, H, W, D) in fp32 (`ops/cost_volume.py:
//     corr_cost_volume_dlast`);
//   - `hdw`: the volume (N, H, D, W) in the input dtype, the Pallas
//     kernel's own contract;
//   - `softargmax`: (N, H, W) fp32, softmax over all D entries of each x
//     (the masked zeros included, as the values 0 they are), then
//     sum_d p_d * d: what the ResNet18-2D model computes from the volume
//     (`ops/softargmax.py` with scale 1), so the volume never reaches
//     device memory.
//
// Groups (`softargmax` only): with G groups each pixel holds G groups of
// C channels, at a pixel stride S >= G * C elements (a channel slice of a
// wider NHWC map is read where it lies), and each (row, group) is an
// independent correlation row: group g of pixel x starts at x * S + g * C.
// The output is (N, H, W, G). This is the H-packed layout of
// `ops/packed2d.py` (G = 2: group q of packed row i holds original row
// 2 i + q): an entry whose original row G * i + g is at or past `rows` is a
// pad row and is written as 0, where the soft-argmax of its all-zero
// volume would be the mean index. G = 1, S = C and rows = H is the
// ungrouped kernel, the same arithmetic in the same order; the grouped
// index arithmetic is a template instantiation of its own (GROUPED).
//
// What bounds it: memory. At the flagship shape (L and R (1, 161, 513, 32)
// bf16, D = 48) the inputs are 10.57 MB; `dlast` writes 15.86 MB more
// (7.9 us of HBM traffic at 3.35 TB/s), `softargmax` 0.33 MB (3.3 us),
// against 0.25 GFLOP of products (0.25 us on bf16 tensor cores).
//
// Design: the warp is the unit of work, and nothing is staged.
//   - a warp owns WX = 16 columns x of one row (n, h) and, for a chunk of
//     up to DC = 64 disparities [d0, d0 + dc), the band y = x - d it
//     needs: nt = ceil((dc + 15) / 8) tiles of 8 columns y starting at
//     yb = x0 + 16 - d0 - 8 nt. Warps are independent: no block barrier,
//     no shared-memory staging of the inputs (a first design staged each
//     block's 64 columns of L and its R window in shared memory through a
//     `cp.async` ring; its address arithmetic, runtime divisions and
//     barriers held `softargmax` at 0.022 ms on an H100 at 700 W, where
//     this design takes 0.016 ms);
//   - bf16: `mma.sync` m16n8k16 (fp32 accumulation) of the warp's 16 x
//     rows against each y tile, the fragments loaded straight from global
//     memory (L2): within a chunk of 32 channels, lane (g, t) takes
//     channels [8t, 8t + 8) of its rows in one 16-byte load and feeds them
//     to the two k16 steps (k slots 2t, 2t + 1, 2t + 8, 2t + 9 of step s
//     hold channels 8t + 4s .. 8t + 4s + 3), the same permutation for A
//     (L) and B (R), so the sum runs over every channel once. Products are
//     exact; only the summation order differs from the plain version. For
//     D = 48, 48 of the 64 columns y are in the band;
//   - fp32: the same fragment layout filled by fp32 FMAs on CUDA cores (no
//     TF32), 4 channels a load, each lane a 2 x 2 register tile (rows g,
//     g + 8; columns 2t, 2t + 1) per y tile, L1 serving the rows its quad
//     shares;
//   - zero outside [0, W) and past C is a zero load, so the band entries
//     with y < 0 come out exactly 0; the accumulators are sized at compile
//     time, NT = 8 y tiles when D <= 49 (the flagship's 48), else 10;
//   - the band entries d = x - y in [d0, d0 + dc) are read out of the
//     accumulator fragments (lane: rows g, g + 8, columns 2t, 2t + 1);
//   - `dlast`, `hdw`: each warp stages its chunk in its own shared-memory
//     area so that its output runs (for `dlast` with D <= 64 the warp's
//     whole 16 x D run, else one run per x; for `hdw` one run of x per d)
//     go out as 16-byte stores, each run shifted in shared memory to its
//     global alignment;
//   - `softargmax`: each lane keeps, for its two rows, a running max, sum
//     of exp and d-weighted sum of exp over its entries (rescaled once per
//     chunk; exp as one MUFU.EX2 of an FMA, v log2e - max log2e), merges
//     them across the 4 lanes of its row by shuffles, and one lane writes
//     4 bytes per x.
// No block uses more than 20 KiB of shared memory (none for `softargmax`),
// so none opts in.
// The tiling is mirrored by `kernels/corr_cost_volume.py:tile_plan`, which
// the CPU tests emulate. The Python wrapper checks the inputs, allocates
// the output, launches on PyTorch's current stream and counts launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int WX = 16;                         // columns x a warp
constexpr int DC = 64;                         // disparities a chunk
constexpr int NT_MAX = (DC + WX - 1 + 7) / 8;  // y tiles of a full chunk
constexpr int NT_SMALL = 8;                    // y tiles when D <= 49
constexpr float LOG2E = 1.4426950408889634f;

enum Mode { HDW = 0, DLAST = 1, SOFTARGMAX = 2 };

__host__ __device__ constexpr int y_tiles(int dc) {
  return (dc + WX - 1 + 7) / 8;
}

struct Params {
  const void* left;
  const void* right;
  void* out;
  int W, C, D;
  int x_groups;  // ceil(W / WX)
  int units;     // N * H * x_groups * G: one a warp
  int d_chunks;  // ceil(D / DC)
  int warp_out;  // elements of a warp's output staging (volume modes)
  int vec;       // 16-byte loads: C and S multiples of 16 bytes, aligned
  // the grouped `softargmax` (GROUPED instantiations) only:
  int H;
  int G;         // groups a pixel
  int S;         // pixel stride, elements (>= G * C)
  int rows;      // original rows: entries of row G * h + g >= rows are 0
};

// 2^x, flushing results below 2^-126 to 0 (MUFU.EX2 alone)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as XLA's convert
}

// 16 bytes of row x of a (W, C) map at channel c (8 bf16 or 4 fp32), zero
// outside [0, W) and past C; pixels C apart, or S apart when GROUPED.
template <bool GROUPED, typename T>
__device__ __forceinline__ uint4 load16(const T* map, int x, int c,
                                        const Params& p) {
  constexpr int V = 16 / sizeof(T);
  union {
    uint4 u;
    T e[V];
  } v;
  v.u = make_uint4(0, 0, 0, 0);
  if (x < 0 || x >= p.W || c >= p.C) return v.u;
  const T* src = map + (int64_t)x * (GROUPED ? p.S : p.C) + c;
  if (p.vec) return __ldg(reinterpret_cast<const uint4*>(src));
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

// One chunk of channels from c0 into the warp's accumulators acc[j]: its 16
// x rows from x0 by y tile j's 8 columns from yb + 8 j, in the m16n8
// fragment layout (lane: rows g, g + 8; columns 2t, 2t + 1).
template <int NT, bool GROUPED>
__device__ __forceinline__ void accumulate(const __nv_bfloat16* lmap,
                                           const __nv_bfloat16* rmap,
                                           const Params& p, int x0, int yb,
                                           int nt, int c0, float (*acc)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int c = c0 + 8 * t;
  const uint4 lo = load16<GROUPED>(lmap, x0 + g, c, p);
  const uint4 hi = load16<GROUPED>(lmap, x0 + g + 8, c, p);
  uint4 b[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j)
    b[j] = j < nt ? load16<GROUPED>(rmap, yb + 8 * j + g, c, p)
                  : make_uint4(0, 0, 0, 0);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j < nt) {
      mma_bf16(acc[j], lo.x, hi.x, lo.y, hi.y, b[j].x, b[j].y);
      mma_bf16(acc[j], lo.z, hi.z, lo.w, hi.w, b[j].z, b[j].w);
    }
  }
}

template <int NT, bool GROUPED>
__device__ __forceinline__ void accumulate(const float* lmap,
                                           const float* rmap,
                                           const Params& p, int x0, int yb,
                                           int nt, int c0, float (*acc)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const uint4 lo = load16<GROUPED>(lmap, x0 + g, c0, p);
  const uint4 hi = load16<GROUPED>(lmap, x0 + g + 8, c0, p);
  const float* a0 = reinterpret_cast<const float*>(&lo);
  const float* a1 = reinterpret_cast<const float*>(&hi);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j < nt) {
      const uint4 r0 = load16<GROUPED>(rmap, yb + 8 * j + 2 * t, c0, p);
      const uint4 r1 = load16<GROUPED>(rmap, yb + 8 * j + 2 * t + 1, c0, p);
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

// Output runs staged in shared memory: run r starts at element
// g_first + r * g_step of ``out`` and holds ``len`` elements; its element e
// is staged at sm[r * s_step + shift(r) + e], shift(r) = start % V, so that
// every 16-byte word of the run is one aligned vector in both memories.
// One warp stores them.
template <typename T>
__device__ __forceinline__ int run_shift(int64_t start) {
  return (int)(start & (16 / sizeof(T) - 1));
}

template <typename T>
__device__ void store_runs(T* out, const T* sm, int runs, int len,
                           int64_t g_first, int64_t g_step, int s_step) {
  constexpr int V = 16 / sizeof(T);
  const int nv = (len + 2 * V - 2) / V;  // vectors a run, any shift
  for (int i = threadIdx.x & 31; i < runs * nv; i += 32) {
    const int r = i / nv, v = i - r * nv;
    const int64_t start = g_first + r * g_step;
    const int e0 = v * V - run_shift<T>(start);  // run element of lane 0
    const T* s = sm + r * s_step + v * V;
    if (e0 >= 0 && e0 + V <= len) {
      *reinterpret_cast<uint4*>(out + start + e0) =
          *reinterpret_cast<const uint4*>(s);
    } else {
      for (int e = 0; e < V; ++e)
        if (e0 + e >= 0 && e0 + e < len) out[start + e0 + e] = s[e];
    }
  }
}

// GROUPED (`softargmax` with G > 1, pad rows or S != C) is its own
// instantiation, so the ungrouped launches run the index arithmetic they
// always ran.
template <typename T, int MODE, int NT, bool GROUPED>
__global__ void __launch_bounds__(THREADS)
corr_kernel(const Params p) {
  extern __shared__ __align__(16) char smem[];
  using OutT = typename std::conditional<MODE == HDW, T, float>::type;
  constexpr int VO = 16 / sizeof(OutT);
  constexpr int CK = sizeof(T) == 2 ? 32 : 4;  // channels a load step
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int unit = blockIdx.x * WARPS + warp;
  if (unit >= p.units) return;  // no block barrier follows
  // units in (n, h, x group, g) order: the groups of one x group are
  // adjacent warps, reading the same lines
  const int xg_unit = GROUPED ? unit / p.G : unit;
  const int gi = GROUPED ? unit - xg_unit * p.G : 0;
  const int64_t nh = xg_unit / p.x_groups;
  const int x0 = (xg_unit - (int)nh * p.x_groups) * WX;
  const int cols = min(WX, p.W - x0);
  const int64_t map_off = GROUPED ? nh * p.W * p.S + (int64_t)gi * p.C
                                  : nh * p.W * p.C;
  const T* lmap = static_cast<const T*>(p.left) + map_off;
  const T* rmap = static_cast<const T*>(p.right) + map_off;
  OutT* wsm = reinterpret_cast<OutT*>(smem) + warp * p.warp_out;

  // running softmax state of rows g and g + 8: max, sum of exp, sum of d exp
  float m[2] = {-FLT_MAX, -FLT_MAX}, s[2] = {0.f, 0.f}, ws[2] = {0.f, 0.f};
  for (int di = 0; di < p.d_chunks; ++di) {
    const int d0 = di * DC, dc = min(DC, p.D - d0), nt = y_tiles(dc);
    const int yb = x0 + WX - d0 - 8 * nt;
    float acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    for (int c0 = 0; c0 < p.C; c0 += CK)
      accumulate<NT, GROUPED>(lmap, rmap, p, x0, yb, nt, c0, acc);

    // Entry (j, r): row k = g + 8 (r >> 1), column y = yb + 8 j + 2t +
    // (r & 1), disparity d = x0 + k - y = d0 + base[r] - 8 j, in the band
    // when 0 <= base[r] - 8 j < dc.
    int base[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      base[r] = g + 8 * (r >> 1) - 2 * t - (r & 1) + 8 * nt - WX;
    if (MODE == SOFTARGMAX) {
      float cm[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          if (j < nt && (unsigned)(base[r] - 8 * j) < (unsigned)dc)
            cm[r >> 1] = fmaxf(cm[r >> 1], acc[j][r]);
      const float cl[2] = {cm[0] * LOG2E, cm[1] * LOG2E};
      float se[4] = {0.f, 0.f, 0.f, 0.f}, je[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if (j < nt && (unsigned)(base[r] - 8 * j) < (unsigned)dc) {
            const float e = exp2_ftz(fmaf(acc[j][r], LOG2E, -cl[r >> 1]));
            se[r] += e;
            je[r] = fmaf((float)j, e, je[r]);
          }
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float scale = exp2_ftz((m[h] - cm[h]) * LOG2E);
        s[h] = s[h] * scale + se[2 * h] + se[2 * h + 1];
        ws[h] = ws[h] * scale +
                (float)(d0 + base[2 * h]) * se[2 * h] - 8.f * je[2 * h] +
                (float)(d0 + base[2 * h + 1]) * se[2 * h + 1] -
                8.f * je[2 * h + 1];
        m[h] = cm[h];
      }
    } else {
      // dlast: one run of cols * D when the chunk holds all of D, else a
      // run of dc per x; hdw: a run of cols per d.
      const bool one_run = MODE == DLAST && p.d_chunks == 1;
      const int64_t g_first = MODE == DLAST ? (nh * p.W + x0) * p.D + d0
                                            : (nh * p.D + d0) * p.W + x0;
      const int64_t g_step = MODE == DLAST ? p.D : p.W;
      const int s_step = MODE == DLAST ? DC + VO : WX + VO;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int k = g + 8 * (r >> 1), dd = base[r] - 8 * j;
          if (j < nt && (unsigned)dd < (unsigned)dc && k < cols) {
            const int y = yb + 8 * j + 2 * t + (r & 1);
            const float v = y < 0 ? 0.f : acc[j][r];  // the explicit zero
            int pos;
            if (one_run)
              pos = run_shift<OutT>(g_first) + k * p.D + dd;
            else if (MODE == DLAST)
              pos = k * s_step + run_shift<OutT>(g_first + k * g_step) + dd;
            else
              pos = dd * s_step + run_shift<OutT>(g_first + dd * g_step) + k;
            store(wsm + pos, v);
          }
        }
      }
      __syncwarp();
      OutT* out = static_cast<OutT*>(p.out);
      if (one_run)
        store_runs(out, wsm, 1, cols * p.D, g_first, 0, 0);
      else if (MODE == DLAST)
        store_runs(out, wsm, cols, dc, g_first, g_step, s_step);
      else
        store_runs(out, wsm, dc, cols, g_first, g_step, s_step);
      __syncwarp();
    }
  }

  if (MODE == SOFTARGMAX) {
    // Merge the 4 lanes of each row (t = 0..3), then lane t = 0 writes.
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
    float* out = static_cast<float*>(p.out);
    // nh < N * H < 2^31 (the launch caps the units)
    const bool pad_row = GROUPED && ((int)nh % p.H) * p.G + gi >= p.rows;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = g + 8 * h;
      if (t == 0 && k < cols) {
        if (GROUPED)
          out[(nh * p.W + x0 + k) * p.G + gi] = pad_row ? 0.f
                                                        : ws[h] / s[h];
        else
          out[nh * p.W + x0 + k] = ws[h] / s[h];
      }
    }
  }
}

template <typename T, int MODE>
cudaError_t launch(const void* left, const void* right, void* out, int N,
                   int H, int W, int C, int D, int G, int S, int rows,
                   cudaStream_t stream) {
  using OutT = typename std::conditional<MODE == HDW, T, float>::type;
  constexpr int VO = 16 / sizeof(OutT);
  if (G < 1 || S < G * C || (MODE != SOFTARGMAX && (G != 1 || S != C)))
    return cudaErrorInvalidValue;
  Params p;
  p.left = left;
  p.right = right;
  p.out = out;
  p.W = W;
  p.C = C;
  p.D = D;
  p.H = H;
  p.G = G;
  p.S = S;
  p.rows = rows;
  p.x_groups = (W + WX - 1) / WX;
  const int64_t units = (int64_t)N * H * p.x_groups * G;
  if (units > INT_MAX - THREADS) return cudaErrorInvalidConfiguration;
  p.units = (int)units;
  p.d_chunks = (D + DC - 1) / DC;
  const auto aligned = [](const void* q) {
    return reinterpret_cast<uintptr_t>(q) % 16 == 0;
  };
  p.vec = (C * sizeof(T)) % 16 == 0 && (S * sizeof(T)) % 16 == 0 &&
          aligned(left) && aligned(right);
  if (!aligned(out)) return cudaErrorMisalignedAddress;
  p.warp_out = 0;
  if (MODE == DLAST)
    p.warp_out = p.d_chunks == 1 ? WX * D + VO : WX * (DC + VO);
  else if (MODE == HDW)
    p.warp_out = (D < DC ? D : DC) * (WX + VO);
  const size_t smem = (size_t)WARPS * p.warp_out * sizeof(OutT);
  const int blocks = (p.units + WARPS - 1) / WARPS;
  const bool small = y_tiles(D < DC ? D : DC) <= NT_SMALL;
  if constexpr (MODE == SOFTARGMAX) {
    if (G > 1 || rows < G * H || S != C) {
      if (small)
        corr_kernel<T, MODE, NT_SMALL, true>
            <<<blocks, THREADS, smem, stream>>>(p);
      else
        corr_kernel<T, MODE, NT_MAX, true>
            <<<blocks, THREADS, smem, stream>>>(p);
      return cudaGetLastError();
    }
  }
  if (small)
    corr_kernel<T, MODE, NT_SMALL, false><<<blocks, THREADS, smem, stream>>>(p);
  else
    corr_kernel<T, MODE, NT_MAX, false><<<blocks, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_mode(int mode, const void* left, const void* right,
                        void* out, int n, int h, int w, int c, int d, int g,
                        int stride, int rows, cudaStream_t s) {
  switch (mode) {
    case HDW:
      return launch<T, HDW>(left, right, out, n, h, w, c, d, g, stride,
                            rows, s);
    case DLAST:
      return launch<T, DLAST>(left, right, out, n, h, w, c, d, g, stride,
                              rows, s);
    case SOFTARGMAX:
      return launch<T, SOFTARGMAX>(left, right, out, n, h, w, c, d, g,
                                   stride, rows, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// left, right: (N, H, W, groups * C) at pixel stride `stride` elements
// (rows of W pixels back to back), fp32 (bf16 == 0) or bf16 (bf16 == 1).
// mode 0 (`hdw`): out (N, H, D, W) in the input dtype; 1 (`dlast`):
// (N, H, W, D) fp32; both with groups = 1 and stride = C. 2
// (`softargmax`): (N, H, W, groups) fp32, an entry of original row
// groups * h + g >= rows written as 0. out 16-byte aligned. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int corr_cost_volume_launch(const void* left, const void* right,
                                       void* out, int n, int h, int w, int c,
                                       int max_disp, int bf16, int mode,
                                       int groups, int stride, int rows,
                                       int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  e = bf16 ? launch_mode<__nv_bfloat16>(mode, left, right, out, n, h, w, c,
                                        max_disp, groups, stride, rows, s)
           : launch_mode<float>(mode, left, right, out, n, h, w, c, max_disp,
                                groups, stride, rows, s);
  return (int)e;
}

extern "C" const char* corr_cost_volume_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
