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
// 269.2 MB, against 47.6 MB of maps read: 0.0899 and 0.0946 ms of HBM
// traffic at 3.35 TB/s on an H100 SXM.
//
// Design (the write path): the previous kernel decoded every output element
// with runtime divisions by K (two more and a group decode in the packed
// layout), ran the boundary function's four data-dependent branches on
// every element, and stored 2 bytes at a time (0.664 and 0.955 ms). Here:
//   - K is a template parameter for the served widths (K = 32, 64) and a
//     runtime value otherwise; a thread owns VEC = 8 consecutive channels
//     (16 bytes of bf16) of one column when K % 8 == 0, else one channel;
//   - a thread holds a_sum, the bias and the two depth-edge vectors of its
//     channels (a0[x] + bk0[x + 1] for d = 0, a2[x] + bk2[x - D] for
//     d = D - 1) in registers for its whole disparity loop, reads S[x - d]
//     VEC-wide from the staged window and writes one VEC-wide store per
//     (d, x) (one 16-byte store in bf16); neighbouring threads write
//     neighbouring 16 bytes, so a block's stores for one d are one
//     contiguous run;
//   - in the packed layout the thread's VEC channels lie in one (qh, qd)
//     group, decoded once per thread; padding slots and rows are stored as
//     zero vectors;
//   - the depth edges are staged per block in shared memory (where its
//     disparities hold d = 0 or D - 1) and read under a branch on d; the
//     diagonal column fix-ups (x in [d - 2, d] and x = W - 1, 4 columns of
//     each (n, d, h)) are a small second pass, `emit_fixups`, one thread
//     a (n, d, h, column, channel group), that recomputes those outputs
//     whole and stores over the first pass's: the bulk of the outputs runs
//     no boundary code, and no block of the first pass waits on the
//     fix-ups' scattered loads;
//   - a block covers 256 threads' columns (64 at K = 32, 32 at K = 64; 16
//     and 8 in the packed layout) and a chunk of about 16 disparities (16
//     depth slots in the packed layout), the chunks of one column tile
//     neighbours in the grid: a_sum and S are staged once per block, and
//     the many short blocks keep every SM's stores in flight to the end.
//
// Registers, shared memory, spills (`-Xptxas -v`, nvcc 12.9, written to
// `build/fused_cv_emit.log`): no instantiation spills or uses a stack.
// bf16 emit_full / emit_packed: 50 / 54 registers at K = 32 and 64, 50 /
// 56 for other K % 8 == 0, 42 / 48 for the one-channel form; emit_fixups
// 48 (VEC 8) and 36 (VEC 1). fp32: emit_full / emit_packed within 4
// registers of these, emit_fixups 56 and 38.
// Dynamic shared memory at NVSmall's call (K = 32, D = 48): 26,496 B a
// full block (3 chunks of 16 disparities), 18,688 B a packed block (2
// chunks of 13 depth slots, both rows).
// On an H100 SXM (700 W) at that call: full 0.234 ms, packed 0.262 ms,
// 38% and 36% of their byte bounds, against the previous kernel's 0.664
// and 0.955 ms (PERF.md). What holds them there is the fp32 `expm1f` of
// every output (127M of them in the full layout): without the ELU, a call
// no model makes, `chip_smoke.py` times them at 0.126 and 0.159 ms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // target threads of a block
constexpr int MAX_THREADS = 1024;
constexpr int DC = 16;        // disparities of a block (and its S window)

template <int VEC>
__device__ __forceinline__ void load(const __nv_bfloat16* p,
                                     float (&v)[VEC]) {
  if constexpr (VEC == 8) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  } else {
    v[0] = __bfloat162float(*p);
  }
}

template <int VEC>
__device__ __forceinline__ void load(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 8) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
    v[0] = *p;
  }
}

// Shared memory, fp32.
template <int VEC>
__device__ __forceinline__ void lds(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 8) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
    v[0] = *p;
  }
}

template <int VEC>
__device__ __forceinline__ void sts(float* p, const float (&v)[VEC]) {
  if constexpr (VEC == 8) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
    *p = v[0];
  }
}

// One rounding to nearest even.
template <int VEC>
__device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[VEC]) {
  if constexpr (VEC == 8) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  } else {
    *p = __float2bfloat16(v[0]);
  }
}

template <int VEC>
__device__ __forceinline__ void store(float* p, const float (&v)[VEC]) {
  if constexpr (VEC == 8) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
    *p = v[0];
  }
}

template <int VEC>
__device__ __forceinline__ void add(float (&v)[VEC], const float (&t)[VEC]) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) v[i] += t[i];
}

template <int VEC>
__device__ __forceinline__ void sub(float (&v)[VEC], const float (&t)[VEC]) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) v[i] -= t[i];
}

// Stage S at columns [sx0, sx0 + sn) of one row, zero outside [0, W):
// ss[col * K + c], ``G = K / VEC`` channel groups a column.
template <typename T, int VEC>
__device__ __forceinline__ void stage_s(float* ss, const T* rrow, int sx0,
                                        int sn, int W, int K, int G) {
  for (int i = threadIdx.x; i < sn * G; i += blockDim.x) {
    const int col = i / G, c0 = (i - col * G) * VEC;
    const int x = sx0 + col;
    float s[VEC], t[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) s[j] = 0.f;
    if (x >= 0 && x < W) {
      const T* p = rrow + (int64_t)x * 6 * K + c0;
      load(p + K, s);                                     // bk1[x]
      if (x + 1 < W) { load(p + 6 * K, t); add(s, t); }   // bk0[x + 1]
      if (x >= 1) { load(p + 2 * K - 6 * K, t); add(s, t); }  // bk2[x - 1]
    }
    sts(ss + col * K + c0, s);
  }
}

// a0[x] + a1[x] + a2[x] of channels [c0, c0 + VEC).
template <typename T, int VEC>
__device__ __forceinline__ void a_sum(float (&as)[VEC], const T* lrow, int x,
                                      int c0, int K) {
  float t[VEC];
  const T* p = lrow + (int64_t)x * 3 * K + c0;
  load(p, as);
  load(p + K, t);
  add(as, t);
  load(p + 2 * K, t);
  add(as, t);
}

// Stage the boundary depth taps of columns [x0, x0 + nt) of one row:
// ``first`` = a0[x] + bk0[x + 1] (d = 0 has no tap d - 1), ``last`` =
// a2[x] + bk2[x - D] (d = D - 1 has no tap d + 1), each (nt, K), only
// where the block's disparities hold d = 0 / d = D - 1.
template <typename T, int VEC>
__device__ __forceinline__ void stage_depth_edges(
    float* first, float* last, bool need_first, bool need_last,
    const T* lrow, const T* rrow, int x0, int nt, int W, int K, int G,
    int D) {
  if (!need_first && !need_last) return;
  const int64_t k3 = 3 * K, k6 = 6 * K;
  for (int i = threadIdx.x; i < nt * G; i += blockDim.x) {
    const int col = i / G, c0 = (i - col * G) * VEC;
    const int x = x0 + col;
    float e[VEC], t[VEC];
    if (need_first) {
      load(lrow + x * k3 + c0, e);
      if (x + 1 < W) { load(rrow + (x + 1) * k6 + c0, t); add(e, t); }
      sts(first + col * K + c0, e);
    }
    if (need_last) {
      load(lrow + x * k3 + 2 * K + c0, e);
      if (x - D >= 0) { load(rrow + (x - D) * k6 + 2 * K + c0, t); add(e, t); }
      sts(last + col * K + c0, e);
    }
  }
}

// The column fix-ups of one (d, x), channels [c0, c0 + VEC), added to
// ``v``: the shift-composition fix at x = d - 1 and each tap's column-0
// and column-(W - dp) terms (they touch x in [d - 2, d] and x = W - 1).
template <typename T, int VEC>
__device__ __forceinline__ void fix_columns(float (&v)[VEC], const T* rrow,
                                            int x, int c0, int d, int W,
                                            int K, int D) {
  const int64_t k6 = 6 * K;
  float t[VEC];
  if (x == d - 1) { load(rrow + c0, t); add(v, t); }  // bk0 at column 0
#pragma unroll
  for (int tap = 0; tap < 3; ++tap) {
    const int dp = d + tap - 1;
    if (dp < 1 || dp > D - 1 || dp >= W) continue;
    const int c = (3 + tap) * K + c0;
    if (x == dp - 1) { load(rrow + c, t); add(v, t); }
    if (x == W - 1) { load(rrow + (W - dp) * k6 + c, t); sub(v, t); }
  }
}

// One output vector from v = a_sum[x] + S[x - d]: the depth edges (staged
// ``first`` / ``last``), the bias and the ELU. The column fix-ups are the
// second pass's (`emit_fixups`).
template <int VEC>
__device__ __forceinline__ void assemble(float (&v)[VEC], const float* first,
                                         const float* last,
                                         const float (&bs)[VEC], int d,
                                         int D, int apply_elu) {
  float t[VEC];
  if (d == 0) { lds(first, t); sub(v, t); }
  if (d == D - 1) { lds(last, t); sub(v, t); }
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    v[i] += bs[i];
    if (apply_elu) v[i] = v[i] > 0.f ? v[i] : expm1f(v[i]);
  }
}

// Full layout: block (column tile of tx, row h, batch n x chunk of dc
// disparities); thread (column xr, channel group): its VEC channels of the
// chunk's d.
template <typename T, int VEC, int KT>
__global__ void __launch_bounds__(KT ? THREADS : MAX_THREADS, KT ? 4 : 1)
emit_full(const T* __restrict__ la, const T* __restrict__ rb,
          const float* __restrict__ bias, T* __restrict__ out, int H, int W,
          int Kr, int D, int apply_elu, int tx, int dc) {
  // the S window, (tx + dc - 1) x K, then first and last, tx x K each
  extern __shared__ float4 smem4[];
  float* ss = reinterpret_cast<float*>(smem4);
  const int K = KT ? KT : Kr;
  const int G = K / VEC;
  const int tid = threadIdx.x;
  const int xr = min(tid / G, tx - 1), c0 = (tid % G) * VEC;
  // the chunks of one column tile are neighbours in the grid: they stage
  // overlapping S windows from L2
  const int chunks = (D + dc - 1) / dc;
  const int xt = blockIdx.x / chunks, d0 = (blockIdx.x - xt * chunks) * dc;
  const int x0 = xt * tx, h = blockIdx.y, n = blockIdx.z;
  const int dn = min(dc, D - d0);
  const int nt = min(tx, W - x0);
  const bool live = tid < tx * G && xr < nt;
  const int x = min(x0 + xr, W - 1);
  const int64_t nh = (int64_t)n * H + h;
  const T* lrow = la + nh * W * 3 * K;   // a0 | a1 | a2
  const T* rrow = rb + nh * W * 6 * K;   // bk0 | bk1 | bk2 | cc0 | cc1 | cc2
  // S columns [x0 - d0 - dn + 1, x0 + nt - d0)
  stage_s<T, VEC>(ss, rrow, x0 - d0 - dn + 1, nt + dn - 1, W, K, G);
  float* first = ss + (tx + dc - 1) * K;
  float* last = first + tx * K;
  stage_depth_edges<T, VEC>(first, last, d0 == 0, d0 + dn == D, lrow, rrow,
                            x0, nt, W, K, G, D);
  float as[VEC], bs[VEC];
  a_sum(as, lrow, x, c0, K);
#pragma unroll
  for (int i = 0; i < VEC; ++i) bs[i] = bias[c0 + i];
  T* o = out + (((int64_t)n * D * H + h) * W + x) * K + c0;
  const int64_t dstride = (int64_t)H * W * K;
  __syncthreads();
  for (int dd = 0; dd < dn; ++dd) {
    const int d = d0 + dd;
    float v[VEC];
    // column x - d of S is staged column xr - dd + dn - 1
    lds(ss + (xr - dd + dn - 1) * K + c0, v);
    add(v, as);
    assemble(v, first + xr * K + c0, last + xr * K + c0, bs, d, D,
             apply_elu);
    if (live) store(o + d * dstride, v);
  }
}

// dh-shifted layout: block (column tile of tx, row slot hq, batch n x chunk
// of ac depth slots); thread (column xr, channel group of the 4K): its row
// h = 2 hq - 1 + qh and its d = 2 ad - 1 + qd of the chunk's slots ad.
template <typename T, int VEC, int KT>
__global__ void __launch_bounds__(KT ? THREADS : MAX_THREADS, KT ? 4 : 1)
emit_packed(const T* __restrict__ la, const T* __restrict__ rb,
            const float* __restrict__ bias, T* __restrict__ out, int H,
            int W, int Kr, int D, int apply_elu, int tx, int ac) {
  // per row parity qh: the S window, (tx + 2 ac - 1) x K, then first and
  // last, tx x K each
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int K = KT ? KT : Kr;
  const int G = K / VEC, G4 = 4 * G;
  const int per = (tx + 2 * ac - 1 + 2 * tx) * K;
  const int tid = threadIdx.x;
  const int xr = min(tid / G4, tx - 1), cg = tid % G4;
  const int grp = cg / G, c0 = (cg - grp * G) * VEC;
  const int qh = grp >> 1, qd = grp & 1;
  const int Dq = (D + 1) / 2 + 1, chunks = (Dq + ac - 1) / ac;
  const int xt = blockIdx.x / chunks, ad0 = (blockIdx.x - xt * chunks) * ac;
  const int x0 = xt * tx, hq = blockIdx.y, Hq = gridDim.y, n = blockIdx.z;
  const int an = min(ac, Dq - ad0);
  // disparities [dlo, dlo + dn)
  const int dlo = 2 * ad0 - 1, dn = 2 * an;
  const int nt = min(tx, W - x0);
  const bool live = tid < tx * G4 && xr < nt;
  const int x = min(x0 + xr, W - 1);
  const int h = 2 * hq - 1 + qh;
  const bool hvalid = h >= 0 && h < H;
  for (int q = 0; q < 2; ++q) {
    const int hh = 2 * hq - 1 + q;
    if (hh < 0 || hh >= H) continue;
    const int64_t row = (int64_t)n * H + hh;
    float* sq = smem + q * per;
    float* fq = sq + (tx + 2 * ac - 1) * K;
    stage_s<T, VEC>(sq, rb + row * W * 6 * K, x0 - dlo - dn + 1, nt + dn - 1,
                    W, K, G);
    stage_depth_edges<T, VEC>(fq, fq + tx * K, dlo <= 0, dlo + dn > D - 1,
                              la + row * W * 3 * K, rb + row * W * 6 * K, x0,
                              nt, W, K, G, D);
  }
  const T* lrow = la + ((int64_t)n * H + min(max(h, 0), H - 1)) * W * 3 * K;
  const float* ss = smem + qh * per;
  const float* first = ss + (tx + 2 * ac - 1 + xr) * K + c0;
  const float* last = first + tx * K;
  float as[VEC], bs[VEC];
  a_sum(as, lrow, x, c0, K);
#pragma unroll
  for (int i = 0; i < VEC; ++i) bs[i] = bias[c0 + i];
  T* o = out + ((((int64_t)n * Dq) * Hq + hq) * W + x) * 4 * K + cg * VEC;
  const int64_t adstride = (int64_t)Hq * W * 4 * K;
  __syncthreads();
  for (int aa = 0; aa < an; ++aa) {
    const int ad = ad0 + aa, d = 2 * ad - 1 + qd;
    const bool valid = hvalid && d >= 0 && d < D;
    float v[VEC];
    // column x - d of S is staged column xr - (d - dlo) + dn - 1
    lds(ss + (xr - (d - dlo) + dn - 1) * K + c0, v);
    add(v, as);
    assemble(v, first, last, bs, d, D, apply_elu);
    if (!valid) {  // padding slots and rows stay exactly zero
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[i] = 0.f;
    }
    if (live) store(o + ad * adstride, v);
  }
}

// The second pass: the outputs with a column fix-up, x in [d - 2, d] and
// x = W - 1 of every (n, d, h), recomputed whole from the maps in device
// memory and stored over the first pass's. One thread a (n, d, h, column
// j, channel group): every load of the pass is in flight at once.
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
emit_fixups(const T* __restrict__ la, const T* __restrict__ rb,
            const float* __restrict__ bias, T* __restrict__ out, int N,
            int H, int W, int K, int D, int apply_elu, int packed) {
  const int G = K / VEC;
  int item = blockIdx.x * blockDim.x + threadIdx.x;  // < 2^31: launch_vec
  if (item >= N * D * H * 4 * G) return;
  const int c0 = item % G * VEC;
  item /= G;
  const int j = item % 4;
  item /= 4;
  const int h = item % H;
  item /= H;
  const int d = item % D, n = item / D;
  const int x = j < 3 ? d - 2 + j : W - 1;
  if (x < 0 || x >= W || (j == 3 && x >= d - 2 && x <= d)) return;
  const int64_t nh = (int64_t)n * H + h;
  const T* lrow = la + nh * W * 3 * K;
  const T* rrow = rb + nh * W * 6 * K;
  const int64_t k3 = 3 * K, k6 = 6 * K;
  float bs[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) bs[i] = bias[c0 + i];
  // as the first pass: S[x - d] + a_sum[x], then the depth edges
  float v[VEC], t[VEC], e[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) v[i] = 0.f;
  const int c = x - d;
  if (c >= 0) {
    const T* p = rrow + c * k6 + c0;
    load(p + K, v);                                     // bk1[c]
    if (c + 1 < W) { load(p + 6 * K, t); add(v, t); }   // bk0[c + 1]
    if (c >= 1) { load(p + 2 * K - 6 * K, t); add(v, t); }  // bk2[c - 1]
  }
  a_sum(e, lrow, x, c0, K);
  add(v, e);
  if (d == 0) {
    load(lrow + x * k3 + c0, e);
    if (x + 1 < W) { load(rrow + (x + 1) * k6 + c0, t); add(e, t); }
    sub(v, e);
  }
  if (d == D - 1) {
    load(lrow + x * k3 + 2 * K + c0, e);
    if (x - D >= 0) { load(rrow + (x - D) * k6 + 2 * K + c0, t); add(e, t); }
    sub(v, e);
  }
  fix_columns<T, VEC>(v, rrow, x, c0, d, W, K, D);
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    v[i] += bs[i];
    if (apply_elu) v[i] = v[i] > 0.f ? v[i] : expm1f(v[i]);
  }
  int64_t o;
  if (packed) {  // depth slot (d + 1) / 2, parity (d + 1) % 2; rows alike
    const int Dq = (D + 1) / 2 + 1, Hq = (H + 1) / 2 + 1;
    const int grp = ((h + 1) & 1) * 2 + ((d + 1) & 1);
    o = ((((int64_t)n * Dq + ((d + 1) >> 1)) * Hq + ((h + 1) >> 1)) * W +
         x) * 4 * K + grp * K + c0;
  } else {
    o = ((((int64_t)n * D + d) * H + h) * W + x) * K + c0;
  }
  store(out + o, v);
}

template <typename T, int VEC, int KT>
cudaError_t launch_vec(const T* la, const T* rb, const float* bias, T* out,
                       int N, int H, int W, int K, int D, int apply_elu,
                       int packed, cudaStream_t stream) {
  const int G = (packed ? 4 : 1) * K / VEC;  // threads of one column
  // the fix-up pass indexes its threads in 32 bits
  const int64_t items = (int64_t)N * D * H * 4 * (K / VEC);
  if (G > MAX_THREADS || items > INT32_MAX) return cudaErrorInvalidValue;
  const int tx = G >= THREADS ? 1 : THREADS / G;
  const int threads = (tx * G + 31) / 32 * 32;
  // chunks of about DC disparities (full) or depth slots, evenly sized
  const int len = packed ? (D + 1) / 2 + 1 : D;
  const int chunks = (len + DC - 1) / DC;
  const int chunk = (len + chunks - 1) / chunks;
  const int window = tx + (packed ? 2 * chunk : chunk) - 1 + 2 * tx;
  const size_t smem = (size_t)(packed ? 2 : 1) * window * K * sizeof(float);
  const void* fn = packed ? (const void*)emit_packed<T, VEC, KT>
                          : (const void*)emit_full<T, VEC, KT>;
  if (smem > 48 * 1024) {
    // Above 48 KB only as opted-in dynamic shared memory; past the card's
    // per-block limit this call fails and the error is returned.
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((W + tx - 1) / tx * chunks, packed ? (H + 1) / 2 + 1 : H,
                  N);
  if (packed)
    emit_packed<T, VEC, KT><<<grid, threads, smem, stream>>>(
        la, rb, bias, out, H, W, K, D, apply_elu, tx, chunk);
  else
    emit_full<T, VEC, KT><<<grid, threads, smem, stream>>>(
        la, rb, bias, out, H, W, K, D, apply_elu, tx, chunk);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  emit_fixups<T, VEC><<<(unsigned)((items + THREADS - 1) / THREADS), THREADS,
                        0, stream>>>(la, rb, bias, out, N, H, W, K, D,
                                     apply_elu, packed);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* la, const void* rb, const float* bias,
                   void* out, int N, int H, int W, int K, int D,
                   int apply_elu, int packed, cudaStream_t stream) {
  const T* l = static_cast<const T*>(la);
  const T* r = static_cast<const T*>(rb);
  T* o = static_cast<T*>(out);
  if (K == 32)
    return launch_vec<T, 8, 32>(l, r, bias, o, N, H, W, K, D, apply_elu,
                                packed, stream);
  if (K == 64)
    return launch_vec<T, 8, 64>(l, r, bias, o, N, H, W, K, D, apply_elu,
                                packed, stream);
  if (K % 8 == 0)
    return launch_vec<T, 8, 0>(l, r, bias, o, N, H, W, K, D, apply_elu,
                               packed, stream);
  return launch_vec<T, 1, 0>(l, r, bias, o, N, H, W, K, D, apply_elu, packed,
                             stream);
}

}  // namespace

// la: (N, H, W, 3K), rb: (N, H, W, 6K), out: (N, D, H, W, K) (packed == 0)
// or (N, (D + 1) / 2 + 1, (H + 1) / 2 + 1, W, 4K) (packed == 1), all
// contiguous, 16-byte aligned and of one dtype, fp32 (bf16 == 0) or bf16
// (bf16 == 1); bias: K fp32 values. (packed ? 4 : 1) * K / (K % 8 ? 1 : 8)
// must be <= 1024. Returns the cudaError_t of the launch (0 on success).
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
