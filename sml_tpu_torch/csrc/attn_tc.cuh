// The tensor-core pieces shared by the bf16 attention kernels: the forward
// (deform_attn.cu, tc::attn_fwd_tc) and the backward's rows kernel
// (deform_attn_bwd.cu, tc::attn_bwd_rows_tc), whose first pass is the same
// loop, and the keys kernel (tc::attn_bwd_keys_tc).
//
// A rows kernel's warp owns 16 query rows, held as A fragments of q in
// registers (mma.cuh); lane (g, t) owns the rows g and g + 8 of them and, in
// each n8 tile of keys, the columns 2t and 2t + 1.  K and V stream in 64-key
// swizzled tiles through a two-stage cp.async ring (stage_pair / stage_tile),
// read by ldmatrix.  Per 32-key half of a tile:
//
//   s = q k^T               product_nt (the backward: dp = dout v^T beside it)
//   s = mask(s + bias)      mask_scores: the bias, the span mask and the key
//                           tail (keys >= J take -f32max, probability 0)
//   m                       drop_pair: the Philox multipliers {0, 1/keep}
//   pass 1: RowStats        stats_update: lane-local running max and sum (and
//                           sum of e dp), folded over the lane quad once by
//                           stats_fold into lse = max + log(sum) (and delta)
//
// Both kernels take lse from this same code, the same sums in the same order,
// so that the forward's p = exp(s - lse) is the one the backward recomputes;
// nvcc compiles the two instantiations apart, and no check on the card holds
// the two lse bit for bit (the forward returns none).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attn_common.cuh"
#include "mma.cuh"
#include "philox.cuh"

namespace tc {

using namespace attn;
using bf16 = __nv_bfloat16;
constexpr int kThreads = 128;             // 4 warps, 16 rows (rows kernel) or keys each
constexpr int kBlock = 64;                // rows (keys) per block, keys (rows) per tile
constexpr int kTile = kBlock * 64;        // elements of one swizzled 64 x DH tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float exp_f(float x) { return exp2f(x * kLog2e); }

// elements (r, j) and (r, j + 1), j even, of a row-major (rows, J) bf16 or
// f32 matrix at p = &m[r][j]; j + 1 may be J when J is odd.  The bias (and
// dbias) comes in bf16 beside bf16 q, k, v, or in f32 (the 1-D deformable
// attention's, whose CPB1D runs in f32).
__device__ __forceinline__ float2 load_pair(const bf16* p, int j, int J) {
  if (!(J & 1)) return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  return make_float2(__bfloat162float(p[0]), j + 1 < J ? __bfloat162float(p[1]) : 0.f);
}
__device__ __forceinline__ float2 load_pair(const float* p, int j, int J) {
  if (!(J & 1)) return *reinterpret_cast<const float2*>(p);
  return make_float2(p[0], j + 1 < J ? p[1] : 0.f);
}
__device__ __forceinline__ void store_pair(bf16* p, float x, float y, int j, int J) {
  if (!(J & 1)) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
    return;
  }
  p[0] = __float2bfloat16(x);
  if (j + 1 < J) p[1] = __float2bfloat16(y);
}
__device__ __forceinline__ void store_pair(float* p, float x, float y, int j, int J) {
  if (!(J & 1)) {
    *reinterpret_cast<float2*>(p) = make_float2(x, y);
    return;
  }
  p[0] = x;
  if (j + 1 < J) p[1] = y;
}
__device__ __forceinline__ float bias_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float bias_f32(float x) { return x; }

// Stage rows [r0, r0 + kBlock) of an (n, 64) bf16 matrix a in the swizzled
// tile sa by cp.async, rows >= n zero-filled; THREADS threads take part.
template <int THREADS = kThreads>
__device__ __forceinline__ void stage_tile(const bf16* a, bf16* sa, int r0, int n) {
  for (int i = threadIdx.x; i < kBlock * 8; i += THREADS) {
    const int r = i >> 3, c = i & 7;
    const bool ok = r0 + r < n;
    const size_t off = (size_t)(ok ? r0 + r : 0) * 64 + c * 8;
    mma::cp_async16(mma::smem_u32(sa + mma::swz64(r, c)), a + off, ok);
  }
}

// The same for two matrices (a, b) into (sa, sb), their copies interleaved:
// two stage_tile calls ran the forward's Nystrom chains 4-9% and the backward
// rows kernel 3-5% slower on an H100 (scripts/profile_attn_bwd.py).
template <int THREADS = kThreads>
__device__ __forceinline__ void stage_pair(const bf16* a, const bf16* b, bf16* sa, bf16* sb,
                                           int r0, int n) {
  for (int i = threadIdx.x; i < kBlock * 8; i += THREADS) {
    const int r = i >> 3, c = i & 7;
    const bool ok = r0 + r < n;
    const size_t off = (size_t)(ok ? r0 + r : 0) * 64 + c * 8;
    mma::cp_async16(mma::smem_u32(sa + mma::swz64(r, c)), a + off, ok);
    mma::cp_async16(mma::smem_u32(sb + mma::swz64(r, c)), b + off, ok);
  }
}

// acc (16 x 32) = A X^T over the 32 rows c0.. of the swizzled 64 x 64 tile x
// (rows: the n of the product); A: a 16 x 64 operand as 4 k-steps of A
// fragments.
__device__ __forceinline__ void product_nt(const uint32_t (&a)[4][4], const bf16* x, int c0,
                                           int lane, float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      const int at = mma::swz64(c0 + 16 * np + (lane & 7) + ((lane >> 4) << 3),
                                2 * ks + ((lane >> 3) & 1));
      uint32_t b[4];
      mma::ldmatrix_x4(b, mma::smem_u32(x + at));
      mma::mma_bf16(acc[2 * np], a[ks], b[0], b[1]);
      mma::mma_bf16(acc[2 * np + 1], a[ks], b[2], b[3]);
    }
  }
}

// acc (16 x 64) += A X over the 16 rows c0.. of the swizzled tile x (the k of
// the product), B by ldmatrix.trans.
__device__ __forceinline__ void product_nn(float (&acc)[8][4], const uint32_t (&a)[4],
                                           const bf16* x, int c0, int lane) {
#pragma unroll
  for (int np = 0; np < 4; ++np) {
    uint32_t b[4];
    mma::ldmatrix_x4_trans(b, mma::smem_u32(x + mma::swz64(c0 + (lane & 7) +
                                                              (((lane >> 3) & 1) << 3),
                                                          2 * np + (lane >> 4))));
    mma::mma_bf16(acc[2 * np], a, b[0], b[1]);
    mma::mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
  }
}

// The masked scores of one 32-key half from key j0: s[i][2h + w] is row
// row[h], key j0 + 8 i + col + w.  Adds the bias (bias_bg: the bag's (N, J)
// rows, bf16 or f32), applies the span mask, and gives keys >= J -f32max.
template <bool HAS_BIAS, bool HAS_SPAN, typename BT>
__device__ __forceinline__ void mask_scores(float (&s)[4][4], const BT* bias_bg, int N,
                                            int J, const int (&row)[2], int j0, int col,
                                            const SpanMask& mask, const bool (&uniform)[2]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int j = j0 + 8 * i + col;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float2 b = make_float2(0.f, 0.f);
      if (HAS_BIAS && j < J && row[h] < N) b = load_pair(bias_bg + (size_t)row[h] * J + j, j, J);
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        float& x = s[i][2 * h + w];
        x = j + w < J ? mask_score<HAS_SPAN>(x + (w ? b.y : b.x), mask, uniform[h], j + w)
                      : kNegMax;
      }
    }
  }
}

// The dropout multipliers {0, inv_keep} of keys j and j + 1 (j even) of row
// `row`: words j % 4 and j % 4 + 1 of the Philox group j / 4 (philox.cuh).
__device__ __forceinline__ float2 drop_pair(unsigned long long seed, int j, int row, int bg,
                                            float keep_prob, float inv_keep) {
  const uint4 bits = philox::bits4(seed, j >> 2, row, bg);
  return make_float2(philox::keep(philox::word(bits, j & 3), keep_prob) ? inv_keep : 0.f,
                     philox::keep(philox::word(bits, (j & 3) + 1), keep_prob) ? inv_keep : 0.f);
}

// A lane's running statistics of its rows row[h] over its own columns: max m,
// sum l of exp(s - m) and, in the backward, sum d of exp(s - m) dp.
struct RowStats {
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, d[2] = {0.f, 0.f};
};

// exp(x): the fast ex2.approx form of the bf16 kernels, or with EXACT the f32
// library's expf (the f32 dh = 32 backward, held to f32's accuracy)
template <bool EXACT>
__device__ __forceinline__ float exp_of(float x) { return EXACT ? expf(x) : exp_f(x); }

// Fold one 32-key half of masked scores s (and dp, with DELTA) into st.
template <bool DELTA, bool EXACT = false>
__device__ __forceinline__ void stats_update(RowStats& st, const float (&s)[4][4],
                                             const float (&dp)[4][4]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = st.m[h];
#pragma unroll
    for (int i = 0; i < 4; ++i) mx = fmaxf(mx, fmaxf(s[i][2 * h], s[i][2 * h + 1]));
    const float sc = exp_of<EXACT>(st.m[h] - mx);
    float l = 0.f, d = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        const float e = exp_of<EXACT>(s[i][2 * h + w] - mx);
        l += e;
        if (DELTA) d = fmaf(e, dp[i][2 * h + w], d);
      }
    st.l[h] = fmaf(st.l[h], sc, l);
    if (DELTA) st.d[h] = fmaf(st.d[h], sc, d);
    st.m[h] = mx;
  }
}

// lse[h] = max + log(sum) (and delta[h] = sum e dp / sum, with DELTA) of the
// rows row[h], the statistics of the lane quad combined in a fixed order.
template <bool DELTA, bool EXACT = false>
__device__ __forceinline__ void stats_fold(const RowStats& st, float (&lse)[2],
                                           float (&delta)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = fmaxf(st.m[h], __shfl_xor_sync(kFull, st.m[h], 1));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
    const float sc = exp_of<EXACT>(st.m[h] - mx);
    float l = st.l[h] * sc, d = st.d[h] * sc;
    l += __shfl_xor_sync(kFull, l, 1);
    if (DELTA) d += __shfl_xor_sync(kFull, d, 1);
    l += __shfl_xor_sync(kFull, l, 2);
    if (DELTA) d += __shfl_xor_sync(kFull, d, 2);
    lse[h] = mx + logf(l);
    if (DELTA) delta[h] = d / l;
  }
}

}  // namespace tc
