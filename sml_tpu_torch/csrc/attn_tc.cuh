// The tensor-core pieces shared by the bf16 attention kernels: the forward
// (deform_attn.cu, tc::attn_fwd_tc) and the backward's rows kernel
// (deform_attn_bwd.cu, tc::attn_bwd_rows_tc), whose first pass is the same
// loop, and the keys kernel (tc::attn_bwd_keys_tc).
//
// A rows kernel's warp owns 16 query rows, held as A fragments of q in
// registers (mma.cuh); lane (g, t) owns the rows g and g + 8 of them and, in
// each n8 tile of keys, the columns 2t and 2t + 1.  K and V stream in 64-key
// swizzled tiles through a two-stage cp.async ring (stage_pair / stage_tile),
// read by ldmatrix; the bias tile of the same 64 keys rides in the same ring
// (stage_bias).  Per 32-key half of a tile:
//
//   s = q k^T               product_nt (the backward: dp = dout v^T beside it)
//   s = mask(s + bias)      mask_scores: the bias from the staged tile, the
//                           span mask and the key tail (keys >= J take
//                           -f32max, probability 0)
//   m                       drop_pair: the Philox multipliers {0, 1/keep}
//   pass 1: RowStats        stats_update: lane-local running max and sum (and
//                           sum of e dp), folded over the lane quad once by
//                           stats_fold into lse = max + log(sum) (and delta)
//
// Both kernels take lse from this same code, the same sums in the same order,
// so that the forward's p = exp(s - lse) is the one the backward recomputes;
// nvcc compiles the two instantiations apart, and no check on the card holds
// the two lse bit for bit (the forward returns none).
//
// The bias (BG, N, J), bf16 beside bf16 q, k, v or f32 (the 1-D deformable
// attention's, whose CPB1D runs in f32), is the largest operand where it is
// present: 2 or 4 bytes a pair, J of them a query row, against a row's 128
// bytes of q; at J = 625 in f32 its reads bound these kernels by bytes.  A
// row of it starts at a 16-byte phase that varies with the row unless J is a
// multiple of kVec = 16 / sizeof(BT), and TMA would need a row stride of a
// multiple of 16 bytes.  So stage_bias copies each row of a 64 x 64 tile by
// 16-byte cp.async from the aligned segment holding its first key, one
// segment more than 64 keys need at most (kBiasLd), and keeps the row's
// element shift s_r: key j0 + c of tile row r sits at r kBiasLd + s_r + c.
// The copy of the next tile is in flight while this one computes, whatever J;
// segments past the row's keys or the bag's end are zero-filled (cp.async's
// src-size).  The backward's rows kernel writes ds into the same tile in
// place and stores each row's dbias in whole 16-byte segments, element by
// element only in a row's head and tail segments (store_dbias).

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

// ---- the bias tile (see the note at the top) ---------------------------------

constexpr int kBiasLd = kBlock + 8;  // elements of a staged bias row: 64 keys + a shift + pad

template <typename BT>
constexpr int kBiasVec = 16 / sizeof(BT);  // bias elements in 16 bytes

// Dynamic shared-memory bytes of a rows kernel (forward and backward): the
// bias tiles' two stages, beside the K and V ring in static shared memory
// (32 KB; static shared memory stops at 48 KB).
template <bool HAS_BIAS, typename BT>
constexpr size_t bias_smem_bytes() {
  return HAS_BIAS ? 2 * kBlock * kBiasLd * sizeof(BT) : 0;
}

// The element shift of global row grow (bag bg's row r: grow = bg N + r) in a
// staged tile: (grow J) mod kVec, the same for every key tile (j0 % 64 == 0);
// with a 16-byte aligned bias (the wrapper checks it) the row's key j0 lies
// that many elements past a 16-byte boundary.
template <typename BT>
__device__ __forceinline__ int bias_shift(int grow, int J) {
  return static_cast<int>((static_cast<unsigned>(grow) * static_cast<unsigned>(J)) &
                          (kBiasVec<BT> - 1));
}

// One 16-byte segment of the bias from src to shared dst: the bytes before
// end (the bag's end) when NEED, else none, the rest zero-filled.
template <typename BT>
__device__ __forceinline__ void stage_segment(uint32_t dst, const BT* src, bool need,
                                              const BT* end, const BT* any) {
  const long long left = need ? (end - src) * (long long)sizeof(BT) : 0;
  const int bytes = left < 16 ? static_cast<int>(left) : 16;
  mma::cp_async16n(dst, bytes ? src : any, bytes);
}

// Stage the tile of global rows [r0, r0 + kBlock) (rows >= rend, past the
// bag, zero-filled) and keys [j0, j0 + kBlock) of the row-major (BG N, J)
// bias (16-byte aligned) in sb, kBlock rows of kBiasLd, by cp.async: each row
// from the aligned segment holding key j0 to the one holding key min(j0 +
// kBlock, J) - 1, the rest of the row and any bytes past the bag's end
// zero-filled.  Segments 0 .. kBlock / kVec - 1 of a row go to consecutive
// threads (the 8 threads of a 16-byte shared store phase on 8 bank groups),
// rows kRowStep apart to one thread at one shift; the last segment to one
// thread a row, staged only at a shift past 0 (nothing reads it at 0).
template <typename BT, int THREADS = kThreads>
__device__ __forceinline__ void stage_bias(const BT* bias, BT* sb, int r0, int rend, int j0,
                                           int J) {
  constexpr int kVec = kBiasVec<BT>, kRowSegs = kBlock / kVec;
  constexpr int kRowStep = THREADS / kRowSegs;  // rows a pass: 16 (bf16), 8 (f32)
  static_assert(THREADS % kRowSegs == 0 && kRowStep % kVec == 0 && THREADS >= kBlock,
                "a thread's rows share one shift; a thread a row for the last segment");
  const BT* end = bias + (size_t)rend * J;
  const int keys = min(kBlock, J - j0);
  const int c = threadIdx.x % kRowSegs, r1 = threadIdx.x / kRowSegs;
  const int shift = bias_shift<BT>(r0 + r1, J);  // that of rows r1 + kRowStep m too
  const bool need = kVec * c < shift + keys;
  const BT* src = bias + (size_t)(r0 + r1) * J + j0 - shift + kVec * c;
  const uint32_t dst = mma::smem_u32(sb + r1 * kBiasLd + kVec * c);
#pragma unroll
  for (int m = 0; m < kBlock / kRowStep; ++m)
    stage_segment(dst + m * kRowStep * kBiasLd * (int)sizeof(BT),
                  src + (size_t)m * kRowStep * J, need && r0 + r1 + kRowStep * m < rend, end,
                  bias);
  if (threadIdx.x < kBlock) {
    const int r = threadIdx.x, s = bias_shift<BT>(r0 + r, J);
    if (s)
      stage_segment(mma::smem_u32(sb + r * kBiasLd + kBlock),
                    bias + (size_t)(r0 + r) * J + j0 - s + kBlock,
                    kBlock < s + keys && r0 + r < rend, end, bias);
  }
}

// Keys j, j + 1 (j even) of a staged bias row p (p: the row plus its shift)
// as floats.  EVEN (J even): every row's shift is even, so the pair is one
// aligned 4- (bf16) or 8-byte (f32) word; else two element loads.
__device__ __forceinline__ float2 bias_pair(const bf16* p, bool even) {
  if (even) return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  return make_float2(__bfloat162float(p[0]), __bfloat162float(p[1]));
}
__device__ __forceinline__ float2 bias_pair(const float* p, bool even) {
  if (even) return *reinterpret_cast<const float2*>(p);
  return make_float2(p[0], p[1]);
}
// x, y to the staged row p at keys j, j + 1, rounded to BT (to nearest)
__device__ __forceinline__ void put_pair(bf16* p, float x, float y, bool even) {
  if (even) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
    return;
  }
  p[0] = __float2bfloat16(x);
  p[1] = __float2bfloat16(y);
}
__device__ __forceinline__ void put_pair(float* p, float x, float y, bool even) {
  if (even) {
    *reinterpret_cast<float2*>(p) = make_float2(x, y);
    return;
  }
  p[0] = x;
  p[1] = y;
}

// The part of segment c (of kVec elements) of a staged row with shift s that
// holds keys of the tile, [s, end), to the row's segments seg0: one 16-byte
// store when the segment lies inside, else element by element.
template <typename BT>
__device__ __forceinline__ void store_segment(BT* seg0, const BT* row, int c, int s, int end) {
  constexpr int kVec = kBiasVec<BT>;
  const int lo = max(kVec * c, s), hi = min(kVec * (c + 1), end);
  if (hi - lo == kVec) {
    *reinterpret_cast<uint4*>(seg0 + kVec * c) = *reinterpret_cast<const uint4*>(row + kVec * c);
  } else {
    for (int e = lo; e < hi; ++e) seg0[e] = row[e];
  }
}

// One warp stores the dbias of its 16 staged rows sb (laid out by
// stage_bias; global rows [r0, r0 + 16), rows >= rend skipped), keys [j0,
// min(j0 + kBlock, J)), to the row-major dbias (16-byte aligned, the bias's
// shape): a whole 16-byte segment inside the row's keys in one store, the
// head and tail segments element by element; segments 0 .. kBlock / kVec - 1
// of a row on consecutive lanes, as stage_bias copies them, the last one a
// lane a row.
template <typename BT>
__device__ __forceinline__ void store_dbias(BT* dbias, const BT* sb, int r0, int rend, int j0,
                                            int J, int lane) {
  constexpr int kVec = kBiasVec<BT>, kRowSegs = kBlock / kVec, kRowStep = 32 / kRowSegs;
  const int keys = min(kBlock, J - j0);
  const int c = lane % kRowSegs;
#pragma unroll
  for (int m = 0; m < 16 / kRowStep; ++m) {
    const int r = lane / kRowSegs + kRowStep * m;
    if (r0 + r >= rend) break;
    const int s = bias_shift<BT>(r0 + r, J);
    store_segment(dbias + (size_t)(r0 + r) * J + j0 - s, sb + r * kBiasLd, c, s, s + keys);
  }
  if (lane < 16 && r0 + lane < rend) {
    const int s = bias_shift<BT>(r0 + lane, J);
    store_segment(dbias + (size_t)(r0 + lane) * J + j0 - s, sb + lane * kBiasLd, kRowSegs, s,
                  s + keys);
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

// The masked scores of the 32-key half from tile key c of the tile from key
// j0: s[i][2h + w] is the lane's row h (brow[h]: its staged bias row, shift
// included), key j0 + c + 8 i + col + w.  Adds the bias, applies the span
// mask, and gives keys >= J -f32max (whatever the tile holds there).
template <bool HAS_BIAS, bool HAS_SPAN, typename BT>
__device__ __forceinline__ void mask_scores(float (&s)[4][4], const BT* const* brow,
                                            bool even, int J, int j0, int c, int col,
                                            const SpanMask& mask, const bool (&uniform)[2]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int jt = c + 8 * i + col, j = j0 + jt;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 b = HAS_BIAS ? bias_pair(brow[h] + jt, even) : make_float2(0.f, 0.f);
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

// The keep bits of a keys kernel's 16-row step from row r0 (a multiple of 8),
// in the transposed layout: lane (g, t) holds the keys key[h] (h < 2) and the
// rows r0 + 8 i + col + w (col = 2t).  The lanes lane ^ (s << 2), s < 4, hold
// the same rows and the same 4-key Philox groups, one word c = (lane >> 2) & 3
// of each: each lane draws its two groups for one row, e = c (e = 2 i + w),
// and the four pass the keep bits round; bit 4 h + e of the result is key[h],
// row e.
__device__ __forceinline__ uint32_t keys_keep_bits(unsigned long long seed, const int (&key)[2],
                                                   int r0, int col, int bg, float keep_prob,
                                                   int lane) {
  const int c = (lane >> 2) & 3;
  const int r = r0 + 8 * (c >> 1) + col + (c & 1);
  const uint32_t own = philox::keep4(philox::bits4(seed, key[0] >> 2, r, bg), keep_prob) |
                       philox::keep4(philox::bits4(seed, key[1] >> 2, r, bg), keep_prob) << 4;
  uint32_t kept = 0u;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const uint32_t from = s ? __shfl_xor_sync(kFull, own, s << 2) : own;
    kept |= ((from >> c) & 0x11u) << (c ^ s);
  }
  return kept;
}

// The keep bits of a rows kernel's 32-key half from key j (a multiple of 8)
// in the accumulator layout: lane (g, t) holds the rows row[h] (h < 2) and
// the keys j + 8 i + 2t + w.  The lanes t and t ^ 1 hold the same 4-key
// Philox groups of the same rows, words 2 (t & 1) + w of each: each draws the
// groups of one row, row[t & 1], and the two swap them, so a group is drawn
// once, not twice as by drop_pair.  Bit 16 h + 4 i + w of the result is
// row[h], key j + 8 i + 2t + w.
__device__ __forceinline__ uint32_t rows_keep_bits(unsigned long long seed, const int (&row)[2],
                                                   int j, int bg, float keep_prob, int lane) {
  const int t = lane & 3, mine = t & 1;
  uint32_t own = 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    own |= philox::keep4(philox::bits4(seed, (j >> 2) + 2 * i + (t >> 1), row[mine], bg),
                         keep_prob) << (4 * i);
  const uint32_t other = __shfl_xor_sync(kFull, own, 1);
  const uint32_t r0 = mine ? other : own, r1 = mine ? own : other;
  return ((r0 >> (2 * mine)) & 0x3333u) | ((r1 >> (2 * mine)) & 0x3333u) << 16;
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
