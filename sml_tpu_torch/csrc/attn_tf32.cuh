// The f32 dh = 32 pieces on the tf32 tensor cores (3xTF32), shared by the
// attention forward (deform_attn.cu, tf32::attn_fwd_tf32) and backward
// (deform_attn_bwd.cu, tf32::attn_bwd_rows_tf32 / attn_bwd_keys_tf32): the
// f32 form without bias, span or dropout that CMTA's Nystrom chains run (8
// heads of 32, 128 landmarks against 2560 tokens).
//
// The layout of the bf16 kernels (attn_tc.cuh): four warps, each owning 16
// rows (or keys) whose operand sits in split A fragments in registers
// (load_a); the streamed operand comes through a two-stage cp.async ring of
// swizzled 64 x 32 f32 tiles (stage_pair, stage_tile), read by ldmatrix
// (product_nt) or at each lane's precomputed offsets (product_nn, Offsets).
// Every product is three tf32 mma.sync m16n8k8 (mma.cuh, mma_3xtf32), each
// tile's tensor-core sums folded into an f32 register sum (fold,
// kFoldTiles).  A thin side's long axis is cut into segments (segments),
// whose partial sums go to an f32 scratch and are added in segment order by
// attn_bwd_combine.
//
// The rows kernels' statistics walk is one code for both directions: per
// key tile s = q k^T, the key tail at -f32max, the running max and sum of
// exp (and, in the backward, of exp * dp) (stats_tile), folded over the lane
// quad by tc::stats_fold, and the segments' (lse, delta) merged in segment
// order (merge_segments).  So the forward's lse is the backward's: the same
// code, the same sums in the same order.  At dh = 64 (every form: the bias,
// the span, dropout) the forward (deform_attn.cu, tf32::attn_fwd_tf32_64) and
// the backward's rows kernel share the score code of a 32-key half as well
// (bias_pairs64, mask_scores64) and fold it with tc::stats_update.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attn_tc.cuh"
#include "mma.cuh"

namespace tf32 {

using tc::kBlock;
using tc::kThreads;
constexpr int kDH = 32;
constexpr int kTileF = kBlock * kDH;  // floats of one swizzled 64 x 32 tile
// Blocks a launch aims at (about 8 per SM of 132): the long axis of a thin
// side is cut into as many segments as take its grid there, at most
// kMaxSegments (which bounds the scratch).
constexpr int kTargetBlocks = 1024;
constexpr int kMaxSegments = 32;
// Fold each tile's tensor-core sum into an f32 register sum: the tensor core
// then chains at most one tile's 8 k-steps (x 3 products) of a long sum.
// false keeps one accumulator for the whole walk (the control measured in
// PERF.md, built by scripts/profile_attn_bwd.py --variant nofold).
constexpr bool kFoldTiles = true;
// Segments of a walk of `tiles` tiles for a grid of `base` blocks, each
// segment `per` tiles (the last may be shorter).
inline int segments(int base, int tiles, int& per) {
  int s = (kTargetBlocks + base - 1) / base;
  s = s < tiles ? s : tiles;
  s = s < kMaxSegments ? s : kMaxSegments;
  per = (tiles + s - 1) / s;
  return (tiles + per - 1) / per;
}

// Stage rows [r0, r0 + kBlock) of two (n, 32) f32 matrices a and b in the
// swizzled tiles sa and sb by cp.async, rows >= n zero-filled.
__device__ __forceinline__ void stage_pair(const float* a, const float* b, float* sa,
                                           float* sb, int r0, int n) {
  for (int i = threadIdx.x; i < kBlock * 8; i += kThreads) {
    const int r = i >> 3, c = i & 7;
    const bool ok = r0 + r < n;
    const size_t off = (size_t)(ok ? r0 + r : 0) * kDH + 4 * c;
    const int at = mma::swz32f(r, 4 * c);
    mma::cp_async16(mma::smem_u32(sa + at), a + off, ok);
    mma::cp_async16(mma::smem_u32(sb + at), b + off, ok);
  }
}

// The split A fragments (4 k-steps of 8 columns) of rows r0 .. r0 + 15 of an
// (n, 32) f32 matrix in device memory; rows >= n give 0.
__device__ __forceinline__ void load_a(uint32_t (&hi)[4][4], uint32_t (&lo)[4][4],
                                       const float* m, int r0, int n, int lane) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + (lane >> 2) + 8 * (e & 1);
      const int c = 8 * ks + (lane & 3) + 4 * (e >> 1);
      mma::split_tf32(r < n ? m[(size_t)r * kDH + c] : 0.f, hi[ks][e], lo[ks][e]);
    }
}

// Each lane's byte offsets in a swizzled 64 x 32 f32 tile (mma::swz32f) of
// the B fragments it reads, fixed for the kernel: rows n0 + 8 i + k of a tile
// start 128 (n0 + 8 i) bytes further on, because n0 + 8 i is a multiple of 8.
struct Offsets {
  uint32_t nt[2];     // product_nt: ldmatrix row of chunks 4 kp + lane / 8
  uint32_t nn[4][2];  // product_nn: n tile nt, rows 2t (w 0) and 2t + 1 (w 1)
  __device__ explicit Offsets(int lane) {
    const int r = lane & 7;
#pragma unroll
    for (int kp = 0; kp < 2; ++kp) nt[kp] = 4 * mma::swz32f(r, 4 * (4 * kp + (lane >> 3)));
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int w = 0; w < 2; ++w)
        nn[n][w] = 4 * mma::swz32f(2 * (lane & 3) + w, 8 * n + (lane >> 2));
  }
};

// acc[i] (16 x 8) = A X^T over the rows n0 + 8 i .. + 7 of the swizzled tile
// x (the n of the product), i < NI; A (16 x 32) split as 4 k-steps.  B by
// ldmatrix: the 32-bit word t of row g of a 16-byte chunk is B's (k t, n g).
template <int NI>
__device__ __forceinline__ void product_nt(const uint32_t (&ah)[4][4], const uint32_t (&al)[4][4],
                                           const float* x, int n0, const Offsets& off,
                                           float (&acc)[NI][4]) {
  float small[NI][4];
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = small[i][e] = 0.f;
  const uint32_t base = mma::smem_u32(x) + 128 * n0;
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int kp = 0; kp < 2; ++kp) {
      uint32_t b[4];  // b0, b1 of k-steps 2 kp and 2 kp + 1
      mma::ldmatrix_x4(b, base + 1024 * i + off.nt[kp]);
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t bh0, bl0, bh1, bl1;
        mma::split_tf32(__uint_as_float(b[2 * kk]), bh0, bl0);
        mma::split_tf32(__uint_as_float(b[2 * kk + 1]), bh1, bl1);
        mma::mma_3xtf32(acc[i], small[i], ah[2 * kp + kk], al[2 * kp + kk], bh0, bh1, bl0, bl1);
      }
    }
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] += small[i][e];
}

// acc + small (16 x 32) += A X over the 8 rows k0 .. k0 + 7 of the swizzled
// tile x (the k of the product), k0 a multiple of 8; A the split accumulator
// of the previous product (mma::split_accum), so B's k positions t and t + 4
// are rows k0 + 2t and k0 + 2t + 1.
__device__ __forceinline__ void product_nn(float (&acc)[4][4], float (&small)[4][4],
                                           const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                           const float* x, int k0, const Offsets& off) {
  const char* base = reinterpret_cast<const char*>(x + 32 * k0);
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    uint32_t bh0, bl0, bh1, bl1;
    mma::split_tf32(*reinterpret_cast<const float*>(base + off.nn[nt][0]), bh0, bl0);
    mma::split_tf32(*reinterpret_cast<const float*>(base + off.nn[nt][1]), bh1, bl1);
    mma::mma_3xtf32(acc[nt], small[nt], ah, al, bh0, bh1, bl0, bl1);
  }
}

// sum += acc + small, acc = small = 0: the f32 register sum of the per-tile
// accumulators
__device__ __forceinline__ void fold(float (&sum)[4][4], float (&acc)[4][4],
                                     float (&small)[4][4]) {
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sum[n][e] += acc[n][e] + small[n][e];
      acc[n][e] = small[n][e] = 0.f;
    }
}

// The (16 x 32) sum of a warp's rows (or keys) r0 + g, r0 + g + 8 into rows
// of 32 floats at dst, rows >= n left alone.
__device__ __forceinline__ void store_rows(float* dst, const float (&sum)[4][4], int r0, int n,
                                           int lane) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + (lane >> 2) + 8 * h;
    if (r < n)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        *reinterpret_cast<float2*>(dst + (size_t)r * kDH + 8 * nt + 2 * (lane & 3)) =
            make_float2(sum[nt][2 * h], sum[nt][2 * h + 1]);
  }
}

// Stage rows [r0, r0 + kBlock) of one (n, 32) f32 matrix a in the swizzled
// tile sa by cp.async, rows >= n zero-filled: stage_pair for one matrix.
__device__ __forceinline__ void stage_tile(const float* a, float* sa, int r0, int n) {
  for (int i = threadIdx.x; i < kBlock * 8; i += kThreads) {
    const int r = i >> 3, c = i & 7;
    const bool ok = r0 + r < n;
    const size_t off = (size_t)(ok ? r0 + r : 0) * kDH + 4 * c;
    mma::cp_async16(mma::smem_u32(sa + mma::swz32f(r, 4 * c)), a + off, ok);
  }
}

// One 64-key tile (from key j0) of a rows kernel's statistics walk: per
// 32-key half s = q k^T (and, with DELTA, dp = dout v^T), keys >= J at
// -f32max, folded into the lane's running statistics st with expf.  sk and
// sv are the tile's K and V; without DELTA, oh, ol and sv are not read.
// The two halves are not unrolled: unrolled, the backward's fused rows kernel
// reached 255 registers and spilled 120 bytes; not, it takes 244 and its
// statistics kernel 128 (177 before), with the same bits (H100, PERF.md).
template <bool DELTA>
__device__ __forceinline__ void stats_tile(tc::RowStats& st, const uint32_t (&qh)[4][4],
                                           const uint32_t (&ql)[4][4],
                                           const uint32_t (&oh)[4][4],
                                           const uint32_t (&ol)[4][4], const float* sk,
                                           const float* sv, int j0, int J, int col,
                                           const Offsets& off) {
#pragma unroll 1
  for (int c0 = 0; c0 < kBlock; c0 += 32) {
    float s[4][4], dp[4][4];
    product_nt<4>(qh, ql, sk, c0, off, s);
    if (DELTA) product_nt<4>(oh, ol, sv, c0, off, dp);
    // s[i][2h + w], dp[i][2h + w]: row row[h], key j0 + c0 + 8 i + col + w
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (j0 + c0 + 8 * i + col + (e & 1) >= J) s[i][e] = attn::kNegMax;
    tc::stats_update<DELTA, true>(st, s, dp);
  }
}

// lse[h] (and delta[h], with DELTA) of the rows row[h] < N of bag
// blockIdx.y, merged from the gridDim.z segments' (lse, delta) in part
// (segment-major, (gridDim.y, N) each) by the max and sum rule, in segment
// order; rows >= N are left alone.
template <bool DELTA>
__device__ __forceinline__ void merge_segments(const float2* part, int N, const int (&row)[2],
                                               float (&lse)[2], float (&delta)[2]) {
  const int S = gridDim.z;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] >= N) continue;
    const float2* pr = part + (size_t)blockIdx.y * N + row[h];
    const size_t step = (size_t)gridDim.y * N;
    float mx = -INFINITY;
    for (int s = 0; s < S; ++s) mx = fmaxf(mx, pr[s * step].x);
    float l = 0.f, d = 0.f;
    for (int s = 0; s < S; ++s) {
      const float2 x = pr[s * step];
      const float e = expf(x.x - mx);
      l += e;
      if (DELTA) d = fmaf(e, x.y, d);
    }
    lse[h] = mx + logf(l);
    if (DELTA) delta[h] = d / l;
  }
}

// out_o[e] = sum over s < S, in order, of part[s][o][e] (o < n_out, e < n4
// float4s): the segments' partial sums of one or two outputs.
__global__ void __launch_bounds__(256)
attn_bwd_combine(const float4* __restrict__ part, int S, size_t n4, int n_out,
                 float4* __restrict__ out0, float4* __restrict__ out1) {
  const size_t total = n4 * n_out;
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    float4 a = part[e];
    for (int s = 1; s < S; ++s) {
      const float4 b = part[s * total + e];
      a.x += b.x;
      a.y += b.y;
      a.z += b.z;
      a.w += b.w;
    }
    if (e < n4)
      out0[e] = a;
    else
      out1[e - n4] = a;
  }
}

// ---- f32 at dh = 64: the forward and the backward's rows and keys kernels ---
//
// At dh = 64 a warp's 16 rows of q and dout as split A fragments would take
// 128 registers, and unsplit 64, beside dq's 32-register sum and the
// products' accumulators: with them in registers every instantiation reached
// the 255-register limit and spilled (PERF.md).  So the block's own operand (q
// and dout, or k and v) sits in two swizzled 64 x 64 f32 tiles in shared
// memory beside the two-stage ring of the streamed ones (16 KB a tile,
// mma::swz64f; 96 KB of dynamic shared memory, two blocks an SM), and each
// k-step's A fragment is read by ldmatrix and split on use, once for the n8
// tiles it meets there (product_nt64).  The f32 bias and dbias stay out of
// shared memory: 36 KB of bias tiles would leave one block an SM.  Each lane
// reads and writes its own elements of them in the m16n8 layout (a row's
// keys 2t, 2t + 1 as one 8-byte access, 32 contiguous bytes for the four
// lanes of a row: whole sectors), issued before the products that hide them.

// The three tf32 products of each k-step go to one tensor-core accumulator
// (mma::mma_3xtf32 with big = small): the small ones apart, as at dh = 32,
// would take a second accumulator beside each.  A product's
// accumulator starts from zero for every 8 k-steps (s, dp: a sum over dh) or
// every 32 keys or 16 rows (dq, dk, dv), then is folded into an f32 sum.

constexpr int kDH64 = 64;
constexpr int kTile64 = kBlock * kDH64;  // floats of one swizzled 64 x 64 tile

// Every dh = 64 operand is split by mma::split_tf32_trunc, in two operations
// instead of split_tf32's five: the kernels are bound by instruction issue
// (PERF.md, scripts/profile_attn_bwd.py --variant rna64).

// The split A fragment of an m16n8 accumulator c (mma::split_accum's layout)
__device__ __forceinline__ void split_accum64(uint32_t (&ah)[4], uint32_t (&al)[4],
                                              const float (&c)[4]) {
  mma::split_tf32_trunc(c[0], ah[0], al[0]);
  mma::split_tf32_trunc(c[2], ah[1], al[1]);
  mma::split_tf32_trunc(c[1], ah[2], al[2]);
  mma::split_tf32_trunc(c[3], ah[3], al[3]);
}
// Dynamic shared-memory bytes of the rows kernel (the K and V ring's two
// stages, q and dout) and of the keys kernel (the same, and the ring's lse
// and delta)
constexpr int kRowsSmem64 = 6 * kTile64 * sizeof(float);
constexpr int kKeysSmem64 = kRowsSmem64 + 4 * kBlock * sizeof(float);

// Stage rows [r0, r0 + kBlock) of two (n, 64) f32 matrices a and b in the
// swizzled tiles sa and sb by cp.async, rows >= n zero-filled.
__device__ __forceinline__ void stage_pair64(const float* a, const float* b, float* sa,
                                             float* sb, int r0, int n) {
  for (int i = threadIdx.x; i < kBlock * 16; i += kThreads) {
    const int r = i >> 4, c = i & 15;
    const bool ok = r0 + r < n;
    const size_t off = (size_t)(ok ? r0 + r : 0) * kDH64 + 4 * c;
    const int at = mma::swz64f(r, 4 * c);
    mma::cp_async16(mma::smem_u32(sa + at), a + off, ok);
    mma::cp_async16(mma::smem_u32(sb + at), b + off, ok);
  }
}

// Each lane's byte offsets in a swizzled 64 x 64 f32 tile (mma::swz64f keeps
// a row's bits apart from the terms xor adds): the ldmatrix row of its warp's
// A fragment at k-step ks at a ^ 32 ks (the warp's 16 rows of the block's own
// tile); of product_nt64's B at k-step pair kp at nt ^ 64 kp; of
// product_nn64's B, rows 2t + w (w < 2) at column 8 n + g, at nn[w] ^ 32 n.
struct Offsets64 {
  uint32_t a, nt, nn[2];
  __device__ Offsets64(int lane, int warp) {
    // matrix lane / 8 of the x4 load: rows 0-7 or 8-15, chunk 2 ks or 2 ks + 1
    a = 4 * mma::swz64f(16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1), 4 * (lane >> 4));
    nt = 4 * mma::swz64f(lane & 7, 4 * (lane >> 3));
    nn[0] = 4 * mma::swz64f(2 * (lane & 3), lane >> 2);
    nn[1] = 4 * mma::swz64f(2 * (lane & 3) + 1, lane >> 2);
  }
};

// acc[i] (16 x 8) = A X^T over the rows n0 + 8 i .. + 7 of the swizzled 64 x
// 64 tile x (the n of the product), i < NI; A the warp's 16 rows of the
// block's own tile own (16 x 64), each k-step's f32 fragment by ldmatrix,
// split once for the NI tiles.  B by ldmatrix: the 32-bit word t of row g of
// a 16-byte chunk is B's (k t, n g); likewise A's a[0..3] = (g, t), (g + 8,
// t), (g, t + 4), (g + 8, t + 4) of the k-step's 8 columns.
template <int NI>
__device__ __forceinline__ void product_nt64(const float* own, const float* x, int n0,
                                             const Offsets64& off, float (&acc)[NI][4]) {
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  const uint32_t abase = mma::smem_u32(own);
  const uint32_t base = mma::smem_u32(x) + 256 * n0;
#pragma unroll
  for (int kp = 0; kp < 4; ++kp) {
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t a[4];
      mma::ldmatrix_x4(a, abase + (off.a ^ (32 * (2 * kp + kk))));
#pragma unroll
      for (int e = 0; e < 4; ++e)
        mma::split_tf32_trunc(__uint_as_float(a[e]), ah[kk][e], al[kk][e]);
    }
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      uint32_t b[4];  // b0, b1 of k-steps 2 kp and 2 kp + 1
      mma::ldmatrix_x4(b, base + 2048 * i + (off.nt ^ (64 * kp)));
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t bh0, bl0, bh1, bl1;
        mma::split_tf32_trunc(__uint_as_float(b[2 * kk]), bh0, bl0);
        mma::split_tf32_trunc(__uint_as_float(b[2 * kk + 1]), bh1, bl1);
        mma::mma_3xtf32(acc[i], acc[i], ah[kk], al[kk], bh0, bh1, bl0, bl1);
      }
    }
  }
}

// Keys j, j + 1 (j even) of an f32 row p (its key 0) in device memory, keys
// >= J as 0.  EVEN (J even): every row starts 8 bytes aligned, and j < J
// holds j + 1 < J: one 8-byte load; else element by element.
__device__ __forceinline__ float2 load_pair64(const float* p, int j, int J, bool even) {
  if (even) return j < J ? *reinterpret_cast<const float2*>(p + j) : make_float2(0.f, 0.f);
  return make_float2(j < J ? p[j] : 0.f, j + 1 < J ? p[j + 1] : 0.f);
}
// x, y to keys j, j + 1 (j even) of the row p, keys >= J left alone
__device__ __forceinline__ void store_pair64(float* p, int j, int J, bool even, float x,
                                             float y) {
  if (even) {
    if (j < J) *reinterpret_cast<float2*>(p + j) = make_float2(x, y);
    return;
  }
  if (j < J) p[j] = x;
  if (j + 1 < J) p[j + 1] = y;
}

// The score code of one 32-key half (keys j0c + 8 i + col + w, i < 4, w <
// 2) of a dh = 64 rows kernel, shared by the forward and the backward's rows
// kernel, for the lane's rows row[h] (h < 2): brow[h], row[h]'s start in the
// (BG, N, J) f32 bias (a row past the bag: row 0, never read), in_bag[h]
// whether it is a row of the bag, uniform[h] whether the span makes it
// uniform; even: J even.  Both issue the bias loads, then the products (the
// backward's dp product beside q k^T), then the mask.

// b[i][h]: the bias of row row[h] at keys j0c + 8 i + col and the next,
// loaded before the products that hide them
__device__ __forceinline__ void bias_pairs64(float2 (&b)[4][2], const float* bias,
                                             const size_t (&brow)[2], const bool (&in_bag)[2],
                                             int j0c, int col, int J, bool even) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      b[i][h] = in_bag[h] ? load_pair64(bias + brow[h], j0c + 8 * i + col, J, even)
                          : make_float2(0.f, 0.f);
}

// s[i][2h + w] (row row[h], key j0c + 8 i + col + w) = mask(s + bias), keys
// >= J at -f32max
template <bool HAS_BIAS, bool HAS_SPAN>
__device__ __forceinline__ void mask_scores64(float (&s)[4][4], const float2 (&b)[4][2],
                                              const attn::SpanMask& mask,
                                              const bool (&uniform)[2], int j0c, int col,
                                              int J) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1, j = j0c + 8 * i + col + (e & 1);
      float& x = s[i][e];
      if (HAS_BIAS) x += (e & 1) ? b[i][h].y : b[i][h].x;
      x = j < J ? attn::mask_score<HAS_SPAN>(x, mask, uniform[h], j) : attn::kNegMax;
    }
}

// Stage rows [r0, r0 + kBlock) of one (n, 64) f32 matrix a in the swizzled
// tile sa by cp.async, rows >= n zero-filled: stage_pair64 for one matrix.
__device__ __forceinline__ void stage_tile64(const float* a, float* sa, int r0, int n) {
  for (int i = threadIdx.x; i < kBlock * 16; i += kThreads) {
    const int r = i >> 4, c = i & 15;
    const bool ok = r0 + r < n;
    const size_t off = (size_t)(ok ? r0 + r : 0) * kDH64 + 4 * c;
    mma::cp_async16(mma::smem_u32(sa + mma::swz64f(r, 4 * c)), a + off, ok);
  }
}

// acc (16 x 32) += A X over the 8 rows k0 .. k0 + 7 of the swizzled 64 x 64
// tile x (the k of the product), k0 a multiple of 8, and its columns 8 N0 ..
// 8 N0 + 31 (the n tiles N0 .. N0 + 3); A the split accumulator of the
// previous product (mma::split_accum), so B's k positions t and t + 4 are
// rows k0 + 2t and k0 + 2t + 1.
template <int N0>
__device__ __forceinline__ void product_nn64(float (&acc)[4][4], const uint32_t (&ah)[4],
                                             const uint32_t (&al)[4], const float* x, int k0,
                                             const Offsets64& off) {
  const char* base = reinterpret_cast<const char*>(x + kDH64 * k0);
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    uint32_t bh0, bl0, bh1, bl1;
    const uint32_t at = 32 * (N0 + n);
    const float b0 = *reinterpret_cast<const float*>(base + (off.nn[0] ^ at));
    const float b1 = *reinterpret_cast<const float*>(base + (off.nn[1] ^ at));
    mma::split_tf32_trunc(b0, bh0, bl0);
    mma::split_tf32_trunc(b1, bh1, bl1);
    mma::mma_3xtf32(acc[n], acc[n], ah, al, bh0, bh1, bl0, bl1);
  }
}

// sum's columns 8 N0 .. 8 N0 + 31 += the product of the split accumulators
// a[i] (i < NI, 8 rows or keys of the tile x from k0 + 8 i each) and those
// columns of x, on zeroed accumulators: a sum of NI k-steps on the tensor
// core, then in f32 registers.
template <int N0, int NI>
__device__ __forceinline__ void fold_half64(float (&sum)[8][4], const float (&a)[NI][4],
                                            const float* x, int k0, const Offsets64& off) {
  float acc[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    uint32_t ah[4], al[4];
    split_accum64(ah, al, a[i]);
    product_nn64<N0>(acc, ah, al, x, k0 + 8 * i, off);
  }
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) sum[N0 + n][e] += acc[n][e];
}

// sum += the (16 x 64) product of a and x (fold_half64), in two halves of 32
// columns: a half's accumulators take 16 registers, not the whole product's
// 32 (the splits of a[i] are made twice).
template <int NI>
__device__ __forceinline__ void product_fold64(float (&sum)[8][4], const float (&a)[NI][4],
                                               const float* x, int k0, const Offsets64& off) {
  fold_half64<0>(sum, a, x, k0, off);
  fold_half64<4>(sum, a, x, k0, off);
}

// The (16 x 64) sum of a warp's rows (or keys) r0 + g, r0 + g + 8 into rows
// of 64 floats at dst, rows >= n left alone.
__device__ __forceinline__ void store_rows64(float* dst, const float (&sum)[8][4], int r0,
                                             int n, int lane) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + (lane >> 2) + 8 * h;
    if (r < n)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        *reinterpret_cast<float2*>(dst + (size_t)r * kDH64 + 8 * nt + 2 * (lane & 3)) =
            make_float2(sum[nt][2 * h], sum[nt][2 * h + 1]);
  }
}

}  // namespace tf32
