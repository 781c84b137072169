// Attention forward for sm_90a, key-tiled:
//
//   out[bg, i] = dropout(softmax_j(mask(q[bg, i] . k[bg, j] + bias[bg, i, j]))) @ v[bg]
//
// q (BG, N, DH) is already scaled; k, v (BG, J, DH); bias (BG, N, J) in q's
// dtype, or f32 beside bf16 q, k, v (the 1-D deformable attention's bias, from
// the f32 CPB1D; no span, no dropout), or absent; out (BG, N, DH) in q's dtype.  Replaces the Pallas kernel
// _fused_attn_fwd_call (sml_tpu/ops/pallas/deform_attn.py, body
// _attn_fwd_kernel) in every compiled form: with or without the bias
// (HAS_BIAS), the span mask (HAS_SPAN) and dropout (DROP).
//
// span (BG, 4) int32 = per-bag [row_start, row_end, col_start, col_end) over
// the unpadded rows and columns (attn_common.cuh, SpanMask): invalid columns
// of a valid row take -f32max before the max, so their probability is exactly
// 0; a row outside the rows (or with no valid column) is uniform over all J.
//
// Dropout (keep_prob < 1): the multiplier {0, 1/keep} of each probability
// comes from Philox4x32-10 on (seed, bg, row, col) (philox.cuh), applied after
// the normalisation and before @ v; no mask reaches device memory.
//
// bf16, the tensor-core kernel tc::attn_fwd_tc: one block of kFwdWarps
// warps per (bg, 16 kFwdWarps query rows), each warp owning 16 rows whose q
// sits in A fragments in registers for the whole kernel (mma.cuh).  K and V
// stream in 64-key swizzled tiles through a two-stage cp.async ring, walked
// twice, with the backward rows kernel's code (attn_tc.cuh):
//   pass 1: s = q k^T (mma.sync m16n8k16, bf16 operands, f32 sums), the bias,
//     span mask and key tail on the accumulator fragments, lane-local running
//     max and sum folded over the lane quad once into lse per row (K only);
//   pass 2: s again, p = exp(s - lse) * m with m the Philox multiplier on
//     (seed, bg, row, col), rounded to bf16 straight into A fragments (where
//     the Pallas kernel rounds attn * mult to v's dtype), out += p V with V by
//     ldmatrix.trans.
// out, 16 x 64 f32 per warp in registers, is stored once as bf16.  Nothing of
// the (BG, N, J) chain reaches device memory.  The bias is the largest
// operand: at the 1-D path's J = 625 its f32 reads (4 bytes a pair, once a
// pass) bound the kernel by bytes.  Its 64 x 64 tile rides in the ring beside
// K (and V), copied by 16-byte cp.async at any J (attn_tc.cuh, stage_bias),
// so the next tile's bias is in flight while this one computes and the
// epilogue reads it from shared memory; the bias stages are dynamic shared
// memory beside the 32 KB of K and V (18 KB in bf16, 36 KB in f32).  Two
// passes, not one online softmax: the normalised p * m is what Pallas rounds,
// and a rescaled accumulator would round exp(s - running max) instead, in
// key-tile order; the second q k^T costs 2 DH FLOP per pair.  Pass 1 is the
// backward's pass 1 (the same code, the same sums in the same order), meant
// to give the backward's lse and p; nvcc compiles the two instantiations
// apart, and no check on the card holds them bit for bit.  A 32-key half past
// J (the last tile of J = 144) is skipped.
//
// f32 at dh = 64 (every form: the default compute dtype's; the deformable
// attention's bias with dropout, TransMIL's bias-less and span chains), the
// tf32 tensor-core kernel tf32::attn_fwd_tf32_64, on the pieces of the dh =
// 64 backward (attn_tf32.cuh): four warps of 16 query rows, the block's q in
// a swizzled 64 x 64 f32 tile in shared memory (16 KB a tile; each k-step's A
// fragment read by ldmatrix and split on use: as split fragments in
// registers q would take 128 of them), K and V through the two-stage
// cp.async ring of swizzled 64 x 64 f32 tiles.  The two steps of the dh = 32
// form, per 32-key half with the backward rows kernel's score code
// (bias_pairs64, mask_scores64: the lane's f32 bias pairs read from device
// memory in the fragment layout before the products, the span mask, the key
// tail at -f32max) and statistics walk (tc::stats_update), so lse is the
// backward's bit for bit by construction; then p = exp(s - lse) * m (the Philox
// multipliers of drop_pair, each group drawn once for a lane pair:
// rows_keep_bits), split into the A fragments of out += p V, whose
// tensor-core sums start from zero every 32 keys and are folded into an f32
// register sum (product_fold64).  A thin side (chain 3: 256 rows
// against 2560 / 4352 keys, 256 blocks) cuts its keys into segments as the
// dh = 32 form does.
//
// f32 at dh = 32 (no bias, span or dropout: CMTA's Nystrom chains, 8 heads
// of 32, 128 landmarks against 2560 tokens), the tf32 tensor-core kernel
// tf32::attn_fwd_tf32, on the pieces of the dh = 32 backward (attn_tf32.cuh):
// one block of four warps per (64 query rows, bg, key segment), each warp's
// 16 rows of q as split A fragments in registers, K and V through the
// two-stage cp.async ring of swizzled 64 x 32 f32 tiles.  The Pallas
// kernel's two steps (_softmax_rows, then attn @ v), not an online softmax:
//   STATS: s = q k^T for the segment's keys (K only), each row's max and sum
//     of exp: the backward rows kernel's statistics walk (stats_tile), so
//     lse is the backward's, bit for bit by construction;
//   OUT: the segments' statistics merged in segment order into lse (segment
//     0 writes it to the scratch), then s again, p = exp(s - lse) in f32,
//     split into the A fragments of out += p V (mma::split_accum; V the B
//     operand), each tile's tensor-core sum folded into an f32 register sum.
// Every product is 3xTF32 (three tf32 mma.sync m16n8k8, mma.cuh).  One key
// segment (chain 1, J = 128) runs both passes in one launch; a thin row side
// (chain 3, 128 rows against 2560 keys: 128 blocks on 132 SMs) cuts its keys
// into tf32::segments (8 at BG 64, 1024 blocks): statistics, then the
// outputs per segment into an f32 scratch (deform_attn_fwd_work), then
// tf32::attn_bwd_combine adds them in segment order: no atomics, the same
// bits on every run.  bf16 never reaches dh = 32 (the Nystrom gate asks for
// dh * itemsize >= 128 bytes).
//
// What bounds it: at the Nystrom chains (J or N of 2560 / 4352, dh 64)
// about 4 * DH FLOP per pair against q, K, V and out read or written once:
// operations on the tensor cores (the kernels issue 6 * DH, q k^T twice); at
// the deformable attention's J = 144, the bias stream, bytes (bf16).  The f32
// forms issue 3 x 6 * DH FLOP a pair on the tf32 tensor cores (three tf32
// products for each f32 one) against 4 * DH on the CUDA cores; the operand
// splits and addresses outnumber the mma about 15 to 1 in the dh = 32 out
// kernel's SASS (12 to 1 in the dh = 32 backward, 9 to 15 at dh = 64), so
// instruction issue bounds them: the splits are the cheap truncating ones
// at dh = 64 (split_tf32_trunc), each k-step's q fragment is split once for
// the four n8 tiles of a half, a half past J or a warp past N does no work,
// and every thin launch is cut into segments that fill the card.
//
// C entry: deform_attn_fwd(dtype, bias_dtype, q, k, v, bias, span, out, work,
//                          BG, N, J, DH, keep_prob, inv_keep, seed, device,
//                          stream) -> cudaGetLastError().
// dtype: 0 = float, 1 = bfloat16 for q, k, v and out; bias_dtype the same
// codes for the bias: dtype's, or 0 with dtype 1 in the form without span and
// dropout (any other pair is cudaErrorInvalidValue).  bias and span may be
// null.  DH is 64, or 32 with dtype 0 and no bias, span or dropout (any other
// dh 32 form is cudaErrorInvalidValue).  work: an f32 scratch of
// deform_attn_fwd_work(dtype, BG, N, J, DH) floats (null when that is 0:
// bf16), whose first BG * N floats receive each row's lse in f32.  The
// library carries its own CUDA runtime, so the entry selects `device` itself.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>
#include <type_traits>

#include "attn_common.cuh"
#include "attn_tc.cuh"
#include "attn_tf32.cuh"
#include "mma.cuh"
#include "philox.cuh"

// ---- bf16: the tensor-core kernel --------------------------------------------

namespace tc {

constexpr int kFwdWarps = 4;
constexpr int kFwdThreads = 32 * kFwdWarps;
constexpr int kFwdRows = 16 * kFwdWarps;  // query rows per block
// blocks per SM for 16 warps, so at most 128 registers a thread: with no
// minimum, ptxas held the bias forms at 96 and spilled
constexpr int kFwdMinBlocks = 512 / kFwdThreads;

// Block (row tile, bg), warp w owns rows row0 + 16 w .. + 15, lane (g, t) the
// rows g and g + 8 of them and, in each n8 tile of keys, the columns 2t and
// 2t + 1; in the output, the columns 8 n + 2t, 8 n + 2t + 1 of n8 tile n.
// BT: the bias's element type, bf16 or f32.  Dynamic shared memory of
// bias_smem_bytes<HAS_BIAS, BT>(): the bias stages.
template <bool HAS_BIAS, bool HAS_SPAN, bool DROP, typename BT = bf16>
__global__ void __launch_bounds__(kFwdThreads, kFwdMinBlocks)
attn_fwd_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, const BT* __restrict__ bias,
            const int* __restrict__ span, bf16* __restrict__ out, int N, int J,
            float keep_prob, float inv_keep, unsigned long long seed) {
  static_assert(kFwdRows == kBlock, "one bias tile row per query row of the block");
  __shared__ __align__(128) bf16 s_kv[2][2][kTile];         // [stage][K, V]
  extern __shared__ __align__(128) unsigned char smem_raw[];
  BT* s_b = reinterpret_cast<BT*>(smem_raw);                  // [stage][kBlock][kBiasLd]
  const int bg = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kFwdRows, wrow0 = row0 + warp * 16;
  const int row[2] = {wrow0 + mma::frag_row(lane, 0), wrow0 + mma::frag_row(lane, 2)};
  const int col = mma::frag_col(lane, 0);  // of element 0 in an n8 tile; element 1 is next
  const SpanMask mask = load_span<HAS_SPAN>(span, bg, J);
  const bool uniform[2] = {HAS_SPAN && mask.uniform(row[0]),
                           HAS_SPAN && mask.uniform(row[1])};
  const bf16* kg = k + (size_t)bg * J * 64;
  const bf16* vg = v + (size_t)bg * J * 64;
  // the lane's two rows in a staged bias tile, shift included
  const int boff[2] = {
      (row[0] - row0) * kBiasLd + bias_shift<BT>(bg * N + row[0], J),
      (row[1] - row0) * kBiasLd + bias_shift<BT>(bg * N + row[1], J)};
  const bool even = !(J & 1);
  const int nt = (J + kBlock - 1) / kBlock;
  auto stage = [&](int it) {  // pass 1 reads K only, pass 2 K and V; both the bias
    bf16* skv = s_kv[it & 1][0];
    const int j0 = (it < nt ? it : it - nt) * kBlock;
    if (it < nt)
      stage_tile<kFwdThreads>(kg, skv, j0, J);
    else
      stage_pair<kFwdThreads>(kg, vg, skv, skv + kTile, j0, J);
    if (HAS_BIAS)
      stage_bias<BT, kFwdThreads>(bias, s_b + (it & 1) * kBlock * kBiasLd, bg * N + row0,
                                  bg * N + N, j0, J);
    mma::cp_async_commit();
  };
  stage(0);

  uint32_t qa[4][4];  // this warp's 16 rows of q as A fragments
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    mma::load_a_global(qa[ks], q + (size_t)bg * N * 64, 64, wrow0, N, 16 * ks, lane);
  RowStats st;  // pass 1: lane-local statistics, folded over the lane quad at its end
  float lse_r[2] = {0.f, 0.f}, no_delta[2];
  float o[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  for (int it = 0; it < 2 * nt; ++it) {
    if (it + 1 < 2 * nt) {
      stage(it + 1);
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();
    const bool pass2 = it >= nt;
    const int j0 = (pass2 ? it - nt : it) * kBlock;
    if (it == nt) stats_fold<false>(st, lse_r, no_delta);
    const bf16* sk = s_kv[it & 1][0];
    const bf16* sv = s_kv[it & 1][1];
    const BT* sb = s_b + (it & 1) * kBlock * kBiasLd;
    const BT* const brow[2] = {sb + boff[0], sb + boff[1]};
#pragma unroll
    for (int c0 = 0; c0 < kBlock; c0 += 32) {
      if (j0 + c0 >= J) break;  // a half of the last tile past J
      float s[4][4];
      product_nt(qa, sk, c0, lane, s);
      // s[i][2h + w]: row row[h], key j0 + c0 + 8 i + col + w
      mask_scores<HAS_BIAS, HAS_SPAN>(s, brow, even, J, j0, c0, col, mask, uniform);
      if (!pass2) {
        stats_update<false>(st, s, s);
        continue;
      }
      // pass 2: p * m (in s), rounded to bf16 as the A operand of out += p V
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float2 m = make_float2(1.f, 1.f);
          if (DROP) m = drop_pair(seed, j0 + c0 + 8 * i + col, row[h], bg, keep_prob, inv_keep);
          s[i][2 * h] = exp_f(s[i][2 * h] - lse_r[h]) * m.x;
          s[i][2 * h + 1] = exp_f(s[i][2 * h + 1] - lse_r[h]) * m.y;
        }
#pragma unroll
      for (int kb = 0; kb < 2; ++kb) {
        uint32_t a[4];
        mma::accum_to_a(a, s[2 * kb], s[2 * kb + 1]);
        product_nn(o, a, sv, c0 + 16 * kb, lane);
      }
    }
    __syncthreads();  // the stage is consumed before the ring refills it
  }
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (row[h] < N)
        *reinterpret_cast<__nv_bfloat162*>(out + ((size_t)bg * N + row[h]) * 64 + 8 * n + col) =
            __floats2bfloat162_rn(o[n][2 * h], o[n][2 * h + 1]);
}

}  // namespace tc

// ---- f32 dh = 32: the tf32 tensor-core kernel (3xTF32, attn_tf32.cuh) -------

namespace tf32 {

// Block (row tile, bg, key segment), warp w owns rows row0 + 16 w .. + 15 (q
// as split A fragments in registers), lane (g, t) the rows g and g + 8 and,
// in each n8 tile of keys, the columns 2t and 2t + 1; in the output, the
// columns 8 n + 2t, 8 n + 2t + 1 of n8 tile n.
//   STATS: walk the segment's keys (K tiles only) for each row's max and sum
//     of exp (stats_tile, the backward rows kernel's walk); with OUT (one
//     segment) fold them into lse, write it, and walk K and V again; alone,
//     write the segment's lse to part (as the backward writes (lse, delta)).
//   OUT: (alone: merge the segments' lse from part in segment order,
//     merge_segments; segment 0 writes lse) per pair p = exp(s - lse), then
//     out += p v over the segment's keys, written to out + seg * seg_stride.
template <bool STATS, bool OUT>
__global__ void __launch_bounds__(kThreads)
attn_fwd_tf32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ out, size_t seg_stride,
              float* __restrict__ lse, float2* __restrict__ part, int N, int J,
              int seg_tiles) {
  static_assert(STATS || OUT, "a pass to run");
  __shared__ __align__(128) float s_kv[2][2][kTileF];  // [stage][K, V]
  const int bg = blockIdx.y, seg = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wrow0 = blockIdx.x * kBlock + warp * 16;
  const int row[2] = {wrow0 + (lane >> 2), wrow0 + (lane >> 2) + 8};
  const int col = 2 * (lane & 3);  // of element 0 in an n8 tile; element 1 is next
  const int t0 = seg * seg_tiles;
  const int nt = min(seg_tiles, (J + kBlock - 1) / kBlock - t0);
  constexpr int kPasses = (STATS ? 1 : 0) + (OUT ? 1 : 0);
  const float* kg = k + (size_t)bg * J * kDH;
  const float* vg = v + (size_t)bg * J * kDH;
  auto stage = [&](int it) {  // the statistics read K only, the output K and V
    const int r0 = (t0 + it % nt) * kBlock;
    if (STATS && it < nt)
      stage_tile(kg, s_kv[it & 1][0], r0, J);
    else
      stage_pair(kg, vg, s_kv[it & 1][0], s_kv[it & 1][1], r0, J);
    mma::cp_async_commit();
  };
  stage(0);

  const Offsets off(lane);
  uint32_t qh[4][4], ql[4][4];
  load_a(qh, ql, q + (size_t)bg * N * kDH, wrow0, N, lane);
  float lse_r[2] = {0.f, 0.f}, no_delta[2] = {0.f, 0.f};
  auto write_lse = [&]() {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (col == 0 && row[h] < N) lse[(size_t)bg * N + row[h]] = lse_r[h];
  };
  if (!STATS) {
    merge_segments<false>(part, N, row, lse_r, no_delta);
    if (seg == 0) write_lse();
  }
  tc::RowStats st;
  float o_sum[4][4], o_acc[4][4], o_small[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o_sum[n][e] = o_acc[n][e] = o_small[n][e] = 0.f;

  for (int it = 0; it < kPasses * nt; ++it) {
    if (it + 1 < kPasses * nt) {
      stage(it + 1);
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();
    const bool out_pass = OUT && (!STATS || it >= nt);
    if (STATS && OUT && it == nt) {
      tc::stats_fold<false, true>(st, lse_r, no_delta);
      write_lse();
    }
    const float* sk = s_kv[it & 1][0];
    const float* sv = s_kv[it & 1][1];
    const int j0 = (t0 + it % nt) * kBlock;
    if (!out_pass) {
      stats_tile<false>(st, qh, ql, qh, ql, sk, sk, j0, J, col, off);
      __syncthreads();  // the stage is consumed before the ring refills it
      continue;
    }
#pragma unroll
    for (int c0 = 0; c0 < kBlock; c0 += 32) {
      float s[4][4];
      product_nt<4>(qh, ql, sk, c0, off, s);
      // s[i][2h + w]: row row[h], key j0 + c0 + 8 i + col + w; -> p
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[i][e] = j0 + c0 + 8 * i + col + (e & 1) < J ? expf(s[i][e] - lse_r[e >> 1]) : 0.f;
        uint32_t ah[4], al[4];
        mma::split_accum(ah, al, s[i]);
        product_nn(o_acc, o_small, ah, al, sv, c0 + 8 * i, off);
      }
    }
    if (kFoldTiles) fold(o_sum, o_acc, o_small);
    __syncthreads();  // the stage is consumed before the ring refills it
  }
  if (STATS && !OUT) {
    tc::stats_fold<false, true>(st, lse_r, no_delta);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (col == 0 && row[h] < N)
        part[((size_t)seg * gridDim.y + bg) * N + row[h]] = make_float2(lse_r[h], 0.f);
  }
  if (OUT) {
    fold(o_sum, o_acc, o_small);
    store_rows(out + seg * seg_stride + (size_t)bg * N * kDH, o_sum, wrow0, N, lane);
  }
}

// ---- f32 dh = 64: the tf32 tensor-core kernel (3xTF32, attn_tf32.cuh) -------

// Block (row tile, bg, key segment), warp w owns rows row0 + 16 w .. + 15 of
// the block's q tile (staged once in shared memory, each k-step's A fragment
// by ldmatrix, split on use), lane (g, t) the rows g and g + 8 and, in each n8
// tile of keys, the columns 2t and 2t + 1; in the output, the columns 8 n +
// 2t, 8 n + 2t + 1 of n8 tile n.  K (and V) stream through a two-stage
// cp.async ring of swizzled 64 x 64 f32 tiles, walked per 32-key half with
// the backward rows kernel's score code (bias_pairs64, mask_scores64: s =
// mask(q k^T + bias), the lane's bias pairs read from device memory before
// the products):
//   STATS: fold s into each row's running max and sum of exp (the backward
//     rows kernel's statistics walk, without delta); with OUT (one segment)
//     fold them into lse, write it, and walk K and V again; alone, write the
//     segment's lse to part.
//   OUT: (alone: merge the segments' lse from part in segment order; segment
//     0 writes lse) p = exp(s - lse) * m (m: the Philox multipliers of
//     tc::rows_keep_bits, each 4-key group drawn once for a lane pair), then
//     out += p V per 32-key half on zeroed accumulators folded into an f32
//     register sum (product_fold64), written to out + seg * seg_stride.
// A half that holds no key (past J, the last tile of J = 144) and a warp
// whose rows all lie past N are skipped.  A statistics-only launch reads K
// alone: three tiles of shared memory, four blocks an SM; the others five,
// two blocks an SM.  Naming the blocks keeps ptxas from capping registers
// below need.
template <bool STATS, bool OUT>
constexpr int fwd_tiles64() { return STATS && !OUT ? 3 : 5; }

template <bool HAS_BIAS, bool HAS_SPAN, bool DROP, bool STATS, bool OUT>
__global__ void __launch_bounds__(kThreads, STATS && !OUT ? 4 : 2)
attn_fwd_tf32_64(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ bias,
                 const int* __restrict__ span, float* __restrict__ out, size_t seg_stride,
                 float* __restrict__ lse, float2* __restrict__ part, int N, int J,
                 int seg_tiles, float keep_prob, float inv_keep, unsigned long long seed) {
  static_assert(STATS || OUT, "a pass to run");
  extern __shared__ __align__(128) float smem64[];
  float* s_q = smem64;                // the block's q
  float* s_k = smem64 + kTile64;      // [stage][kTile64]
  float* s_v = s_k + 2 * kTile64;     // [stage][kTile64], not with STATS alone
  const int bg = blockIdx.y, seg = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kBlock, wrow0 = row0 + warp * 16;
  const int row[2] = {wrow0 + (lane >> 2), wrow0 + (lane >> 2) + 8};
  const int col = 2 * (lane & 3);  // of element 0 in an n8 tile; element 1 is next
  const int t0 = seg * seg_tiles;
  const int nt = min(seg_tiles, (J + kBlock - 1) / kBlock - t0);
  constexpr int kPasses = (STATS ? 1 : 0) + (OUT ? 1 : 0);
  const attn::SpanMask mask = attn::load_span<HAS_SPAN>(span, bg, J);
  const bool uniform[2] = {HAS_SPAN && mask.uniform(row[0]), HAS_SPAN && mask.uniform(row[1])};
  const bool in_bag[2] = {row[0] < N, row[1] < N};
  // the lane's two rows of the bias (a row past the bag: never read)
  const size_t brow[2] = {((size_t)bg * N + (in_bag[0] ? row[0] : 0)) * J,
                          ((size_t)bg * N + (in_bag[1] ? row[1] : 0)) * J};
  const bool even = !(J & 1);
  const float* kg = k + (size_t)bg * J * kDH64;
  const float* vg = v + (size_t)bg * J * kDH64;
  stage_tile64(q + (size_t)bg * N * kDH64, s_q, row0, N);
  auto stage = [&](int it) {  // the statistics read K only, the output K and V
    const int buf = it & 1, j0 = (t0 + it % nt) * kBlock;
    if (STATS && it < nt)
      stage_tile64(kg, s_k + buf * kTile64, j0, J);
    else
      stage_pair64(kg, vg, s_k + buf * kTile64, s_v + buf * kTile64, j0, J);
    mma::cp_async_commit();
  };
  stage(0);

  const Offsets64 off(lane, warp);
  float lse_r[2] = {0.f, 0.f}, no_delta[2] = {0.f, 0.f};
  auto write_lse = [&]() {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (col == 0 && in_bag[h]) lse[(size_t)bg * N + row[h]] = lse_r[h];
  };
  if (!STATS) {
    merge_segments<false>(part, N, row, lse_r, no_delta);
    if (seg == 0) write_lse();
  }
  tc::RowStats st;
  float o_sum[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o_sum[n][e] = 0.f;

  for (int it = 0; it < kPasses * nt; ++it) {
    if (it + 1 < kPasses * nt) {
      stage(it + 1);
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();
    const bool out_pass = OUT && (!STATS || it >= nt);
    if (STATS && OUT && it == nt) {
      tc::stats_fold<false, true>(st, lse_r, no_delta);
      write_lse();
    }
    const int buf = it & 1, j0 = (t0 + it % nt) * kBlock;
    const float* sk = s_k + buf * kTile64;
    const float* sv = s_v + buf * kTile64;
    // the 32-key halves that hold a key, for a warp that holds a row
    const int c_end = wrow0 < N ? min(kBlock, J - j0) : 0;
#pragma unroll 1
    for (int c0 = 0; c0 < c_end; c0 += 32) {
      // s[i][2h + w]: row row[h], key j0 + c0 + 8 i + col + w
      float2 b[4][2];
      if (HAS_BIAS) bias_pairs64(b, bias, brow, in_bag, j0 + c0, col, J, even);
      float s[4][4];
      product_nt64<4>(s_q, sk, c0, off, s);
      mask_scores64<HAS_BIAS, HAS_SPAN>(s, b, mask, uniform, j0 + c0, col, J);
      if (!out_pass) {
        tc::stats_update<false, true>(st, s, s);
        continue;
      }
      // p m (in s; a masked key's -f32max gives 0), then out += p V
      const uint32_t kept =
          DROP ? tc::rows_keep_bits(seed, row, j0 + c0, bg, keep_prob, lane) : 0u;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const float m = !DROP ? 1.f : ((kept >> (16 * h + 4 * i + (e & 1))) & 1u ? inv_keep
                                                                                  : 0.f);
          s[i][e] = expf(s[i][e] - lse_r[h]) * m;
        }
      product_fold64<4>(o_sum, s, sv, c0, off);
    }
    __syncthreads();  // the stage is consumed before the ring refills it
  }
  if (STATS && !OUT) {
    tc::stats_fold<false, true>(st, lse_r, no_delta);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (col == 0 && in_bag[h])
        part[((size_t)seg * gridDim.y + bg) * N + row[h]] = make_float2(lse_r[h], 0.f);
  }
  if (OUT)
    store_rows64(out + seg * seg_stride + (size_t)bg * N * kDH64, o_sum, wrow0, N, lane);
}

// The scratch of an f32 launch (dh = 32 or 64), in floats: each row's lse,
// then, when the keys are cut into segments, the segments' lse (float2, as
// the backward's (lse, delta)) and their partial outputs.
struct FwdWork {
  int seg, per;
  size_t part, out, total;  // offsets and size, in floats
};

inline FwdWork fwd_work_of(int BG, int N, int J, int DH) {
  FwdWork w{};
  const int nti = (N + kBlock - 1) / kBlock, ntj = (J + kBlock - 1) / kBlock;
  w.seg = segments(nti * BG, ntj, w.per);
  const size_t rows = (size_t)BG * N;
  w.part = (rows + 3) / 4 * 4;
  w.out = w.part + (w.seg > 1 ? (2 * w.seg * rows + 3) / 4 * 4 : 0);
  w.total = w.out + (w.seg > 1 ? (size_t)w.seg * rows * DH : 0);
  return w;
}

}  // namespace tf32

namespace {

struct Args {
  const void *q, *k, *v, *bias;
  const int* span;
  void* out;
  float* work;
  int BG, N, J;
  float keep_prob, inv_keep;
  unsigned long long seed;
  cudaStream_t stream;
};

template <bool HAS_BIAS, bool HAS_SPAN, bool DROP, typename BT = tc::bf16>
cudaError_t launch_tc(const Args& a) {
  using tc::bf16;
  auto kernel = tc::attn_fwd_tc<HAS_BIAS, HAS_SPAN, DROP, BT>;
  constexpr int smem = static_cast<int>(tc::bias_smem_bytes<HAS_BIAS, BT>());
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((a.N + tc::kFwdRows - 1) / tc::kFwdRows, a.BG), tc::kFwdThreads, smem,
           a.stream>>>(static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
                       static_cast<const bf16*>(a.v), static_cast<const BT*>(a.bias),
                       a.span, static_cast<bf16*>(a.out), a.N, a.J, a.keep_prob,
                       a.inv_keep, a.seed);
  return cudaGetLastError();
}

template <typename K>
cudaError_t max_shared(K kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// out (n floats) = the sums in segment order of S segments' partial outputs
// (tf32::attn_bwd_combine)
cudaError_t combine(const Args& a, const float* part_sums, int S, size_t n, float* out) {
  const unsigned blocks = (unsigned)std::min<size_t>((n / 4 + 255) / 256, 8 * 132);
  tf32::attn_bwd_combine<<<blocks, 256, 0, a.stream>>>(
      reinterpret_cast<const float4*>(part_sums), S, n / 4, 1,
      reinterpret_cast<float4*>(out), nullptr);
  return cudaGetLastError();
}

// The f32 dh = 32 form on the tf32 tensor cores: both passes in one launch
// (one key segment), or statistics, outputs per segment and their sum.
cudaError_t launch_tf32(const Args& a) {
  using tf32::kBlock;
  using tf32::kDH;
  using tf32::kThreads;
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  float* out = static_cast<float*>(a.out);
  const tf32::FwdWork w = tf32::fwd_work_of(a.BG, a.N, a.J, kDH);
  if (a.work == nullptr) return cudaErrorInvalidValue;
  const dim3 grid((a.N + kBlock - 1) / kBlock, a.BG, w.seg);
  float2* part = reinterpret_cast<float2*>(a.work + w.part);
  cudaError_t err;
  if (w.seg == 1) {
    auto fused = tf32::attn_fwd_tf32<true, true>;
    if ((err = max_shared(fused)) != cudaSuccess) return err;
    fused<<<grid, kThreads, 0, a.stream>>>(q, k, v, out, 0, a.work, nullptr, a.N, a.J, w.per);
    return cudaGetLastError();
  }
  auto stats = tf32::attn_fwd_tf32<true, false>;
  auto outs = tf32::attn_fwd_tf32<false, true>;
  if ((err = max_shared(stats)) != cudaSuccess || (err = max_shared(outs)) != cudaSuccess)
    return err;
  const size_t n = (size_t)a.BG * a.N * kDH;
  stats<<<grid, kThreads, 0, a.stream>>>(q, k, v, nullptr, 0, a.work, part, a.N, a.J, w.per);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  outs<<<grid, kThreads, 0, a.stream>>>(q, k, v, a.work + w.out, n, a.work, part, a.N, a.J,
                                        w.per);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return combine(a, a.work + w.out, w.seg, n, out);
}

// max_shared, and the dynamic shared memory of the dh = 64 kernel's passes
template <bool HAS_BIAS, bool HAS_SPAN, bool DROP, bool STATS, bool OUT>
cudaError_t prepare64() {
  auto kernel = tf32::attn_fwd_tf32_64<HAS_BIAS, HAS_SPAN, DROP, STATS, OUT>;
  constexpr int smem = tf32::fwd_tiles64<STATS, OUT>() * tf32::kTile64 * sizeof(float);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  return err != cudaSuccess ? err : max_shared(kernel);
}

// The f32 dh = 64 forms on the tf32 tensor cores: as launch_tf32, with the
// bias, the span and dropout
template <bool HAS_BIAS, bool HAS_SPAN, bool DROP>
cudaError_t launch_tf32_64(const Args& a) {
  using tf32::kBlock;
  using tf32::kDH64;
  using tf32::kThreads;
  using tf32::kTile64;
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* bias = static_cast<const float*>(a.bias);
  float* out = static_cast<float*>(a.out);
  const tf32::FwdWork w = tf32::fwd_work_of(a.BG, a.N, a.J, kDH64);
  if (a.work == nullptr) return cudaErrorInvalidValue;
  const dim3 grid((a.N + kBlock - 1) / kBlock, a.BG, w.seg);
  float2* part = reinterpret_cast<float2*>(a.work + w.part);
  constexpr int kBytes = sizeof(float) * kTile64;
  cudaError_t err;
  if (w.seg == 1) {
    if ((err = prepare64<HAS_BIAS, HAS_SPAN, DROP, true, true>()) != cudaSuccess) return err;
    tf32::attn_fwd_tf32_64<HAS_BIAS, HAS_SPAN, DROP, true, true>
        <<<grid, kThreads, tf32::fwd_tiles64<true, true>() * kBytes, a.stream>>>(
            q, k, v, bias, a.span, out, 0, a.work, nullptr, a.N, a.J, w.per, a.keep_prob,
            a.inv_keep, a.seed);
    return cudaGetLastError();
  }
  if ((err = prepare64<HAS_BIAS, HAS_SPAN, DROP, true, false>()) != cudaSuccess ||
      (err = prepare64<HAS_BIAS, HAS_SPAN, DROP, false, true>()) != cudaSuccess)
    return err;
  const size_t n = (size_t)a.BG * a.N * kDH64;
  tf32::attn_fwd_tf32_64<HAS_BIAS, HAS_SPAN, DROP, true, false>
      <<<grid, kThreads, tf32::fwd_tiles64<true, false>() * kBytes, a.stream>>>(
          q, k, v, bias, a.span, nullptr, 0, a.work, part, a.N, a.J, w.per, a.keep_prob,
          a.inv_keep, a.seed);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  tf32::attn_fwd_tf32_64<HAS_BIAS, HAS_SPAN, DROP, false, true>
      <<<grid, kThreads, tf32::fwd_tiles64<false, true>() * kBytes, a.stream>>>(
          q, k, v, bias, a.span, a.work + w.out, n, a.work, part, a.N, a.J, w.per,
          a.keep_prob, a.inv_keep, a.seed);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return combine(a, a.work + w.out, w.seg, n, out);
}

// bf16 to the tensor-core kernel, f32 at dh 64 to the tf32 one
template <typename T, bool HAS_BIAS, bool HAS_SPAN, bool DROP>
cudaError_t launch(const Args& a) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return launch_tc<HAS_BIAS, HAS_SPAN, DROP>(a);
  else
    return launch_tf32_64<HAS_BIAS, HAS_SPAN, DROP>(a);
}

template <typename T>
cudaError_t dispatch(const Args& a) {
  const bool b = a.bias != nullptr, s = a.span != nullptr, d = a.keep_prob < 1.f;
  if (b) {
    if (s) return d ? launch<T, true, true, true>(a) : launch<T, true, true, false>(a);
    return d ? launch<T, true, false, true>(a) : launch<T, true, false, false>(a);
  }
  if (s) return d ? launch<T, false, true, true>(a) : launch<T, false, true, false>(a);
  return d ? launch<T, false, false, true>(a) : launch<T, false, false, false>(a);
}

}  // namespace

extern "C" int deform_attn_fwd(int dtype, int bias_dtype, const void* q, const void* k,
                               const void* v, const void* bias, const void* span, void* out,
                               void* work, int BG, int N, int J, int DH, float keep_prob,
                               float inv_keep, unsigned long long seed, int device,
                               void* stream) {
  // dh 32: the f32 form without bias, span or dropout (CMTA's Nystrom chains)
  const bool dh32 = DH == 32 && dtype == 0 && bias == nullptr && span == nullptr &&
                    !(keep_prob < 1.f);
  if (DH != 64 && !dh32) return cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Args a{q, k, v, bias, static_cast<const int*>(span), out, static_cast<float*>(work),
               BG, N, J, keep_prob, inv_keep, seed, static_cast<cudaStream_t>(stream)};
  if (dh32) return launch_tf32(a);
  if (bias != nullptr && bias_dtype != dtype) {
    // the f32 bias beside bf16 q, k, v: the one form the 1-D path runs
    if (dtype == 1 && bias_dtype == 0 && span == nullptr && !(keep_prob < 1.f))
      return launch_tc<true, false, false, float>(a);
    return cudaErrorInvalidValue;
  }
  if (dtype == 0) return dispatch<float>(a);
  if (dtype == 1) return dispatch<__nv_bfloat16>(a);
  return cudaErrorInvalidValue;
}

// Floats of the scratch an f32 launch (dtype 0, dh 32 or 64) needs: each
// row's lse, and the partial sums of the key segments it cuts the keys into
// (0 for bf16).
extern "C" long long deform_attn_fwd_work(int dtype, int BG, int N, int J, int DH) {
  if (dtype != 0 || (DH != 32 && DH != 64)) return 0;
  return static_cast<long long>(tf32::fwd_work_of(BG, N, J, DH).total);
}
