// Attention backward for sm_90a, recompute form, key-tiled.  For
//
//   p = softmax_j(mask(q . k_j + bias_j)),  out = (p * m) @ v
//
// with m the dropout multiplier {0, 1/keep} (philox.cuh; m = 1 when keep == 1),
// and dout given, it returns
//
//   dv = (p * m)^T dout          dp = (dout v^T) * m
//   ds = p * (dp - delta),  delta = sum_j dp p,  zeroed at every masked pair
//   dbias = ds,  dq = ds @ k,  dk = ds^T q
//
// Replaces the Pallas kernel _fused_attn_bwd_call (sml_tpu/ops/pallas/
// deform_attn.py, body _attn_bwd_kernel) in every compiled form: with or
// without the bias (no dbias then), the span mask (attn_common.cuh, SpanMask;
// the cotangent is zeroed at every masked pair, whole uniform rows included)
// and dropout.  Nothing of the (BG, N, J) chain is saved from the forward or
// goes to device memory (dbias aside, which is an output): both kernels
// recompute it.  As in the Pallas kernel, ds is rounded to q's dtype before dq
// and dk, and p * m to v's dtype before dv; every sum is in f32.
//
// The TPU kernel sums dk and dv over the row tiles along a sequential grid
// axis.  Blocks on the H100 run in parallel, so the work is split in two
// kernels with no atomics (the result repeats bit for bit):
//
// rows kernel, one block per (bg, 64 query rows): pass 1 walks K and V in key
//   tiles with an online max and sum and writes each row's lse = max +
//   log(sum) and delta = sum_j p dp, (BG, N) f32 each; pass 2 walks them
//   again for p = exp(s - lse), ds, dbias and dq.
// keys kernel, one block per (bg, 64 keys), looping over the rows in tiles
//   of 64: it recomputes p from lse, dp and m, then ds = p (dp m - delta),
//   and sums dk and dv for its keys.
//
// What bounds it: about 10 * DH FLOP per pair (five products of 2 * DH each:
// q k^T, dout v^T, (p m)^T dout, ds k, ds^T q) against q, k, v, dout, dq,
// dk, dv read or written once, and 4 bytes of bias and dbias per pair in bf16 in
// the bias form: operations on the tensor cores at the Nystrom chains, bytes
// at the deformable attention's J = 144.  The recompute issues about 18 * DH
// per pair: q k^T and dout v^T three times (pass 1, pass 2, keys kernel); at
// 3xTF32 three tf32 products for each.
//
// bf16, the tensor-core kernels (*_tc): every product is a warp-level
// mma.sync m16n8k16, bf16 operands and f32 sums (mma.cuh); the rows kernel's
// scores, masks, multipliers and pass-1 statistics are the forward's own code
// (attn_tc.cuh, shared with deform_attn.cu's attn_fwd_tc), four warps per
// block, each warp owning 16 query rows (rows kernel) or 16 keys (keys
// kernel).  The streamed operand (K and V, or q and dout) comes through a
// two-stage cp.async ring of swizzled 64 x 64 tiles read with ldmatrix; the
// block's own operand sits in A fragments in registers for the whole kernel.
// The masks, the bias, the Philox multipliers and the softmax run on the
// accumulator fragments in registers.  A 4-key Philox group spans 2 lanes of
// a fragment in the rows kernel, which draws it once per lane and row (half
// of the words go unused: sharing them by shuffle measured slower), and 4
// lanes in the keys kernel's transposed layout, where each lane draws the
// group for one of the rows the four share and passes the keep bits round by
// shuffles (one call per group and row).  ds (rounded to bf16) becomes the A
// operand of the next product without leaving the registers (the
// accumulator-to-A identity of mma.cuh): rows kernel dq += ds k with k from
// the key tile by ldmatrix.trans; keys kernel, in the transposed layout (keys
// x rows), dv += (p m)^T dout and dk += ds^T q, with dout and q by
// ldmatrix.trans.
// The bias comes through shared memory in all three kernels (bf16 and the
// forward's too): its 64 x 64 tile rides in the ring beside the streamed
// operand, copied by 16-byte cp.async at any J (attn_tc.cuh, stage_bias; a
// row of the bias starts at another 16-byte phase unless J % 8 == 0 in bf16,
// J % 4 == 0 in f32, and the tile keeps each row's shift), so the next tile's
// bias is in flight while this one computes.  The keys kernel's fragments
// read it down columns, the rows kernel's along rows; the rows kernel writes
// ds over it in place and stores dbias in whole 16-byte segments, element by
// element only in each row's head and tail segments (store_dbias).  With an
// f32 bias at the 1-D path's J = 625 these bytes bound the backward: 4 bytes a
// pair read three times (both passes of the rows kernel, the keys kernel) and
// 4 of dbias written, against q, k, v, dout and the gradients' 256 bytes a
// row or key.  The keys kernel's q k^T and dout v^T sums run in another order
// than the rows kernel's, so p and ds of the two kernels may differ in the
// last bits; the bf16 gradient tolerance covers it.
// f32, the tf32 tensor-core kernels: at dh = 32 (no bias, span or dropout:
// CMTA's Nystrom chains, BG 64, 128 landmarks against 2560 tokens)
// tf32::attn_bwd_rows_tf32 / attn_bwd_keys_tf32, at dh = 64 (every form: the
// deformable attention's bias with dropout, TransMIL's bias-less and span
// chains, BG 64, 256 landmarks against 2560 or 4352 tokens)
// tf32::attn_bwd_rows_tf32_64 / attn_bwd_keys_tf32_64.  The layout of the
// bf16 kernels (four warps, 16 rows or keys each, the streamed operand
// through a two-stage cp.async ring of swizzled 64 x DH f32 tiles) and the
// TPU kernel's algorithm, ds = p (dp - delta) formed for each pair before dq
// = ds k and dk = ds^T q; in f32 neither ds nor p m is rounded.  At dh = 32
// the block's own operand sits in split A fragments in registers; at dh = 64
// those would take 128 registers (64 unsplit) beside dq's sum, so the
// block's own q and dout (or k and v) sit in shared memory beside the ring,
// each k-step's A fragment read by ldmatrix and split on use (96 KB of
// dynamic shared memory: two blocks an SM), and the f32 bias and dbias are
// read and written by each lane in the accumulator layout, without a staged
// tile (attn_tf32.cuh).  The span mask and dropout are the bf16 kernels' own
// code on the m16n8 accumulators (attn_tc.cuh: drop_pair, keys_keep_bits),
// whose layout tf32's m16n8k8 shares.  Every product is f32-accurate from
// three tf32 mma.sync m16n8k8 (3xTF32, mma.cuh): each operand split as hi +
// lo, both rounded to tf32, and a b = a_lo b_hi + a_hi b_lo + a_hi b_hi: at
// dh = 32 the two small products in one accumulator and the big one in
// another; at dh = 64 all three in one (fewer registers), each operand
// split by truncation in two operations (mma::split_tf32_trunc).  The
// tensor core truncates the sums it carries, so a long sum is never left to
// it: at dh = 32 each 64-row or 64-key tile's products start from zeroed
// accumulators, which are then added to an f32 register sum (kFoldTiles), so
// the tensor core chains at most 8 k-steps of a sum over the long axis; at dh
// = 64, where a tile's dq, dk and dv accumulators do not fit beside the
// rest, every 32 keys (rows kernel) or 16 rows (keys kernel), in two halves
// of 32 columns (tf32::product_fold64).  s, dp, p and
// ds stay in the accumulator fragments; p and ds become A fragments of the
// next product without a shuffle (mma::split_accum: a k index is only a
// position in the sum), B read from the tiles by ldmatrix (s, dp) or by
// 32-bit loads at each lane's precomputed offsets (dq, dk, dv).  exp is the
// library's expf.  At the Nystrom chains one side is thin (128 or 256
// landmark rows or keys: 128 or 256 blocks of 64 on 132 SMs; at dh = 64 also
// the deformable attention's 144 or 256 keys), so its long axis is cut into
// segments (tf32::segments, about 1024 blocks a launch): the rows kernel then
// runs twice, statistics per key segment ((lse, delta) of the segment), then
// gradients per segment after merging the segments' statistics by the max and
// sum rule in segment order; the keys kernel writes dk and dv per row
// segment; the partial sums go to an f32 scratch (deform_attn_bwd_work) and
// tf32::attn_bwd_combine adds them in segment order.  These pieces, the
// rows kernel's statistics walk and the merge of the segments among them,
// live in attn_tf32.cuh, shared with the dh = 32 forward (deform_attn.cu).
//
// Left for later: wgmma and TMA (a warpgroup product of 64-row tiles would
// reach past mma.sync's rate), keeping K and V whole in shared memory when
// J <= 256 (one pass over them for both passes), and taking lse from the
// forward so that pass 1 drops out.  In the tf32 kernels each of the four
// warps splits every element of the streamed tile it reads, and the splits
// and the rest outnumber the mma about 12 to 1 in the SASS: the kernels are
// bound by instruction issue.  Splitting each tile once per block into hi
// and lo tiles gave the same bits but spilled and ran 3% slower (PERF.md).
//
// C entry: deform_attn_bwd(dtype, bias_dtype, q, k, v, bias, span, dout, dq,
//                          dk, dv, dbias, lse, delta, work, BG, N, J, DH,
//                          keep_prob, inv_keep, seed, device, stream)
//          -> cudaGetLastError().
// dtype: 0 = float, 1 = bfloat16 for q, k, v, dout, dq, dk and dv (lse and
// delta: f32 scratch of (BG, N); work: f32 scratch of deform_attn_bwd_work(dtype,
// BG, N, J, DH) floats, null when that is 0); bias_dtype the same codes for bias and
// dbias: dtype's, or 0 with dtype 1 in the form without span and dropout (the
// 1-D deformable attention's f32 bias; any other pair is
// cudaErrorInvalidValue).  bias / dbias and span may be null.  DH is 64, or 32
// with dtype 0 and no bias, span or dropout (any other dh 32 form is
// cudaErrorInvalidValue).

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

// ---- bf16: the tensor-core kernels (shared pieces: attn_tc.cuh) -------------

namespace tc {

// Rows kernel: block (row tile, bg), warp w owns rows row0 + 16 w .. + 15,
// lane (g, t) the rows g and g + 8 of them and, in each n8 tile of keys, the
// columns 2t and 2t + 1.  K and V, and the bias tile of the same keys, stream
// in 64-key tiles through a two-stage cp.async ring, walked twice (pass 1:
// statistics; pass 2: ds, dbias and dq); pass 2 writes ds over the staged bias
// in place, and each warp stores its rows' dbias from there (store_dbias).
// BT: the element type of bias and dbias, bf16 or f32.  Dynamic shared
// memory of bias_smem_bytes<HAS_BIAS, BT>(): the bias stages.
template <bool HAS_BIAS, bool HAS_SPAN, bool DROP, typename BT = bf16>
__global__ void __launch_bounds__(kThreads)
attn_bwd_rows_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const BT* __restrict__ bias,
                 const int* __restrict__ span, const bf16* __restrict__ dout,
                 bf16* __restrict__ dq, BT* __restrict__ dbias, float* __restrict__ lse,
                 float* __restrict__ delta, int N, int J, float keep_prob, float inv_keep,
                 unsigned long long seed) {
  __shared__ __align__(128) bf16 s_kv[2][2][kTile];         // [stage][K, V]
  extern __shared__ __align__(128) unsigned char smem_raw[];
  BT* s_b = reinterpret_cast<BT*>(smem_raw);                  // [stage][kBlock][kBiasLd]
  const int bg = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kBlock, wrow0 = row0 + warp * 16;
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
  auto stage = [&](int it) {
    bf16* skv = s_kv[it & 1][0];
    const int j0 = (it < nt ? it : it - nt) * kBlock;
    stage_pair(kg, vg, skv, skv + kTile, j0, J);
    if (HAS_BIAS)
      stage_bias<BT>(bias, s_b + (it & 1) * kBlock * kBiasLd, bg * N + row0, bg * N + N, j0, J);
    mma::cp_async_commit();
  };
  stage(0);

  uint32_t qa[4][4], oa[4][4];  // this warp's 16 rows of q and dout as A fragments
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    mma::load_a_global(qa[ks], q + (size_t)bg * N * 64, 64, wrow0, N, 16 * ks, lane);
    mma::load_a_global(oa[ks], dout + (size_t)bg * N * 64, 64, wrow0, N, 16 * ks, lane);
  }
  RowStats st;  // pass 1: lane-local statistics, folded over the lane quad at its end
  float lse_r[2] = {0.f, 0.f}, delta_r[2] = {0.f, 0.f};
  float dq_acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[n][e] = 0.f;

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
    if (it == nt) {
      stats_fold<true>(st, lse_r, delta_r);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (col == 0 && row[h] < N) {
          lse[(size_t)bg * N + row[h]] = lse_r[h];
          delta[(size_t)bg * N + row[h]] = delta_r[h];
        }
    }
    const bf16* sk = s_kv[it & 1][0];
    const bf16* sv = s_kv[it & 1][1];
    BT* sb = s_b + (it & 1) * kBlock * kBiasLd;
    BT* const brow[2] = {sb + boff[0], sb + boff[1]};
#pragma unroll
    for (int c0 = 0; c0 < kBlock; c0 += 32) {
      float s[4][4], dp[4][4];
      product_nt(qa, sk, c0, lane, s);
      product_nt(oa, sv, c0, lane, dp);
      // s[i][2h + w], dp[i][2h + w]: row row[h], key j0 + c0 + 8 i + col + w
      mask_scores<HAS_BIAS, HAS_SPAN>(s, brow, even, J, j0, c0, col, mask, uniform);
      if (DROP) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float2 m = drop_pair(seed, j0 + c0 + 8 * i + col, row[h], bg, keep_prob,
                                       inv_keep);
            dp[i][2 * h] *= m.x;
            dp[i][2 * h + 1] *= m.y;
          }
      }
      if (!pass2) {
        stats_update<true>(st, s, dp);
        continue;
      }
      // pass 2: ds (in s; over the staged bias, as dbias), then dq += ds k
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int jt = c0 + 8 * i + col, j = j0 + jt;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int w = 0; w < 2; ++w) {
            float& x = s[i][2 * h + w];
            x = j + w < J && pair_valid<HAS_SPAN>(mask, uniform[h], j + w)
                    ? exp_f(x - lse_r[h]) * (dp[i][2 * h + w] - delta_r[h])
                    : 0.f;
          }
          if (HAS_BIAS) put_pair(brow[h] + jt, s[i][2 * h], s[i][2 * h + 1], even);
        }
      }
#pragma unroll
      for (int kb = 0; kb < 2; ++kb) {
        uint32_t a[4];
        mma::accum_to_a(a, s[2 * kb], s[2 * kb + 1]);
        product_nn(dq_acc, a, sk, c0 + 16 * kb, lane);
      }
    }
    if (HAS_BIAS && pass2) {  // this warp's rows of ds, from the tile (its own lanes wrote them)
      __syncwarp();
      store_dbias(dbias, sb + 16 * warp * kBiasLd, bg * N + wrow0, bg * N + N, j0, J, lane);
    }
    __syncthreads();  // the stage is consumed before the ring refills it
  }
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (row[h] < N)
        *reinterpret_cast<__nv_bfloat162*>(dq + ((size_t)bg * N + row[h]) * 64 + 8 * n + col) =
            __floats2bfloat162_rn(dq_acc[n][2 * h], dq_acc[n][2 * h + 1]);
}

template <bool HAS_BIAS, typename BT>
constexpr size_t keys_smem_bytes() {
  return 2 * 2 * kTile * sizeof(bf16)                           // q, dout stages
         + 2 * 2 * kBlock * sizeof(float)                       // lse, delta stages
         + (HAS_BIAS ? 2 * kBlock * kBiasLd * sizeof(BT) : 0);  // bias stages
}

// Keys kernel: block (key tile, bg), warp w owns keys key0 + 16 w .. + 15 as
// the rows of its products (s^T = k q^T, dp^T = v dout^T), lane (g, t) the
// keys g and g + 8 and, in each n8 tile of query rows, the rows 2t and 2t + 1.
// q, dout, lse, delta (and the bias tile) stream in 64-row tiles through a
// two-stage ring, each tile in four 16-row steps: dv += (p m)^T dout and
// dk += ds^T q, summed over all rows in this block in row order.  The bias
// tile comes by 16-byte cp.async at any J (stage_bias), the fragments reading
// its columns at each row's shift, and the copy of the next tile is in
// flight while this one computes.  With an f32 bias at J = 625 the kernel
// reads 4 bytes of bias a pair from device memory, beside q and dout's 4 (a
// row's 256 bytes once a 64-key block, which the L2 cache can serve).
template <bool HAS_BIAS, bool HAS_SPAN, bool DROP, typename BT = bf16>
__global__ void __launch_bounds__(kThreads)
attn_bwd_keys_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const BT* __restrict__ bias,
                 const int* __restrict__ span, const bf16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 bf16* __restrict__ dk, bf16* __restrict__ dv, int N, int J, float keep_prob,
                 float inv_keep, unsigned long long seed) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* s_q = reinterpret_cast<bf16*>(smem_raw);              // [2][kTile]
  bf16* s_do = s_q + 2 * kTile;                               // [2][kTile]
  float* s_lse = reinterpret_cast<float*>(s_do + 2 * kTile);  // [2][kBlock]
  float* s_dl = s_lse + 2 * kBlock;                           // [2][kBlock]
  BT* s_b = reinterpret_cast<BT*>(s_dl + 2 * kBlock);         // [2][kBlock][kBiasLd]

  const int bg = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int key_blk = blockIdx.x * kBlock;
  const int bcol[2] = {warp * 16 + mma::frag_row(lane, 0), warp * 16 + mma::frag_row(lane, 2)};
  const int key[2] = {key_blk + bcol[0], key_blk + bcol[1]};  // bcol: in the bias tile
  const int col = mma::frag_col(lane, 0);  // of element 0 in an n8 tile; element 1 is next
  const SpanMask mask = load_span<HAS_SPAN>(span, bg, J);
  // the shift of the lane's tile rows rs + 8 i + col + w in a staged bias
  // tile: rs + 8 i and the tile's first row are multiples of 8, so it
  // depends on w alone
  const int bshift[2] = {bias_shift<BT>(bg * N + col, J), bias_shift<BT>(bg * N + col + 1, J)};
  const bf16* qg = q + (size_t)bg * N * 64;
  const bf16* dog = dout + (size_t)bg * N * 64;
  const int nr = (N + kBlock - 1) / kBlock;
  auto stage = [&](int it) {
    const int r0 = it * kBlock, buf = it & 1;
    stage_pair(qg, dog, s_q + buf * kTile, s_do + buf * kTile, r0, N);
    if (HAS_BIAS)
      stage_bias<BT>(bias, s_b + buf * kBlock * kBiasLd, bg * N + r0, bg * N + N, key_blk, J);
    mma::cp_async_commit();
    static_assert(kThreads == 2 * kBlock, "one thread per lse and per delta of a tile");
    const int tr = threadIdx.x & (kBlock - 1);
    const float* src = threadIdx.x < kBlock ? lse : delta;
    float* dst = (threadIdx.x < kBlock ? s_lse : s_dl) + buf * kBlock;
    dst[tr] = r0 + tr < N ? src[(size_t)bg * N + r0 + tr] : 0.f;
  };
  stage(0);

  uint32_t ka[4][4], va[4][4];  // this warp's 16 keys of k and v as A fragments
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    mma::load_a_global(ka[ks], k + (size_t)bg * J * 64, 64, key_blk + 16 * warp, J, 16 * ks,
                       lane);
    mma::load_a_global(va[ks], v + (size_t)bg * J * 64, 64, key_blk + 16 * warp, J, 16 * ks,
                       lane);
  }
  float dk_acc[8][4], dv_acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int it = 0; it < nr; ++it) {
    if (it + 1 < nr) {
      stage(it + 1);
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();
    const int r0 = it * kBlock, buf = it & 1;
    const bf16* sq = s_q + buf * kTile;
    const bf16* sdo = s_do + buf * kTile;
    const float* slse = s_lse + buf * kBlock;
    const float* sdl = s_dl + buf * kBlock;
    const BT* sb = s_b + buf * kBlock * kBiasLd;
#pragma unroll 1  // unrolled, the bias-less form spills
    for (int rs = 0; rs < kBlock; rs += 16) {
      // s^T and dp^T of this warp's 16 keys x rows rs .. rs + 15 of the tile
      float st[2][4], dpt[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[i][e] = dpt[i][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const int at = mma::swz64(rs + (lane & 7) + ((lane >> 4) << 3),
                                  2 * ks + ((lane >> 3) & 1));
        uint32_t b[4];
        mma::ldmatrix_x4(b, mma::smem_u32(sq + at));
        mma::mma_bf16(st[0], ka[ks], b[0], b[1]);
        mma::mma_bf16(st[1], ka[ks], b[2], b[3]);
        mma::ldmatrix_x4(b, mma::smem_u32(sdo + at));
        mma::mma_bf16(dpt[0], va[ks], b[0], b[1]);
        mma::mma_bf16(dpt[1], va[ks], b[2], b[3]);
      }
      // st[i][2h + w]: key key[h], row r0 + rs + 8 i + col + w; -> p m and ds.
      // Bit 4 h + 2 i + w of kept: that pair's keep decision (keys_keep_bits).
      const uint32_t kept =
          DROP ? keys_keep_bits(seed, key, r0 + rs, col, bg, keep_prob, lane) : 0u;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int w = 0; w < 2; ++w) {
          const int rl = rs + 8 * i + col + w;
          const int r = r0 + rl;
          const bool uni = HAS_SPAN && mask.uniform(r);
          const BT* brow = sb + rl * kBiasLd + bshift[w];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int j = key[h];
            float pd = 0.f, ds = 0.f;
            if (r < N && j < J) {
              float x = st[i][2 * h + w];
              if (HAS_BIAS) x += bias_f32(brow[bcol[h]]);
              const float p = exp_f(mask_score<HAS_SPAN>(x, mask, uni, j) - slse[rl]);
              const float m =
                  !DROP ? 1.f : ((kept >> (4 * h + 2 * i + w)) & 1u ? inv_keep : 0.f);
              pd = p * m;
              if (pair_valid<HAS_SPAN>(mask, uni, j))
                ds = p * (dpt[i][2 * h + w] * m - sdl[rl]);
            }
            st[i][2 * h + w] = pd;
            dpt[i][2 * h + w] = ds;
          }
        }
      uint32_t pa[4], da[4];
      mma::accum_to_a(pa, st[0], st[1]);
      mma::accum_to_a(da, dpt[0], dpt[1]);
      product_nn(dv_acc, pa, sdo, rs, lane);
      product_nn(dk_acc, da, sq, rs, lane);
    }
    __syncthreads();  // the stage is consumed before the ring refills it
  }
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (key[h] < J) {
        const size_t at = ((size_t)bg * J + key[h]) * 64 + 8 * n + col;
        *reinterpret_cast<__nv_bfloat162*>(dk + at) =
            __floats2bfloat162_rn(dk_acc[n][2 * h], dk_acc[n][2 * h + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dv + at) =
            __floats2bfloat162_rn(dv_acc[n][2 * h], dv_acc[n][2 * h + 1]);
      }
}

}  // namespace tc

// ---- f32 dh = 32: the tf32 tensor-core kernels (3xTF32, attn_tf32.cuh) -------

namespace tf32 {

// Rows kernel: block (row tile, bg, key segment), warp w owns rows row0 + 16 w
// .. + 15 (q and dout as split A fragments in registers), lane (g, t) the
// rows g and g + 8 and, in each n8 tile of keys, the columns 2t and 2t + 1.
// K and V stream through a two-stage cp.async ring of swizzled 64-key tiles.
//   STATS: walk the segment's keys for each row's max, sum of exp and sum of
//     exp * dp (stats_tile, the forward's walk too); with GRAD (one segment)
//     fold them into lse and delta and walk the keys again; alone, write the
//     segment's (lse, delta) to part.
//   GRAD: (alone: merge the segments' (lse, delta) from part, by the max and
//     sum rule in segment order, merge_segments; segment 0 writes lse and
//     delta) per pair
//     p = exp(s - lse), ds = p (dp - delta), then dq += ds k over the
//     segment's keys, written to dq_out + seg * seg_stride.
template <bool STATS, bool GRAD>
__global__ void __launch_bounds__(kThreads)
attn_bwd_rows_tf32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ dout,
                   float* __restrict__ dq_out, size_t seg_stride, float* __restrict__ lse,
                   float* __restrict__ delta, float2* __restrict__ part, int N, int J,
                   int seg_tiles) {
  static_assert(STATS || GRAD, "a pass to run");
  __shared__ __align__(128) float s_kv[2][2][kTileF];  // [stage][K, V]
  const int bg = blockIdx.y, seg = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wrow0 = blockIdx.x * kBlock + warp * 16;
  const int row[2] = {wrow0 + (lane >> 2), wrow0 + (lane >> 2) + 8};
  const int col = 2 * (lane & 3);  // of element 0 in an n8 tile; element 1 is next
  const int t0 = seg * seg_tiles;
  const int nt = min(seg_tiles, (J + kBlock - 1) / kBlock - t0);
  constexpr int kPasses = (STATS ? 1 : 0) + (GRAD ? 1 : 0);
  const float* kg = k + (size_t)bg * J * kDH;
  const float* vg = v + (size_t)bg * J * kDH;
  auto stage = [&](int it) {
    stage_pair(kg, vg, s_kv[it & 1][0], s_kv[it & 1][1], (t0 + it % nt) * kBlock, J);
    mma::cp_async_commit();
  };
  stage(0);

  const Offsets off(lane);
  uint32_t qh[4][4], ql[4][4], oh[4][4], ol[4][4];
  load_a(qh, ql, q + (size_t)bg * N * kDH, wrow0, N, lane);
  load_a(oh, ol, dout + (size_t)bg * N * kDH, wrow0, N, lane);
  float lse_r[2] = {0.f, 0.f}, delta_r[2] = {0.f, 0.f};
  if (!STATS) {
    merge_segments<true>(part, N, row, lse_r, delta_r);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (seg == 0 && col == 0 && row[h] < N) {
        lse[(size_t)bg * N + row[h]] = lse_r[h];
        delta[(size_t)bg * N + row[h]] = delta_r[h];
      }
  }
  tc::RowStats st;
  float dq_sum[4][4], dq_acc[4][4], dq_small[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_sum[n][e] = dq_acc[n][e] = dq_small[n][e] = 0.f;

  for (int it = 0; it < kPasses * nt; ++it) {
    if (it + 1 < kPasses * nt) {
      stage(it + 1);
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();
    const bool grad = GRAD && (!STATS || it >= nt);
    if (STATS && GRAD && it == nt) {
      tc::stats_fold<true, true>(st, lse_r, delta_r);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (col == 0 && row[h] < N) {
          lse[(size_t)bg * N + row[h]] = lse_r[h];
          delta[(size_t)bg * N + row[h]] = delta_r[h];
        }
    }
    const float* sk = s_kv[it & 1][0];
    const float* sv = s_kv[it & 1][1];
    const int j0 = (t0 + it % nt) * kBlock;
    if (!grad) {
      stats_tile<true>(st, qh, ql, oh, ol, sk, sv, j0, J, col, off);
      __syncthreads();  // the stage is consumed before the ring refills it
      continue;
    }
#pragma unroll
    for (int c0 = 0; c0 < kBlock; c0 += 32) {
      float s[4][4], dp[4][4];
      product_nt<4>(qh, ql, sk, c0, off, s);
      product_nt<4>(oh, ol, sv, c0, off, dp);
      // s[i][2h + w], dp[i][2h + w]: row row[h], key j0 + c0 + 8 i + col + w
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          s[i][e] = j0 + c0 + 8 * i + col + (e & 1) < J
                        ? expf(s[i][e] - lse_r[h]) * (dp[i][e] - delta_r[h])
                        : 0.f;
        }
        uint32_t ah[4], al[4];
        mma::split_accum(ah, al, s[i]);
        product_nn(dq_acc, dq_small, ah, al, sk, c0 + 8 * i, off);
      }
    }
    if (kFoldTiles) fold(dq_sum, dq_acc, dq_small);
    __syncthreads();  // the stage is consumed before the ring refills it
  }
  if (STATS && !GRAD) {
    tc::stats_fold<true, true>(st, lse_r, delta_r);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (col == 0 && row[h] < N)
        part[((size_t)seg * gridDim.y + bg) * N + row[h]] = make_float2(lse_r[h], delta_r[h]);
  }
  if (GRAD) {
    fold(dq_sum, dq_acc, dq_small);
    store_rows(dq_out + seg * seg_stride + (size_t)bg * N * kDH, dq_sum, wrow0, N, lane);
  }
}

// Keys kernel: block (key tile, bg, row segment), warp w owns keys key0 +
// 16 w .. + 15 (k and v as split A fragments) as the rows of its products
// (s^T = k q^T, dp^T = v dout^T), lane (g, t) the keys g and g + 8 and, in
// each n8 tile of query rows, the rows 2t and 2t + 1.  q, dout, lse and delta
// stream in 64-row tiles through a two-stage ring, each tile in four 16-row
// steps: p = exp(s - lse), ds = p (dp - delta), dv += p^T dout and dk +=
// ds^T q over the segment's rows in row order, written to dk_out / dv_out +
// seg * seg_stride.
__global__ void __launch_bounds__(kThreads)
attn_bwd_keys_tf32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   float* __restrict__ dk_out, float* __restrict__ dv_out, size_t seg_stride,
                   int N, int J, int seg_tiles) {
  __shared__ __align__(128) float s_qo[2][2][kTileF];  // [stage][q, dout]
  __shared__ float s_ld[2][2][kBlock];                 // [stage][lse, delta]
  const int bg = blockIdx.y, seg = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kw0 = blockIdx.x * kBlock + warp * 16;
  const int key[2] = {kw0 + (lane >> 2), kw0 + (lane >> 2) + 8};
  const int col = 2 * (lane & 3);  // of element 0 in an n8 tile of rows; element 1 is next
  const int t0 = seg * seg_tiles;
  const int nt = min(seg_tiles, (N + kBlock - 1) / kBlock - t0);
  const float* qg = q + (size_t)bg * N * kDH;
  const float* dog = dout + (size_t)bg * N * kDH;
  auto stage = [&](int it) {
    const int r0 = (t0 + it) * kBlock, buf = it & 1;
    stage_pair(qg, dog, s_qo[buf][0], s_qo[buf][1], r0, N);
    mma::cp_async_commit();
    static_assert(kThreads == 2 * kBlock, "one thread per lse and per delta of a tile");
    const int tr = threadIdx.x & (kBlock - 1), which = threadIdx.x >> 6;
    const float* src = which ? delta : lse;
    s_ld[buf][which][tr] = r0 + tr < N ? src[(size_t)bg * N + r0 + tr] : 0.f;
  };
  stage(0);

  const Offsets off(lane);
  uint32_t kh[4][4], kl[4][4], vh[4][4], vl[4][4];
  load_a(kh, kl, k + (size_t)bg * J * kDH, kw0, J, lane);
  load_a(vh, vl, v + (size_t)bg * J * kDH, kw0, J, lane);
  float dk_sum[4][4], dv_sum[4][4], dk_acc[4][4], dv_acc[4][4], dk_small[4][4], dv_small[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      dk_sum[n][e] = dv_sum[n][e] = dk_acc[n][e] = dv_acc[n][e] = dk_small[n][e] =
          dv_small[n][e] = 0.f;

  for (int it = 0; it < nt; ++it) {
    if (it + 1 < nt) {
      stage(it + 1);
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();
    const int r0 = (t0 + it) * kBlock, buf = it & 1;
    const float* sq = s_qo[buf][0];
    const float* sdo = s_qo[buf][1];
    const float* slse = s_ld[buf][0];
    const float* sdl = s_ld[buf][1];
#pragma unroll 2  // 7% faster than 1 at CMTA's chains; 4 would pass 255 registers
    for (int rs = 0; rs < kBlock; rs += 16) {
      float st[2][4], dpt[2][4];
      product_nt<2>(kh, kl, sq, rs, off, st);
      product_nt<2>(vh, vl, sdo, rs, off, dpt);
      // st[i][2h + w]: key key[h], row r0 + rs + 8 i + col + w; -> p (in st), ds (in dpt)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rl = rs + 8 * i + col + (e & 1);
          float p = 0.f, ds = 0.f;
          if (r0 + rl < N && key[e >> 1] < J) {
            p = expf(st[i][e] - slse[rl]);
            ds = p * (dpt[i][e] - sdl[rl]);
          }
          st[i][e] = p;
          dpt[i][e] = ds;
        }
        uint32_t ah[4], al[4];
        mma::split_accum(ah, al, st[i]);
        product_nn(dv_acc, dv_small, ah, al, sdo, rs + 8 * i, off);
        mma::split_accum(ah, al, dpt[i]);
        product_nn(dk_acc, dk_small, ah, al, sq, rs + 8 * i, off);
      }
    }
    if (kFoldTiles) {
      fold(dk_sum, dk_acc, dk_small);
      fold(dv_sum, dv_acc, dv_small);
    }
    __syncthreads();  // the stage is consumed before the ring refills it
  }
  fold(dk_sum, dk_acc, dk_small);
  fold(dv_sum, dv_acc, dv_small);
  store_rows(dk_out + seg * seg_stride + (size_t)bg * J * kDH, dk_sum, kw0, J, lane);
  store_rows(dv_out + seg * seg_stride + (size_t)bg * J * kDH, dv_sum, kw0, J, lane);
}

// ---- f32 dh = 64: every form, on the tf32 tensor cores ----------------------
//
// Rows kernel: block (row tile, bg, key segment), warp w owns rows row0 + 16 w
// .. + 15 of the block's q and dout tiles (staged once), lane (g, t) the rows
// g and g + 8 and, in each n8 tile of keys, the columns 2t and 2t + 1.  K and
// V stream through a two-stage cp.async ring of swizzled 64-key tiles,
// walked per 32-key half:
//   s = mask(q k^T + bias), dp = (dout v^T) * m     (the lane's bias pairs
//       loaded from device memory before the products; the span mask and
//       the bf16 rows kernel's drop_pair on the m16n8k8 accumulators)
//   STATS: fold s (and dp) into each row's running max, sum of exp and sum of
//     exp * dp; with GRAD (one segment) fold them into lse and delta and walk
//     the keys again; alone, write the segment's (lse, delta) to part.
//   GRAD: (alone: merge the segments' (lse, delta) from part, in segment
//     order; segment 0 writes lse and delta) ds = p (dp - delta) for each
//     valid pair (p = exp(s - lse)), stored as dbias, then dq += ds k, per
//     32-key half on zeroed accumulators folded into an f32 register sum; dq
//     to dq_out + seg * seg_stride.
// Both dh = 64 kernels are bounded for two blocks an SM, which their shared
// memory allows: without the minimum, ptxas holds some instantiations to
// fewer registers and spills (PERF.md; profile_attn_bwd.py --variant
// oneblock64).
template <bool HAS_BIAS, bool HAS_SPAN, bool DROP, bool STATS, bool GRAD>
__global__ void __launch_bounds__(kThreads, 2)
attn_bwd_rows_tf32_64(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ bias,
                      const int* __restrict__ span, const float* __restrict__ dout,
                      float* __restrict__ dq_out, size_t seg_stride, float* __restrict__ dbias,
                      float* __restrict__ lse, float* __restrict__ delta,
                      float2* __restrict__ part, int N, int J, int seg_tiles, float keep_prob,
                      float inv_keep, unsigned long long seed) {
  static_assert(STATS || GRAD, "a pass to run");
  extern __shared__ __align__(128) float smem64[];
  float* s_kv = smem64;                    // [stage][K, V][kTile64]
  float* s_q = smem64 + 4 * kTile64;       // the block's q, then dout
  const float* s_do = s_q + kTile64;
  const int bg = blockIdx.y, seg = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kBlock, wrow0 = row0 + warp * 16;
  const int row[2] = {wrow0 + (lane >> 2), wrow0 + (lane >> 2) + 8};
  const int col = 2 * (lane & 3);  // of element 0 in an n8 tile; element 1 is next
  const int t0 = seg * seg_tiles;
  const int nt = min(seg_tiles, (J + kBlock - 1) / kBlock - t0);
  constexpr int kPasses = (STATS ? 1 : 0) + (GRAD ? 1 : 0);
  const attn::SpanMask mask = attn::load_span<HAS_SPAN>(span, bg, J);
  const bool uniform[2] = {HAS_SPAN && mask.uniform(row[0]), HAS_SPAN && mask.uniform(row[1])};
  const bool in_bag[2] = {row[0] < N, row[1] < N};
  const float* kg = k + (size_t)bg * J * kDH64;
  const float* vg = v + (size_t)bg * J * kDH64;
  // the lane's two rows of the bias and dbias (a row past the bag: never read)
  const size_t brow[2] = {((size_t)bg * N + (in_bag[0] ? row[0] : 0)) * J,
                          ((size_t)bg * N + (in_bag[1] ? row[1] : 0)) * J};
  const bool even = !(J & 1);
  stage_pair64(q + (size_t)bg * N * kDH64, dout + (size_t)bg * N * kDH64, s_q, s_q + kTile64,
               row0, N);
  auto stage = [&](int it) {
    const int buf = it & 1, j0 = (t0 + it % nt) * kBlock;
    stage_pair64(kg, vg, s_kv + 2 * buf * kTile64, s_kv + (2 * buf + 1) * kTile64, j0, J);
    mma::cp_async_commit();
  };
  stage(0);

  const Offsets64 off(lane, warp);
  float lse_r[2] = {0.f, 0.f}, delta_r[2] = {0.f, 0.f};
  if (!STATS) {
    merge_segments<true>(part, N, row, lse_r, delta_r);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (seg == 0 && col == 0 && in_bag[h]) {
        lse[(size_t)bg * N + row[h]] = lse_r[h];
        delta[(size_t)bg * N + row[h]] = delta_r[h];
      }
  }
  tc::RowStats st;
  float dq_sum[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_sum[n][e] = 0.f;

  for (int it = 0; it < kPasses * nt; ++it) {
    if (it + 1 < kPasses * nt) {
      stage(it + 1);
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();
    const bool grad = GRAD && (!STATS || it >= nt);
    if (STATS && GRAD && it == nt) {
      tc::stats_fold<true, true>(st, lse_r, delta_r);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (col == 0 && in_bag[h]) {
          lse[(size_t)bg * N + row[h]] = lse_r[h];
          delta[(size_t)bg * N + row[h]] = delta_r[h];
        }
    }
    const int buf = it & 1, j0 = (t0 + it % nt) * kBlock;
    const float* sk = s_kv + 2 * buf * kTile64;
    const float* sv = sk + kTile64;
    // the 32-key halves that hold a key (a half past J adds only zeros), for
    // a warp that holds a row (rows past N are never stored): the last tile
    // of J = 144 holds 16 keys (PERF.md; --variant allhalves64)
    const int c_end = wrow0 < N ? min(kBlock, J - j0) : 0;
#pragma unroll 1
    for (int c0 = 0; c0 < c_end; c0 += 32) {
      // s[i][2h + w], dp[i][2h + w]: row row[h], key j0 + c0 + 8 i + col + w;
      // the forward's score code, with dp's product before the mask
      float2 b[4][2];
      if (HAS_BIAS) bias_pairs64(b, bias, brow, in_bag, j0 + c0, col, J, even);
      float s[4][4], dp[4][4];
      product_nt64<4>(s_q, sk, c0, off, s);
      product_nt64<4>(s_do, sv, c0, off, dp);
      mask_scores64<HAS_BIAS, HAS_SPAN>(s, b, mask, uniform, j0 + c0, col, J);
      if (DROP) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float2 m = tc::drop_pair(seed, j0 + c0 + 8 * i + col, row[h], bg, keep_prob,
                                           inv_keep);
            dp[i][2 * h] *= m.x;
            dp[i][2 * h + 1] *= m.y;
          }
      }
      if (!grad) {
        tc::stats_update<true, true>(st, s, dp);
        continue;
      }
      // ds (in s; stored as dbias), then dq += ds k
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = j0 + c0 + 8 * i + col;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int w = 0; w < 2; ++w) {
            float& x = s[i][2 * h + w];
            x = j + w < J && attn::pair_valid<HAS_SPAN>(mask, uniform[h], j + w)
                    ? expf(x - lse_r[h]) * (dp[i][2 * h + w] - delta_r[h])
                    : 0.f;
          }
          if (HAS_BIAS && in_bag[h])
            store_pair64(dbias + brow[h], j, J, even, s[i][2 * h], s[i][2 * h + 1]);
        }
      }
      product_fold64<4>(dq_sum, s, sk, c0, off);
    }
    __syncthreads();  // the stage is consumed before the ring refills it
  }
  if (STATS && !GRAD) {
    tc::stats_fold<true, true>(st, lse_r, delta_r);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (col == 0 && in_bag[h])
        part[((size_t)seg * gridDim.y + bg) * N + row[h]] = make_float2(lse_r[h], delta_r[h]);
  }
  if (GRAD)
    store_rows64(dq_out + seg * seg_stride + (size_t)bg * N * kDH64, dq_sum, wrow0, N, lane);
}

// Keys kernel: block (key tile, bg, row segment), warp w owns keys key0 + 16 w
// .. + 15 of the block's k and v tiles (staged once) as the rows of its
// products (s^T = k q^T, dp^T = v dout^T), lane (g, t) the keys g and g + 8
// and, in each n8 tile of query rows, the rows 2t and 2t + 1.  q, dout, lse
// and delta stream in 64-row tiles through a two-stage ring, each tile in
// four 16-row steps: p = exp(mask(s + bias) - lse) (the lane's bias elements
// loaded from device memory before the products), m, ds = p (dp m - delta),
// then dv += (p m)^T dout and dk += ds^T q, each on zeroed accumulators
// folded into an f32 register sum, over the segment's rows in row order,
// written to dk_out / dv_out + seg * seg_stride.
template <bool HAS_BIAS, bool HAS_SPAN, bool DROP>
__global__ void __launch_bounds__(kThreads, 2)
attn_bwd_keys_tf32_64(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ bias,
                      const int* __restrict__ span, const float* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      float* __restrict__ dk_out, float* __restrict__ dv_out, size_t seg_stride,
                      int N, int J, int seg_tiles, float keep_prob, float inv_keep,
                      unsigned long long seed) {
  extern __shared__ __align__(128) float smem64[];
  float* s_qo = smem64;                 // [stage][q, dout][kTile64]
  float* s_k = smem64 + 4 * kTile64;    // the block's k, then v
  const float* s_v = s_k + kTile64;
  float* s_ld = s_k + 2 * kTile64;      // [stage][lse, delta][kBlock]
  const int bg = blockIdx.y, seg = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int key_blk = blockIdx.x * kBlock, kw0 = key_blk + warp * 16;
  const int key[2] = {kw0 + (lane >> 2), kw0 + (lane >> 2) + 8};
  const int col = 2 * (lane & 3);  // of element 0 in an n8 tile of rows; element 1 is next
  const attn::SpanMask mask = attn::load_span<HAS_SPAN>(span, bg, J);
  const int t0 = seg * seg_tiles;
  const int nt = min(seg_tiles, (N + kBlock - 1) / kBlock - t0);
  const float* qg = q + (size_t)bg * N * kDH64;
  const float* dog = dout + (size_t)bg * N * kDH64;
  const float* bias_bg = HAS_BIAS ? bias + (size_t)bg * N * J : nullptr;
  stage_pair64(k + (size_t)bg * J * kDH64, v + (size_t)bg * J * kDH64, s_k, s_k + kTile64,
               key_blk, J);
  auto stage = [&](int it) {
    const int r0 = (t0 + it) * kBlock, buf = it & 1;
    stage_pair64(qg, dog, s_qo + 2 * buf * kTile64, s_qo + (2 * buf + 1) * kTile64, r0, N);
    mma::cp_async_commit();
    static_assert(kThreads == 2 * kBlock, "one thread per lse and per delta of a tile");
    const int tr = threadIdx.x & (kBlock - 1), which = threadIdx.x >> 6;
    const float* src = which ? delta : lse;
    s_ld[(2 * buf + which) * kBlock + tr] = r0 + tr < N ? src[(size_t)bg * N + r0 + tr] : 0.f;
  };
  stage(0);

  const Offsets64 off(lane, warp);
  float dk_sum[8][4], dv_sum[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_sum[n][e] = dv_sum[n][e] = 0.f;

  for (int it = 0; it < nt; ++it) {
    if (it + 1 < nt) {
      stage(it + 1);
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();
    const int r0 = (t0 + it) * kBlock, buf = it & 1;
    const float* sq = s_qo + 2 * buf * kTile64;
    const float* sdo = sq + kTile64;
    const float* slse = s_ld + 2 * buf * kBlock;
    const float* sdl = slse + kBlock;
    // every 16-row step, also past N or for a warp past J: skipping them (a
    // runtime trip count) slowed the Nystrom chains (PERF.md; --variant
    // skiprows64)
#pragma unroll 1
    for (int rs = 0; rs < kBlock; rs += 16) {
      // st[i][2h + w], dpt[i][2h + w]: key key[h], row r0 + rs + 8 i + col + w
      float b[2][4];
      if (HAS_BIAS) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = r0 + rs + 8 * i + col + (e & 1), j = key[e >> 1];
            b[i][e] = r < N && j < J ? bias_bg[(size_t)r * J + j] : 0.f;
          }
      }
      float st[2][4], dpt[2][4];
      product_nt64<2>(s_k, sq, rs, off, st);
      product_nt64<2>(s_v, sdo, rs, off, dpt);
      // -> p m (in st), ds (in dpt); bit 4 h + 2 i + w of kept: that pair's keep
      const uint32_t kept =
          DROP ? tc::keys_keep_bits(seed, key, r0 + rs, col, bg, keep_prob, lane) : 0u;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int w = 0; w < 2; ++w) {
          const int rl = rs + 8 * i + col + w;
          const int r = r0 + rl;
          const bool uni = HAS_SPAN && mask.uniform(r);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int j = key[h];
            float pd = 0.f, ds = 0.f;
            if (r < N && j < J) {
              float x = st[i][2 * h + w];
              if (HAS_BIAS) x += b[i][2 * h + w];
              const float p = expf(attn::mask_score<HAS_SPAN>(x, mask, uni, j) - slse[rl]);
              const float m =
                  !DROP ? 1.f : ((kept >> (4 * h + 2 * i + w)) & 1u ? inv_keep : 0.f);
              pd = p * m;
              if (attn::pair_valid<HAS_SPAN>(mask, uni, j))
                ds = p * (dpt[i][2 * h + w] * m - sdl[rl]);
            }
            st[i][2 * h + w] = pd;
            dpt[i][2 * h + w] = ds;
          }
        }
      product_fold64<2>(dv_sum, st, sdo, rs, off);
      product_fold64<2>(dk_sum, dpt, sq, rs, off);
    }
    __syncthreads();  // the stage is consumed before the ring refills it
  }
  store_rows64(dk_out + seg * seg_stride + (size_t)bg * J * kDH64, dk_sum, kw0, J, lane);
  store_rows64(dv_out + seg * seg_stride + (size_t)bg * J * kDH64, dv_sum, kw0, J, lane);
}

// The scratch of an f32 launch (dh = 32 or 64), in floats: the rows kernel's
// (lse, delta) and dq partials when it cuts the keys into segments, and the
// keys kernel's dk and dv partials when it cuts the rows.
struct Work {
  int rows_seg, rows_per, keys_seg, keys_per;
  size_t stats, dq, kv, total;  // offsets and size, in floats
};

inline Work work_of(int BG, int N, int J, int DH) {
  Work w{};
  const int nti = (N + kBlock - 1) / kBlock, ntj = (J + kBlock - 1) / kBlock;
  w.rows_seg = segments(nti * BG, ntj, w.rows_per);
  w.keys_seg = segments(ntj * BG, nti, w.keys_per);
  const size_t rows = (size_t)BG * N, keys = (size_t)BG * J;
  w.stats = 0;
  w.dq = w.rows_seg > 1 ? (2 * w.rows_seg * rows + 3) / 4 * 4 : 0;
  w.kv = w.dq + (w.rows_seg > 1 ? (size_t)w.rows_seg * rows * DH : 0);
  w.total = w.kv + (w.keys_seg > 1 ? (size_t)w.keys_seg * 2 * keys * DH : 0);
  return w;
}

}  // namespace tf32

namespace {

struct Args {
  const void *q, *k, *v, *bias;
  const int* span;
  const void* dout;
  void *dq, *dk, *dv, *dbias;
  float *lse, *delta, *work;
  int BG, N, J;
  float keep_prob, inv_keep;
  unsigned long long seed;
  cudaStream_t stream;
};

template <bool HAS_BIAS, bool HAS_SPAN, bool DROP, typename BT = tc::bf16>
cudaError_t launch_tc(const Args& a) {
  using tc::bf16;
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  const BT* bias = static_cast<const BT*>(a.bias);
  const bf16* dout = static_cast<const bf16*>(a.dout);
  auto rows = tc::attn_bwd_rows_tc<HAS_BIAS, HAS_SPAN, DROP, BT>;
  constexpr int rows_smem = static_cast<int>(tc::bias_smem_bytes<HAS_BIAS, BT>());
  cudaError_t err =
      cudaFuncSetAttribute(rows, cudaFuncAttributeMaxDynamicSharedMemorySize, rows_smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(rows, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  rows<<<dim3((a.N + tc::kBlock - 1) / tc::kBlock, a.BG), tc::kThreads, rows_smem,
         a.stream>>>(
      q, k, v, bias, a.span, dout, static_cast<bf16*>(a.dq), static_cast<BT*>(a.dbias),
      a.lse, a.delta, a.N, a.J, a.keep_prob, a.inv_keep, a.seed);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto keys = tc::attn_bwd_keys_tc<HAS_BIAS, HAS_SPAN, DROP, BT>;
  constexpr int keys_smem = static_cast<int>(tc::keys_smem_bytes<HAS_BIAS, BT>());
  err = cudaFuncSetAttribute(keys, cudaFuncAttributeMaxDynamicSharedMemorySize, keys_smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(keys, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  keys<<<dim3((a.J + tc::kBlock - 1) / tc::kBlock, a.BG), tc::kThreads, keys_smem,
         a.stream>>>(q, k, v, bias, a.span, dout, a.lse, a.delta, static_cast<bf16*>(a.dk),
                     static_cast<bf16*>(a.dv), a.N, a.J, a.keep_prob, a.inv_keep, a.seed);
  return cudaGetLastError();
}

template <typename K>
cudaError_t max_shared(K kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// max_shared, and `bytes` of dynamic shared memory allowed
template <typename K>
cudaError_t dyn_shared(K kernel, int bytes) {
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  return err != cudaSuccess ? err : max_shared(kernel);
}

// out0 (and out1, n_out 2) = the sums in segment order of S segments' partial
// sums of n floats each (tf32::attn_bwd_combine)
cudaError_t combine(const Args& a, const float* part_sums, int S, size_t n, int n_out,
                    float* out0, float* out1) {
  const size_t total = n / 4 * n_out;
  const unsigned blocks = (unsigned)std::min<size_t>((total + 255) / 256, 8 * 132);
  tf32::attn_bwd_combine<<<blocks, 256, 0, a.stream>>>(
      reinterpret_cast<const float4*>(part_sums), S, n / 4, n_out,
      reinterpret_cast<float4*>(out0), reinterpret_cast<float4*>(out1));
  return cudaGetLastError();
}

// The f32 dh = 32 form on the tf32 tensor cores: rows kernel (one launch, or
// statistics then gradients over key segments), keys kernel, then the sums
// of the segments' partials.
cudaError_t launch_tf32(const Args& a) {
  using tf32::kBlock;
  using tf32::kDH;
  using tf32::kThreads;
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* dout = static_cast<const float*>(a.dout);
  float* dq = static_cast<float*>(a.dq);
  float* dk = static_cast<float*>(a.dk);
  float* dv = static_cast<float*>(a.dv);
  const tf32::Work w = tf32::work_of(a.BG, a.N, a.J, kDH);
  if (w.total && a.work == nullptr) return cudaErrorInvalidValue;
  const size_t rows = (size_t)a.BG * a.N * kDH, keys = (size_t)a.BG * a.J * kDH;
  const dim3 rows_grid((a.N + kBlock - 1) / kBlock, a.BG, w.rows_seg);
  const dim3 keys_grid((a.J + kBlock - 1) / kBlock, a.BG, w.keys_seg);
  float2* part = reinterpret_cast<float2*>(a.work + w.stats);
  cudaError_t err;
  if (w.rows_seg == 1) {
    auto fused = tf32::attn_bwd_rows_tf32<true, true>;
    if ((err = max_shared(fused)) != cudaSuccess) return err;
    fused<<<rows_grid, kThreads, 0, a.stream>>>(q, k, v, dout, dq, 0, a.lse, a.delta, nullptr,
                                                a.N, a.J, w.rows_per);
  } else {
    auto stats = tf32::attn_bwd_rows_tf32<true, false>;
    auto grad = tf32::attn_bwd_rows_tf32<false, true>;
    if ((err = max_shared(stats)) != cudaSuccess || (err = max_shared(grad)) != cudaSuccess)
      return err;
    stats<<<rows_grid, kThreads, 0, a.stream>>>(q, k, v, dout, nullptr, 0, a.lse, a.delta,
                                                part, a.N, a.J, w.rows_per);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    grad<<<rows_grid, kThreads, 0, a.stream>>>(q, k, v, dout, a.work + w.dq, rows, a.lse,
                                               a.delta, part, a.N, a.J, w.rows_per);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const bool keys_part = w.keys_seg > 1;
  if ((err = max_shared(tf32::attn_bwd_keys_tf32)) != cudaSuccess) return err;
  tf32::attn_bwd_keys_tf32<<<keys_grid, kThreads, 0, a.stream>>>(
      q, k, v, dout, a.lse, a.delta, keys_part ? a.work + w.kv : dk,
      keys_part ? a.work + w.kv + keys : dv, keys_part ? 2 * keys : 0, a.N, a.J, w.keys_per);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (w.rows_seg > 1 &&
      (err = combine(a, a.work + w.dq, w.rows_seg, rows, 1, dq, nullptr)) != cudaSuccess)
    return err;
  if (keys_part) return combine(a, a.work + w.kv, w.keys_seg, keys, 2, dk, dv);
  return cudaSuccess;
}

// The f32 dh = 64 forms on the tf32 tensor cores: as launch_tf32, with the
// bias (and dbias), the span and dropout
template <bool HAS_BIAS, bool HAS_SPAN, bool DROP>
cudaError_t launch_tf32_64(const Args& a) {
  using tf32::kBlock;
  using tf32::kDH64;
  using tf32::kThreads;
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* bias = static_cast<const float*>(a.bias);
  const float* dout = static_cast<const float*>(a.dout);
  float* dq = static_cast<float*>(a.dq);
  float* dk = static_cast<float*>(a.dk);
  float* dv = static_cast<float*>(a.dv);
  float* dbias = static_cast<float*>(a.dbias);
  const tf32::Work w = tf32::work_of(a.BG, a.N, a.J, kDH64);
  if (w.total && a.work == nullptr) return cudaErrorInvalidValue;
  const size_t rows = (size_t)a.BG * a.N * kDH64, keys = (size_t)a.BG * a.J * kDH64;
  const dim3 rows_grid((a.N + kBlock - 1) / kBlock, a.BG, w.rows_seg);
  const dim3 keys_grid((a.J + kBlock - 1) / kBlock, a.BG, w.keys_seg);
  float2* part = reinterpret_cast<float2*>(a.work + w.stats);
  constexpr int rows_smem = tf32::kRowsSmem64, keys_smem = tf32::kKeysSmem64;
  cudaError_t err;
  if (w.rows_seg == 1) {
    auto fused = tf32::attn_bwd_rows_tf32_64<HAS_BIAS, HAS_SPAN, DROP, true, true>;
    if ((err = dyn_shared(fused, rows_smem)) != cudaSuccess) return err;
    fused<<<rows_grid, kThreads, rows_smem, a.stream>>>(
        q, k, v, bias, a.span, dout, dq, 0, dbias, a.lse, a.delta, nullptr, a.N, a.J,
        w.rows_per, a.keep_prob, a.inv_keep, a.seed);
  } else {
    auto stats = tf32::attn_bwd_rows_tf32_64<HAS_BIAS, HAS_SPAN, DROP, true, false>;
    auto grad = tf32::attn_bwd_rows_tf32_64<HAS_BIAS, HAS_SPAN, DROP, false, true>;
    if ((err = dyn_shared(stats, rows_smem)) != cudaSuccess ||
        (err = dyn_shared(grad, rows_smem)) != cudaSuccess)
      return err;
    stats<<<rows_grid, kThreads, rows_smem, a.stream>>>(
        q, k, v, bias, a.span, dout, nullptr, 0, nullptr, a.lse, a.delta, part, a.N, a.J,
        w.rows_per, a.keep_prob, a.inv_keep, a.seed);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    grad<<<rows_grid, kThreads, rows_smem, a.stream>>>(
        q, k, v, bias, a.span, dout, a.work + w.dq, rows, dbias, a.lse, a.delta, part, a.N,
        a.J, w.rows_per, a.keep_prob, a.inv_keep, a.seed);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const bool keys_part = w.keys_seg > 1;
  auto keys_kernel = tf32::attn_bwd_keys_tf32_64<HAS_BIAS, HAS_SPAN, DROP>;
  if ((err = dyn_shared(keys_kernel, keys_smem)) != cudaSuccess) return err;
  keys_kernel<<<keys_grid, kThreads, keys_smem, a.stream>>>(
      q, k, v, bias, a.span, dout, a.lse, a.delta, keys_part ? a.work + w.kv : dk,
      keys_part ? a.work + w.kv + keys : dv, keys_part ? 2 * keys : 0, a.N, a.J, w.keys_per,
      a.keep_prob, a.inv_keep, a.seed);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (w.rows_seg > 1 &&
      (err = combine(a, a.work + w.dq, w.rows_seg, rows, 1, dq, nullptr)) != cudaSuccess)
    return err;
  if (keys_part) return combine(a, a.work + w.kv, w.keys_seg, keys, 2, dk, dv);
  return cudaSuccess;
}

// bf16 to the tensor-core kernels, f32 at dh 64 to the tf32 ones
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

extern "C" int deform_attn_bwd(int dtype, int bias_dtype, const void* q, const void* k,
                               const void* v, const void* bias, const void* span,
                               const void* dout, void* dq, void* dk, void* dv, void* dbias,
                               void* lse, void* delta, void* work, int BG, int N, int J,
                               int DH, float keep_prob, float inv_keep,
                               unsigned long long seed, int device, void* stream) {
  // dh 32: the f32 form without bias, span or dropout (CMTA's Nystrom chains)
  const bool dh32 = DH == 32 && dtype == 0 && bias == nullptr && span == nullptr &&
                    !(keep_prob < 1.f);
  if (DH != 64 && !dh32) return cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Args a{q, k, v, bias, static_cast<const int*>(span), dout, dq, dk, dv, dbias,
               static_cast<float*>(lse), static_cast<float*>(delta),
               static_cast<float*>(work), BG, N, J, keep_prob, inv_keep, seed,
               static_cast<cudaStream_t>(stream)};
  if (dh32) return launch_tf32(a);
  if (bias != nullptr && bias_dtype != dtype) {
    // the f32 bias (and dbias) beside bf16 q, k, v: the one form the 1-D path runs
    if (dtype == 1 && bias_dtype == 0 && span == nullptr && !(keep_prob < 1.f))
      return launch_tc<true, false, false, float>(a);
    return cudaErrorInvalidValue;
  }
  if (dtype == 0) return dispatch<float>(a);
  if (dtype == 1) return dispatch<__nv_bfloat16>(a);
  return cudaErrorInvalidValue;
}

// Floats of the scratch an f32 launch (dtype 0, dh 32 or 64) needs beside lse
// and delta: the partial sums of the segments it cuts a thin side's long axis
// into (0 for bf16, and for shapes whose launches cut no axis).
extern "C" long long deform_attn_bwd_work(int dtype, int BG, int N, int J, int DH) {
  if (dtype != 0 || (DH != 32 && DH != 64)) return 0;
  return static_cast<long long>(tf32::work_of(BG, N, J, DH).total);
}
