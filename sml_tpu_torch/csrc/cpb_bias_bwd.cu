// CPB bias backward for sm_90a, recompute form.  For the forward of
// cpb_bias.cu,
//
//   a    = w0x * dx[bg, x*J + j] + w0y * dy[bg, y, j] + b0,  h1 = relu(a)   (dm)
//   z2   = w1^T h1 + b1,  h2 = relu(z2)                                      (dm)
//   bias[bg, y, x*J + j] = w2 . h2 + b2
//
// and g = dbias[bg, y, x*J + j], it returns per pair
//
//   dz2 = [z2 > 0] w2 g    dz1 = [a > 0] (w1 dz2)
//   d_dx += w0x . dz1 (summed over y)    d_dy += w0y . dz1 (summed over x)
//   dw1 += h1 dz2^T, db1 += dz2, dw2 += h2 g, db2 += g,
//   dw0x += dz1 dx, dw0y += dz1 dy, db0 += dz1        (summed over every pair)
//
// Replaces the Pallas kernel _cpb_bwd_call (sml_tpu/ops/pallas/deform_attn.py,
// body _bwd_kernel).  Nothing is saved from the forward: layer 1 and layer 2
// are recomputed in registers, layer 1 with the forward's fmaf order.  No
// (BG, N, J, dm) activation reaches device memory.
//
// What bounds it on the H100: operations, about 6*dm^2 + 16*dm FLOP per pair
// (6656 at dm = 32) against 2 bytes of bf16 dbias (4 of f32); in f32 three
// tf32 products for each of the 6*dm^2 (3xTF32).
//
// Both kernels run one block per (bg, tile of kTile lanes l = x*J + j),
// looping over all H query rows (the TPU kernel's "sr" order recast for
// parallel blocks), so d_dx and the weight gradients stay on chip for the
// whole launch; d_dx is written once.  d_dy and the weight gradients leave as
// per-block partials, (BG, tiles, H, J) and (BG, tiles, dm*dm + 5*dm + 1),
// which the wrapper sums.  No atomics: each pair's w0y . dz1 goes to a shared
// row of the tile's lanes (as four partial sums, one per lane of a quad), and
// after each query row threads over j sum the tile's
// lanes of their j in ascending x (fold_ddy; the row is double-buffered, one
// barrier a row); the weight gradients combine across lanes and warps in a
// fixed order.  So the result repeats bit for bit at every J.
//
// bf16, cpb_bias_bwd_tc: the three dm x dm products on the tensor cores as
// warp-level mma.sync m16n8k16, bf16 operands and f32 sums (mma.cuh).  A warp
// takes 16 pairs of one query row per step as the M dimension; lane (g, t)
// owns pairs g and g + 8 and columns 8n + 2t, 8n + 2t + 1 of every n8 tile n,
// which is at once the A-fragment layout of h1 and the accumulator layout of
// z2 and dh1:
//   - layer 1 in f32 on the CUDA cores, relu(a) rounded to bf16 straight into
//     the A fragments of h1, and z2 = h1 w1 + b1: the forward's own code
//     (cpb_common.cuh, shared with tc::cpb_bias_fwd_tc in cpb_bias.cu), so
//     z2 and its ReLU mask are the forward's bit for bit;
//   - dh1 = dz2 w1^T, with w1 and w1^T held as B fragments in registers for
//     the whole launch;
//   - dz2 = [z2 > 0] w2 g in f32, rounded to bf16 as an A fragment
//     (accum_to_a);
//   - dz1 = [h1 > 0] dh1 element for element, no shuffle: the mask is read
//     from the h1 fragment, whose elements are dh1's;
//   - dw1 += h1^T dz2 over K = the step's 16 pairs, with the fragments of h1
//     and dz2 transposed in registers (movmatrix) and the dm x dm f32 sum in
//     registers for the whole launch.
// Its rounding points are the TPU kernel's: h1 and dz2 to bf16 before the
// products, dx and dy to bf16 in dw0x and dw0y; every sum is f32.  The thin
// sums (d_dx, d_dy, dw0x, dw0y and db0 from dz1; db1 and dw2 from dz2; db2)
// stay in f32 on the CUDA cores, per lane and column, and dz1 is never
// rounded.  dm = 8 pads the k16 step with zero columns; dm = 16 and 32 fill
// it.  The next row's dbias and per-pair dy are loaded into registers during
// the current row and staged in shared memory at its end.
//
// f32, tf32::cpb_bias_bwd_tf32: the bf16 kernel's grid and thin sums, the
// dm x dm products on the tf32 tensor cores (mma.sync m16n8k8, mma.cuh), f32
// throughout with no bf16 rounding; a warp takes kTiles = 2 m16 tiles of
// pairs (32 pairs) a step:
//   - layer 1 in f32 on the CUDA cores in the forward's fmaf order, so dz1's
//     mask a > 0 is the forward's bit for bit; z2 = h1 w1 + b1 is
//     cpb_common.cuh's cpb::tf32 code, 3xTF32 (each operand split as hi + lo,
//     three tf32 products for one f32 one), h1's A fragments split to nearest
//     in mma::split_accum's permutation: k positions t and t + 4 are the
//     lane's columns 2t and 2t + 1, so h1, z2 and dh1 share each lane's
//     columns and no value moves between lanes.  The f32 forward
//     (cpb_bias.cu, tf32::cpb_bias_fwd_tf32) calls the same code on the same
//     staged weights, so z2 and its mask are the forward's bit for bit (the
//     Pallas backward, which recomputes z2 apart from its forward, may take
//     the other branch at z2 within a few ulps of 0);
//   - dz2 = g [z2 > 0] w2 is never formed: with the mask exact in tf32 (1 or
//     0), dh1 = dz2 w1^T = g ([z2 > 0] (w2 w1^T)) and dw1 = h1^T dz2 = ((g
//     h1)^T [z2 > 0]) w2 per column, and db1 = w2 sum [z2 > 0] g, so each of
//     the two products is 3xTF32 with one operand's lo part 0: two products,
//     not three (112 mma per 16 pairs at dm = 32 instead of 144; the mma
//     count sets the kernel's pace);
//   - w1 and w2 w1^T as B fragments split once per block into shared memory
//     in fragment order (cpb::tf32::stage_b, 8 KB each at dm = 32), one
//     16-byte load a lane per k8 step and n8 tile for both tiles of the step:
//     held in registers they would take 128 a thread at dm = 32;
//   - dw1 needs the pairs as K, so g h1 and the mask are transposed through
//     shared memory (movmatrix is 16-bit only): each warp stages its step's
//     in the layouts of h_at / m_at below, where each lane's 8-byte stores and
//     its fragment loads are conflict-free and land in fragment order, so no
//     register moves build the fragments; g h1 is split truncated
//     (mma::split_tf32_trunc);
//   - every product is one chain per accumulator, the small products before
//     the big one; dw1's chain runs over one query row's steps and is folded
//     into an f32 sum at the end of every row (in shared memory: in
//     registers it would take 32 more a thread at dm = 32), since the tensor
//     core truncates what it carries;
//   - the thin sums (d_dx, d_dy, dw0x, dw0y, db0, db1 / w2, dw2, db2) in f32 on
//     the CUDA cores per lane and column, as in the bf16 kernel.
// __launch_bounds__ names two blocks an SM (about 107 KB of shared memory
// each at dm = 32); dm = 8 leaves dw1's m16 tile half zero.
//
// C entry: cpb_bias_bwd(dtype, dx, dy, w0x, w0y, b0, w1, b1, w2, dbias, ddx,
//                       ddy_part, wgrad_part, BG, H, W, J, dm, device, stream)
//          -> cudaGetLastError().
// dtype 0 = float, 1 = bfloat16 (weights and dbias); dx, dy and every output
// are float.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "cpb_common.cuh"
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTile = 512;          // lanes per block, both kernels

template <int DM>
__host__ __device__ constexpr int wgrad_size() {
  return DM * DM + 5 * DM + 1;
}

// the SLOTS partial sums of one lane, (p0 + p1) + (p2 + p3) for four
template <int SLOTS>
__device__ __forceinline__ float slot_sum(const float* p) {
  if constexpr (SLOTS == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    return (v.x + v.y) + (v.z + v.w);
  } else {
    return p[0];
  }
}

// The block's tile of lanes l0 + i, i < n_lanes = min(kTile, W*J - l0); the
// first of them has j0 = l0 % J.
struct TileLanes {
  int n_lanes, j0;
  __device__ TileLanes(int l0, int WJ, int J) : n_lanes(min(kTile, WJ - l0)), j0(l0 % J) {}
};

// d_dy of one query row for the block's tile: for every j, the tile's pairs of
// that j (tile lanes i = (j - j0) mod J, + J, ...) summed in ascending x;
// pair_row holds SLOTS partial sums per lane
template <int THREADS, int SLOTS>
__device__ __forceinline__ void fold_ddy(const float* pair_row, float* out_row,
                                         const TileLanes& tl, int J) {
  for (int j = threadIdx.x; j < J; j += THREADS) {
    float s = 0.f;
    for (int i = j >= tl.j0 ? j - tl.j0 : j - tl.j0 + J; i < tl.n_lanes; i += J)
      s += slot_sum<SLOTS>(pair_row + SLOTS * i);
    out_row[j] = s;
  }
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel

namespace tc {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kSteps = kTile / (16 * kWarps);  // 16-pair steps per warp and row
constexpr int kStage = kTile / kThreads;       // lanes each thread stages per row

template <int DM>
__host__ __device__ constexpr int smem_floats() {
  return cpb::par_floats<DM>() + 17 * kTile + kWarps * wgrad_size<DM>();
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// v summed over the 8 lanes that share t (g = 0..7), in a fixed order
__device__ __forceinline__ float sum_over_g(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

template <int DM>
__global__ void __launch_bounds__(kThreads)
cpb_bias_bwd_tc(const float* __restrict__ dx, const float* __restrict__ dy,
                const bf16* __restrict__ w0x, const bf16* __restrict__ w0y,
                const bf16* __restrict__ b0, const bf16* __restrict__ w1,
                const bf16* __restrict__ b1, const bf16* __restrict__ w2,
                const bf16* __restrict__ dbias, float* __restrict__ ddx,
                float* __restrict__ ddy_part, float* __restrict__ wgrad_part, int H, int W,
                int J) {
  constexpr int NT = cpb::Frags<DM>::NT;
  constexpr int KT = cpb::Frags<DM>::KT;
  constexpr int SIZE = wgrad_size<DM>();
  extern __shared__ __align__(16) float smem[];
  float* s_par = smem;                 // the weights in f32 (cpb::stage_params)
  float* s_dx = s_par + cpb::par_floats<DM>();  // [kTile]: dx of the tile's lanes, 0 past W*J
  float* s_ddx = s_dx + kTile;         // [kTile][4]: d_dx per lane, one slot per t
  float* s_pair = s_ddx + 4 * kTile;   // [2][kTile][4]: w0y . dz1 per lane of a row
  float* s_g = s_pair + 8 * kTile;     // [2][kTile]: dbias of a row, f32
  float* s_dyp = s_g + 2 * kTile;      // [2][kTile]: dy[bg, y, l % J] of a row
  float* s_red = s_dyp + 2 * kTile;    // [kWarps][SIZE]

  const int tile = blockIdx.x;
  const int tiles = gridDim.x;
  const int bg = blockIdx.y;
  const int WJ = W * J;
  const int l0 = tile * kTile;
  const TileLanes lanes(l0, WJ, J);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;

  cpb::stage_params<DM>(s_par, w0x, w0y, b0, b1, w2, threadIdx.x, kThreads);
  // the lanes this thread stages every row: threadIdx.x + kThreads * q
  int js[kStage];
#pragma unroll
  for (int q = 0; q < kStage; ++q) {
    const int i = threadIdx.x + kThreads * q;
    const bool ok = l0 + i < WJ;
    js[q] = ok ? (l0 + i) % J : -1;
    s_dx[i] = ok ? dx[(size_t)bg * WJ + l0 + i] : 0.f;
    *reinterpret_cast<float4*>(s_ddx + 4 * i) = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // w1 as B fragments: bz for z2 = h1 w1 (k x m), bh for dh1 = dz2 w1^T (m x k)
  uint32_t bz[KT][NT][2], bh[NT][KT][2];
  cpb::w1_frags<DM>(bz, w1, g, t);
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int k2 = 8 * n + g, m2 = 16 * kt + 2 * t;
      bh[n][kt][0] = cpb::w1_bits<DM>(w1, k2, m2) | cpb::w1_bits<DM>(w1, k2, m2 + 1) << 16;
      bh[n][kt][1] = cpb::w1_bits<DM>(w1, k2, m2 + 8) | cpb::w1_bits<DM>(w1, k2, m2 + 9) << 16;
    }
  }

  float acc_w1[KT][NT][4];
  float acc_w0x[NT][2], acc_w0y[NT][2], acc_b0[NT][2], acc_b1[NT][2], acc_w2[NT][2];
  float acc_b2 = 0.f;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int kt = 0; kt < KT; ++kt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_w1[kt][n][e] = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      acc_w0x[n][h] = acc_w0y[n][h] = acc_b0[n][h] = acc_b1[n][h] = acc_w2[n][h] = 0.f;
  }

  // a row's dbias and per-pair dy: loaded into registers a row ahead, staged at
  // the end of the row before
  bf16 rg[kStage];
  float rdy[kStage];
  auto load_row = [&](int y) {
    const bf16* g_row = dbias + ((size_t)bg * H + y) * WJ + l0;
    const float* dy_row = dy + ((size_t)bg * H + y) * J;
#pragma unroll
    for (int q = 0; q < kStage; ++q) {
      rg[q] = __float2bfloat16(0.f);
      rdy[q] = 0.f;
      if (js[q] >= 0) {
        rg[q] = g_row[threadIdx.x + kThreads * q];
        rdy[q] = dy_row[js[q]];
      }
    }
  };
  auto stage_row = [&](int y) {
#pragma unroll
    for (int q = 0; q < kStage; ++q) {
      s_g[(y & 1) * kTile + threadIdx.x + kThreads * q] = __bfloat162float(rg[q]);
      s_dyp[(y & 1) * kTile + threadIdx.x + kThreads * q] = rdy[q];
    }
  };
  load_row(0);
  stage_row(0);
  if (H > 1) load_row(1);
  __syncthreads();

  for (int y = 0; y < H; ++y) {
    const float* g_buf = s_g + (y & 1) * kTile;
    const float* dy_buf = s_dyp + (y & 1) * kTile;
    float* pair_row = s_pair + (y & 1) * 4 * kTile;
#pragma unroll 1
    for (int s = 0; s < kSteps; ++s) {
      const int i0 = (warp * kSteps + s) * 16;
      if (l0 + i0 >= WJ) break;  // warp-uniform: no pair of this step or later
      // the lane's pairs: rows g and g + 8 of the step (0 past W*J)
      float xv[2], yv[2], gv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = i0 + g + 8 * r;
        xv[r] = s_dx[i];
        yv[r] = dy_buf[i];
        gv[r] = g_buf[i];
      }

      // layer 1 and z2 = h1 w1 + b1, as the forward computes them (cpb_common.cuh)
      uint32_t ha[KT][4];
      cpb::layer1<DM>(ha, s_par, xv, yv, t);
      float z[NT][4];
      cpb::layer2<DM>(z, ha, bz, s_par, t);

      // dz2 = [z2 > 0] w2 g in f32 (db1, and dw2 = sum relu(z2) g as z2 [z2 > 0] g),
      // then to bf16 A fragments
      float d2[2 * KT][4];
#pragma unroll
      for (int n = 0; n < 2 * KT; ++n) {
        if (n < NT) {
          const float4 bw = cpb::b1_w2<DM>(s_par, n, t);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float sel = z[n][e] > 0.f ? gv[e >> 1] : 0.f;
            d2[n][e] = ((e & 1) ? bw.w : bw.z) * sel;
            acc_b1[n][e & 1] += d2[n][e];
            acc_w2[n][e & 1] = fmaf(z[n][e], sel, acc_w2[n][e & 1]);
          }
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) d2[n][e] = 0.f;
        }
      }
      acc_b2 += gv[0] + gv[1];
      uint32_t da[KT][4];
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) mma::accum_to_a(da[kt], d2[2 * kt], d2[2 * kt + 1]);

      // dh1 = dz2 w1^T
      float dh[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        dh[n][0] = dh[n][1] = dh[n][2] = dh[n][3] = 0.f;
#pragma unroll
        for (int kt = 0; kt < KT; ++kt) mma::mma_bf16(dh[n], da[kt], bh[n][kt][0], bh[n][kt][1]);
      }

      // dz1 = [h1 > 0] dh1 in f32: d_dx and d_dy per pair, dw0x, dw0y, db0
      float px[2] = {0.f, 0.f}, py[2] = {0.f, 0.f};
      const float xb[2] = {round_bf16(xv[0]), round_bf16(xv[1])};
      const float yb[2] = {round_bf16(yv[0]), round_bf16(yv[1])};
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float4 w = ld4(s_par + 4 * (4 * n + t));   // w0x, w0y
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const uint32_t hb = ha[n >> 1][2 * (n & 1) + r];
          const float lo = (hb & 0x7fffu) ? dh[n][2 * r] : 0.f;
          const float hi = (hb & 0x7fff0000u) ? dh[n][2 * r + 1] : 0.f;
          px[r] = fmaf(w.y, hi, fmaf(w.x, lo, px[r]));
          py[r] = fmaf(w.w, hi, fmaf(w.z, lo, py[r]));
          acc_w0x[n][0] = fmaf(lo, xb[r], acc_w0x[n][0]);
          acc_w0x[n][1] = fmaf(hi, xb[r], acc_w0x[n][1]);
          acc_w0y[n][0] = fmaf(lo, yb[r], acc_w0y[n][0]);
          acc_w0y[n][1] = fmaf(hi, yb[r], acc_w0y[n][1]);
          acc_b0[n][0] += lo;
          acc_b0[n][1] += hi;
        }
      }
      // the lane's partial sums of the pair over its columns, in slot t: the
      // quad's four are added in fold_ddy (d_dy) and at the end (d_dx)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        s_ddx[4 * (i0 + g + 8 * r) + t] += px[r];
        pair_row[4 * (i0 + g + 8 * r) + t] = py[r];
      }

      // dw1 += h1^T dz2 over K = the step's 16 pairs.  A = h1^T (k x pairs):
      // its 8 x 8 blocks are those of h1 transposed, (0, 2, 1, 3) in order;
      // B = dz2 (pairs x m), read as the transposed blocks of dz2's fragment.
      uint32_t bt[NT][2];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        bt[n][0] = mma::movmatrix_trans(da[n >> 1][2 * (n & 1)]);
        bt[n][1] = mma::movmatrix_trans(da[n >> 1][2 * (n & 1) + 1]);
      }
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
        const uint32_t at[4] = {mma::movmatrix_trans(ha[kt][0]), mma::movmatrix_trans(ha[kt][2]),
                                mma::movmatrix_trans(ha[kt][1]), mma::movmatrix_trans(ha[kt][3])};
#pragma unroll
        for (int n = 0; n < NT; ++n) mma::mma_bf16(acc_w1[kt][n], at, bt[n][0], bt[n][1]);
      }
    }
    if (y + 1 < H) {
      stage_row(y + 1);
      if (y + 2 < H) load_row(y + 2);
    }
    __syncthreads();
    fold_ddy<kThreads, 4>(pair_row, ddy_part + (((size_t)bg * tiles + tile) * H + y) * J,
                          lanes, J);
  }

#pragma unroll
  for (int q = 0; q < kStage; ++q) {
    const int i = threadIdx.x + kThreads * q;
    if (js[q] >= 0) ddx[(size_t)bg * WJ + l0 + i] = slot_sum<4>(s_ddx + 4 * i);
  }

  // the weight gradients: over the lanes of a warp, then over the warps, in a
  // fixed order (each dw1 element has one lane; the vectors sum over g)
  float* red = s_red + warp * SIZE;
#pragma unroll
  for (int kt = 0; kt < KT; ++kt)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = 16 * kt + mma::frag_row(lane, e);
        if (k < DM) red[k * DM + 8 * n + mma::frag_col(lane, e)] = acc_w1[kt][n][e];
      }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float v0 = sum_over_g(acc_w0x[n][h]), v1 = sum_over_g(acc_w0y[n][h]),
                  v2 = sum_over_g(acc_b0[n][h]), v3 = sum_over_g(acc_b1[n][h]),
                  v4 = sum_over_g(acc_w2[n][h]);
      const int c = DM * DM + 8 * n + 2 * t + h;
      if (g == 0) {
        red[c] = v0;
        red[c + DM] = v1;
        red[c + 2 * DM] = v2;
        red[c + 3 * DM] = v3;
        red[c + 4 * DM] = v4;
      }
    }
  }
  acc_b2 = sum_over_g(acc_b2);  // the four lanes of a quad hold the same pairs
  if (lane == 0) red[DM * DM + 5 * DM] = acc_b2;
  __syncthreads();
  float* out = wgrad_part + ((size_t)bg * tiles + tile) * SIZE;
  for (int e = threadIdx.x; e < SIZE; e += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += s_red[w * SIZE + e];
    out[e] = s;
  }
}

}  // namespace tc

// ---------------------------------------------------------------------------
// f32: the tf32 tensor-core kernel (3xTF32)

namespace tf32 {

// the bf16 kernel's block: 4 warps, a row staged a row ahead
using tc::kStage;
using tc::kThreads;
using tc::kWarps;
// m16 tiles of pairs a warp takes per step: each B fragment of w1 and w2 w1^T
// loaded from shared memory feeds kTiles products, and the tiles' product
// chains are independent (one tile a step: 1-3% slower, scripts/
// profile_cpb_bwd.py --variant onetile)
constexpr int kTiles = 2;
constexpr int kPairs = 16 * kTiles;                // pairs per warp step
constexpr int kSteps = kTile / (kPairs * kWarps);  // steps per warp and row
// blocks an SM holds: named in __launch_bounds__ so that ptxas gives each
// thread the registers two blocks leave it (without a count it may cap them
// lower and spill)
constexpr int kBlocksPerSM = 2;

// A warp stages its step's g h1 and [z2 > 0] for dw1 in two arrays whose
// 8-byte stores and loads fall on 32 distinct banks a half-warp, and whose
// 8-byte chunks hold the pairs of values that one lane stores together and
// another loads into neighbouring registers of its fragment:
//   - g h1, A of dw1: row pp = 16i + 2g + r for pair g + 8r of tile i, the
//     columns of each 16-column tile mt interleaved, k and k + 8 side by side
//     (column 16mt + 2(k % 8) + (k % 16 >= 8)); rows of 16 MT + 4 floats, the
//     chunks of row pp xor (pp >> 1) % 8;
//   - [z2 > 0], B of dw1: row m, the step's pairs in that order (pp); rows of
//     kPairs + 8 floats, the chunks of row m xor m % 8.
// So a lane stores h1 of columns k and k + 8, and the mask of its pairs g and g
// + 8, in one 8-byte store each; the k positions t and t + 4 of dw1's k8 step
// ks are the pairs at rows 8ks + 2t and 8ks + 2t + 1, whose A values (k, k +
// 8) and B values are one 8-byte load each, in fragment order.
template <int DM>
__host__ __device__ constexpr int ld_h() {
  return 16 * ((DM + 15) / 16) + 4;
}
constexpr int kLdM = kPairs + 8;

__device__ __forceinline__ int h_at(int row, int chunk, int ld) {
  return row * ld + 2 * (chunk ^ ((row >> 1) & 7));
}
__device__ __forceinline__ int m_at(int m, int chunk) {
  return m * kLdM + 2 * (chunk ^ (m & 7));
}

// floats of a warp's staging area
template <int DM>
__host__ __device__ constexpr int stage_floats() {
  return kPairs * ld_h<DM>() + DM * kLdM;
}

// floats of a warp's dw1 sum: each lane's accumulators (MT * NT * 4), lane
// minor
template <int DM>
__host__ __device__ constexpr int w1_sum_floats() {
  return 32 * ((DM + 15) / 16) * (DM / 8) * 4;
}

template <int DM>
__host__ __device__ constexpr int smem_floats() {
  return cpb::tf32::par_floats<DM>() + 2 * cpb::tf32::b_floats<DM>() + 17 * kTile +
         kWarps * (stage_floats<DM>() + w1_sum_floats<DM>());
}

template <int DM>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
cpb_bias_bwd_tf32(const float* __restrict__ dx, const float* __restrict__ dy,
                  const float* __restrict__ w0x, const float* __restrict__ w0y,
                  const float* __restrict__ b0, const float* __restrict__ w1,
                  const float* __restrict__ b1, const float* __restrict__ w2,
                  const float* __restrict__ dbias, float* __restrict__ ddx,
                  float* __restrict__ ddy_part, float* __restrict__ wgrad_part, int H, int W,
                  int J) {
  constexpr int NT = cpb::tf32::Frags<DM>::NT;
  constexpr int T = kTiles;
  constexpr int MT = (DM + 15) / 16;  // m16 tiles over dw1's rows (dm = 8: half zero)
  constexpr int LDH = ld_h<DM>();
  constexpr int SIZE = wgrad_size<DM>();
  static_assert(SIZE <= stage_floats<DM>(), "a warp's weight gradients fit its staging area");
  extern __shared__ __align__(16) float smem[];
  float* s_par = smem;                 // the weights in f32 (cpb::tf32::stage_params)
  uint4* s_wz = reinterpret_cast<uint4*>(s_par + cpb::tf32::par_floats<DM>());  // w1: z2 = h1 w1
  uint4* s_wh = s_wz + NT * NT * 32;   // w2 w1^T: dh1 = g [z2 > 0] (w2 w1^T)
  float* s_dx = reinterpret_cast<float*>(s_wh + NT * NT * 32);  // [kTile]: dx, 0 past W*J
  float* s_ddx = s_dx + kTile;         // [kTile][4]: d_dx per lane, one slot per t
  float* s_pair = s_ddx + 4 * kTile;   // [2][kTile][4]: w0y . dz1 per lane of a row
  float* s_g = s_pair + 8 * kTile;     // [2][kTile]: dbias of a row
  float* s_dyp = s_g + 2 * kTile;      // [2][kTile]: dy[bg, y, l % J] of a row
  float* s_stage = s_dyp + 2 * kTile;  // [kWarps]: a step's g h1 and [z2 > 0];
                                       // at the end [kWarps][SIZE], the weight gradients
  float* s_w1sum = s_stage + kWarps * stage_floats<DM>();  // [kWarps][MT][NT][4][32]: dw1

  const int tile = blockIdx.x;
  const int tiles = gridDim.x;
  const int bg = blockIdx.y;
  const int WJ = W * J;
  const int l0 = tile * kTile;
  const TileLanes lanes(l0, WJ, J);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;

  cpb::tf32::stage_params<DM>(s_par, w0x, w0y, b0, b1, w2, threadIdx.x, kThreads);
  cpb::tf32::stage_b<DM, false>(s_wz, w1, nullptr, threadIdx.x, kThreads);
  cpb::tf32::stage_b<DM, true>(s_wh, w1, w2, threadIdx.x, kThreads);
  int js[kStage];
#pragma unroll
  for (int q = 0; q < kStage; ++q) {
    const int i = threadIdx.x + kThreads * q;
    const bool ok = l0 + i < WJ;
    js[q] = ok ? (l0 + i) % J : -1;
    s_dx[i] = ok ? dx[(size_t)bg * WJ + l0 + i] : 0.f;
    *reinterpret_cast<float4*>(s_ddx + 4 * i) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float* sh = s_stage + warp * stage_floats<DM>();  // [kPairs][LDH]: g h1 (h_at)
  float* sd = sh + kPairs * LDH;                      // [DM][kLdM]: [z2 > 0] (m_at)
  float* w1sum = s_w1sum + warp * (MT * NT * 4 * 32) + lane;  // the lane's, stride 32

  // dw1 / w2 in the accumulator layout of its m16n8 tiles (rows k, columns m):
  // the tensor core's chain over a row's steps, folded at the end of every row
  // into an f32 sum in shared memory (in registers it would take MT * NT * 4
  // more a thread, 32 at dm = 32); db1 / w2 in acc_b1
  float acc_w1[MT][NT][4];
  float acc_w0x[NT][2], acc_w0y[NT][2], acc_b0[NT][2], acc_b1[NT][2], acc_w2[NT][2];
  float acc_b2 = 0.f;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc_w1[mt][n][e] = 0.f;
        w1sum[32 * ((mt * NT + n) * 4 + e)] = 0.f;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h)
      acc_w0x[n][h] = acc_w0y[n][h] = acc_b0[n][h] = acc_b1[n][h] = acc_w2[n][h] = 0.f;
  }

  // a row's dbias and per-pair dy: loaded into registers a row ahead, staged at
  // the end of the row before
  float rg[kStage], rdy[kStage];
  auto load_row = [&](int y) {
    const float* g_row = dbias + ((size_t)bg * H + y) * WJ + l0;
    const float* dy_row = dy + ((size_t)bg * H + y) * J;
#pragma unroll
    for (int q = 0; q < kStage; ++q) {
      rg[q] = 0.f;
      rdy[q] = 0.f;
      if (js[q] >= 0) {
        rg[q] = g_row[threadIdx.x + kThreads * q];
        rdy[q] = dy_row[js[q]];
      }
    }
  };
  auto stage_row = [&](int y) {
#pragma unroll
    for (int q = 0; q < kStage; ++q) {
      s_g[(y & 1) * kTile + threadIdx.x + kThreads * q] = rg[q];
      s_dyp[(y & 1) * kTile + threadIdx.x + kThreads * q] = rdy[q];
    }
  };
  load_row(0);
  stage_row(0);
  if (H > 1) load_row(1);
  __syncthreads();

  for (int y = 0; y < H; ++y) {
    const float* g_buf = s_g + (y & 1) * kTile;
    const float* dy_buf = s_dyp + (y & 1) * kTile;
    float* pair_row = s_pair + (y & 1) * 4 * kTile;
#pragma unroll 1
    for (int s = 0; s < kSteps; ++s) {
      const int i0 = (warp * kSteps + s) * kPairs;
      if (l0 + i0 >= WJ) break;  // warp-uniform: no pair of this step or later
      // the lane's pairs: rows g and g + 8 of tile i of the step (0 past W*J)
      float xv[T][2], yv[T][2], gv[T][2];
#pragma unroll
      for (int i = 0; i < T; ++i)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int p = i0 + 16 * i + g + 8 * r;
          xv[i][r] = s_dx[p];
          yv[i][r] = dy_buf[p];
          gv[i][r] = g_buf[p];
        }

      // layer 1 in f32 (the forward's fmaf order); g h1 staged for dw1
      float h1[T][NT][4];
      cpb::tf32::layer1<DM, T>(h1, s_par, xv, yv, t);
#pragma unroll
      for (int i = 0; i < T; ++i)
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int j = 0; j < (NT + 1) / 2; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              *reinterpret_cast<float2*>(sh + h_at(16 * i + 2 * g + r, 8 * j + 2 * t + h, LDH)) =
                  make_float2(h1[i][2 * j][2 * r + h] * gv[i][r],
                              2 * j + 1 < NT ? h1[i][2 * j + 1][2 * r + h] * gv[i][r] : 0.f);

      // z2 = h1 w1 + b1 (cpb_common.cuh); its mask [z2 > 0] in the A-fragment
      // order of dh1's product (element e2 before e1, mma::split_accum's
      // permutation) and staged for dw1; the thin sums of dz2 = [z2 > 0] w2 g
      // in f32: db1 / w2 = sum [z2 > 0] g, and dw2 = sum relu(z2) g as z2
      // [z2 > 0] g
      uint32_t mk[T][NT][4];
      {
        float z[T][NT][4];
        cpb::tf32::layer2<DM, T>(z, h1, s_wz, s_par, lane, t);
#pragma unroll
        for (int i = 0; i < T; ++i)
#pragma unroll
          for (int n = 0; n < NT; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const bool on = z[i][n][e] > 0.f;
              const float sel = on ? gv[i][e >> 1] : 0.f;
              mk[i][n][(e >> 1) | ((e & 1) << 1)] = on ? 0x3f800000u : 0u;  // 1.f or 0.f
              acc_b1[n][e & 1] += sel;
              acc_w2[n][e & 1] = fmaf(z[i][n][e], sel, acc_w2[n][e & 1]);
            }
#pragma unroll
            for (int h = 0; h < 2; ++h)
              *reinterpret_cast<uint2*>(sd + m_at(8 * n + 2 * t + h, 8 * i + g)) =
                  make_uint2(mk[i][n][2 * h], mk[i][n][2 * h + 1]);
          }
      }
#pragma unroll
      for (int i = 0; i < T; ++i) acc_b2 += gv[i][0] + gv[i][1];

      // dh1 = dz2 w1^T = g ([z2 > 0] (w2 w1^T)): the mask is exact in tf32, so
      // 3xTF32 is two products, mask (w2 w1^T)_lo then mask (w2 w1^T)_hi, w2
      // w1^T from s_wh (stage_b<DM, true> scaled by w2), one chain a tile; then
      // times each pair's g in f32
      float dh[T][NT][4];
#pragma unroll
      for (int i = 0; i < T; ++i)
#pragma unroll
        for (int n = 0; n < NT; ++n) dh[i][n][0] = dh[i][n][1] = dh[i][n][2] = dh[i][n][3] = 0.f;
#pragma unroll
      for (int mb = 0; mb < NT; ++mb)
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const uint4 b = s_wh[(mb * NT + n) * 32 + lane];
#pragma unroll
          for (int i = 0; i < T; ++i) {
            mma::mma_tf32(dh[i][n], mk[i][mb], b.z, b.w);
            mma::mma_tf32(dh[i][n], mk[i][mb], b.x, b.y);
          }
        }
#pragma unroll
      for (int i = 0; i < T; ++i)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) dh[i][n][e] *= gv[i][e >> 1];

      // dz1 = [a > 0] dh1 in f32, element for element (the mask is h1's, whose
      // layout dh1 shares): d_dx and d_dy per pair, dw0x, dw0y, db0
#pragma unroll
      for (int i = 0; i < T; ++i) {
        float px[2] = {0.f, 0.f}, py[2] = {0.f, 0.f};
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const float4 w = *reinterpret_cast<const float4*>(s_par + 4 * (4 * n + t));
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float lo = h1[i][n][2 * r] > 0.f ? dh[i][n][2 * r] : 0.f;
            const float hi = h1[i][n][2 * r + 1] > 0.f ? dh[i][n][2 * r + 1] : 0.f;
            px[r] = fmaf(w.y, hi, fmaf(w.x, lo, px[r]));
            py[r] = fmaf(w.w, hi, fmaf(w.z, lo, py[r]));
            acc_w0x[n][0] = fmaf(lo, xv[i][r], acc_w0x[n][0]);
            acc_w0x[n][1] = fmaf(hi, xv[i][r], acc_w0x[n][1]);
            acc_w0y[n][0] = fmaf(lo, yv[i][r], acc_w0y[n][0]);
            acc_w0y[n][1] = fmaf(hi, yv[i][r], acc_w0y[n][1]);
            acc_b0[n][0] += lo;
            acc_b0[n][1] += hi;
          }
        }
        // the lane's partial sums of the pair over its columns, in slot t: the
        // quad's four are added in fold_ddy (d_dy) and at the end (d_dx)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int p = i0 + 16 * i + g + 8 * r;
          s_ddx[4 * p + t] += px[r];
          pair_row[4 * p + t] = py[r];
        }
      }

      // dw1 += h1^T dz2 = (g h1)^T [z2 > 0], times w2 per column at the end,
      // over K = the step's pairs, from the staged rows: A = (g h1)^T (rows k),
      // split truncated; B = the mask (columns m), exact in tf32, so two
      // products
      __syncwarp();
#pragma unroll
      for (int ks = 0; ks < kPairs / 8; ++ks) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const float2 v0 = *reinterpret_cast<const float2*>(sh + h_at(8 * ks + 2 * t,
                                                                        8 * mt + g, LDH));
          const float2 v1 = *reinterpret_cast<const float2*>(sh + h_at(8 * ks + 2 * t + 1,
                                                                        8 * mt + g, LDH));
          uint32_t ah[4], al[4];
          mma::split_tf32_trunc(v0.x, ah[0], al[0]);
          mma::split_tf32_trunc(v0.y, ah[1], al[1]);
          mma::split_tf32_trunc(v1.x, ah[2], al[2]);
          mma::split_tf32_trunc(v1.y, ah[3], al[3]);
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            const uint2 b = *reinterpret_cast<const uint2*>(sd + m_at(8 * n + g, 4 * ks + t));
            mma::mma_tf32(acc_w1[mt][n], al, b.x, b.y);
            mma::mma_tf32(acc_w1[mt][n], ah, b.x, b.y);
          }
        }
      }
      __syncwarp();  // the next step overwrites the staging rows
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          w1sum[32 * ((mt * NT + n) * 4 + e)] += acc_w1[mt][n][e];
          acc_w1[mt][n][e] = 0.f;
        }
    if (y + 1 < H) {
      stage_row(y + 1);
      if (y + 2 < H) load_row(y + 2);
    }
    __syncthreads();
    fold_ddy<kThreads, 4>(pair_row, ddy_part + (((size_t)bg * tiles + tile) * H + y) * J,
                          lanes, J);
  }

#pragma unroll
  for (int q = 0; q < kStage; ++q) {
    const int i = threadIdx.x + kThreads * q;
    if (js[q] >= 0) ddx[(size_t)bg * WJ + l0 + i] = slot_sum<4>(s_ddx + 4 * i);
  }

  // the weight gradients: over the lanes of a warp, then over the warps, in a
  // fixed order (each dw1 element has one lane; the vectors sum over g), in
  // the staging area (free after the last row's barrier)
  float* red = s_stage + warp * SIZE;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = 16 * mt + mma::frag_row(lane, e);
        if (k < DM)
          red[k * DM + 8 * n + mma::frag_col(lane, e)] =
              s_par[3 * DM + 4 * (4 * n + t) + 2 + (e & 1)] *   // w2 of the column
              w1sum[32 * ((mt * NT + n) * 4 + e)];
      }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float v0 = tc::sum_over_g(acc_w0x[n][h]), v1 = tc::sum_over_g(acc_w0y[n][h]),
                  v2 = tc::sum_over_g(acc_b0[n][h]),
                  v3 = s_par[3 * DM + 4 * (4 * n + t) + 2 + h] * tc::sum_over_g(acc_b1[n][h]),
                  v4 = tc::sum_over_g(acc_w2[n][h]);
      const int c = DM * DM + 8 * n + 2 * t + h;
      if (g == 0) {
        red[c] = v0;
        red[c + DM] = v1;
        red[c + 2 * DM] = v2;
        red[c + 3 * DM] = v3;
        red[c + 4 * DM] = v4;
      }
    }
  }
  acc_b2 = tc::sum_over_g(acc_b2);  // the four lanes of a quad hold the same pairs
  if (lane == 0) red[DM * DM + 5 * DM] = acc_b2;
  __syncthreads();
  float* out = wgrad_part + ((size_t)bg * tiles + tile) * SIZE;
  for (int e = threadIdx.x; e < SIZE; e += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += s_stage[w * SIZE + e];
    out[e] = s;
  }
}

}  // namespace tf32

// ---------------------------------------------------------------------------

template <typename T, int DM>
cudaError_t launch(const void* dx, const void* dy, const void* w0x, const void* w0y,
                   const void* b0, const void* w1, const void* b1, const void* w2,
                   const void* dbias, void* ddx, void* ddy_part, void* wgrad_part, int BG,
                   int H, int W, int J, cudaStream_t stream) {
  constexpr bool kTc = std::is_same<T, bf16>::value;
  const size_t smem = (kTc ? tc::smem_floats<DM>() : tf32::smem_floats<DM>()) * sizeof(float);
  void (*kernel)(const float*, const float*, const T*, const T*, const T*, const T*,
                 const T*, const T*, const T*, float*, float*, float*, int, int, int);
  if constexpr (kTc) {
    kernel = tc::cpb_bias_bwd_tc<DM>;
  } else {
    kernel = tf32::cpb_bias_bwd_tf32<DM>;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int tiles = (W * J + kTile - 1) / kTile;
  kernel<<<dim3(tiles, BG), kTc ? tc::kThreads : tf32::kThreads, smem, stream>>>(
      static_cast<const float*>(dx), static_cast<const float*>(dy),
      static_cast<const T*>(w0x), static_cast<const T*>(w0y), static_cast<const T*>(b0),
      static_cast<const T*>(w1), static_cast<const T*>(b1), static_cast<const T*>(w2),
      static_cast<const T*>(dbias), static_cast<float*>(ddx),
      static_cast<float*>(ddy_part), static_cast<float*>(wgrad_part), H, W, J);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dm(int dm, const void* dx, const void* dy, const void* w0x,
                        const void* w0y, const void* b0, const void* w1, const void* b1,
                        const void* w2, const void* dbias, void* ddx, void* ddy_part,
                        void* wgrad_part, int BG, int H, int W, int J, cudaStream_t s) {
  switch (dm) {
    case 8:
      return launch<T, 8>(dx, dy, w0x, w0y, b0, w1, b1, w2, dbias, ddx, ddy_part,
                          wgrad_part, BG, H, W, J, s);
    case 16:
      return launch<T, 16>(dx, dy, w0x, w0y, b0, w1, b1, w2, dbias, ddx, ddy_part,
                           wgrad_part, BG, H, W, J, s);
    case 32:
      return launch<T, 32>(dx, dy, w0x, w0y, b0, w1, b1, w2, dbias, ddx, ddy_part,
                           wgrad_part, BG, H, W, J, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int cpb_bias_bwd(int dtype, const void* dx, const void* dy, const void* w0x,
                            const void* w0y, const void* b0, const void* w1,
                            const void* b1, const void* w2, const void* dbias, void* ddx,
                            void* ddy_part, void* wgrad_part, int BG, int H, int W, int J,
                            int dm, int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_dm<float>(dm, dx, dy, w0x, w0y, b0, w1, b1, w2, dbias, ddx, ddy_part,
                              wgrad_part, BG, H, W, J, s);
  if (dtype == 1)
    return dispatch_dm<bf16>(dm, dx, dy, w0x, w0y, b0, w1, b1, w2, dbias, ddx, ddy_part,
                             wgrad_part, BG, H, W, J, s);
  return cudaErrorInvalidValue;
}
