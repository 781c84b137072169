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
// (6656 at dm = 32) against 2 bytes of bf16 dbias.
//
// Both kernels run one block per (bg, tile of kTile lanes l = x*J + j),
// looping over all H query rows (the TPU kernel's "sr" order recast for
// parallel blocks), so d_dx and the weight gradients stay on chip for the
// whole launch; d_dx is written once.  d_dy and the weight gradients leave as
// per-block partials, (BG, tiles, H, J) and (BG, tiles, dm*dm + 5*dm + 1),
// which the wrapper sums.  No atomics: each pair's w0y . dz1 goes to a shared
// row of the tile's lanes (in the tensor-core kernel as four partial sums, one
// per lane of a quad), and after each query row threads over j sum the tile's
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
// f32, cpb_bias_bwd_kernel, the CUDA-core twin and the exact-arithmetic
// reference on the card: each thread owns kLanesPerThread lanes and runs the
// per-pair backward in f32 registers with the forward's fmaf order, so the
// ReLU masks are the forward's.  The weight gradients are per-warp register
// sums (lane k owns row k of dw1 and entry k of the vectors) over h1, dz2 and
// h2*g (then dz1) staged for the warp's 32 pairs in shared memory.
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
// f32: the CUDA-core twin

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLanesPerThread = kTile / kThreads;

// floats of dynamic shared memory before the d_dy rows and the staging area
template <int DM>
__host__ __device__ constexpr int head_floats() {
  return 2 * DM * DM + 5 * DM;
}

template <int N4>
__device__ __forceinline__ void store_row(float* dst, const float* v) {
#pragma unroll
  for (int i = 0; i < N4; ++i)
    reinterpret_cast<float4*>(dst)[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2],
                                                    v[4 * i + 3]);
}

template <int DM>
__global__ void __launch_bounds__(kThreads)
cpb_bias_bwd_kernel(const float* __restrict__ dx, const float* __restrict__ dy,
                    const float* __restrict__ w0x, const float* __restrict__ w0y,
                    const float* __restrict__ b0, const float* __restrict__ w1,
                    const float* __restrict__ b1, const float* __restrict__ w2,
                    const float* __restrict__ dbias, float* __restrict__ ddx,
                    float* __restrict__ ddy_part, float* __restrict__ wgrad_part, int H,
                    int W, int J) {
  static_assert(DM % 4 == 0 && DM <= 32, "lane k owns index k; rows are float4");
  constexpr int LD = DM + 4;          // staged row: 16-byte aligned, conflict-free
  constexpr int STAGE = 32 * LD;      // one staged (32 pairs x DM) array
  extern __shared__ __align__(16) float smem[];
  float* s_w1t = smem;                // [DM][DM]: s_w1t[m * DM + k] = w1[k][m]
  float* s_w1 = s_w1t + DM * DM;      // [DM][DM]: s_w1[k * DM + m] = w1[k][m]
  float* s_w0x = s_w1 + DM * DM;
  float* s_w0y = s_w0x + DM;
  float* s_b0 = s_w0y + DM;
  float* s_b1 = s_b0 + DM;
  float* s_w2 = s_b1 + DM;
  float* s_pair = s_w2 + DM;          // [2][kTile]: w0y . dz1 per lane of a row
  float* s_stage = s_pair + 2 * kTile;  // [kWarps][3][32][LD]

  const int tile = blockIdx.x;
  const int tiles = gridDim.x;
  const int bg = blockIdx.y;
  const int WJ = W * J;
  const TileLanes lanes(tile * kTile, WJ, J);
  for (int i = threadIdx.x; i < DM * DM; i += kThreads) {
    const int k = i / DM;
    const int m = i - k * DM;
    s_w1t[m * DM + k] = w1[i];
    s_w1[i] = w1[i];
  }
  for (int i = threadIdx.x; i < DM; i += kThreads) {
    s_w0x[i] = w0x[i];
    s_w0y[i] = w0y[i];
    s_b0[i] = b0[i];
    s_b1[i] = b1[i];
    s_w2[i] = w2[i];
  }

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* sa = s_stage + warp * 3 * STAGE;  // h1, then dz1
  float* sb = sa + STAGE;                  // dz2
  float* sc = sb + STAGE;                  // h2 * g

  float dxv[kLanesPerThread], ddx_acc[kLanesPerThread];
  int jv[kLanesPerThread];
#pragma unroll
  for (int i = 0; i < kLanesPerThread; ++i) {
    const int l = tile * kTile + i * kThreads + threadIdx.x;
    const bool ok = l < WJ;
    dxv[i] = ok ? dx[(size_t)bg * WJ + l] : 0.f;
    jv[i] = ok ? l % J : -1;
    ddx_acc[i] = 0.f;
  }
  float acc_w1[DM];
#pragma unroll
  for (int m = 0; m < DM; ++m) acc_w1[m] = 0.f;
  float acc_w0x = 0.f, acc_w0y = 0.f, acc_b0 = 0.f, acc_b1 = 0.f, acc_w2 = 0.f,
        acc_b2 = 0.f;
  __syncthreads();

  for (int y = 0; y < H; ++y) {
    const float* dy_row = dy + ((size_t)bg * H + y) * J;
    const float* g_row = dbias + ((size_t)bg * H + y) * WJ;
    float* pair_row = s_pair + (y & 1) * kTile;
#pragma unroll
    for (int i = 0; i < kLanesPerThread; ++i) {
      const int l = tile * kTile + i * kThreads + threadIdx.x;
      const bool ok = jv[i] >= 0;
      const float dyv = ok ? dy_row[jv[i]] : 0.f;
      const float g = ok ? g_row[l] : 0.f;

      // layer 1, as the forward
      float h1[DM];
      unsigned m1 = 0u;
#pragma unroll
      for (int k = 0; k < DM; ++k) {
        const float a = fmaf(s_w0x[k], dxv[i], fmaf(s_w0y[k], dyv, s_b0[k]));
        m1 |= (a > 0.f ? 1u : 0u) << k;
        h1[k] = fmaxf(a, 0.f);
      }
      // layer 2, as the forward (k ascending), then dz2 and h2 * g
      float d2[DM];
#pragma unroll
      for (int m = 0; m < DM; ++m) {
        const float4* wrow = reinterpret_cast<const float4*>(s_w1t + m * DM);
        float z = s_b1[m];
#pragma unroll
        for (int k4 = 0; k4 < DM / 4; ++k4) {
          const float4 w = wrow[k4];
          z = fmaf(w.x, h1[4 * k4 + 0], z);
          z = fmaf(w.y, h1[4 * k4 + 1], z);
          z = fmaf(w.z, h1[4 * k4 + 2], z);
          z = fmaf(w.w, h1[4 * k4 + 3], z);
        }
        d2[m] = z > 0.f ? s_w2[m] * g : 0.f;
        sc[lane * LD + m] = fmaxf(z, 0.f) * g;
      }
      store_row<DM / 4>(sa + lane * LD, h1);
      store_row<DM / 4>(sb + lane * LD, d2);
      // dz1 = [a > 0] (w1 dz2); d_dx and d_dy contributions of this pair
      float dz1[DM];
      float tdx = 0.f, tdy = 0.f;
#pragma unroll
      for (int k = 0; k < DM; ++k) {
        const float4* wrow = reinterpret_cast<const float4*>(s_w1 + k * DM);
        float s = 0.f;
#pragma unroll
        for (int m4 = 0; m4 < DM / 4; ++m4) {
          const float4 w = wrow[m4];
          s = fmaf(w.x, d2[4 * m4 + 0], s);
          s = fmaf(w.y, d2[4 * m4 + 1], s);
          s = fmaf(w.z, d2[4 * m4 + 2], s);
          s = fmaf(w.w, d2[4 * m4 + 3], s);
        }
        dz1[k] = (m1 >> k) & 1u ? s : 0.f;
        tdx = fmaf(s_w0x[k], dz1[k], tdx);
        tdy = fmaf(s_w0y[k], dz1[k], tdy);
      }
      ddx_acc[i] += tdx;
      pair_row[i * kThreads + threadIdx.x] = tdy;
      acc_b2 += g;
      __syncwarp();

      // lane k: dw1[k][:] += sum_p h1[p][k] dz2[p][:], db1[k], dw2[k]
      if (lane < DM) {
#pragma unroll 2
        for (int p = 0; p < 32; ++p) {
          const float hk = sa[p * LD + lane];
          const float4* row = reinterpret_cast<const float4*>(sb + p * LD);
#pragma unroll
          for (int m4 = 0; m4 < DM / 4; ++m4) {
            const float4 r = row[m4];
            acc_w1[4 * m4 + 0] = fmaf(hk, r.x, acc_w1[4 * m4 + 0]);
            acc_w1[4 * m4 + 1] = fmaf(hk, r.y, acc_w1[4 * m4 + 1]);
            acc_w1[4 * m4 + 2] = fmaf(hk, r.z, acc_w1[4 * m4 + 2]);
            acc_w1[4 * m4 + 3] = fmaf(hk, r.w, acc_w1[4 * m4 + 3]);
          }
          acc_b1 += sb[p * LD + lane];
          acc_w2 += sc[p * LD + lane];
        }
      }
      __syncwarp();
      store_row<DM / 4>(sa + lane * LD, dz1);
      __syncwarp();
      // lane k: dw0x[k], dw0y[k], db0[k]
#pragma unroll 4
      for (int p = 0; p < 32; ++p) {
        const float xs = __shfl_sync(0xffffffffu, dxv[i], p);
        const float ys = __shfl_sync(0xffffffffu, dyv, p);
        const float dz = lane < DM ? sa[p * LD + lane] : 0.f;
        acc_w0x = fmaf(dz, xs, acc_w0x);
        acc_w0y = fmaf(dz, ys, acc_w0y);
        acc_b0 += dz;
      }
      __syncwarp();  // the next pair overwrites the staging rows
    }
    __syncthreads();
    fold_ddy<kThreads, 1>(pair_row, ddy_part + (((size_t)bg * tiles + tile) * H + y) * J,
                          lanes, J);
  }

#pragma unroll
  for (int i = 0; i < kLanesPerThread; ++i) {
    const int l = tile * kTile + i * kThreads + threadIdx.x;
    if (jv[i] >= 0) ddx[(size_t)bg * WJ + l] = ddx_acc[i];
  }

  // combine the warps' weight gradients in a fixed order
  constexpr int SIZE = wgrad_size<DM>();
  float* red = s_stage + warp * SIZE;  // the staging area is free now
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc_b2 += __shfl_xor_sync(0xffffffffu, acc_b2, o);
  if (lane < DM) {
#pragma unroll
    for (int m = 0; m < DM; ++m) red[lane * DM + m] = acc_w1[m];
    red[DM * DM + lane] = acc_w0x;
    red[DM * DM + DM + lane] = acc_w0y;
    red[DM * DM + 2 * DM + lane] = acc_b0;
    red[DM * DM + 3 * DM + lane] = acc_b1;
    red[DM * DM + 4 * DM + lane] = acc_w2;
  }
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

template <int DM>
size_t smem_bytes() {
  return (size_t)(head_floats<DM>() + 2 * kTile + kWarps * 3 * 32 * (DM + 4)) *
         sizeof(float);
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

template <typename T, int DM>
cudaError_t launch(const void* dx, const void* dy, const void* w0x, const void* w0y,
                   const void* b0, const void* w1, const void* b1, const void* w2,
                   const void* dbias, void* ddx, void* ddy_part, void* wgrad_part, int BG,
                   int H, int W, int J, cudaStream_t stream) {
  constexpr bool kTc = std::is_same<T, bf16>::value;
  static_assert(kTc || kWarps * wgrad_size<DM>() <= kWarps * 3 * 32 * (DM + 4),
                "the warps' weight gradients fit the staging area");
  const size_t smem = kTc ? tc::smem_floats<DM>() * sizeof(float) : smem_bytes<DM>();
  void (*kernel)(const float*, const float*, const T*, const T*, const T*, const T*,
                 const T*, const T*, const T*, float*, float*, float*, int, int, int);
  if constexpr (kTc) {
    kernel = tc::cpb_bias_bwd_tc<DM>;
  } else {
    kernel = cpb_bias_bwd_kernel<DM>;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int tiles = (W * J + kTile - 1) / kTile;
  kernel<<<dim3(tiles, BG), kTc ? tc::kThreads : kThreads, smem, stream>>>(
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
