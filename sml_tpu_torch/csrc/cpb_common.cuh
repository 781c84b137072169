// Layers 1 and 2 of the CPB MLP on the tensor cores, shared by the bf16
// forward (cpb_bias.cu, tc::cpb_bias_fwd_tc) and the bf16 backward's
// recompute (cpb_bias_bwd.cu, tc::cpb_bias_bwd_tc), so that both compute the
// same z2 bit for bit and take the same layer-2 ReLU decisions:
//
//   a  = w0x * dx + (w0y * dy + b0)    f32, as fmaf(w0x, dx, fmaf(w0y, dy, b0))
//   h1 = bf16(relu(a))                 rounded straight into A fragments
//   z2 = h1 w1 + b1                    mma.sync m16n8k16, f32 sums from b1
//
// A warp takes 16 pairs per step as the M dimension; lane (g, t) owns pairs g
// and g + 8 and columns 8n + 2t, 8n + 2t + 1 of every n8 tile n, which is at
// once the A-fragment layout of h1 and the accumulator layout of z2
// (mma.cuh).  dm = 8 pads the k16 step with zero columns of h1 and w1; dm = 16
// and 32 fill it.
//
// cpb::tf32 holds the same two layers in f32 for the f32 forms, on the tf32
// tensor cores as 3xTF32 (mma.cuh), shared in the same way by the f32 forward
// (cpb_bias.cu, tf32::cpb_bias_fwd_tf32) and the f32 backward's recompute
// (cpb_bias_bwd.cu, tf32::cpb_bias_bwd_tf32): both stage the weights with
// tf32::stage_params and w1 with tf32::stage_b<DM, false>, so they compute the
// same z2 bit for bit and take the same layer-1 and layer-2 ReLU decisions.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "mma.cuh"

namespace cpb {

template <int DM>
struct Frags {
  static_assert(DM % 8 == 0 && DM <= 32, "dm columns in n8 tiles");
  static constexpr int NT = DM / 8;           // n8 tiles over dm
  static constexpr int KT = (DM + 15) / 16;   // k16 steps over dm (dm = 8: zero-padded)
};

// floats of the weights in shared memory (stage_params)
template <int DM>
__host__ __device__ constexpr int par_floats() {
  return 5 * DM;
}

// The weights in f32, per column pair c = 2i, 2i + 1 (one 16-byte load each):
// [DM/2][4] (w0x[c], w0x[c+1], w0y[c], w0y[c+1]), [DM] b0,
// [DM/2][4] (b1[c], b1[c+1], w2[c], w2[c+1]).  Threads tid, tid + nthreads, ...
template <int DM>
__device__ __forceinline__ void stage_params(float* s_par, const __nv_bfloat16* w0x,
                                             const __nv_bfloat16* w0y,
                                             const __nv_bfloat16* b0,
                                             const __nv_bfloat16* b1,
                                             const __nv_bfloat16* w2, int tid, int nthreads) {
  for (int i = tid; i < DM; i += nthreads) {
    const int c = 4 * (i >> 1) + (i & 1);
    s_par[c] = __bfloat162float(w0x[i]);
    s_par[c + 2] = __bfloat162float(w0y[i]);
    s_par[2 * DM + i] = __bfloat162float(b0[i]);
    s_par[3 * DM + c] = __bfloat162float(b1[i]);
    s_par[3 * DM + c + 2] = __bfloat162float(w2[i]);
  }
}

// (b1, b1, w2, w2) of the lane's columns 8n + 2t, + 1
template <int DM>
__device__ __forceinline__ float4 b1_w2(const float* s_par, int n, int t) {
  return *reinterpret_cast<const float4*>(s_par + 3 * DM + 4 * (4 * n + t));
}

// bits of w1[k][m] (bf16, row-major dm x dm), 0 outside it
template <int DM>
__device__ __forceinline__ uint32_t w1_bits(const __nv_bfloat16* w1, int k, int m) {
  return k < DM && m < DM ? reinterpret_cast<const unsigned short*>(w1)[k * DM + m] : 0u;
}

// w1 (k x m) as the B fragments of z2 = h1 w1, for the whole launch
template <int DM>
__device__ __forceinline__ void w1_frags(uint32_t (&bz)[Frags<DM>::KT][Frags<DM>::NT][2],
                                         const __nv_bfloat16* w1, int g, int t) {
#pragma unroll
  for (int kt = 0; kt < Frags<DM>::KT; ++kt) {
#pragma unroll
    for (int n = 0; n < Frags<DM>::NT; ++n) {
      const int k = 16 * kt + 2 * t, m = 8 * n + g;
      bz[kt][n][0] = w1_bits<DM>(w1, k, m) | w1_bits<DM>(w1, k + 1, m) << 16;
      bz[kt][n][1] = w1_bits<DM>(w1, k + 8, m) | w1_bits<DM>(w1, k + 9, m) << 16;
    }
  }
}

// Layer 1 of the lane's pairs (dx xv[r], dy yv[r] of pair g + 8r) in f32,
// relu(a) rounded to bf16 A fragments of h1
template <int DM>
__device__ __forceinline__ void layer1(uint32_t (&ha)[Frags<DM>::KT][4], const float* s_par,
                                       const float (&xv)[2], const float (&yv)[2], int t) {
#pragma unroll
  for (int n = 0; n < 2 * Frags<DM>::KT; ++n) {
    const int kt = n >> 1, h = n & 1;
    if (n < Frags<DM>::NT) {
      // w0x, w0y of columns 8n + 2t, + 1; then their b0
      const float4 w = *reinterpret_cast<const float4*>(s_par + 4 * (4 * n + t));
      const float2 bb = *reinterpret_cast<const float2*>(s_par + 2 * DM + 8 * n + 2 * t);
#pragma unroll
      for (int r = 0; r < 2; ++r)
        ha[kt][2 * h + r] = mma::pack_relu_bf16(fmaf(w.x, xv[r], fmaf(w.z, yv[r], bb.x)),
                                                fmaf(w.y, xv[r], fmaf(w.w, yv[r], bb.y)));
    } else {
      ha[kt][2 * h] = ha[kt][2 * h + 1] = 0u;
    }
  }
}

// z2 = h1 w1 + b1 in f32 accumulator fragments
template <int DM>
__device__ __forceinline__ void layer2(float (&z)[Frags<DM>::NT][4],
                                       const uint32_t (&ha)[Frags<DM>::KT][4],
                                       const uint32_t (&bz)[Frags<DM>::KT][Frags<DM>::NT][2],
                                       const float* s_par, int t) {
#pragma unroll
  for (int n = 0; n < Frags<DM>::NT; ++n) {
    const float4 bw = b1_w2<DM>(s_par, n, t);
    z[n][0] = z[n][2] = bw.x;
    z[n][1] = z[n][3] = bw.y;
#pragma unroll
    for (int kt = 0; kt < Frags<DM>::KT; ++kt)
      mma::mma_bf16(z[n], ha[kt], bz[kt][n][0], bz[kt][n][1]);
  }
}

// ---- f32: layers 1 and 2 on the tf32 tensor cores (3xTF32) -------------------
//
//   a  = w0x * dx + (w0y * dy + b0)    f32, as fmaf(w0x, dx, fmaf(w0y, dy, b0))
//   h1 = relu(a)                       f32, never rounded
//   z2 = h1 w1 + b1                    mma.sync m16n8k8, h1 and w1 split as
//                                      hi + lo (mma::split_tf32), f32 sums from b1
//
// m16n8k8 gives each lane k positions t and t + 4 of a k8 step; h1's A
// fragment of step kb gives them its columns 8kb + 2t and 8kb + 2t + 1
// (mma::split_accum's permutation), which are the lane's own columns of h1 in
// the accumulator layout, and w1's B fragment reads rows 8kb + 2t and 8kb + 2t
// + 1 to match.  So h1, z2 and every other accumulator-layout tile of a
// 16-pair step share each lane's columns, and no value moves between lanes.
namespace tf32 {

template <int DM>
struct Frags {
  static_assert(DM % 8 == 0 && DM <= 32, "dm columns in n8 tiles");
  static constexpr int NT = DM / 8;   // n8 tiles over dm, and k8 steps over dm
};

// floats of one dm x dm matrix as split B fragments (stage_b)
template <int DM>
__host__ __device__ constexpr int b_floats() {
  return 2 * DM * DM;
}

// floats of the weights in shared memory (stage_params)
template <int DM>
__host__ __device__ constexpr int par_floats() {
  return 7 * DM;
}

// The f32 weights in the layout of cpb::stage_params, then [DM/2][4] (b1[c],
// b1[c+1], b1[c], b1[c+1]): z2's accumulator fragment started at b1 in one
// 16-byte load.  Threads tid, tid + nthreads, ...
template <int DM>
__device__ __forceinline__ void stage_params(float* s_par, const float* w0x, const float* w0y,
                                             const float* b0, const float* b1, const float* w2,
                                             int tid, int nthreads) {
  for (int i = tid; i < DM; i += nthreads) {
    const int c = 4 * (i >> 1) + (i & 1);
    s_par[c] = w0x[i];
    s_par[c + 2] = w0y[i];
    s_par[2 * DM + i] = b0[i];
    s_par[3 * DM + c] = b1[i];
    s_par[3 * DM + c + 2] = w2[i];
    s_par[5 * DM + c] = s_par[5 * DM + c + 2] = b1[i];
  }
}

// The B fragments of x w for a row-major dm x dm f32 matrix w (k x n), or of
// x w^T with TRANS, each element of row k times kscale[k] if kscale is given
// (rounded once in f32), split once (mma::split_tf32), in fragment order:
// entry (kb * NT + n) * 32 + lane is {hi(b0), hi(b1), lo(b0), lo(b1)} of lane
// (g, t), b0 the element at (k 8kb + 2t, n 8n + g) and b1 at (k 8kb + 2t + 1,
// n 8n + g): one conflict-free 16-byte load a lane per k8 step and n8 tile.
// Threads tid, tid + nthreads, ...
template <int DM, bool TRANS>
__device__ __forceinline__ void stage_b(uint4* dst, const float* w, const float* kscale,
                                        int tid, int nthreads) {
  constexpr int NT = Frags<DM>::NT;
  for (int i = tid; i < NT * NT * 32; i += nthreads) {
    const int lane = i & 31, n = (i >> 5) % NT, kb = (i >> 5) / NT;
    const int k = 8 * kb + 2 * (lane & 3), c = 8 * n + (lane >> 2);
    float b0 = TRANS ? w[c * DM + k] : w[k * DM + c];
    float b1 = TRANS ? w[c * DM + k + 1] : w[(k + 1) * DM + c];
    if (kscale) {
      b0 *= kscale[k];
      b1 *= kscale[k + 1];
    }
    uint4 v;
    mma::split_tf32(b0, v.x, v.z);
    mma::split_tf32(b1, v.y, v.w);
    dst[i] = v;
  }
}

// Layer 1 of the lane's pairs in T m16 tiles of pairs (dx xv[i][r], dy
// yv[i][r] of pair g + 8r of tile i) in f32: h1 = relu(a) in the accumulator
// layout of n8 tile n, element 2r + h at column 8n + 2t + h
template <int DM, int T>
__device__ __forceinline__ void layer1(float (&h)[T][Frags<DM>::NT][4], const float* s_par,
                                       const float (&xv)[T][2], const float (&yv)[T][2],
                                       int t) {
#pragma unroll
  for (int n = 0; n < Frags<DM>::NT; ++n) {
    // w0x, w0y of columns 8n + 2t, + 1; then their b0
    const float4 w = *reinterpret_cast<const float4*>(s_par + 4 * (4 * n + t));
    const float2 bb = *reinterpret_cast<const float2*>(s_par + 2 * DM + 8 * n + 2 * t);
#pragma unroll
    for (int i = 0; i < T; ++i)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        h[i][n][2 * r] = fmaxf(fmaf(w.x, xv[i][r], fmaf(w.z, yv[i][r], bb.x)), 0.f);
        h[i][n][2 * r + 1] = fmaxf(fmaf(w.y, xv[i][r], fmaf(w.w, yv[i][r], bb.y)), 0.f);
      }
  }
}

// z2 = h1 w1 + b1 of T m16 tiles of pairs in f32 accumulator fragments,
// 3xTF32 with h1 split here (to nearest) and w1 from s_wz (stage_b<DM,
// false>), each B fragment loaded once for the T tiles: per k8 step and n8
// tile the two small products (h1_lo w1_hi, h1_hi w1_lo), then the big one, in
// one chain per tile from b1 (3 dm / 8 products; the tensor core truncates
// what it carries by at most an ulp of the running sum a product)
template <int DM, int T>
__device__ __forceinline__ void layer2(float (&z)[T][Frags<DM>::NT][4],
                                       const float (&h)[T][Frags<DM>::NT][4], const uint4* s_wz,
                                       const float* s_par, int lane, int t) {
  constexpr int NT = Frags<DM>::NT;
  uint32_t ah[T][NT][4], al[T][NT][4];
#pragma unroll
  for (int i = 0; i < T; ++i)
#pragma unroll
    for (int kb = 0; kb < NT; ++kb) mma::split_accum(ah[i][kb], al[i][kb], h[i][kb]);
#pragma unroll
  for (int i = 0; i < T; ++i)
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float4 bq = *reinterpret_cast<const float4*>(s_par + 5 * DM + 4 * (4 * n + t));
      z[i][n][0] = bq.x;
      z[i][n][1] = bq.y;
      z[i][n][2] = bq.z;
      z[i][n][3] = bq.w;
    }
#pragma unroll
  for (int kb = 0; kb < NT; ++kb)
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const uint4 b = s_wz[(kb * NT + n) * 32 + lane];
#pragma unroll
      for (int i = 0; i < T; ++i) {
        mma::mma_tf32(z[i][n], al[i][kb], b.x, b.y);
        mma::mma_tf32(z[i][n], ah[i][kb], b.z, b.w);
        mma::mma_tf32(z[i][n], ah[i][kb], b.x, b.y);
      }
    }
}

}  // namespace tf32

}  // namespace cpb
