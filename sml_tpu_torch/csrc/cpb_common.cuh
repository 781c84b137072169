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

}  // namespace cpb
