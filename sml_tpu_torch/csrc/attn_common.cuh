// Helpers shared by the attention kernels (deform_attn.cu, deform_attn_bwd.cu):
// the per-bag span mask and, for the f32 dh = 64 forward's CUDA-core twin
// (the tensor-core kernels' pieces are in attn_tc.cuh), 16-byte vector loads
// of float rows, warp reductions, the padded shared-memory row stride of K
// and V, the key tiles that stream K and V through shared memory and the
// Philox dropout multipliers of a row's key tile.

#pragma once

#include <cuda_runtime.h>

#include "philox.cuh"

namespace attn {

__device__ __forceinline__ float to_f32(float x) { return x; }

// one 16-byte vector of T, converted to floats
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* f) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  }
};

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ void store2(float* p, float2 v) {
  *reinterpret_cast<float2*>(p) = v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__host__ __device__ constexpr int row_stride(int dh) {
  return dh + Vec16<T>::N;  // one extra 16-byte unit: an odd count of units per row
}

// -finfo(f32).max, the fill of masked columns (the Pallas kernel's _NEG_INF)
constexpr float kNegMax = -3.4028234663852886e38f;

// Keys per shared-memory tile.  Lane l of a warp takes the keys l + 32 t
// (t < 4) of a tile, one K row each, so the 32 rows a warp reads at once are
// consecutive (the padded stride keeps them on distinct banks).
constexpr int kTile = 128;

// Stage keys [j0, j0 + kTile) of one bag's K and V (kg, vg: (J, DH) rows) in
// shared memory rows of stride row_stride<T>(DH); rows past J are zeroed so
// that a zero probability never meets a stale value.
template <typename T, int DH>
__device__ __forceinline__ void stage_kv_tile(const T* __restrict__ kg,
                                              const T* __restrict__ vg, T* s_k, T* s_v,
                                              int j0, int J) {
  constexpr int VN = Vec16<T>::N;
  constexpr int LD = row_stride<T>(DH);
  constexpr int VPR = DH / VN;
  for (int i = threadIdx.x; i < kTile * VPR; i += blockDim.x) {
    const int r = i / VPR;
    const int c = (i - r * VPR) * VN;
    uint4 kk = make_uint4(0u, 0u, 0u, 0u), vv = kk;
    if (j0 + r < J) {
      kk = *reinterpret_cast<const uint4*>(kg + (size_t)(j0 + r) * DH + c);
      vv = *reinterpret_cast<const uint4*>(vg + (size_t)(j0 + r) * DH + c);
    }
    *reinterpret_cast<uint4*>(s_k + r * LD + c) = kk;
    *reinterpret_cast<uint4*>(s_v + r * LD + c) = vv;
  }
}

// Stage `rows` rows of a (N, DH) matrix from row row0 in shared memory.
template <typename T, int DH>
__device__ __forceinline__ void stage_rows(const T* __restrict__ g, T* s, int rows) {
  constexpr int VN = Vec16<T>::N;
  constexpr int LD = row_stride<T>(DH);
  constexpr int VPR = DH / VN;
  for (int i = threadIdx.x; i < rows * VPR; i += blockDim.x) {
    const int r = i / VPR;
    const int c = (i - r * VPR) * VN;
    *reinterpret_cast<uint4*>(s + r * LD + c) =
        *reinterpret_cast<const uint4*>(g + (size_t)r * DH + c);
  }
}

// s[t] = x . key(lane + 32 t) for t < nt: x is one row in shared memory (read
// by every lane at once), the keys are rows of a staged tile.  The products
// are summed in column order, the order of the keys kernel of the backward.
template <typename T, int DH>
__device__ __forceinline__ void dot_keys(const T* x, const T* s_tile, int lane, int nt,
                                         float (&s)[kTile / 32]) {
  constexpr int VN = Vec16<T>::N;
  constexpr int LD = row_stride<T>(DH);
  float xr[DH];
#pragma unroll
  for (int c = 0; c < DH; c += VN) Vec16<T>::load(x + c, xr + c);
#pragma unroll
  for (int t = 0; t < kTile / 32; ++t) {
    s[t] = 0.f;
    if (t < nt) {
      const T* kr = s_tile + (lane + 32 * t) * LD;
#pragma unroll
      for (int c = 0; c < DH; c += VN) {
        float kf[VN];
        Vec16<T>::load(kr + c, kf);
#pragma unroll
        for (int e = 0; e < VN; ++e) s[t] = fmaf(xr[c + e], kf[e], s[t]);
      }
    }
  }
}

// The per-bag validity interval [row_start, row_end) x [col_start, col_end) of
// the span form (the Pallas kernel's _span_valid).  A row outside the rows, or
// a row with no valid column in [0, J), is uniform: its scores are 0 on every
// column, which is what the Pallas kernel's where(col, s, -f32max) then
// where(row, ., 0) give.  Any other row fills its invalid columns with
// -f32max, whose probability is exactly 0.  Every masked pair's cotangent is 0.
struct SpanMask {
  int rs, re, cs, ce;
  bool any_col;
  __device__ __forceinline__ bool uniform(int row) const {
    return !(row >= rs && row < re && any_col);
  }
  __device__ __forceinline__ bool col(int j) const { return j >= cs && j < ce; }
};

template <bool HAS_SPAN>
__device__ __forceinline__ SpanMask load_span(const int* __restrict__ span, int bg, int J) {
  SpanMask m{0, 0x7fffffff, 0, 0x7fffffff, true};
  if (HAS_SPAN) {
    const int4 s = *reinterpret_cast<const int4*>(span + 4 * bg);
    m = SpanMask{s.x, s.y, s.z, s.w, max(s.z, 0) < min(s.w, J)};
  }
  return m;
}

// The masked score of key j in a row that is (or is not) uniform.
template <bool HAS_SPAN>
__device__ __forceinline__ float mask_score(float s, const SpanMask& m, bool uniform,
                                            int j) {
  if (!HAS_SPAN) return s;
  return uniform ? 0.f : (m.col(j) ? s : kNegMax);
}

// Whether the pair (row, j) of a row that is (or is not) uniform keeps its
// cotangent.
template <bool HAS_SPAN>
__device__ __forceinline__ bool pair_valid(const SpanMask& m, bool uniform, int j) {
  return !HAS_SPAN || (!uniform && m.col(j));
}

// The dropout multipliers {0, inv_keep} of keys [j0, j0 + kTile) of one row,
// into s_mult[kTile]: lane l draws keys 4 l .. 4 l + 3 from one Philox call
// (philox.cuh); keys past J get 0.  The caller syncs the warp before reading.
__device__ __forceinline__ void drop_mult_tile(float* s_mult, unsigned long long seed,
                                               int j0, int J, int row, int bg,
                                               float keep_prob, float inv_keep, int lane) {
  const int j = j0 + 4 * lane;
  uint4 bits = make_uint4(0u, 0u, 0u, 0u);
  if (j < J) bits = philox::bits4(seed, j >> 2, row, bg);
#pragma unroll
  for (int w = 0; w < 4; ++w)
    s_mult[4 * lane + w] =
        (j + w < J && philox::keep(philox::word(bits, w), keep_prob)) ? inv_keep : 0.f;
}

}  // namespace attn
