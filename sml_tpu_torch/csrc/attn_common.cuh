// Helpers shared by the attention kernels (deform_attn.cu, deform_attn_bwd.cu,
// through attn_tc.cuh and attn_tf32.cuh): the masked-column fill and the
// per-bag span mask.

#pragma once

#include <cuda_runtime.h>

namespace attn {

// -finfo(f32).max, the fill of masked columns (the Pallas kernel's _NEG_INF)
constexpr float kNegMax = -3.4028234663852886e38f;

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

}  // namespace attn
