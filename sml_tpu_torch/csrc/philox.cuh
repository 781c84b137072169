// Philox4x32-10 keep decisions for the in-kernel dropout of the attention kernels.
//
// The keep decision of element (bg, row, col) of a (BG, N, J) probability
// tensor is a pure function of (seed, bg, row, col): one Philox4x32-10 call on
// the counter (col / 4, row, bg, 0) with the key (seed low word, seed high
// word) gives four 32-bit words, and word col % 4 is that element's bits.  It
// is kept when u = (bits & 0x7FFFFF) * 2^-23 < keep_prob, the rule of the
// Pallas kernel's _dropout_mult.  Nothing depends on tile sizes, so the
// forward kernel, the backward kernel and the plain PyTorch version
// (sml_tpu_torch/ops/kernels/philox.py) draw the same mask.

#pragma once

#include <stdint.h>

namespace philox {

constexpr uint32_t kM0 = 0xD2511F53u;
constexpr uint32_t kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u;
constexpr uint32_t kW1 = 0xBB67AE85u;

// the four 32-bit words of Philox4x32-10 for counter (c0, c1, c2, 0)
__device__ __forceinline__ uint4 bits4(uint64_t seed, uint32_t c0, uint32_t c1,
                                       uint32_t c2) {
  uint32_t k0 = static_cast<uint32_t>(seed), k1 = static_cast<uint32_t>(seed >> 32);
  uint32_t x0 = c0, x1 = c1, x2 = c2, x3 = 0u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += kW0;
      k1 += kW1;
    }
    const uint32_t hi0 = __umulhi(kM0, x0), lo0 = kM0 * x0;
    const uint32_t hi1 = __umulhi(kM1, x2), lo1 = kM1 * x2;
    x0 = hi1 ^ x1 ^ k0;
    x1 = lo1;
    x2 = hi0 ^ x3 ^ k1;
    x3 = lo0;
  }
  return make_uint4(x0, x1, x2, x3);
}

__device__ __forceinline__ uint32_t word(const uint4& b, int i) {
  return i == 0 ? b.x : (i == 1 ? b.y : (i == 2 ? b.z : b.w));
}

__device__ __forceinline__ bool keep(uint32_t bits, float keep_prob) {
  return static_cast<float>(bits & 0x7FFFFFu) * (1.0f / 8388608.0f) < keep_prob;
}

// the keep decisions of the four words of b as bits 0..3
__device__ __forceinline__ uint32_t keep4(const uint4& b, float keep_prob) {
  return static_cast<uint32_t>(keep(b.x, keep_prob)) |
         static_cast<uint32_t>(keep(b.y, keep_prob)) << 1 |
         static_cast<uint32_t>(keep(b.z, keep_prob)) << 2 |
         static_cast<uint32_t>(keep(b.w, keep_prob)) << 3;
}

}  // namespace philox
