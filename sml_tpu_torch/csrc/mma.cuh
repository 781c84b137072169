// Warp-level tensor-core building blocks for sm_80 and later (sm_90a here):
// the bf16 m16n8k16 product with f32 accumulators, ldmatrix loads of its
// operands from shared memory, 16-byte cp.async copies from device memory,
// and the lane maps of the fragments; at the end, f32 products on the tf32
// tensor cores (3xTF32).  Plain inline PTX, no CUTLASS / CuTe.
//
// Fragments of mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, for lane
// l of a warp, g = l / 4 and t = l % 4 (PTX ISA, "Matrix Fragments for
// mma.m16n8k16"); each 32-bit register holds two bf16, the lower column in
// the low half:
//   A (16 x 16, row-major)  a[0] = (g, 2t..2t+1)    a[1] = (g + 8, 2t..2t+1)
//                           a[2] = (g, 2t+8..2t+9)  a[3] = (g + 8, 2t+8..2t+9)
//   B (16 x 8, k x n)       b[0] = (k 2t..2t+1, n g)   b[1] = (k 2t+8..2t+9, n g)
//   C, D (16 x 8, f32)      c[e] = (frag_row(l, e), frag_col(l, e)):
//                           c[0], c[1] = (g, 2t), (g, 2t+1); c[2], c[3] = row g + 8
// So the accumulators of two neighbouring n8 tiles (columns 0-7 and 8-15),
// rounded to bf16 and packed in pairs, are an A fragment whose k runs over
// those 16 columns (accum_to_a).
//
// ldmatrix.x4 loads four 8 x 8 b16 matrices; lanes 8i..8i+7 give the shared
// address of row 0..7 of matrix i (16 bytes each) and register i receives
// matrix i: (row g, columns 2t, 2t+1), or with .trans (rows 2t, 2t+1, column g).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// d += a b, m16n8k16, bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The transpose of an 8 x 8 b16 matrix held one register per lane in the
// ldmatrix layout (row g, columns 2t, 2t+1), returned in the same layout,
// without shared memory.  Each register of an A fragment, or of a B fragment
// read as the transposed matrix, is such an 8 x 8 block.
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t a) {
  uint32_t d;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(d) : "r"(a));
  return d;
}

// 16 bytes from device to shared memory, asynchronously: the first `bytes`
// (0..16) read from src (16-byte aligned), the rest zero-filled; with 0
// nothing is read (src must still be a device address)
__device__ __forceinline__ void cp_async16n(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}
// the same, all 16 bytes or (!valid) none
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  cp_async16n(dst, src, valid ? 16 : 0);
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the (row, column) of accumulator element e (0..3) of lane l in an m16n8 tile
__device__ __forceinline__ int frag_row(int lane, int e) {
  return (lane >> 2) + ((e >> 1) << 3);
}
__device__ __forceinline__ int frag_col(int lane, int e) { return ((lane & 3) << 1) + (e & 1); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// relu(lo), relu(hi) rounded to bf16 and packed, lo in the low half
__device__ __forceinline__ uint32_t pack_relu_bf16(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

// The A fragment (16 x 16, k over 16 columns) of the accumulators c0
// (columns 0-7) and c1 (columns 8-15), rounded to bf16.
__device__ __forceinline__ void accum_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                           const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// A (16 x 16) fragment of rows r0.. of a row-major bf16 matrix in device
// memory (ld elements per row), columns k0..k0+15; rows >= rows_valid give 0.
__device__ __forceinline__ void load_a_global(uint32_t (&a)[4], const __nv_bfloat16* m,
                                              int ld, int r0, int rows_valid, int k0,
                                              int lane) {
  const int r = r0 + (lane >> 2), c = k0 + ((lane & 3) << 1);
  const uint32_t* lo = reinterpret_cast<const uint32_t*>(m + (size_t)r * ld + c);
  const uint32_t* hi = reinterpret_cast<const uint32_t*>(m + (size_t)(r + 8) * ld + c);
  const bool ok_lo = r < rows_valid, ok_hi = r + 8 < rows_valid;
  a[0] = ok_lo ? lo[0] : 0u;
  a[1] = ok_hi ? hi[0] : 0u;
  a[2] = ok_lo ? lo[4] : 0u;
  a[3] = ok_hi ? hi[4] : 0u;
}

// Shared-memory tiles of rows of 64 bf16 (8 chunks of 16 bytes), chunk c of
// row r stored at chunk c ^ (r % 8): the 8 rows an ldmatrix phase reads at
// one chunk fall on 8 distinct 16-byte bank groups.
__device__ __forceinline__ int swz64(int r, int chunk) {
  return r * 64 + ((chunk ^ (r & 7)) << 3);
}

// ---- f32 products on the tf32 tensor cores (3xTF32) -------------------------
//
// Fragments of mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 (PTX ISA,
// "Matrix Fragments for mma.m16n8k8", .tf32), one 32-bit element a register,
// lane l, g = l / 4, t = l % 4:
//   A (16 x 8)  a[0] = (g, t)  a[1] = (g + 8, t)  a[2] = (g, t + 4)  a[3] = (g + 8, t + 4)
//   B (8 x 8)   b0 = (k t, n g)  b1 = (k t + 4, n g)
//   C, D        as m16n8k16: c[0], c[1] = (g, 2t), (g, 2t + 1); c[2], c[3] = row g + 8
// A k index is only a position in the sum, so a product may give position t
// of a lane any column of its operands as long as A and B give it the same
// one.  Hence an accumulator is an A fragment without a shuffle
// (split_accum): position t takes its column 2t and position t + 4 its
// column 2t + 1, and the B fragment of that product reads its k rows 2t and
// 2t + 1.
//
// An f32 x is split as x = hi + lo: hi is x rounded to tf32, lo the exact
// rest x - hi, itself rounded to tf32 (|lo - x + hi| <= 2^-22 |x|).
// Then a b = a_hi b_hi + a_hi b_lo + a_lo b_hi up to the dropped a_lo b_lo
// (about 2^-22 |a b|), against about 2^-11 for one tf32 product; each
// tf32 x tf32 product is exact in f32.

// d += a b, m16n8k8, tf32 operands, f32 accumulators
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x split as hi + lo, each rounded to tf32 to nearest with ties away from
// zero: cvt.rna.tf32.f32's rounding, here in two integer operations (ptxas
// turns cvt.rna into a longer compare-and-select sequence on sm_90a)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// x split as hi + lo in two operations: hi is x truncated to tf32 (its low
// 13 bits cleared), lo the exact rest x - hi as f32, whose low 13 bits the
// tensor core does not read (a tf32 operand is a 32-bit register with them
// ignored), so lo is truncated there: |error| <= 2^-20 |x|, against
// split_tf32's 2^-22 at five operations.
__device__ __forceinline__ void split_tf32_trunc(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// big + small += a b as three tf32 products: the small ones first (a_lo b_hi,
// a_hi b_lo) into small, the big one (a_hi b_hi) into big; the caller adds
// small to big in f32.  The tensor core truncates the sums it carries: apart,
// the small terms never meet the big ones there, and the two chains run
// independently.
__device__ __forceinline__ void mma_3xtf32(float (&big)[4], float (&small)[4],
                                           const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                           uint32_t bh0, uint32_t bh1, uint32_t bl0,
                                           uint32_t bl1) {
  mma_tf32(small, al, bh0, bh1);
  mma_tf32(small, ah, bl0, bl1);
  mma_tf32(big, ah, bh0, bh1);
}

// The split A fragment of an m16n8 accumulator c: k position t is its column
// 2t, position t + 4 its column 2t + 1.
__device__ __forceinline__ void split_accum(uint32_t (&ah)[4], uint32_t (&al)[4],
                                            const float (&c)[4]) {
  split_tf32(c[0], ah[0], al[0]);
  split_tf32(c[2], ah[1], al[1]);
  split_tf32(c[1], ah[2], al[2]);
  split_tf32(c[3], ah[3], al[3]);
}

// Shared-memory tiles of f32 rows of 32 (8 chunks of 16 bytes, as the bf16
// tiles' rows of 64): chunk c / 4 of row r stored at chunk (c / 4) ^ (r % 8),
// the swizzle of swz64 in bytes.  ldmatrix reads 8 rows at one chunk, and the
// lanes (g, t) reading rows 2t (or 2t + 1) at column 8 n + g fall on 32
// distinct banks.
__device__ __forceinline__ int swz32f(int r, int c) {
  return r * 32 + ((((c >> 2) ^ r) & 7) << 2) + (c & 3);
}

// The same for f32 rows of 64 (16 chunks): chunk c / 4 of row r stored at
// chunk (c / 4) ^ (r % 8), the low three bits of the chunk index swizzled.
// The 8 rows an ldmatrix phase reads at one chunk, and the lanes (g, t)
// reading rows 2t (or 2t + 1) at column 8 n + g, fall on distinct banks.
__device__ __forceinline__ int swz64f(int r, int c) {
  return r * 64 + (((c >> 2) ^ (r & 7)) << 2) + (c & 3);
}

}  // namespace mma
