// Attention forward for sm_90a, key-tiled:
//
//   out[bg, i] = dropout(softmax_j(mask(q[bg, i] . k[bg, j] + bias[bg, i, j]))) @ v[bg]
//
// q (BG, N, DH) is already scaled; k, v (BG, J, DH); bias (BG, N, J) in q's
// dtype or absent; out (BG, N, DH) in q's dtype.  Replaces the Pallas kernel
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
// One block per (bg, tile of kRows query rows), the q rows in shared memory.
// K and V stream through shared memory in tiles of kTile keys, so J has no
// limit (the Nystrom chain 3 has J = 2560 or 4352).  Each warp owns query
// rows; per tile and row its lanes take the keys lane + 32 t, reduce the
// tile's max and sum of exponentials with shuffles, and update the row's
// running max, running sum and rescaled accumulator (online softmax; the
// accumulator is f32 in shared memory, two output columns per lane).  A
// masked column's -f32max keeps a first all-masked tile from poisoning the
// sum: exp(m_old - m_new) is then 0.  Rows past N are skipped.
//
// What bounds it: at the Nystrom chains (J or N of 2560 / 4352, dh 64, bf16)
// about 4 * DH FLOP per pair against q, K, V and out read or written once, so
// operations on the tensor cores would be the bound; the products here run
// on the CUDA cores in f32.  Chain 3 has 256 rows per bag: 4 row tiles x BG
// blocks, about 2 blocks per SM at BG = 64 (the keys are not split yet).
//
// C entry: deform_attn_fwd(dtype, q, k, v, bias, span, out, BG, N, J, DH,
//                          keep_prob, inv_keep, seed, device, stream)
//          -> cudaGetLastError().
// dtype: 0 = float, 1 = bfloat16 for q, k, v, bias and out.  bias and span
// may be null.  DH must be 64.  The library carries its own CUDA runtime, so
// the entry selects `device` itself.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attn_common.cuh"
#include "philox.cuh"

namespace {

using namespace attn;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 64;

template <typename T, int DH>
constexpr size_t smem_bytes() {
  return (size_t)(kRows + 2 * kTile) * row_stride<T>(DH) * sizeof(T)  // q rows, K, V
         + 2 * (size_t)kWarps * kTile * sizeof(float)                 // p, multipliers
         + (size_t)kRows * (DH + 2) * sizeof(float);                  // acc, max, sum
}

template <typename T, int DH, bool HAS_BIAS, bool HAS_SPAN, bool DROP>
__global__ void __launch_bounds__(kThreads)
deform_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ bias,
                       const int* __restrict__ span, T* __restrict__ out, int N, int J,
                       float keep_prob, float inv_keep, unsigned long long seed) {
  static_assert(DH == 64, "each lane owns DH / 32 = 2 output columns");
  constexpr int LD = row_stride<T>(DH);
  constexpr int NT = kTile / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_q = reinterpret_cast<T*>(smem_raw);
  T* s_k = s_q + kRows * LD;
  T* s_v = s_k + kTile * LD;
  float* s_p = reinterpret_cast<float*>(s_v + kTile * LD);  // [kWarps][kTile]
  float* s_mult = s_p + kWarps * kTile;                      // [kWarps][kTile]
  float* s_acc = s_mult + kWarps * kTile;                    // [kRows][DH]
  float* s_m = s_acc + kRows * DH;                           // [kRows] running max
  float* s_l = s_m + kRows;                                  // [kRows] running sum

  const int bg = blockIdx.y;
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, N - row0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const SpanMask mask = load_span<HAS_SPAN>(span, bg, J);
  stage_rows<T, DH>(q + ((size_t)bg * N + row0) * DH, s_q, rows);
  for (int i = threadIdx.x; i < kRows * DH; i += kThreads) s_acc[i] = 0.f;
  if (threadIdx.x < kRows) {
    s_m[threadIdx.x] = -INFINITY;
    s_l[threadIdx.x] = 0.f;
  }
  const T* kg = k + (size_t)bg * J * DH;
  const T* vg = v + (size_t)bg * J * DH;
  float* p = s_p + warp * kTile;
  float* mult = s_mult + warp * kTile;

  for (int j0 = 0; j0 < J; j0 += kTile) {
    __syncthreads();  // the previous tile is consumed (first: q and the state are set)
    stage_kv_tile<T, DH>(kg, vg, s_k, s_v, j0, J);
    __syncthreads();
    const int len = min(kTile, J - j0);
    const int nt = (len + 31) / 32;
    for (int r = warp; r < rows; r += kWarps) {
      const int row = row0 + r;
      const bool uniform = HAS_SPAN && mask.uniform(row);
      if (DROP) drop_mult_tile(mult, seed, j0, J, row, bg, keep_prob, inv_keep, lane);
      float s[NT];
      dot_keys<T, DH>(s_q + r * LD, s_k, lane, nt, s);
      float tmax = -INFINITY;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const int j = j0 + lane + 32 * t;
        if (t < nt && j < J) {
          if (HAS_BIAS) s[t] += to_f32(bias[((size_t)bg * N + row) * J + j]);
          s[t] = mask_score<HAS_SPAN>(s[t], mask, uniform, j);
        } else {
          s[t] = -INFINITY;
        }
        tmax = fmaxf(tmax, s[t]);
      }
      tmax = warp_max(tmax);
      const float m_old = s_m[r];
      const float m_new = fmaxf(m_old, tmax);
      const float scale = expf(m_old - m_new);
      if (DROP) __syncwarp();  // lanes read multipliers that other lanes drew
      float es = 0.f;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const float e = expf(s[t] - m_new);
        es += e;
        if (t < nt) p[lane + 32 * t] = DROP ? e * mult[lane + 32 * t] : e;
      }
      es = warp_sum(es);
      __syncwarp();  // p is written, and every lane has read s_m[r]

      float2* acc = reinterpret_cast<float2*>(s_acc + r * DH) + lane;
      float2 a = *acc;
      a.x *= scale;
      a.y *= scale;
      const T* vcol = s_v + 2 * lane;
#pragma unroll 4
      for (int jj = 0; jj < len; ++jj) {
        const float pj = p[jj];
        const float2 vv = load2(vcol + jj * LD);
        a.x = fmaf(pj, vv.x, a.x);
        a.y = fmaf(pj, vv.y, a.y);
      }
      *acc = a;
      if (lane == 0) {
        s_m[r] = m_new;
        s_l[r] = s_l[r] * scale + es;
      }
      __syncwarp();  // the next row rewrites p and the multipliers
    }
  }
  for (int r = warp; r < rows; r += kWarps) {
    const float2 a = reinterpret_cast<const float2*>(s_acc + r * DH)[lane];
    const float inv = 1.f / s_l[r];
    store2(out + ((size_t)bg * N + row0 + r) * DH + 2 * lane,
           make_float2(a.x * inv, a.y * inv));
  }
}

struct Args {
  const void *q, *k, *v, *bias;
  const int* span;
  void* out;
  int BG, N, J;
  float keep_prob, inv_keep;
  unsigned long long seed;
  cudaStream_t stream;
};

template <typename T, bool HAS_BIAS, bool HAS_SPAN, bool DROP>
cudaError_t launch(const Args& a) {
  constexpr int DH = 64;
  constexpr size_t smem = smem_bytes<T, DH>();
  auto kernel = deform_attn_fwd_kernel<T, DH, HAS_BIAS, HAS_SPAN, DROP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + kRows - 1) / kRows, a.BG);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.bias), a.span, static_cast<T*>(a.out), a.N, a.J,
      a.keep_prob, a.inv_keep, a.seed);
  return cudaGetLastError();
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

extern "C" int deform_attn_fwd(int dtype, const void* q, const void* k, const void* v,
                               const void* bias, const void* span, void* out, int BG,
                               int N, int J, int DH, float keep_prob, float inv_keep,
                               unsigned long long seed, int device, void* stream) {
  if (DH != 64) return cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Args a{q, k, v, bias, static_cast<const int*>(span), out, BG, N, J, keep_prob,
               inv_keep, seed, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return dispatch<float>(a);
  if (dtype == 1) return dispatch<__nv_bfloat16>(a);
  return cudaErrorInvalidValue;
}
