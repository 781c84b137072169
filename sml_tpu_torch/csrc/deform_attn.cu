// Deformable-attention forward for sm_90a:
//
//   out[bg, i] = softmax_j(q[bg, i] . k[bg, j] + bias[bg, i, j]) @ v[bg]
//
// q (BG, N, DH) is already scaled; k, v (BG, J, DH); bias (BG, N, J) in float
// or bfloat16, upcast to f32; out (BG, N, DH) in q's dtype.  Replaces the
// Pallas kernel _fused_attn_fwd_call (sml_tpu/ops/pallas/deform_attn.py, body
// _attn_fwd_kernel and its dropout _dropout_mult) with no span mask.
//
// Dropout (keep_prob < 1, the DROP instantiation): the multiplier {0, 1/keep}
// of each probability comes from Philox4x32-10 on (seed, bg, row, col)
// (philox.cuh), applied after the normalisation and before @ v; no mask
// reaches device memory.  keep_prob == 1 runs the eval instantiation, whose
// arithmetic is unchanged.
//
// One block per (bg, tile of kRows query rows).  K and V of the sample sit in
// dynamic shared memory in the input dtype, rows padded by 16 bytes so that
// 16-byte loads of neighbouring rows fall in different banks.  Each warp owns
// query rows: its lanes take the keys j = lane, lane+32, ... (q row in
// registers, K row from shared memory), write sim + bias to a per-warp f32
// row buffer, reduce the row max and the sum of exponentials with shuffles,
// then each lane accumulates p @ V for its DH/32 output columns.  Rows past N
// in the last tile are skipped, so no input is padded.
//
// C entry: deform_attn_fwd(dtype, bias_dtype, q, k, v, bias, out, BG, N, J, DH,
//                          keep_prob, inv_keep, seed, device, stream)
//          -> cudaGetLastError().
// dtype / bias_dtype: 0 = float, 1 = bfloat16.  DH must be 64.  The library
// carries its own CUDA runtime, so the entry selects `device` itself.

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

template <typename T, typename TB, int DH, bool DROP>
__global__ void __launch_bounds__(kThreads)
deform_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const TB* __restrict__ bias,
                       T* __restrict__ out, int N, int J, float keep_prob,
                       float inv_keep, unsigned long long seed) {
  static_assert(DH == 64, "each lane owns DH / 32 = 2 output columns");
  constexpr int VN = Vec16<T>::N;
  constexpr int LD = row_stride<T>(DH);
  constexpr int VPR = DH / VN;  // 16-byte vectors per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_k = reinterpret_cast<T*>(smem_raw);
  T* s_v = s_k + (size_t)J * LD;
  float* s_p = reinterpret_cast<float*>(s_v + (size_t)J * LD);  // [kWarps][J]

  const int bg = blockIdx.y;
  const int row0 = blockIdx.x * kRows;
  const T* kg = k + (size_t)bg * J * DH;
  const T* vg = v + (size_t)bg * J * DH;
  for (int i = threadIdx.x; i < J * VPR; i += kThreads) {
    const int r = i / VPR;
    const int c = (i - r * VPR) * VN;
    *reinterpret_cast<uint4*>(s_k + r * LD + c) =
        *reinterpret_cast<const uint4*>(kg + (size_t)r * DH + c);
    *reinterpret_cast<uint4*>(s_v + r * LD + c) =
        *reinterpret_cast<const uint4*>(vg + (size_t)r * DH + c);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* p = s_p + warp * J;
  const int rows = min(kRows, N - row0);
  for (int r = warp; r < rows; r += kWarps) {
    const size_t row = (size_t)bg * N + row0 + r;
    float qr[DH];
#pragma unroll
    for (int c = 0; c < DH; c += VN) Vec16<T>::load(q + row * DH + c, qr + c);
    const TB* brow = bias + row * J;

    float mx = -INFINITY;
    for (int j = lane; j < J; j += 32) {
      const T* kr = s_k + j * LD;
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < DH; c += VN) {
        float kf[VN];
        Vec16<T>::load(kr + c, kf);
#pragma unroll
        for (int e = 0; e < VN; ++e) s = fmaf(qr[c + e], kf[e], s);
      }
      s += to_f32(brow[j]);
      p[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    if (DROP) {
      __syncwarp();  // lanes read p[j] that other lanes wrote
      // each lane takes groups of 4 keys: one Philox call gives their 4 words
      for (int g = lane; 4 * g < J; g += 32) {
        const uint4 bits = philox::bits4(seed, g, row0 + r, bg);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = 4 * g + jj;
          if (j < J) {
            const float e = expf(p[j] - mx);
            sum += e;
            p[j] = philox::keep(philox::word(bits, jj), keep_prob) ? e * inv_keep : 0.f;
          }
        }
      }
    } else {
      for (int j = lane; j < J; j += 32) {
        const float e = expf(p[j] - mx);
        p[j] = e;
        sum += e;
      }
    }
    sum = warp_sum(sum);
    __syncwarp();

    float2 acc = make_float2(0.f, 0.f);
    const T* vcol = s_v + 2 * lane;
#pragma unroll 4
    for (int j = 0; j < J; ++j) {
      const float pj = p[j];
      const float2 vv = load2(vcol + j * LD);
      acc.x = fmaf(pj, vv.x, acc.x);
      acc.y = fmaf(pj, vv.y, acc.y);
    }
    const float inv = 1.f / sum;
    store2(out + row * DH + 2 * lane, make_float2(acc.x * inv, acc.y * inv));
    __syncwarp();  // the next row rewrites p
  }
}

template <typename T, typename TB>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias,
                   void* out, int BG, int N, int J, float keep_prob, float inv_keep,
                   unsigned long long seed, cudaStream_t stream) {
  constexpr int DH = 64;
  const size_t smem = 2 * (size_t)J * row_stride<T>(DH) * sizeof(T) +
                      (size_t)kWarps * J * sizeof(float);
  auto kernel = keep_prob < 1.f ? deform_attn_fwd_kernel<T, TB, DH, true>
                                : deform_attn_fwd_kernel<T, TB, DH, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kRows - 1) / kRows, BG);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const TB*>(bias), static_cast<T*>(out), N, J, keep_prob, inv_keep,
      seed);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_bias(int bias_dtype, const void* q, const void* k, const void* v,
                          const void* bias, void* out, int BG, int N, int J,
                          float keep_prob, float inv_keep, unsigned long long seed,
                          cudaStream_t stream) {
  if (bias_dtype == 0)
    return launch<T, float>(q, k, v, bias, out, BG, N, J, keep_prob, inv_keep, seed,
                            stream);
  if (bias_dtype == 1)
    return launch<T, __nv_bfloat16>(q, k, v, bias, out, BG, N, J, keep_prob, inv_keep,
                                    seed, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int deform_attn_fwd(int dtype, int bias_dtype, const void* q, const void* k,
                               const void* v, const void* bias, void* out, int BG, int N,
                               int J, int DH, float keep_prob, float inv_keep,
                               unsigned long long seed, int device, void* stream) {
  if (DH != 64) return cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_bias<float>(bias_dtype, q, k, v, bias, out, BG, N, J, keep_prob,
                                inv_keep, seed, s);
  if (dtype == 1)
    return dispatch_bias<__nv_bfloat16>(bias_dtype, q, k, v, bias, out, BG, N, J,
                                        keep_prob, inv_keep, seed, s);
  return cudaErrorInvalidValue;
}
