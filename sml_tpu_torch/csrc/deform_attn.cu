// Deformable-attention forward (eval form) for sm_90a:
//
//   out[bg, i] = softmax_j(q[bg, i] . k[bg, j] + bias[bg, i, j]) @ v[bg]
//
// q (BG, N, DH) is already scaled; k, v (BG, J, DH); bias (BG, N, J) in float
// or bfloat16, upcast to f32; out (BG, N, DH) in q's dtype.  Replaces the
// Pallas kernel _fused_attn_fwd_call (sml_tpu/ops/pallas/deform_attn.py, body
// _attn_fwd_kernel) with no dropout and no span mask.
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
//                          device, stream) -> cudaGetLastError().
// dtype / bias_dtype: 0 = float, 1 = bfloat16.  DH must be 64.  The library
// carries its own CUDA runtime, so the entry selects `device` itself.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 64;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

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
template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* f) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
};

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float2 v) {
  *reinterpret_cast<float2*>(p) = v;
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float2 v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __float22bfloat162_rn(v);
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

template <typename T, typename TB, int DH>
__global__ void __launch_bounds__(kThreads)
deform_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const TB* __restrict__ bias,
                       T* __restrict__ out, int N, int J) {
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
    for (int j = lane; j < J; j += 32) {
      const float e = expf(p[j] - mx);
      p[j] = e;
      sum += e;
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
                   void* out, int BG, int N, int J, cudaStream_t stream) {
  constexpr int DH = 64;
  const size_t smem = 2 * (size_t)J * row_stride<T>(DH) * sizeof(T) +
                      (size_t)kWarps * J * sizeof(float);
  auto kernel = deform_attn_fwd_kernel<T, TB, DH>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kRows - 1) / kRows, BG);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const TB*>(bias), static_cast<T*>(out), N, J);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_bias(int bias_dtype, const void* q, const void* k, const void* v,
                          const void* bias, void* out, int BG, int N, int J,
                          cudaStream_t stream) {
  if (bias_dtype == 0) return launch<T, float>(q, k, v, bias, out, BG, N, J, stream);
  if (bias_dtype == 1)
    return launch<T, __nv_bfloat16>(q, k, v, bias, out, BG, N, J, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int deform_attn_fwd(int dtype, int bias_dtype, const void* q, const void* k,
                               const void* v, const void* bias, void* out, int BG, int N,
                               int J, int DH, int device, void* stream) {
  if (DH != 64) return cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_bias<float>(bias_dtype, q, k, v, bias, out, BG, N, J, s);
  if (dtype == 1)
    return dispatch_bias<__nv_bfloat16>(bias_dtype, q, k, v, bias, out, BG, N, J, s);
  return cudaErrorInvalidValue;
}
