// CPB bias forward for sm_90a: the continuous-position-bias MLP of the 2-D
// deformable attention, evaluated at every (query row y, query column x,
// kv point j) of every (sample, offset group) bg:
//
//   h1   = relu(w0x * dx[bg, x*J + j] + w0y * dy[bg, y, j] + b0)   (dm)
//   h2   = relu(w1^T h1 + b1)                                       (dm)
//   bias[bg, y, x*J + j] = w2 . h2 + b2
//
// Replaces the Pallas kernel fused_cpb_bias (sml_tpu/ops/pallas/deform_attn.py,
// body _fwd_kernel).  One block per (bg, y); the weights (w1 transposed, so a
// row of it is one float4-loadable run) and the row's dy sit in shared memory;
// each thread runs the whole per-pair MLP in f32 registers for kPairs lanes
// at once, so every broadcast weight load feeds kPairs FMAs.  The (BG, N, J, dm)
// activations never reach device memory.  Writes the compute dtype T.
//
// C entry: cpb_bias_fwd(dtype, dx, dy, w0x, w0y, b0, w1, b1, w2, b2, out,
//                       BG, H, W, J, dm, device, stream) -> cudaGetLastError().
// dtype 0 = float, 1 = bfloat16 (weights and output); dx, dy are float.  The
// library carries its own CUDA runtime, so the entry selects `device` itself.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPairs = 2;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int DM>
__global__ void __launch_bounds__(kThreads)
cpb_bias_kernel(const float* __restrict__ dx, const float* __restrict__ dy,
                const T* __restrict__ w0x, const T* __restrict__ w0y,
                const T* __restrict__ b0, const T* __restrict__ w1,
                const T* __restrict__ b1, const T* __restrict__ w2,
                const T* __restrict__ b2, T* __restrict__ out, int H, int W, int J) {
  static_assert(DM % 4 == 0, "w1 rows are read as float4");
  extern __shared__ __align__(16) float smem[];
  float* s_w1t = smem;              // [DM][DM]: s_w1t[m * DM + k] = w1[k][m]
  float* s_w0x = s_w1t + DM * DM;
  float* s_w0y = s_w0x + DM;
  float* s_b0 = s_w0y + DM;
  float* s_b1 = s_b0 + DM;
  float* s_w2 = s_b1 + DM;
  float* s_dy = s_w2 + DM;          // [J]: dy of this query row

  const int bg = blockIdx.x / H;
  const int y = blockIdx.x - bg * H;
  for (int i = threadIdx.x; i < DM * DM; i += kThreads) {
    const int k = i / DM;
    const int m = i - k * DM;
    s_w1t[m * DM + k] = to_f32(w1[i]);
  }
  for (int i = threadIdx.x; i < DM; i += kThreads) {
    s_w0x[i] = to_f32(w0x[i]);
    s_w0y[i] = to_f32(w0y[i]);
    s_b0[i] = to_f32(b0[i]);
    s_b1[i] = to_f32(b1[i]);
    s_w2[i] = to_f32(w2[i]);
  }
  const float* dy_row = dy + ((size_t)bg * H + y) * J;
  for (int i = threadIdx.x; i < J; i += kThreads) s_dy[i] = dy_row[i];
  __syncthreads();

  const float bias2 = to_f32(b2[0]);
  const int WJ = W * J;
  const float* dx_row = dx + (size_t)bg * WJ;
  T* out_row = out + ((size_t)bg * H + y) * WJ;

  for (int base = threadIdx.x; base < WJ; base += kThreads * kPairs) {
    float h1[kPairs][DM];
#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
      const int l = base + p * kThreads;
      const bool ok = l < WJ;
      const float dxv = ok ? dx_row[l] : 0.f;
      const float dyv = ok ? s_dy[l % J] : 0.f;
#pragma unroll
      for (int k = 0; k < DM; ++k)
        h1[p][k] = fmaxf(fmaf(s_w0x[k], dxv, fmaf(s_w0y[k], dyv, s_b0[k])), 0.f);
    }
    float acc[kPairs];
#pragma unroll
    for (int p = 0; p < kPairs; ++p) acc[p] = bias2;
#pragma unroll 4
    for (int m = 0; m < DM; ++m) {
      const float4* wrow = reinterpret_cast<const float4*>(s_w1t + m * DM);
      float z[kPairs];
#pragma unroll
      for (int p = 0; p < kPairs; ++p) z[p] = s_b1[m];
#pragma unroll
      for (int k4 = 0; k4 < DM / 4; ++k4) {
        const float4 w = wrow[k4];
#pragma unroll
        for (int p = 0; p < kPairs; ++p) {
          z[p] = fmaf(w.x, h1[p][4 * k4 + 0], z[p]);
          z[p] = fmaf(w.y, h1[p][4 * k4 + 1], z[p]);
          z[p] = fmaf(w.z, h1[p][4 * k4 + 2], z[p]);
          z[p] = fmaf(w.w, h1[p][4 * k4 + 3], z[p]);
        }
      }
      const float w2m = s_w2[m];
#pragma unroll
      for (int p = 0; p < kPairs; ++p) acc[p] = fmaf(w2m, fmaxf(z[p], 0.f), acc[p]);
    }
#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
      const int l = base + p * kThreads;
      if (l < WJ) out_row[l] = from_f32<T>(acc[p]);
    }
  }
}

template <typename T, int DM>
cudaError_t launch(const void* dx, const void* dy, const void* w0x, const void* w0y,
                   const void* b0, const void* w1, const void* b1, const void* w2,
                   const void* b2, void* out, int BG, int H, int W, int J,
                   cudaStream_t stream) {
  const size_t smem = (size_t)(DM * DM + 5 * DM + J) * sizeof(float);
  cpb_bias_kernel<T, DM><<<BG * H, kThreads, smem, stream>>>(
      static_cast<const float*>(dx), static_cast<const float*>(dy),
      static_cast<const T*>(w0x), static_cast<const T*>(w0y), static_cast<const T*>(b0),
      static_cast<const T*>(w1), static_cast<const T*>(b1), static_cast<const T*>(w2),
      static_cast<const T*>(b2), static_cast<T*>(out), H, W, J);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dm(int dm, const void* dx, const void* dy, const void* w0x,
                        const void* w0y, const void* b0, const void* w1, const void* b1,
                        const void* w2, const void* b2, void* out, int BG, int H, int W,
                        int J, cudaStream_t stream) {
  switch (dm) {
    case 8:
      return launch<T, 8>(dx, dy, w0x, w0y, b0, w1, b1, w2, b2, out, BG, H, W, J, stream);
    case 16:
      return launch<T, 16>(dx, dy, w0x, w0y, b0, w1, b1, w2, b2, out, BG, H, W, J, stream);
    case 32:
      return launch<T, 32>(dx, dy, w0x, w0y, b0, w1, b1, w2, b2, out, BG, H, W, J, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int cpb_bias_fwd(int dtype, const void* dx, const void* dy, const void* w0x,
                            const void* w0y, const void* b0, const void* w1,
                            const void* b1, const void* w2, const void* b2, void* out,
                            int BG, int H, int W, int J, int dm, int device,
                            void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_dm<float>(dm, dx, dy, w0x, w0y, b0, w1, b1, w2, b2, out, BG, H, W, J, s);
  if (dtype == 1)
    return dispatch_dm<__nv_bfloat16>(dm, dx, dy, w0x, w0y, b0, w1, b1, w2, b2, out, BG, H,
                                      W, J, s);
  return cudaErrorInvalidValue;
}
