// CPB bias backward for sm_90a, recompute form.  For the forward of
// cpb_bias.cu,
//
//   a    = w0x * dx[bg, x*J + j] + w0y * dy[bg, y, j] + b0,  h1 = relu(a)   (dm)
//   z2   = w1^T h1 + b1,  h2 = relu(z2)                                      (dm)
//   bias[bg, y, x*J + j] = w2 . h2 + b2
//
// and g = dbias[bg, y, x*J + j], it returns per pair
//
//   dz2 = [z2 > 0] w2 g    dz1 = [a > 0] (w1 dz2)
//   d_dx += w0x . dz1 (summed over y)    d_dy += w0y . dz1 (summed over x)
//   dw1 += h1 dz2^T, db1 += dz2, dw2 += h2 g, db2 += g,
//   dw0x += dz1 dx, dw0y += dz1 dy, db0 += dz1        (summed over every pair)
//
// Replaces the Pallas kernel _cpb_bwd_call (sml_tpu/ops/pallas/deform_attn.py,
// body _bwd_kernel).  Nothing is saved from the forward: h1 and z2 are
// recomputed in f32 registers exactly as cpb_bias.cu computes them (same fmaf
// order), so the ReLU masks are the forward's.  No (BG, N, J, dm) activation
// reaches device memory.
//
// Layout: one block per (bg, tile of kTile lanes l = x*J + j), looping over
// all H query rows (the TPU kernel's "sr" order recast for parallel blocks).
// Each thread owns kLanesPerThread lanes, so d_dx stays in registers and is
// written once.  Per row, d_dy of the block is summed in shared memory (one
// row of J per warp, combined in a fixed order) and written to a per-block
// partial (BG, tiles, H, J); the wrapper sums it over tiles.  The weight
// gradients are per-warp register sums (lane k owns row k of dw1 and entry k
// of the vectors): each warp stages h1, dz2 and h2*g (then dz1) of its 32
// pairs in shared memory, and lane k reduces over the 32 pairs.  At the end
// the warps combine in a fixed order into a per-block partial
// (BG, tiles, dm*dm + 5*dm + 1), summed by the wrapper.  No atomics touch
// device memory; the result does not vary from run to run for J >= 32.
//
// What bounds it on the H100: operations, about 6*dm^2 + 16*dm FLOP per pair
// against 2 bytes of bf16 dbias.  All three dm x dm products (z2, w1 dz2,
// h1 dz2^T) run as f32 FMAs on the CUDA cores; wgmma is later work.
//
// C entry: cpb_bias_bwd(dtype, dx, dy, w0x, w0y, b0, w1, b1, w2, dbias, ddx,
//                       ddy_part, wgrad_part, BG, H, W, J, dm, device, stream)
//          -> cudaGetLastError().
// dtype 0 = float, 1 = bfloat16 (weights and dbias); dx, dy and every output
// are float.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLanesPerThread = 2;
constexpr int kTile = kThreads * kLanesPerThread;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <int DM>
__host__ __device__ constexpr int wgrad_size() {
  return DM * DM + 5 * DM + 1;
}

// floats of dynamic shared memory before the staging area
template <int DM>
__host__ __device__ constexpr int head_floats() {
  return 2 * DM * DM + 5 * DM;
}

template <int N4>
__device__ __forceinline__ void store_row(float* dst, const float* v) {
#pragma unroll
  for (int i = 0; i < N4; ++i)
    reinterpret_cast<float4*>(dst)[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2],
                                                    v[4 * i + 3]);
}

template <typename T, int DM>
__global__ void __launch_bounds__(kThreads)
cpb_bias_bwd_kernel(const float* __restrict__ dx, const float* __restrict__ dy,
                    const T* __restrict__ w0x, const T* __restrict__ w0y,
                    const T* __restrict__ b0, const T* __restrict__ w1,
                    const T* __restrict__ b1, const T* __restrict__ w2,
                    const T* __restrict__ dbias, float* __restrict__ ddx,
                    float* __restrict__ ddy_part, float* __restrict__ wgrad_part, int H,
                    int W, int J) {
  static_assert(DM % 4 == 0 && DM <= 32, "lane k owns index k; rows are float4");
  constexpr int LD = DM + 4;          // staged row: 16-byte aligned, conflict-free
  constexpr int STAGE = 32 * LD;      // one staged (32 pairs x DM) array
  extern __shared__ __align__(16) float smem[];
  float* s_w1t = smem;                // [DM][DM]: s_w1t[m * DM + k] = w1[k][m]
  float* s_w1 = s_w1t + DM * DM;      // [DM][DM]: s_w1[k * DM + m] = w1[k][m]
  float* s_w0x = s_w1 + DM * DM;
  float* s_w0y = s_w0x + DM;
  float* s_b0 = s_w0y + DM;
  float* s_b1 = s_b0 + DM;
  float* s_w2 = s_b1 + DM;
  float* s_ddy = s_w2 + DM;           // [kWarps][J]
  float* s_stage = s_ddy + kWarps * J;  // [kWarps][3][32][LD]

  const int tile = blockIdx.x;
  const int tiles = gridDim.x;
  const int bg = blockIdx.y;
  const int WJ = W * J;
  for (int i = threadIdx.x; i < DM * DM; i += kThreads) {
    const int k = i / DM;
    const int m = i - k * DM;
    const float w = to_f32(w1[i]);
    s_w1t[m * DM + k] = w;
    s_w1[i] = w;
  }
  for (int i = threadIdx.x; i < DM; i += kThreads) {
    s_w0x[i] = to_f32(w0x[i]);
    s_w0y[i] = to_f32(w0y[i]);
    s_b0[i] = to_f32(b0[i]);
    s_b1[i] = to_f32(b1[i]);
    s_w2[i] = to_f32(w2[i]);
  }
  for (int i = threadIdx.x; i < kWarps * J; i += kThreads) s_ddy[i] = 0.f;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* sa = s_stage + warp * 3 * STAGE;  // h1, then dz1
  float* sb = sa + STAGE;                  // dz2
  float* sc = sb + STAGE;                  // h2 * g
  float* my_ddy = s_ddy + warp * J;

  float dxv[kLanesPerThread], ddx_acc[kLanesPerThread];
  int jv[kLanesPerThread];
#pragma unroll
  for (int i = 0; i < kLanesPerThread; ++i) {
    const int l = tile * kTile + i * kThreads + threadIdx.x;
    const bool ok = l < WJ;
    dxv[i] = ok ? dx[(size_t)bg * WJ + l] : 0.f;
    jv[i] = ok ? l % J : -1;
    ddx_acc[i] = 0.f;
  }
  float acc_w1[DM];
#pragma unroll
  for (int m = 0; m < DM; ++m) acc_w1[m] = 0.f;
  float acc_w0x = 0.f, acc_w0y = 0.f, acc_b0 = 0.f, acc_b1 = 0.f, acc_w2 = 0.f,
        acc_b2 = 0.f;
  __syncthreads();

  for (int y = 0; y < H; ++y) {
    const float* dy_row = dy + ((size_t)bg * H + y) * J;
    const T* g_row = dbias + ((size_t)bg * H + y) * WJ;
#pragma unroll
    for (int i = 0; i < kLanesPerThread; ++i) {
      const int l = tile * kTile + i * kThreads + threadIdx.x;
      const bool ok = jv[i] >= 0;
      const float dyv = ok ? dy_row[jv[i]] : 0.f;
      const float g = ok ? to_f32(g_row[l]) : 0.f;

      // layer 1, as the forward
      float h1[DM];
      unsigned m1 = 0u;
#pragma unroll
      for (int k = 0; k < DM; ++k) {
        const float a = fmaf(s_w0x[k], dxv[i], fmaf(s_w0y[k], dyv, s_b0[k]));
        m1 |= (a > 0.f ? 1u : 0u) << k;
        h1[k] = fmaxf(a, 0.f);
      }
      // layer 2, as the forward (k ascending), then dz2 and h2 * g
      float d2[DM];
#pragma unroll
      for (int m = 0; m < DM; ++m) {
        const float4* wrow = reinterpret_cast<const float4*>(s_w1t + m * DM);
        float z = s_b1[m];
#pragma unroll
        for (int k4 = 0; k4 < DM / 4; ++k4) {
          const float4 w = wrow[k4];
          z = fmaf(w.x, h1[4 * k4 + 0], z);
          z = fmaf(w.y, h1[4 * k4 + 1], z);
          z = fmaf(w.z, h1[4 * k4 + 2], z);
          z = fmaf(w.w, h1[4 * k4 + 3], z);
        }
        d2[m] = z > 0.f ? s_w2[m] * g : 0.f;
        sc[lane * LD + m] = fmaxf(z, 0.f) * g;
      }
      store_row<DM / 4>(sa + lane * LD, h1);
      store_row<DM / 4>(sb + lane * LD, d2);
      // dz1 = [a > 0] (w1 dz2); d_dx and d_dy contributions of this pair
      float dz1[DM];
      float tdx = 0.f, tdy = 0.f;
#pragma unroll
      for (int k = 0; k < DM; ++k) {
        const float4* wrow = reinterpret_cast<const float4*>(s_w1 + k * DM);
        float s = 0.f;
#pragma unroll
        for (int m4 = 0; m4 < DM / 4; ++m4) {
          const float4 w = wrow[m4];
          s = fmaf(w.x, d2[4 * m4 + 0], s);
          s = fmaf(w.y, d2[4 * m4 + 1], s);
          s = fmaf(w.z, d2[4 * m4 + 2], s);
          s = fmaf(w.w, d2[4 * m4 + 3], s);
        }
        dz1[k] = (m1 >> k) & 1u ? s : 0.f;
        tdx = fmaf(s_w0x[k], dz1[k], tdx);
        tdy = fmaf(s_w0y[k], dz1[k], tdy);
      }
      ddx_acc[i] += tdx;
      if (ok) atomicAdd(my_ddy + jv[i], tdy);  // distinct j within a warp when J >= 32
      acc_b2 += g;
      __syncwarp();

      // lane k: dw1[k][:] += sum_p h1[p][k] dz2[p][:], db1[k], dw2[k]
      if (lane < DM) {
#pragma unroll 2
        for (int p = 0; p < 32; ++p) {
          const float hk = sa[p * LD + lane];
          const float4* row = reinterpret_cast<const float4*>(sb + p * LD);
#pragma unroll
          for (int m4 = 0; m4 < DM / 4; ++m4) {
            const float4 r = row[m4];
            acc_w1[4 * m4 + 0] = fmaf(hk, r.x, acc_w1[4 * m4 + 0]);
            acc_w1[4 * m4 + 1] = fmaf(hk, r.y, acc_w1[4 * m4 + 1]);
            acc_w1[4 * m4 + 2] = fmaf(hk, r.z, acc_w1[4 * m4 + 2]);
            acc_w1[4 * m4 + 3] = fmaf(hk, r.w, acc_w1[4 * m4 + 3]);
          }
          acc_b1 += sb[p * LD + lane];
          acc_w2 += sc[p * LD + lane];
        }
      }
      __syncwarp();
      store_row<DM / 4>(sa + lane * LD, dz1);
      __syncwarp();
      // lane k: dw0x[k], dw0y[k], db0[k]
#pragma unroll 4
      for (int p = 0; p < 32; ++p) {
        const float xs = __shfl_sync(0xffffffffu, dxv[i], p);
        const float ys = __shfl_sync(0xffffffffu, dyv, p);
        const float dz = lane < DM ? sa[p * LD + lane] : 0.f;
        acc_w0x = fmaf(dz, xs, acc_w0x);
        acc_w0y = fmaf(dz, ys, acc_w0y);
        acc_b0 += dz;
      }
      __syncwarp();  // the next pair overwrites the staging rows
    }
    __syncthreads();
    for (int j = threadIdx.x; j < J; j += kThreads) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        s += s_ddy[w * J + j];
        s_ddy[w * J + j] = 0.f;
      }
      ddy_part[(((size_t)bg * tiles + tile) * H + y) * J + j] = s;
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kLanesPerThread; ++i) {
    const int l = tile * kTile + i * kThreads + threadIdx.x;
    if (jv[i] >= 0) ddx[(size_t)bg * WJ + l] = ddx_acc[i];
  }

  // combine the warps' weight gradients in a fixed order
  constexpr int SIZE = wgrad_size<DM>();
  float* red = s_stage + warp * SIZE;  // the staging area is free now
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc_b2 += __shfl_xor_sync(0xffffffffu, acc_b2, o);
  if (lane < DM) {
#pragma unroll
    for (int m = 0; m < DM; ++m) red[lane * DM + m] = acc_w1[m];
    red[DM * DM + lane] = acc_w0x;
    red[DM * DM + DM + lane] = acc_w0y;
    red[DM * DM + 2 * DM + lane] = acc_b0;
    red[DM * DM + 3 * DM + lane] = acc_b1;
    red[DM * DM + 4 * DM + lane] = acc_w2;
  }
  if (lane == 0) red[DM * DM + 5 * DM] = acc_b2;
  __syncthreads();
  float* out = wgrad_part + ((size_t)bg * tiles + tile) * SIZE;
  for (int e = threadIdx.x; e < SIZE; e += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += s_stage[w * SIZE + e];
    out[e] = s;
  }
}

template <int DM>
size_t smem_bytes(int J) {
  return (size_t)(head_floats<DM>() + kWarps * J + kWarps * 3 * 32 * (DM + 4)) *
         sizeof(float);
}

template <typename T, int DM>
cudaError_t launch(const void* dx, const void* dy, const void* w0x, const void* w0y,
                   const void* b0, const void* w1, const void* b1, const void* w2,
                   const void* dbias, void* ddx, void* ddy_part, void* wgrad_part, int BG,
                   int H, int W, int J, cudaStream_t stream) {
  static_assert(kWarps * wgrad_size<DM>() <= kWarps * 3 * 32 * (DM + 4),
                "the warps' weight gradients fit the staging area");
  const size_t smem = smem_bytes<DM>(J);
  auto kernel = cpb_bias_bwd_kernel<T, DM>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int tiles = (W * J + kTile - 1) / kTile;
  kernel<<<dim3(tiles, BG), kThreads, smem, stream>>>(
      static_cast<const float*>(dx), static_cast<const float*>(dy),
      static_cast<const T*>(w0x), static_cast<const T*>(w0y), static_cast<const T*>(b0),
      static_cast<const T*>(w1), static_cast<const T*>(b1), static_cast<const T*>(w2),
      static_cast<const T*>(dbias), static_cast<float*>(ddx),
      static_cast<float*>(ddy_part), static_cast<float*>(wgrad_part), H, W, J);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dm(int dm, const void* dx, const void* dy, const void* w0x,
                        const void* w0y, const void* b0, const void* w1, const void* b1,
                        const void* w2, const void* dbias, void* ddx, void* ddy_part,
                        void* wgrad_part, int BG, int H, int W, int J, cudaStream_t s) {
  switch (dm) {
    case 8:
      return launch<T, 8>(dx, dy, w0x, w0y, b0, w1, b1, w2, dbias, ddx, ddy_part,
                          wgrad_part, BG, H, W, J, s);
    case 16:
      return launch<T, 16>(dx, dy, w0x, w0y, b0, w1, b1, w2, dbias, ddx, ddy_part,
                           wgrad_part, BG, H, W, J, s);
    case 32:
      return launch<T, 32>(dx, dy, w0x, w0y, b0, w1, b1, w2, dbias, ddx, ddy_part,
                           wgrad_part, BG, H, W, J, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int cpb_bias_bwd(int dtype, const void* dx, const void* dy, const void* w0x,
                            const void* w0y, const void* b0, const void* w1,
                            const void* b1, const void* w2, const void* dbias, void* ddx,
                            void* ddy_part, void* wgrad_part, int BG, int H, int W, int J,
                            int dm, int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_dm<float>(dm, dx, dy, w0x, w0y, b0, w1, b1, w2, dbias, ddx, ddy_part,
                              wgrad_part, BG, H, W, J, s);
  if (dtype == 1)
    return dispatch_dm<__nv_bfloat16>(dm, dx, dy, w0x, w0y, b0, w1, b1, w2, dbias, ddx,
                                      ddy_part, wgrad_part, BG, H, W, J, s);
  return cudaErrorInvalidValue;
}
