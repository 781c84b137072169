// CPB bias forward for sm_90a: the continuous-position-bias MLP of the 2-D
// deformable attention, evaluated at every (query row y, query column x,
// kv point j) of every (sample, offset group) bg:
//
//   h1   = relu(w0x * dx[bg, x*J + j] + w0y * dy[bg, y, j] + b0)   (dm)
//   h2   = relu(w1^T h1 + b1)                                       (dm)
//   bias[bg, y, x*J + j] = w2 . h2 + b2
//
// Replaces the Pallas kernel fused_cpb_bias (sml_tpu/ops/pallas/deform_attn.py,
// body _fwd_kernel).  Both kernels run one block per (bg, y), with the weights
// and the row's dy in shared memory, and its warps stride over the row's W*J
// lanes: 3200 blocks at the 2500-patch shape (BG = 64, H = 50), 4096 at the
// 4096-patch one, each with a whole row of work, so no block reduces anything
// and no pair is recomputed (the backward's (bg, lane tile) grid exists to
// keep d_dx on chip over the rows, which the forward has no need of).  The
// (BG, N, J, dm) activations never reach device memory.
//
// What bounds it on the H100: operations.  2*dm^2 + 6*dm + 1 = 2241 FLOP per
// pair at dm = 32 against 2 bytes of bf16 bias written: 51.6 GFLOP and 46 MB
// at 2500 patches.  Layer 2 (2*dm^2 = 2048 of them) is a matrix product;
// layers 1 and 3 (6*dm + 1 = 193, 9%) are not.
//
// bf16, tc::cpb_bias_fwd_tc: layer 2 on the tensor cores as warp-level
// mma.sync m16n8k16 (8 per 16-pair step at dm = 32), bf16 operands and f32
// sums.  A warp takes 16 consecutive lanes of the row per step as the M
// dimension; lane (g, t) owns pairs g and g + 8 and columns 8n + 2t, + 1 of
// every n8 tile n (mma.cuh):
//   - layer 1 and z2 = h1 w1 + b1 are cpb_common.cuh's code, which the
//     backward's recompute (cpb_bias_bwd.cu, tc::cpb_bias_bwd_tc) runs too:
//     layer 1 in f32 on the CUDA cores as fmaf(w0x, dx, fmaf(w0y, dy, b0)),
//     relu(a) rounded to bf16 straight into A fragments, w1 held as B
//     fragments in registers for the whole block (16 at dm = 32), the sums
//     started at b1.  So the two kernels' z2, and their layer-2 ReLU masks,
//     agree bit for bit;
//   - layer 3 in f32 on the CUDA cores: each lane sums w2[c] relu(z2[c]) over
//     its columns for its two pairs (16 max and 16 fma at dm = 32), then the
//     quad's four lanes add their sums in a fixed order (xor 1, then xor 2;
//     two shuffles, each lane sending the pair it does not keep), so two
//     launches give the same bits;
//   - a pair's j = l mod J starts with one division and then advances by the
//     warps' stride mod J with one conditional subtract; its dx is loaded a
//     step ahead, through a pointer stepped by the stride (so is the store's
//     address), and the loop is unrolled by two steps;
//   - the bias is rounded once to bf16; lanes t = 0 and 1 store the step's 16
//     consecutive outputs (one 32-byte sector) straight from registers: at 2
//     bytes a pair the store is not what bounds the kernel, so no shared
//     staging.
// The CUDA-core work (layers 1 and 3, the quad sum, loads and the loop: 146
// instructions per lane and step at dm = 32, of which 8 are the mma) sets its
// pace, not the tensor cores.  Unrolling and the stepped pointers took it
// from 181 instructions a step to 146, and from 0.392 to 0.333 ms at 2500
// patches on an H100 80GB HBM3 at 700 W (scripts/profile_cpb_bwd.py).
// Rounding points: h1 to bf16 before layer 2, where the TPU kernel (jnp.dot
// of bf16 h1, f32 accumulation) and the backward's recompute round it; z2, h2
// and layer 3 stay in f32 (the TPU kernel keeps h2 in f32); the output is
// rounded once.  A 16-pair step past W*J computes zeros and stores nothing
// there; dm = 8 pads the k16 step with zero columns.
//
// f32, cpb_bias_kernel, the CUDA-core twin and the exact-arithmetic reference
// on the card: each thread runs the whole per-pair MLP in f32 registers for
// kPairs lanes at once (w1 transposed in shared memory, so a row of it is one
// float4-loadable run), so every broadcast weight load feeds kPairs FMAs; h1
// is never rounded.
//
// C entry: cpb_bias_fwd(dtype, dx, dy, w0x, w0y, b0, w1, b1, w2, b2, out,
//                       BG, H, W, J, dm, device, stream) -> cudaGetLastError().
// dtype 0 = float, 1 = bfloat16 (weights and output); dx, dy are float.  The
// library carries its own CUDA runtime, so the entry selects `device` itself.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "cpb_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// f32: the CUDA-core twin

constexpr int kThreads = 256;
constexpr int kPairs = 2;

template <int DM>
__global__ void __launch_bounds__(kThreads)
cpb_bias_kernel(const float* __restrict__ dx, const float* __restrict__ dy,
                const float* __restrict__ w0x, const float* __restrict__ w0y,
                const float* __restrict__ b0, const float* __restrict__ w1,
                const float* __restrict__ b1, const float* __restrict__ w2,
                const float* __restrict__ b2, float* __restrict__ out, int H, int W, int J) {
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
    s_w1t[m * DM + k] = w1[i];
  }
  for (int i = threadIdx.x; i < DM; i += kThreads) {
    s_w0x[i] = w0x[i];
    s_w0y[i] = w0y[i];
    s_b0[i] = b0[i];
    s_b1[i] = b1[i];
    s_w2[i] = w2[i];
  }
  const float* dy_row = dy + ((size_t)bg * H + y) * J;
  for (int i = threadIdx.x; i < J; i += kThreads) s_dy[i] = dy_row[i];
  __syncthreads();

  const float bias2 = b2[0];
  const int WJ = W * J;
  const float* dx_row = dx + (size_t)bg * WJ;
  float* out_row = out + ((size_t)bg * H + y) * WJ;

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
      if (l < WJ) out_row[l] = acc[p];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel

namespace tc {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStride = 16 * kWarps;   // lanes from one of a warp's steps to its next

template <int DM>
__global__ void __launch_bounds__(kThreads)
cpb_bias_fwd_tc(const float* __restrict__ dx, const float* __restrict__ dy,
                const bf16* __restrict__ w0x, const bf16* __restrict__ w0y,
                const bf16* __restrict__ b0, const bf16* __restrict__ w1,
                const bf16* __restrict__ b1, const bf16* __restrict__ w2,
                const bf16* __restrict__ b2, bf16* __restrict__ out, int H, int W, int J) {
  constexpr int NT = cpb::Frags<DM>::NT;
  constexpr int KT = cpb::Frags<DM>::KT;
  extern __shared__ __align__(16) float smem[];
  float* s_par = smem;                            // the weights (cpb::stage_params)
  float* s_dy = s_par + cpb::par_floats<DM>();    // [J]: dy of this query row

  const int bg = blockIdx.x / H;
  const int y = blockIdx.x - bg * H;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  cpb::stage_params<DM>(s_par, w0x, w0y, b0, b1, w2, threadIdx.x, kThreads);
  const float* dy_row = dy + ((size_t)bg * H + y) * J;
  for (int i = threadIdx.x; i < J; i += kThreads) s_dy[i] = dy_row[i];
  uint32_t bz[KT][NT][2];
  cpb::w1_frags<DM>(bz, w1, g, t);
  const float bias2 = __bfloat162float(b2[0]);
  __syncthreads();

  const int WJ = W * J;
  const float* dx_row = dx + (size_t)bg * WJ;
  bf16* out_row = out + ((size_t)bg * H + y) * WJ;
  // the lane's pairs i0 + g + 8r of the step: their j, and their dx a step ahead
  const int jstep = kStride % J;
  int i0 = 16 * warp;
  int jv[2];
  float xn[2];
  const float* xp = dx_row + i0 + g;
  bf16* op = out_row + i0 + g + 8 * (t & 1);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + g + 8 * r;
    jv[r] = i % J;
    xn[r] = i < WJ ? xp[8 * r] : 0.f;
  }
#pragma unroll 2
  for (; i0 < WJ; i0 += kStride) {
    float xv[2], yv[2];
    xp += kStride;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      xv[r] = xn[r];
      yv[r] = s_dy[jv[r]];
      const int i = i0 + kStride + g + 8 * r;
      xn[r] = i < WJ ? xp[8 * r] : 0.f;
      jv[r] += jstep;
      if (jv[r] >= J) jv[r] -= J;
    }

    uint32_t ha[KT][4];
    cpb::layer1<DM>(ha, s_par, xv, yv, t);
    float z[NT][4];
    cpb::layer2<DM>(z, ha, bz, s_par, t);

    // layer 3: w2 . relu(z2) over the lane's columns for pairs g and g + 8
    float acc[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float4 bw = cpb::b1_w2<DM>(s_par, n, t);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[e >> 1] = fmaf((e & 1) ? bw.w : bw.z, fmaxf(z[n][e], 0.f), acc[e >> 1]);
    }
    // over the quad: lane t keeps pair g + 8 (t & 1), then adds the other pair
    // of the lanes t ^ 2; every lane of a pair ends with the same bits
    const bool odd = t & 1;
    float s = odd ? acc[1] : acc[0];
    s += __shfl_xor_sync(0xffffffffu, odd ? acc[0] : acc[1], 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    const int i = i0 + g + 8 * t;
    if (t < 2 && i < WJ) *op = __float2bfloat16(s + bias2);
    op += kStride;
  }
}

}  // namespace tc

// ---------------------------------------------------------------------------

template <int DM>
cudaError_t launch_f32(const void* dx, const void* dy, const void* w0x, const void* w0y,
                       const void* b0, const void* w1, const void* b1, const void* w2,
                       const void* b2, void* out, int BG, int H, int W, int J,
                       cudaStream_t stream) {
  const size_t smem = (size_t)(DM * DM + 5 * DM + J) * sizeof(float);
  cpb_bias_kernel<DM><<<BG * H, kThreads, smem, stream>>>(
      static_cast<const float*>(dx), static_cast<const float*>(dy),
      static_cast<const float*>(w0x), static_cast<const float*>(w0y),
      static_cast<const float*>(b0), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<float*>(out), H, W, J);
  return cudaGetLastError();
}

template <int DM>
cudaError_t launch_tc(const void* dx, const void* dy, const void* w0x, const void* w0y,
                      const void* b0, const void* w1, const void* b1, const void* w2,
                      const void* b2, void* out, int BG, int H, int W, int J,
                      cudaStream_t stream) {
  const size_t smem = (size_t)(cpb::par_floats<DM>() + J) * sizeof(float);
  tc::cpb_bias_fwd_tc<DM><<<BG * H, tc::kThreads, smem, stream>>>(
      static_cast<const float*>(dx), static_cast<const float*>(dy),
      static_cast<const bf16*>(w0x), static_cast<const bf16*>(w0y),
      static_cast<const bf16*>(b0), static_cast<const bf16*>(w1),
      static_cast<const bf16*>(b1), static_cast<const bf16*>(w2),
      static_cast<const bf16*>(b2), static_cast<bf16*>(out), H, W, J);
  return cudaGetLastError();
}

template <int DM>
cudaError_t launch(int dtype, const void* dx, const void* dy, const void* w0x,
                   const void* w0y, const void* b0, const void* w1, const void* b1,
                   const void* w2, const void* b2, void* out, int BG, int H, int W, int J,
                   cudaStream_t s) {
  if (dtype == 0) return launch_f32<DM>(dx, dy, w0x, w0y, b0, w1, b1, w2, b2, out, BG, H, W, J, s);
  if (dtype == 1) return launch_tc<DM>(dx, dy, w0x, w0y, b0, w1, b1, w2, b2, out, BG, H, W, J, s);
  return cudaErrorInvalidValue;
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
  switch (dm) {
    case 8:
      return launch<8>(dtype, dx, dy, w0x, w0y, b0, w1, b1, w2, b2, out, BG, H, W, J, s);
    case 16:
      return launch<16>(dtype, dx, dy, w0x, w0y, b0, w1, b1, w2, b2, out, BG, H, W, J, s);
    case 32:
      return launch<32>(dtype, dx, dy, w0x, w0y, b0, w1, b1, w2, b2, out, BG, H, W, J, s);
    default:
      return cudaErrorInvalidValue;
  }
}
