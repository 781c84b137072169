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
// pair at dm = 32 against 2 bytes of bf16 bias written (4 of f32): 51.6 GFLOP
// and 46 MB (92 MB) at 2500 patches.  Layer 2 (2*dm^2 = 2048 of them) is a
// matrix product; layers 1 and 3 (6*dm + 1 = 193, 9%) are not.  In f32 each
// of layer 2's products is three tf32 ones (3xTF32).
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
// f32, tf32::cpb_bias_fwd_tf32: the bf16 kernel's grid, block and loop, layer
// 2 on the tf32 tensor cores as mma.sync m16n8k8 (mma.cuh), f32 throughout
// with no bf16 rounding; a warp takes kTiles = 2 m16 tiles of pairs (32
// consecutive lanes of the row) a step:
//   - layers 1 and 2 are cpb_common.cuh's cpb::tf32 code, called as the f32
//     backward's recompute (cpb_bias_bwd.cu, tf32::cpb_bias_bwd_tf32) calls
//     it, on weights staged by the same cpb::tf32::stage_params and w1 split
//     by the same cpb::tf32::stage_b<DM, false> into shared memory in
//     fragment order: layer 1 as fmaf(w0x, dx, fmaf(w0y, dy, b0)), h1 split
//     to nearest, z2 = h1 w1 + b1 as 3xTF32 in one chain a tile from b1 (48
//     mma per 16 pairs at dm = 32).  An m16n8k8 row of z2 depends only on its
//     own A row, so the forward's (bg, y) grid and the backward's (bg, lane
//     tile) grid give each pair the same z2, and the two kernels take the
//     same layer-2 ReLU decisions bit for bit, as the bf16 pair does;
//   - layer 3 in f32 on the CUDA cores as in the bf16 kernel (w2 relu(z2)
//     over the lane's columns from cpb::b1_w2, then the quad's sum in a fixed
//     order, xor 1, then xor 2); with two tiles the two shuffles of xor 1
//     leave each lane one pair of each tile and the one of xor 2 one pair in
//     all (three shuffles, not four), so lane t ends with pair g + 8 (t & 1)
//     of tile t >> 1 and the warp's 32 lanes store the step's 32 consecutive
//     outputs, 128 bytes in whole 32-byte sectors, straight from registers:
//     at 4 bytes a pair (0.028 ms of 92 MB at 2500 patches) the store is not
//     what bounds the kernel.  The sum is the same tree with one tile (lanes
//     t < 2 store), so kTiles does not change the bits;
//   - j advanced by the conditional subtract and dx loaded a step ahead, as
//     in the bf16 kernel; the loop is not unrolled (two tiles give the step
//     its independent chains, and registers are the scarce resource: the
//     split h1 of both tiles is 64 a thread at dm = 32 beside z2's 32);
//   - __launch_bounds__ names kBlocksPerSM blocks an SM, so ptxas sizes the
//     registers for them; shared memory (7 dm + 2 dm^2 + J floats) is small.
// A 16-pair tile past W*J computes with dx = 0 and stores nothing there;
// dm = 8 is one k8 step and needs no padding.  The step loop is 494
// instructions per lane at dm = 32, 96 of them mma (5.1 per mma; 111
// registers, no spill): 0.785 ms at 2500 patches, about 3.0 SM cycles per mma
// (the backward's 4.4), against the CUDA-core twin's 1.466, on an H100 80GB
// HBM3 at 700 W (scripts/profile_cpb_bwd.py).  With the mma count fixed, the
// time followed the other instructions: one tile a step (10% more per pair)
// ran 6% slower, five blocks an SM (96 registers, 7% more) 4% slower.
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
// f32: the tf32 tensor-core kernel (3xTF32)

namespace tf32 {

// the bf16 kernel's block: 4 warps over the row
using tc::kThreads;
using tc::kWarps;
// m16 tiles of pairs a warp takes per step: each split B fragment of w1
// loaded from shared memory feeds kTiles products, and the tiles' product
// chains are independent (scripts/profile_cpb_bwd.py --variant fwdonetile
// takes one)
constexpr int kTiles = 2;
constexpr int kStride = 16 * kTiles * kWarps;   // lanes from one of a warp's steps to its next
// blocks an SM holds: named in __launch_bounds__ so that ptxas gives each
// thread the registers that many blocks leave it, 128 (without a count it may
// cap them lower and spill); 111 at dm = 32 hold four blocks an SM, and so
// would a bound of three.  Shared memory (9.7 KB a block at dm = 32, J = 144)
// would allow more (--variant fwdfiveblocks names one more: 4% slower)
constexpr int kBlocksPerSM = 4;

// floats of shared memory: the weights, w1's split B fragments, the row's dy
template <int DM>
__host__ __device__ constexpr int smem_floats(int J) {
  return cpb::tf32::par_floats<DM>() + cpb::tf32::b_floats<DM>() + J;
}

template <int DM>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
cpb_bias_fwd_tf32(const float* __restrict__ dx, const float* __restrict__ dy,
                  const float* __restrict__ w0x, const float* __restrict__ w0y,
                  const float* __restrict__ b0, const float* __restrict__ w1,
                  const float* __restrict__ b1, const float* __restrict__ w2,
                  const float* __restrict__ b2, float* __restrict__ out, int H, int W, int J) {
  constexpr int NT = cpb::tf32::Frags<DM>::NT;
  constexpr int T = kTiles;
  static_assert(T == 1 || T == 2, "a warp step stores one or two tiles");
  extern __shared__ __align__(16) float smem[];
  float* s_par = smem;                 // the weights in f32 (cpb::tf32::stage_params)
  uint4* s_wz = reinterpret_cast<uint4*>(s_par + cpb::tf32::par_floats<DM>());  // w1: z2 = h1 w1
  float* s_dy = reinterpret_cast<float*>(s_wz + NT * NT * 32);  // [J]: dy of this query row

  const int bg = blockIdx.x / H;
  const int y = blockIdx.x - bg * H;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  cpb::tf32::stage_params<DM>(s_par, w0x, w0y, b0, b1, w2, threadIdx.x, kThreads);
  cpb::tf32::stage_b<DM, false>(s_wz, w1, nullptr, threadIdx.x, kThreads);
  const float* dy_row = dy + ((size_t)bg * H + y) * J;
  for (int i = threadIdx.x; i < J; i += kThreads) s_dy[i] = dy_row[i];
  const float bias2 = b2[0];
  __syncthreads();

  const int WJ = W * J;
  const float* dx_row = dx + (size_t)bg * WJ;
  float* out_row = out + ((size_t)bg * H + y) * WJ;
  // the lane's pairs i0 + 16i + g + 8r of the step (tile i, row g + 8r):
  // their j, and their dx a step ahead
  const int jstep = kStride % J;
  int i0 = 16 * T * warp;
  int jv[T][2];
  float xn[T][2];
  const float* xp = dx_row + i0 + g;
  // the lane's output after the quad's sum: pair g + 8(t & 1) of tile t >> 1
  // (T = 2; lanes t < 2 with T = 1), so the warp stores i0 + g + 8t, whole
  // consecutive 32-byte sectors
  float* op = out_row + i0 + g + 8 * t;
#pragma unroll
  for (int i = 0; i < T; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int p = i0 + 16 * i + g + 8 * r;
      jv[i][r] = p % J;
      xn[i][r] = p < WJ ? xp[16 * i + 8 * r] : 0.f;
    }
#pragma unroll 1
  for (; i0 < WJ; i0 += kStride) {
    float xv[T][2], yv[T][2];
    xp += kStride;
#pragma unroll
    for (int i = 0; i < T; ++i)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        xv[i][r] = xn[i][r];
        yv[i][r] = s_dy[jv[i][r]];
        const int p = i0 + kStride + 16 * i + g + 8 * r;
        xn[i][r] = p < WJ ? xp[16 * i + 8 * r] : 0.f;
        jv[i][r] += jstep;
        if (jv[i][r] >= J) jv[i][r] -= J;
      }

    // layers 1 and 2: the backward's recompute (cpb_common.cuh), so z2 and its
    // ReLU mask are the backward's bit for bit
    float z[T][NT][4];
    {
      float h1[T][NT][4];
      cpb::tf32::layer1<DM, T>(h1, s_par, xv, yv, t);
      cpb::tf32::layer2<DM, T>(z, h1, s_wz, s_par, lane, t);
    }

    // layer 3: w2 . relu(z2) over the lane's columns for pairs g and g + 8 of
    // each tile
    float acc[T][2];
#pragma unroll
    for (int i = 0; i < T; ++i) acc[i][0] = acc[i][1] = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float4 bw = cpb::b1_w2<DM>(s_par, n, t);
#pragma unroll
      for (int i = 0; i < T; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[i][e >> 1] = fmaf((e & 1) ? bw.w : bw.z, fmaxf(z[i][n][e], 0.f), acc[i][e >> 1]);
    }
    // over the quad: xor 1, lane t keeps pair g + 8 (t & 1) of each tile; xor
    // 2, it keeps tile t >> 1 and adds the lanes t ^ 2's sum of it
    const bool odd = t & 1;
    float s[T];
#pragma unroll
    for (int i = 0; i < T; ++i)
      s[i] = (odd ? acc[i][1] : acc[i][0]) +
             __shfl_xor_sync(0xffffffffu, odd ? acc[i][0] : acc[i][1], 1);
    const int i = i0 + g + 8 * t;
    if constexpr (T == 2) {
      const bool upper = t & 2;
      const float v = (upper ? s[1] : s[0]) + __shfl_xor_sync(0xffffffffu, upper ? s[0] : s[1], 2);
      if (i < WJ) *op = v + bias2;
    } else {
      const float v = s[0] + __shfl_xor_sync(0xffffffffu, s[0], 2);
      if (t < 2 && i < WJ) *op = v + bias2;
    }
    op += kStride;
  }
}

}  // namespace tf32

// ---------------------------------------------------------------------------

template <int DM>
cudaError_t launch_tf32(const void* dx, const void* dy, const void* w0x, const void* w0y,
                        const void* b0, const void* w1, const void* b1, const void* w2,
                        const void* b2, void* out, int BG, int H, int W, int J,
                        cudaStream_t stream) {
  const size_t smem = (size_t)tf32::smem_floats<DM>(J) * sizeof(float);
  tf32::cpb_bias_fwd_tf32<DM><<<BG * H, tf32::kThreads, smem, stream>>>(
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
  if (dtype == 0) return launch_tf32<DM>(dx, dy, w0x, w0y, b0, w1, b1, w2, b2, out, BG, H, W, J, s);
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
