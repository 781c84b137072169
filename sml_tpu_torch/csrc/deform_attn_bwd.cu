// Deformable-attention backward for sm_90a, recompute form.  For
//
//   p = softmax_j(q . k_j + bias_j),  out = (p * m) @ v
//
// with m the dropout multiplier {0, 1/keep} (philox.cuh; m = 1 when keep == 1),
// and dout given, it returns
//
//   dv = (p * m)^T dout          dp = (dout v^T) * m
//   ds = p * (dp - sum_j dp p)   dbias = ds,  dq = ds @ k,  dk = ds^T q
//
// Replaces the Pallas kernel _fused_attn_bwd_call (sml_tpu/ops/pallas/
// deform_attn.py, body _attn_bwd_kernel) with a bias and no span mask.  Nothing
// of the (BG, N, J) chain is saved from the forward: both kernels recompute it.
// As in the Pallas kernel, ds is rounded to q's dtype before dq and dk, and
// p * m to v's dtype before dv; every sum is in f32.
//
// The TPU kernel sums dk and dv over the row tiles along a sequential grid
// axis.  Blocks on the H100 run in parallel, so the work is split in two
// kernels and the sum over rows stays inside one block, with no atomics and
// no partials (the result does not vary from run to run):
//
// rows kernel, one block per (bg, 64 query rows), laid out as the forward: K
//   and V in shared memory, one warp per row.  It recomputes p, then dp, ds,
//   writes dbias and dq and the row's log-sum-exp lse (BG, N) f32.
// keys kernel, one block per (bg, 16 keys), looping over all N rows in chunks
//   of 64: it recomputes p = exp(q . k + bias - lse) and m for its 16 x 64
//   pairs, reads ds back from dbias (the wrapper requires bias in q's dtype,
//   so that is exactly the rounded ds), and accumulates dk and dv for its keys
//   in registers.  Its q . k sums run in the rows kernel's order, so p is the
//   same to the last bits of lse.
//
// What bounds it: bytes.  About 10 * DH FLOP per pair against the bias and
// dbias streams (4 bytes per pair in bf16) and q, dout, dq read or written
// once: about 160 FLOP per byte, under the card's ridge.  Both kernels run
// their products on the CUDA cores from shared memory, and the keys kernel
// re-reads q and dout once per 16 keys (mostly from L2).
//
// C entry: deform_attn_bwd(dtype, q, k, v, bias, dout, dq, dk, dv, dbias, lse,
//                          BG, N, J, DH, keep_prob, inv_keep, seed, device,
//                          stream) -> cudaGetLastError().
// dtype: 0 = float, 1 = bfloat16 for q, k, v, bias, dout and every output but
// lse.  DH must be 64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attn_common.cuh"
#include "philox.cuh"

namespace {

using namespace attn;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 64;     // rows kernel: query rows per block
constexpr int kKeys = 16;     // keys kernel: keys per block (4 Philox groups)
constexpr int kChunk = 64;    // keys kernel: query rows per shared-memory chunk
constexpr int kQLd = 68;      // padded f32 row of the q / dout chunks (16-byte aligned)
constexpr int kKLd = 65;      // padded f32 row of the key tile

template <typename T, int DH, bool DROP>
__global__ void __launch_bounds__(kThreads)
attn_bwd_rows_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ bias,
                     const T* __restrict__ dout, T* __restrict__ dq,
                     T* __restrict__ dbias, float* __restrict__ lse, int N, int J,
                     float keep_prob, float inv_keep, unsigned long long seed) {
  static_assert(DH == 64, "each lane owns DH / 32 = 2 columns of dq");
  constexpr int VN = Vec16<T>::N;
  constexpr int LD = row_stride<T>(DH);
  constexpr int VPR = DH / VN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_k = reinterpret_cast<T*>(smem_raw);
  T* s_v = s_k + (size_t)J * LD;
  float* s_p = reinterpret_cast<float*>(s_v + (size_t)J * LD);  // [kWarps][J]
  float* s_d = s_p + (size_t)kWarps * J;                          // [kWarps][J]

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
  float* d = s_d + warp * J;
  const int rows = min(kRows, N - row0);
  for (int r = warp; r < rows; r += kWarps) {
    const size_t row = (size_t)bg * N + row0 + r;
    const T* brow = bias + row * J;
    float mx = -INFINITY;
    {
      float qr[DH];
#pragma unroll
      for (int c = 0; c < DH; c += VN) Vec16<T>::load(q + row * DH + c, qr + c);
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
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < J; j += 32) {
      const float e = expf(p[j] - mx);
      p[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    const float inv = 1.f / sum;
    for (int j = lane; j < J; j += 32) p[j] *= inv;
    __syncwarp();  // with dropout, lanes read p[j] that other lanes wrote

    // dp = (dout . v_j) * m, and delta = sum_j dp p
    float delta = 0.f;
    {
      float dr[DH];
#pragma unroll
      for (int c = 0; c < DH; c += VN) Vec16<T>::load(dout + row * DH + c, dr + c);
      auto dot_v = [&](int j) {
        const T* vr = s_v + j * LD;
        float s = 0.f;
#pragma unroll
        for (int c = 0; c < DH; c += VN) {
          float vf[VN];
          Vec16<T>::load(vr + c, vf);
#pragma unroll
          for (int e = 0; e < VN; ++e) s = fmaf(dr[c + e], vf[e], s);
        }
        return s;
      };
      if (DROP) {
        for (int g = lane; 4 * g < J; g += 32) {
          const uint4 bits = philox::bits4(seed, g, row0 + r, bg);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int j = 4 * g + jj;
            if (j < J) {
              const float dp = philox::keep(philox::word(bits, jj), keep_prob)
                                   ? dot_v(j) * inv_keep : 0.f;
              d[j] = dp;
              delta = fmaf(dp, p[j], delta);
            }
          }
        }
      } else {
        for (int j = lane; j < J; j += 32) {
          const float dp = dot_v(j);
          d[j] = dp;
          delta = fmaf(dp, p[j], delta);
        }
      }
    }
    delta = warp_sum(delta);
    __syncwarp();  // with dropout, lanes read d[j] that other lanes wrote
    T* dbrow = dbias + row * J;
    for (int j = lane; j < J; j += 32) {
      const float ds = p[j] * (d[j] - delta);
      store1(dbrow + j, ds);
      d[j] = round_to(ds, T());
    }
    __syncwarp();

    float2 acc = make_float2(0.f, 0.f);
    const T* kcol = s_k + 2 * lane;
#pragma unroll 4
    for (int j = 0; j < J; ++j) {
      const float dj = d[j];
      const float2 kk = load2(kcol + j * LD);
      acc.x = fmaf(dj, kk.x, acc.x);
      acc.y = fmaf(dj, kk.y, acc.y);
    }
    store2(dq + row * DH + 2 * lane, acc);
    if (lane == 0) lse[row] = mx + logf(sum);
    __syncwarp();  // the next row rewrites p and d
  }
}

template <typename T, int DH, bool DROP>
__global__ void __launch_bounds__(kThreads)
attn_bwd_keys_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ bias, const T* __restrict__ dout,
                     const T* __restrict__ dbias, const float* __restrict__ lse,
                     T* __restrict__ dk, T* __restrict__ dv, int N, int J,
                     float keep_prob, float inv_keep, unsigned long long seed) {
  static_assert(DH == 64 && kKeys * DH == 4 * kThreads, "4 dk and 4 dv per thread");
  static_assert(kChunk * (kKeys / 4) == kThreads, "one thread per (row, key group)");
  __shared__ float s_k[kKeys][kKLd];
  __shared__ __align__(16) float s_q[kChunk][kQLd];
  __shared__ __align__(16) float s_do[kChunk][kQLd];
  __shared__ float s_pd[kChunk][kKeys];
  __shared__ float s_ds[kChunk][kKeys];
  __shared__ float s_lse[kChunk];

  const int bg = blockIdx.y;
  const int j0 = blockIdx.x * kKeys;
  const int t = threadIdx.x;
  const T* qg = q + (size_t)bg * N * DH;
  const T* dog = dout + (size_t)bg * N * DH;
  for (int i = t; i < kKeys * DH; i += kThreads) {
    const int jl = i / DH, c = i - jl * DH;
    s_k[jl][c] = j0 + jl < J ? to_f32(k[((size_t)bg * J + j0 + jl) * DH + c]) : 0.f;
  }

  const int pr = t >> 2;            // pair phase: chunk row
  const int grp = t & 3;            //             key group (4 keys)
  const int kl = t >> 4;            // sum phase:  key
  const int c4 = (t & 15) * 4;      //             4 columns
  float dk_acc[4] = {0.f, 0.f, 0.f, 0.f}, dv_acc[4] = {0.f, 0.f, 0.f, 0.f};

  for (int r0 = 0; r0 < N; r0 += kChunk) {
    __syncthreads();  // the previous chunk is consumed (and s_k is staged)
    for (int i = t; i < kChunk * DH; i += kThreads) {
      const int rr = i / DH, c = i - rr * DH;
      const bool ok = r0 + rr < N;
      s_q[rr][c] = ok ? to_f32(qg[(size_t)(r0 + rr) * DH + c]) : 0.f;
      s_do[rr][c] = ok ? to_f32(dog[(size_t)(r0 + rr) * DH + c]) : 0.f;
    }
    if (t < kChunk) s_lse[t] = r0 + t < N ? lse[(size_t)bg * N + r0 + t] : 0.f;
    __syncthreads();

    {
      const int row = r0 + pr;
      float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
      for (int c = 0; c < DH; ++c) {
        const float qv = s_q[pr][c];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) s[jj] = fmaf(qv, s_k[4 * grp + jj][c], s[jj]);
      }
      uint4 bits = make_uint4(0u, 0u, 0u, 0u);
      if (DROP) bits = philox::bits4(seed, (j0 >> 2) + grp, row, bg);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int jl = 4 * grp + jj;
        const int j = j0 + jl;
        float pd = 0.f, ds = 0.f;
        if (row < N && j < J) {
          const size_t at = ((size_t)bg * N + row) * J + j;
          const float pj = expf(s[jj] + to_f32(bias[at]) - s_lse[pr]);
          const float m = DROP ? (philox::keep(philox::word(bits, jj), keep_prob)
                                      ? inv_keep : 0.f)
                               : 1.f;
          pd = round_to(pj * m, T());
          ds = to_f32(dbias[at]);
        }
        s_pd[pr][jl] = pd;
        s_ds[pr][jl] = ds;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int rr = 0; rr < kChunk; ++rr) {
      const float ds = s_ds[rr][kl], pd = s_pd[rr][kl];
      const float4 qv = *reinterpret_cast<const float4*>(&s_q[rr][c4]);
      const float4 ov = *reinterpret_cast<const float4*>(&s_do[rr][c4]);
      dk_acc[0] = fmaf(ds, qv.x, dk_acc[0]);
      dk_acc[1] = fmaf(ds, qv.y, dk_acc[1]);
      dk_acc[2] = fmaf(ds, qv.z, dk_acc[2]);
      dk_acc[3] = fmaf(ds, qv.w, dk_acc[3]);
      dv_acc[0] = fmaf(pd, ov.x, dv_acc[0]);
      dv_acc[1] = fmaf(pd, ov.y, dv_acc[1]);
      dv_acc[2] = fmaf(pd, ov.z, dv_acc[2]);
      dv_acc[3] = fmaf(pd, ov.w, dv_acc[3]);
    }
  }
  const int j = j0 + kl;
  if (j < J) {
    const size_t at = ((size_t)bg * J + j) * DH + c4;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      store1(dk + at + e, dk_acc[e]);
      store1(dv + at + e, dv_acc[e]);
    }
  }
}

template <typename T, bool DROP>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias,
                   const void* dout, void* dq, void* dk, void* dv, void* dbias,
                   float* lse, int BG, int N, int J, float keep_prob, float inv_keep,
                   unsigned long long seed, cudaStream_t stream) {
  constexpr int DH = 64;
  const size_t smem = 2 * (size_t)J * row_stride<T>(DH) * sizeof(T) +
                      2 * (size_t)kWarps * J * sizeof(float);
  auto rows = attn_bwd_rows_kernel<T, DH, DROP>;
  cudaError_t err = cudaFuncSetAttribute(
      rows, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  rows<<<dim3((N + kRows - 1) / kRows, BG), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(bias), static_cast<const T*>(dout), static_cast<T*>(dq),
      static_cast<T*>(dbias), lse, N, J, keep_prob, inv_keep, seed);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_bwd_keys_kernel<T, DH, DROP><<<dim3((J + kKeys - 1) / kKeys, BG), kThreads, 0,
                                      stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(bias),
      static_cast<const T*>(dout), static_cast<const T*>(dbias), lse,
      static_cast<T*>(dk), static_cast<T*>(dv), N, J, keep_prob, inv_keep, seed);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_drop(const void* q, const void* k, const void* v, const void* bias,
                          const void* dout, void* dq, void* dk, void* dv, void* dbias,
                          float* lse, int BG, int N, int J, float keep_prob,
                          float inv_keep, unsigned long long seed, cudaStream_t s) {
  if (keep_prob < 1.f)
    return launch<T, true>(q, k, v, bias, dout, dq, dk, dv, dbias, lse, BG, N, J,
                           keep_prob, inv_keep, seed, s);
  return launch<T, false>(q, k, v, bias, dout, dq, dk, dv, dbias, lse, BG, N, J,
                          keep_prob, inv_keep, seed, s);
}

}  // namespace

extern "C" int deform_attn_bwd(int dtype, const void* q, const void* k, const void* v,
                               const void* bias, const void* dout, void* dq, void* dk,
                               void* dv, void* dbias, void* lse, int BG, int N, int J,
                               int DH, float keep_prob, float inv_keep,
                               unsigned long long seed, int device, void* stream) {
  if (DH != 64) return cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 0)
    return dispatch_drop<float>(q, k, v, bias, dout, dq, dk, dv, dbias, l, BG, N, J,
                                keep_prob, inv_keep, seed, s);
  if (dtype == 1)
    return dispatch_drop<__nv_bfloat16>(q, k, v, bias, dout, dq, dk, dv, dbias, l, BG,
                                        N, J, keep_prob, inv_keep, seed, s);
  return cudaErrorInvalidValue;
}
