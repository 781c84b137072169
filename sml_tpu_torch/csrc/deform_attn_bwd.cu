// Attention backward for sm_90a, recompute form, key-tiled.  For
//
//   p = softmax_j(mask(q . k_j + bias_j)),  out = (p * m) @ v
//
// with m the dropout multiplier {0, 1/keep} (philox.cuh; m = 1 when keep == 1),
// and dout given, it returns
//
//   dv = (p * m)^T dout          dp = (dout v^T) * m
//   ds = p * (dp - delta),  delta = sum_j dp p,  zeroed at every masked pair
//   dbias = ds,  dq = ds @ k,  dk = ds^T q
//
// Replaces the Pallas kernel _fused_attn_bwd_call (sml_tpu/ops/pallas/
// deform_attn.py, body _attn_bwd_kernel) in every compiled form: with or
// without the bias (no dbias then), the span mask (attn_common.cuh, SpanMask;
// the cotangent is zeroed at every masked pair, whole uniform rows included)
// and dropout.  Nothing of the (BG, N, J) chain is saved from the forward or
// goes to device memory (dbias aside, which is an output): both kernels
// recompute it.  As in the Pallas kernel, ds is rounded to q's dtype before dq
// and dk, and p * m to v's dtype before dv; every sum is in f32.
//
// The TPU kernel sums dk and dv over the row tiles along a sequential grid
// axis.  Blocks on the H100 run in parallel, so the work is split in two
// kernels and the sum over rows stays inside one block, with no atomics and
// no partials (the result repeats bit for bit):
//
// rows kernel, one block per (bg, 64 query rows), q and dout rows in shared
//   memory, K and V streamed in key tiles as in the forward, one warp per
//   row.  Pass 1 walks the tiles with an online max and sum and writes each
//   row's lse = max + log(sum) and delta = sum_j p dp, (BG, N) f32 each.
//   Pass 2 walks them again: p = exp(s - lse), ds, dbias, and dq accumulated
//   in shared memory.
// keys kernel, one block per (bg, 16 keys), looping over all N rows in chunks
//   of 64: it recomputes p = exp(s - lse), dp and m for its 16 x 64 pairs,
//   then ds = p (dp m - delta), and sums dk and dv for its keys in registers.
//   Its q . k and dout . v sums run in the rows kernel's order, so p and ds
//   are the rows kernel's to the last bit.
//
// What bounds it: about 10 * DH FLOP per pair against q, k, v, dout, dq, dk,
// dv read or written once (and 4 bytes of bias and dbias per pair in bf16 in
// the bias form): operations on the tensor cores at the Nystrom chains.  The
// products here run on the CUDA cores in f32 (the rows kernel does 5 * DH
// fused multiply-adds per pair, the keys kernel 4 * DH), and the keys kernel
// re-reads q and dout once per 16 keys (mostly from L2).
//
// C entry: deform_attn_bwd(dtype, q, k, v, bias, span, dout, dq, dk, dv, dbias,
//                          lse, delta, BG, N, J, DH, keep_prob, inv_keep, seed,
//                          device, stream) -> cudaGetLastError().
// dtype: 0 = float, 1 = bfloat16 for q, k, v, bias, dout and every output but
// lse and delta (f32 scratch of (BG, N)).  bias / dbias and span may be null.
// DH must be 64.

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

template <typename T, int DH>
constexpr size_t rows_smem_bytes() {
  return (size_t)(2 * kRows + 2 * kTile) * row_stride<T>(DH) * sizeof(T)  // q, dout, K, V
         + 2 * (size_t)kWarps * kTile * sizeof(float)                     // ds, multipliers
         + (size_t)kRows * (DH + 3) * sizeof(float);                      // dq, max, sum, delta
}

template <typename T, int DH, bool HAS_BIAS, bool HAS_SPAN, bool DROP>
__global__ void __launch_bounds__(kThreads)
attn_bwd_rows_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ bias,
                     const int* __restrict__ span, const T* __restrict__ dout,
                     T* __restrict__ dq, T* __restrict__ dbias, float* __restrict__ lse,
                     float* __restrict__ delta, int N, int J, float keep_prob,
                     float inv_keep, unsigned long long seed) {
  static_assert(DH == 64, "each lane owns DH / 32 = 2 columns of dq");
  constexpr int LD = row_stride<T>(DH);
  constexpr int NT = kTile / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_q = reinterpret_cast<T*>(smem_raw);
  T* s_do = s_q + kRows * LD;
  T* s_k = s_do + kRows * LD;
  T* s_v = s_k + kTile * LD;
  float* s_d = reinterpret_cast<float*>(s_v + kTile * LD);  // [kWarps][kTile] ds
  float* s_mult = s_d + kWarps * kTile;                      // [kWarps][kTile]
  float* s_acc = s_mult + kWarps * kTile;                    // [kRows][DH] dq
  float* s_m = s_acc + kRows * DH;   // [kRows] running max, then lse
  float* s_l = s_m + kRows;          // [kRows] running sum
  float* s_dl = s_l + kRows;         // [kRows] running sum of e * dp, then delta

  const int bg = blockIdx.y;
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, N - row0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const SpanMask mask = load_span<HAS_SPAN>(span, bg, J);
  stage_rows<T, DH>(q + ((size_t)bg * N + row0) * DH, s_q, rows);
  stage_rows<T, DH>(dout + ((size_t)bg * N + row0) * DH, s_do, rows);
  for (int i = threadIdx.x; i < kRows * DH; i += kThreads) s_acc[i] = 0.f;
  if (threadIdx.x < kRows) {
    s_m[threadIdx.x] = -INFINITY;
    s_l[threadIdx.x] = 0.f;
    s_dl[threadIdx.x] = 0.f;
  }
  const T* kg = k + (size_t)bg * J * DH;
  const T* vg = v + (size_t)bg * J * DH;
  float* d = s_d + warp * kTile;
  float* mult = s_mult + warp * kTile;

  // the masked scores s[t] and dp[t] = (dout . v_j) * m of keys j0 + lane + 32 t
  auto scores = [&](int r, int row, bool uniform, int j0, int nt, float (&s)[NT],
                    float (&dp)[NT]) {
    if (DROP) drop_mult_tile(mult, seed, j0, J, row, bg, keep_prob, inv_keep, lane);
    dot_keys<T, DH>(s_q + r * LD, s_k, lane, nt, s);
    dot_keys<T, DH>(s_do + r * LD, s_v, lane, nt, dp);
    if (DROP) __syncwarp();  // lanes read multipliers that other lanes drew
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int j = j0 + lane + 32 * t;
      if (t < nt && j < J) {
        if (HAS_BIAS) s[t] += to_f32(bias[((size_t)bg * N + row) * J + j]);
        s[t] = mask_score<HAS_SPAN>(s[t], mask, uniform, j);
        if (DROP) dp[t] *= mult[lane + 32 * t];
      } else {
        s[t] = -INFINITY;
        dp[t] = 0.f;
      }
    }
  };

  // pass 1: each row's lse and delta
  for (int j0 = 0; j0 < J; j0 += kTile) {
    __syncthreads();  // the previous tile is consumed (first: q, dout, the state)
    stage_kv_tile<T, DH>(kg, vg, s_k, s_v, j0, J);
    __syncthreads();
    const int nt = (min(kTile, J - j0) + 31) / 32;
    for (int r = warp; r < rows; r += kWarps) {
      const int row = row0 + r;
      const bool uniform = HAS_SPAN && mask.uniform(row);
      float s[NT], dp[NT];
      scores(r, row, uniform, j0, nt, s, dp);
      float tmax = s[0];
#pragma unroll
      for (int t = 1; t < NT; ++t) tmax = fmaxf(tmax, s[t]);
      tmax = warp_max(tmax);
      const float m_old = s_m[r];
      const float m_new = fmaxf(m_old, tmax);
      const float scale = expf(m_old - m_new);
      float es = 0.f, des = 0.f;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const float e = expf(s[t] - m_new);
        es += e;
        des = fmaf(e, dp[t], des);
      }
      es = warp_sum(es);
      des = warp_sum(des);
      __syncwarp();  // every lane has read s_m[r] and the multipliers
      if (lane == 0) {
        s_m[r] = m_new;
        s_l[r] = s_l[r] * scale + es;
        s_dl[r] = s_dl[r] * scale + des;
      }
      __syncwarp();
    }
  }
  for (int r = warp; r < rows; r += kWarps) {
    if (lane == 0) {
      const size_t row = (size_t)bg * N + row0 + r;
      const float l = s_l[r];
      s_m[r] = lse[row] = s_m[r] + logf(l);
      s_dl[r] = delta[row] = s_dl[r] / l;
    }
  }

  // pass 2: ds, dbias and dq
  for (int j0 = 0; j0 < J; j0 += kTile) {
    __syncthreads();  // the previous tile is consumed (first: lse and delta are set)
    stage_kv_tile<T, DH>(kg, vg, s_k, s_v, j0, J);
    __syncthreads();
    const int len = min(kTile, J - j0);
    const int nt = (len + 31) / 32;
    for (int r = warp; r < rows; r += kWarps) {
      const int row = row0 + r;
      const bool uniform = HAS_SPAN && mask.uniform(row);
      float s[NT], dp[NT];
      scores(r, row, uniform, j0, nt, s, dp);
      const float lse_r = s_m[r], delta_r = s_dl[r];
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const int j = j0 + lane + 32 * t;
        if (t < nt) {
          float ds = 0.f;
          if (j < J && pair_valid<HAS_SPAN>(mask, uniform, j))
            ds = expf(s[t] - lse_r) * (dp[t] - delta_r);
          if (HAS_BIAS && j < J) store1(dbias + ((size_t)bg * N + row) * J + j, ds);
          d[lane + 32 * t] = round_to(ds, T());
        }
      }
      __syncwarp();  // d is written

      float2* acc = reinterpret_cast<float2*>(s_acc + r * DH) + lane;
      float2 a = *acc;
      const T* kcol = s_k + 2 * lane;
#pragma unroll 4
      for (int jj = 0; jj < len; ++jj) {
        const float dj = d[jj];
        const float2 kk = load2(kcol + jj * LD);
        a.x = fmaf(dj, kk.x, a.x);
        a.y = fmaf(dj, kk.y, a.y);
      }
      *acc = a;
      __syncwarp();  // the next row rewrites d and the multipliers
    }
  }
  for (int r = warp; r < rows; r += kWarps)
    store2(dq + ((size_t)bg * N + row0 + r) * DH + 2 * lane,
           reinterpret_cast<const float2*>(s_acc + r * DH)[lane]);
}

struct KeysSmem {
  float k[kKeys][kKLd];
  float v[kKeys][kKLd];
  __align__(16) float q[kChunk][kQLd];
  __align__(16) float dout[kChunk][kQLd];
  float pd[kChunk][kKeys];
  float ds[kChunk][kKeys];
  float lse[kChunk];
  float delta[kChunk];
};

template <typename T, int DH, bool HAS_BIAS, bool HAS_SPAN, bool DROP>
__global__ void __launch_bounds__(kThreads)
attn_bwd_keys_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ bias,
                     const int* __restrict__ span, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, int N, int J,
                     float keep_prob, float inv_keep, unsigned long long seed) {
  static_assert(DH == 64 && kKeys * DH == 4 * kThreads, "4 dk and 4 dv per thread");
  static_assert(kChunk * (kKeys / 4) == kThreads, "one thread per (row, key group)");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  KeysSmem& sm = *reinterpret_cast<KeysSmem*>(smem_raw);

  const int bg = blockIdx.y;
  const int j0 = blockIdx.x * kKeys;
  const int t = threadIdx.x;
  const SpanMask mask = load_span<HAS_SPAN>(span, bg, J);
  const T* qg = q + (size_t)bg * N * DH;
  const T* dog = dout + (size_t)bg * N * DH;
  for (int i = t; i < kKeys * DH; i += kThreads) {
    const int jl = i / DH, c = i - jl * DH;
    const bool ok = j0 + jl < J;
    const size_t at = ((size_t)bg * J + j0 + jl) * DH + c;
    sm.k[jl][c] = ok ? to_f32(k[at]) : 0.f;
    sm.v[jl][c] = ok ? to_f32(v[at]) : 0.f;
  }

  const int pr = t >> 2;            // pair phase: chunk row
  const int grp = t & 3;            //             key group (4 keys)
  const int kl = t >> 4;            // sum phase:  key
  const int c4 = (t & 15) * 4;      //             4 columns
  float dk_acc[4] = {0.f, 0.f, 0.f, 0.f}, dv_acc[4] = {0.f, 0.f, 0.f, 0.f};

  for (int r0 = 0; r0 < N; r0 += kChunk) {
    __syncthreads();  // the previous chunk is consumed (and the keys are staged)
    for (int i = t; i < kChunk * DH; i += kThreads) {
      const int rr = i / DH, c = i - rr * DH;
      const bool ok = r0 + rr < N;
      sm.q[rr][c] = ok ? to_f32(qg[(size_t)(r0 + rr) * DH + c]) : 0.f;
      sm.dout[rr][c] = ok ? to_f32(dog[(size_t)(r0 + rr) * DH + c]) : 0.f;
    }
    if (t < kChunk) {
      const bool ok = r0 + t < N;
      sm.lse[t] = ok ? lse[(size_t)bg * N + r0 + t] : 0.f;
      sm.delta[t] = ok ? delta[(size_t)bg * N + r0 + t] : 0.f;
    }
    __syncthreads();

    {
      const int row = r0 + pr;
      float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
      for (int c = 0; c < DH; ++c) {
        const float qv = sm.q[pr][c], ov = sm.dout[pr][c];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          s[jj] = fmaf(qv, sm.k[4 * grp + jj][c], s[jj]);
          dp[jj] = fmaf(ov, sm.v[4 * grp + jj][c], dp[jj]);
        }
      }
      uint4 bits = make_uint4(0u, 0u, 0u, 0u);
      if (DROP) bits = philox::bits4(seed, (j0 >> 2) + grp, row, bg);
      const bool uniform = HAS_SPAN && mask.uniform(row);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int jl = 4 * grp + jj;
        const int j = j0 + jl;
        float pd = 0.f, ds = 0.f;
        if (row < N && j < J) {
          float sv = s[jj];
          if (HAS_BIAS) sv += to_f32(bias[((size_t)bg * N + row) * J + j]);
          sv = mask_score<HAS_SPAN>(sv, mask, uniform, j);
          const float pj = expf(sv - sm.lse[pr]);
          const float m = DROP ? (philox::keep(philox::word(bits, jj), keep_prob)
                                      ? inv_keep : 0.f)
                               : 1.f;
          pd = round_to(pj * m, T());
          if (pair_valid<HAS_SPAN>(mask, uniform, j))
            ds = round_to(pj * (dp[jj] * m - sm.delta[pr]), T());
        }
        sm.pd[pr][jl] = pd;
        sm.ds[pr][jl] = ds;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int rr = 0; rr < kChunk; ++rr) {
      const float ds = sm.ds[rr][kl], pd = sm.pd[rr][kl];
      const float4 qv = *reinterpret_cast<const float4*>(&sm.q[rr][c4]);
      const float4 ov = *reinterpret_cast<const float4*>(&sm.dout[rr][c4]);
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

struct Args {
  const void *q, *k, *v, *bias;
  const int* span;
  const void* dout;
  void *dq, *dk, *dv, *dbias;
  float *lse, *delta;
  int BG, N, J;
  float keep_prob, inv_keep;
  unsigned long long seed;
  cudaStream_t stream;
};

template <typename T, bool HAS_BIAS, bool HAS_SPAN, bool DROP>
cudaError_t launch(const Args& a) {
  constexpr int DH = 64;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* bias = static_cast<const T*>(a.bias);
  const T* dout = static_cast<const T*>(a.dout);
  constexpr size_t rows_smem = rows_smem_bytes<T, DH>();
  auto rows = attn_bwd_rows_kernel<T, DH, HAS_BIAS, HAS_SPAN, DROP>;
  cudaError_t err = cudaFuncSetAttribute(
      rows, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(rows_smem));
  if (err != cudaSuccess) return err;
  rows<<<dim3((a.N + kRows - 1) / kRows, a.BG), kThreads, rows_smem, a.stream>>>(
      q, k, v, bias, a.span, dout, static_cast<T*>(a.dq), static_cast<T*>(a.dbias), a.lse,
      a.delta, a.N, a.J, a.keep_prob, a.inv_keep, a.seed);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto keys = attn_bwd_keys_kernel<T, DH, HAS_BIAS, HAS_SPAN, DROP>;
  err = cudaFuncSetAttribute(keys, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(sizeof(KeysSmem)));
  if (err != cudaSuccess) return err;
  keys<<<dim3((a.J + kKeys - 1) / kKeys, a.BG), kThreads, sizeof(KeysSmem), a.stream>>>(
      q, k, v, bias, a.span, dout, a.lse, a.delta, static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.N, a.J, a.keep_prob, a.inv_keep, a.seed);
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

extern "C" int deform_attn_bwd(int dtype, const void* q, const void* k, const void* v,
                               const void* bias, const void* span, const void* dout,
                               void* dq, void* dk, void* dv, void* dbias, void* lse,
                               void* delta, int BG, int N, int J, int DH, float keep_prob,
                               float inv_keep, unsigned long long seed, int device,
                               void* stream) {
  if (DH != 64) return cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Args a{q, k, v, bias, static_cast<const int*>(span), dout, dq, dk, dv, dbias,
               static_cast<float*>(lse), static_cast<float*>(delta), BG, N, J, keep_prob,
               inv_keep, seed, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return dispatch<float>(a);
  if (dtype == 1) return dispatch<__nv_bfloat16>(a);
  return cudaErrorInvalidValue;
}
