// The pixel stage of the port's JPEG decoder: int16 coefficients from the host
// entropy stage (sml_tpu_torch/runtime/jpeg.cpp) -> the RGB bag that PIL's
// np.asarray(Image.open(p).convert("RGB")) gives, uint8 or f32 / 255.
//
// Replaces no Pallas kernel: the JAX package decodes raw patches with PIL on the
// host (sml_tpu/data/datasets.py:109-114).  It computes what libjpeg-turbo's
// default decode path computes, in integers, so the bytes are PIL's:
//   - dequantise and the ISLOW inverse DCT of jidctint.c (CONST_BITS 13,
//     PASS1_BITS 2, DESCALE rounding, the range-limit table behind & 1023);
//   - chroma upsampling as jdsample.c does by default (h2v1 / h1v2 fancy with
//     biases 1 / 2, h2v2 fancy with 8 / 7 over the column sums of two rows,
//     edges replicated at the component's own size, a box filter where the
//     component is at most 2 samples wide, 1x1 copied);
//   - jdcolor.c's YCbCr -> RGB (SCALEBITS 16, ONE_HALF, the combined green
//     term) and clamping; a grey file's L in R, G and B;
//   - float(v) / 255.0f, correctly rounded (nvcc's default -prec-div=true), as
//     numpy's float32 / 255.0.
// The plain version, sml_tpu_torch/ops/kernels/jpeg.py:jpeg_pixels_plain, does
// the same arithmetic in PyTorch int32 operations.
//
// What bounds it on the H100: bytes.  Per 224 x 224 4:2:0 patch, 150.5 KB of
// int16 coefficients in and 602 KB of f32 out per bag row; about 40 integer
// operations per coefficient and 30 per output pixel, far below the ridge.
// Design (simple first; speed is later work): idct_kernel, one thread per 8x8
// block, into uint8 sample planes (one byte per coefficient, at the
// coefficients' own offsets) in a scratch buffer the wrapper allocates; then
// colour_kernel, one thread per output pixel of each bag row, reading the row's
// file's planes, so a file repeated in the bag is transformed once.
//
// Header of one file, in int32 (runtime/jpeg.cpp): width, height, components,
// hmax, vmax, restart interval, coefficients, 0; per component h, v, blocks
// across, blocks down; per component 64 quantisation values, natural order.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWidth = 0, kHeight = 1, kComps = 2, kHmax = 3, kVmax = 4, kComp = 8,
              kQuant = 20, kHeaderInts = kQuant + 64 * 3;
constexpr int kIdctThreads = 128, kColourThreads = 256;

__device__ __forceinline__ int descale(int x, int n) { return (x + (1 << (n - 1))) >> n; }

// jdmaster.c's post-IDCT range limit, indexed by x & RANGE_MASK
__device__ __forceinline__ int range_limit(int x) {
  const int t = x & 1023;
  return t < 128 ? t + 128 : t < 512 ? 255 : t < 896 ? 0 : t - 896;
}

// one pass of jpeg_idct_islow over v[0], v[S], ..., v[7S], in place, descaled by SHIFT
template <int S, int SHIFT>
__device__ __forceinline__ void idct_1d(int* v) {
  int z2 = v[2 * S], z3 = v[6 * S];
  int z1 = (z2 + z3) * 4433;                         // FIX_0_541196100
  int tmp2 = z1 + z3 * -15137;                       // FIX_1_847759065
  int tmp3 = z1 + z2 * 6270;                         // FIX_0_765366865
  int tmp0 = (v[0] + v[4 * S]) << 13;
  int tmp1 = (v[0] - v[4 * S]) << 13;
  const int tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  const int tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  tmp0 = v[7 * S];
  tmp1 = v[5 * S];
  tmp2 = v[3 * S];
  tmp3 = v[1 * S];
  z1 = tmp0 + tmp3;
  z2 = tmp1 + tmp2;
  z3 = tmp0 + tmp2;
  int z4 = tmp1 + tmp3;
  const int z5 = (z3 + z4) * 9633;                   // FIX_1_175875602
  tmp0 = tmp0 * 2446;                                // FIX_0_298631336
  tmp1 = tmp1 * 16819;                               // FIX_2_053119869
  tmp2 = tmp2 * 25172;                               // FIX_3_072711026
  tmp3 = tmp3 * 12299;                               // FIX_1_501321110
  z1 = z1 * -7373;                                   // FIX_0_899976223
  z2 = z2 * -20995;                                  // FIX_2_562915447
  z3 = z3 * -16069 + z5;                             // FIX_1_961570560
  z4 = z4 * -3196 + z5;                              // FIX_0_390180644
  tmp0 += z1 + z3;
  tmp1 += z2 + z4;
  tmp2 += z2 + z3;
  tmp3 += z1 + z4;
  v[0] = descale(tmp10 + tmp3, SHIFT);
  v[7 * S] = descale(tmp10 - tmp3, SHIFT);
  v[1 * S] = descale(tmp11 + tmp2, SHIFT);
  v[6 * S] = descale(tmp11 - tmp2, SHIFT);
  v[2 * S] = descale(tmp12 + tmp1, SHIFT);
  v[5 * S] = descale(tmp12 - tmp1, SHIFT);
  v[3 * S] = descale(tmp13 + tmp0, SHIFT);
  v[4 * S] = descale(tmp13 - tmp0, SHIFT);
}

// grid (blocks of the largest file / kIdctThreads, files): block b of file
// blockIdx.y -> 64 samples in its component's plane
__global__ void __launch_bounds__(kIdctThreads)
idct_kernel(const int16_t* __restrict__ coef, const int* __restrict__ hdr,
            const int64_t* __restrict__ offsets, uint8_t* __restrict__ planes) {
  const int f = blockIdx.y;
  const int* h = hdr + (int64_t)f * kHeaderInts;
  __shared__ int quant[3 * 64];
  __shared__ int geo[kQuant];
  for (int i = threadIdx.x; i < 3 * 64; i += blockDim.x) quant[i] = h[kQuant + i];
  if (threadIdx.x < kQuant) geo[threadIdx.x] = h[threadIdx.x];
  __syncthreads();
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  int c = 0;
  int64_t first = offsets[f];
  for (;;) {                                         // the component holding block b
    const int nb = geo[kComp + 4 * c + 2] * geo[kComp + 4 * c + 3];
    if (b < nb) break;
    b -= nb;
    first += (int64_t)nb * 64;
    if (++c == geo[kComps]) return;
  }
  const int bw = geo[kComp + 4 * c + 2];
  const int by = b / bw, bx = b - by * bw;
  const int4* src = reinterpret_cast<const int4*>(coef + first + (int64_t)b * 64);
  int v[64];
#pragma unroll
  for (int q = 0; q < 8; ++q) {                      // 8 coefficients per 16-byte load
    const int4 w = src[q];
    const int words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[q * 8 + 2 * k] = (int)(int16_t)(words[k] & 0xFFFF);
      v[q * 8 + 2 * k + 1] = (int)(int16_t)((unsigned)words[k] >> 16);
    }
  }
  const int* qt = quant + 64 * c;
#pragma unroll
  for (int k = 0; k < 64; ++k) v[k] *= qt[k];
#pragma unroll
  for (int col = 0; col < 8; ++col) idct_1d<8, 11>(v + col);          // pass 1: columns
#pragma unroll
  for (int row = 0; row < 8; ++row) idct_1d<1, 18>(v + 8 * row);      // pass 2: rows
  const int pitch = bw * 8;
  uint8_t* dst = planes + first + (int64_t)(by * 8) * pitch + bx * 8;
#pragma unroll
  for (int row = 0; row < 8; ++row) {
    unsigned lo = 0, hi = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      lo |= (unsigned)range_limit(v[8 * row + k]) << (8 * k);
      hi |= (unsigned)range_limit(v[8 * row + 4 + k]) << (8 * k);
    }
    *reinterpret_cast<uint2*>(dst + (int64_t)row * pitch) = make_uint2(lo, hi);
  }
}

// the upsampled chroma sample at output (x, y) from its plane p (pitch bytes a
// row, cw x ch real samples), for luma sampling h x v
__device__ __forceinline__ int chroma(const uint8_t* p, int pitch, int cw, int ch, int h,
                                      int v, int x, int y) {
  auto at = [&](int yy, int xx) { return (int)p[(int64_t)yy * pitch + xx]; };
  if (h == 1 && v == 1) return at(y, x);
  if (h == 2 && cw <= 2) return at(y / v, x / 2);                     // box
  if (h == 2 && v == 1) {                                             // h2v1 fancy
    const int ix = x >> 1, near = 3 * at(y, ix);
    return (x & 1) ? (near + at(y, min(ix + 1, cw - 1)) + 2) >> 2
                   : (near + at(y, max(ix - 1, 0)) + 1) >> 2;
  }
  if (h == 1) {                                                       // h1v2 fancy
    const int iy = y >> 1, near = 3 * at(iy, x);
    return (y & 1) ? (near + at(min(iy + 1, ch - 1), x) + 2) >> 2
                   : (near + at(max(iy - 1, 0), x) + 1) >> 2;
  }
  const int iy = y >> 1, ny = (y & 1) ? min(iy + 1, ch - 1) : max(iy - 1, 0);   // h2v2 fancy
  const int ix = x >> 1, nx = (x & 1) ? min(ix + 1, cw - 1) : max(ix - 1, 0);
  const int here = 3 * at(iy, ix) + at(ny, ix), there = 3 * at(iy, nx) + at(ny, nx);
  return (x & 1) ? (3 * here + there + 7) >> 4 : (3 * here + there + 8) >> 4;
}

__device__ __forceinline__ int clamp255(int x) { return min(max(x, 0), 255); }

__device__ __forceinline__ void put(uint8_t* out, int v) { *out = (uint8_t)v; }
__device__ __forceinline__ void put(float* out, int v) { *out = (float)v / 255.0f; }

// grid (pixels / kColourThreads, bag rows): pixel p of row r from file index[r]
template <typename OutT>
__global__ void __launch_bounds__(kColourThreads)
colour_kernel(const uint8_t* __restrict__ planes, const int* __restrict__ hdr,
              const int64_t* __restrict__ offsets, const int64_t* __restrict__ index,
              int height, int width, OutT* __restrict__ out) {
  const int r = blockIdx.y;
  const int64_t f = index[r];
  __shared__ int geo[kQuant];
  if (threadIdx.x < kQuant) geo[threadIdx.x] = hdr[f * kHeaderInts + threadIdx.x];
  __syncthreads();
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= height * width) return;
  const int y = p / width, x = p - y * width;
  const uint8_t* luma = planes + offsets[f];
  const int pitch0 = geo[kComp + 2] * 8;
  const int lum = luma[(int64_t)y * pitch0 + x];
  int rgb[3] = {lum, lum, lum};
  if (geo[kComps] == 3) {
    const int hmax = geo[kHmax], vmax = geo[kVmax];
    const int cw = (geo[kWidth] + hmax - 1) / hmax, ch = (geo[kHeight] + vmax - 1) / vmax;
    const int pitch = geo[kComp + 4 + 2] * 8;
    const uint8_t* cbp = luma + (int64_t)geo[kComp + 2] * geo[kComp + 3] * 64;
    const uint8_t* crp = cbp + (int64_t)geo[kComp + 4 + 2] * geo[kComp + 4 + 3] * 64;
    const int cb = chroma(cbp, pitch, cw, ch, hmax, vmax, x, y) - 128;
    const int cr = chroma(crp, pitch, cw, ch, hmax, vmax, x, y) - 128;
    // jdcolor.c: FIX(1.40200) 91881, FIX(1.77200) 116130, FIX(0.71414) 46802,
    // FIX(0.34414) 22554, ONE_HALF 32768, SCALEBITS 16
    rgb[0] = clamp255(lum + ((91881 * cr + 32768) >> 16));
    rgb[1] = clamp255(lum + ((-22554 * cb + 32768 - 46802 * cr) >> 16));
    rgb[2] = clamp255(lum + ((116130 * cb + 32768) >> 16));
  }
  OutT* dst = out + ((int64_t)r * height * width + p) * 3;
  put(dst, rgb[0]);
  put(dst + 1, rgb[1]);
  put(dst + 2, rgb[2]);
}

}  // namespace

// coef, hdr, offsets, index on the device; scratch holds one byte per
// coefficient; out (rows, height, width, 3) uint8 (out_float 0) or f32 (1).
// Returns cudaGetLastError() after the two launches.
extern "C" int jpeg_pixels(const void* coef, const void* hdr, const void* offsets,
                           const void* index, void* scratch, int n_files, int max_blocks,
                           int rows, int height, int width, int out_float, void* out,
                           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n_files <= 0 || rows <= 0 || max_blocks <= 0) return cudaSuccess;
  if (n_files > 65535 || rows > 65535) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* c16 = static_cast<const int16_t*>(coef);
  const auto* h = static_cast<const int*>(hdr);
  const auto* off = static_cast<const int64_t*>(offsets);
  auto* planes = static_cast<uint8_t*>(scratch);
  idct_kernel<<<dim3((max_blocks + kIdctThreads - 1) / kIdctThreads, n_files), kIdctThreads, 0,
                s>>>(c16, h, off, planes);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid((height * width + kColourThreads - 1) / kColourThreads, rows);
  const auto* idx = static_cast<const int64_t*>(index);
  if (out_float)
    colour_kernel<float><<<grid, kColourThreads, 0, s>>>(planes, h, off, idx, height, width,
                                                         static_cast<float*>(out));
  else
    colour_kernel<uint8_t><<<grid, kColourThreads, 0, s>>>(planes, h, off, idx, height, width,
                                                           static_cast<uint8_t*>(out));
  return cudaGetLastError();
}
