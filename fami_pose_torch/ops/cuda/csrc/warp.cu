// Per-image sub-pixel translation warp, dst(p) = src(p - t), for Hopper.
//
// Replaces the TPU kernel fami_pose_tpu/ops/pallas/warp.py::warp_translate_pallas
// (_warp_kernel, pallas_call at :119), the same function as
// fami_pose_tpu/ops/warp.py::warp_translate: t = (tx, ty) is clamped to
// +-max_shift per image, split into floor and fraction, and each output
// value is the 4-corner bilinear blend of the source around p - t, zero
// outside the image.
//
// What bounds it on an H100: it reads each input once and writes each output
// once (~21 MB each way at (32, 48, 96, 72) bf16) and does ~10 flops per
// element, so the bytes set the least time (~13 us at 3.35 TB/s). Measured
// (chip_smoke.py, H100 80GB HBM3, 700 W): 13.5 us there, 5.6 us at 8
// images, 74.0 us at 128 (85 MB, more than the 50 MB L2; bound 50.7 us).
//
// Design. The TPU kernel shifts rows held on chip in two separable passes.
// Here the translation is uniform over an image, so a thread owns a strip of
// V = 16 / sizeof(T) consecutive output columns (8 in bf16, 4 in f32) and a
// band of 8 rows of one (image, channel) plane, and walks down the band:
//   - for output row y it needs source rows y - ty0 - 1 and y - ty0, each at
//     the V + 1 columns x - tx0 - 1 ... x - tx0 + V - 1. Those lie in the two
//     aligned 16-byte vectors of the source row at a = x - tx0 - 1 - sh and
//     a + V, where sh = (-tx0 - 1) mod V is the same for the whole image: the
//     kernel is instantiated for each sh, so the V + 1 values are picked out
//     of the two vectors with register moves fixed at compile time;
//   - each source row is loaded once per band and kept in registers for the
//     next output row, so a source element is read from device memory
//     (9 / 8) times, not four;
//   - the V outputs are blended in f32 (the plain version's order) and
//     written with one 16-byte store.
// The grid's y axis walks the images, so a block never spans two translations
// and the clamp, floor and fraction are computed per block from the image's
// two floats. Where a row is not a whole number of 16-byte vectors (W % V,
// or a pointer not 16-byte aligned) the same kernel takes a scalar path: a
// thread per output element with 4 scalar corner reads.
//
// Build (nvcc 12.9, -Xptxas -v, sm_90a): 38 registers (bf16), 32 (f32), no
// spills, no shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBand = 8;  // output rows a vector thread walks

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// element e (0 <= e < 2V) of two 16-byte vectors, as f32
template <typename T>
__device__ __forceinline__ float elem(const uint4& a, const uint4& b, int e);
template <>
__device__ __forceinline__ float elem<float>(const uint4& a, const uint4& b,
                                             int e) {
  const uint4& v = e < 4 ? a : b;
  const int i = e & 3;
  return __uint_as_float(i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w);
}
template <>
__device__ __forceinline__ float elem<__nv_bfloat16>(const uint4& a,
                                                     const uint4& b, int e) {
  const uint4& v = e < 8 ? a : b;
  const int i = (e & 7) >> 1;
  const uint32_t w = i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
  return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
}

// the V + 1 source values of one row for a strip, zero outside the image
template <typename T, int SH>
__device__ __forceinline__ void load_row(const T* __restrict__ src, int sy,
                                         int a, int H, int W,
                                         float (&r)[16 / sizeof(T) + 1]) {
  constexpr int V = 16 / sizeof(T);
  uint4 lo = make_uint4(0u, 0u, 0u, 0u), hi = lo;
  if ((unsigned)sy < (unsigned)H) {
    const T* row = src + (size_t)sy * W;
    if ((unsigned)a < (unsigned)W)
      lo = __ldg(reinterpret_cast<const uint4*>(row + a));
    if ((unsigned)(a + V) < (unsigned)W)
      hi = __ldg(reinterpret_cast<const uint4*>(row + a + V));
  }
#pragma unroll
  for (int i = 0; i <= V; ++i) r[i] = elem<T>(lo, hi, SH + i);
}

// one strip of V columns over a band of rows; W % V == 0
template <typename T, int SH>
__device__ void warp_strip(const T* __restrict__ src, T* __restrict__ dst,
                           int H, int W, int x, int y_begin, int y_end,
                           int tx0, int ty0, float fx, float fy) {
  constexpr int V = 16 / sizeof(T);
  const int a = x - tx0 - 1 - SH;  // a multiple of V
  float prev[V + 1], cur[V + 1];
  load_row<T, SH>(src, y_begin - ty0 - 1, a, H, W, prev);
  for (int y = y_begin; y < y_end; ++y) {
    load_row<T, SH>(src, y - ty0, a, H, W, cur);
    T o[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float top = prev[i] * fx + prev[i + 1] * (1.f - fx);
      const float bot = cur[i] * fx + cur[i + 1] * (1.f - fx);
      o[i] = from_f<T>(top * fy + bot * (1.f - fy));
    }
    uint4 w;
    memcpy(&w, o, 16);
    *reinterpret_cast<uint4*>(dst + (size_t)y * W + x) = w;
#pragma unroll
    for (int i = 0; i <= V; ++i) prev[i] = cur[i];
  }
}

template <typename T>
__device__ __forceinline__ void warp_strip_sh(int sh, const T* src, T* dst,
                                              int H, int W, int x, int y0,
                                              int y1, int tx0, int ty0,
                                              float fx, float fy) {
  switch (sh) {
    case 0: warp_strip<T, 0>(src, dst, H, W, x, y0, y1, tx0, ty0, fx, fy); break;
    case 1: warp_strip<T, 1>(src, dst, H, W, x, y0, y1, tx0, ty0, fx, fy); break;
    case 2: warp_strip<T, 2>(src, dst, H, W, x, y0, y1, tx0, ty0, fx, fy); break;
    case 3: warp_strip<T, 3>(src, dst, H, W, x, y0, y1, tx0, ty0, fx, fy); break;
    default:
      if constexpr (sizeof(T) == 2) {
        switch (sh) {
          case 4: warp_strip<T, 4>(src, dst, H, W, x, y0, y1, tx0, ty0, fx, fy); break;
          case 5: warp_strip<T, 5>(src, dst, H, W, x, y0, y1, tx0, ty0, fx, fy); break;
          case 6: warp_strip<T, 6>(src, dst, H, W, x, y0, y1, tx0, ty0, fx, fy); break;
          default: warp_strip<T, 7>(src, dst, H, W, x, y0, y1, tx0, ty0, fx, fy); break;
        }
      }
  }
}

// grid (blocks over one image's work, N): blockIdx.y is the image
template <typename T>
__global__ void __launch_bounds__(kThreads)
    warp_translate_kernel(const T* __restrict__ img,
                          const float* __restrict__ offsets,
                          T* __restrict__ out, int C, int H, int W,
                          float max_shift, int vec) {
  constexpr int V = 16 / sizeof(T);
  const int n = blockIdx.y;
  const float tx = fminf(fmaxf(offsets[2 * n], -max_shift), max_shift);
  const float ty = fminf(fmaxf(offsets[2 * n + 1], -max_shift), max_shift);
  const float txf = floorf(tx);
  const float tyf = floorf(ty);
  const float fx = tx - txf;
  const float fy = ty - tyf;
  const int tx0 = (int)txf;
  const int ty0 = (int)tyf;
  const size_t hw = (size_t)H * W;
  const T* src_n = img + (size_t)n * C * hw;
  T* dst_n = out + (size_t)n * C * hw;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (vec) {
    const int strips = W / V;
    const int bands = (H + kBand - 1) / kBand;
    if (t >= (long long)C * bands * strips) return;
    const int strip = (int)(t % strips);
    const int rest = (int)(t / strips);
    const int band = rest % bands;
    const int c = rest / bands;
    const int sh = ((-tx0 - 1) % V + V) % V;
    const int y0 = band * kBand;
    warp_strip_sh<T>(sh, src_n + c * hw, dst_n + c * hw, H, W, strip * V, y0,
                     min(H, y0 + kBand), tx0, ty0, fx, fy);
    return;
  }
  for (long long e = t; e < (long long)C * hw;
       e += (long long)gridDim.x * blockDim.x) {
    const long long c = e / hw;
    const int p = (int)(e - c * hw);
    const T* src = src_n + c * hw;
    const int y = p / W;
    const int sx = p - y * W - tx0;
    const int sy = y - ty0;
    const bool r1 = sy >= 0 && sy < H;          // row sy
    const bool r0 = sy - 1 >= 0 && sy - 1 < H;  // row sy - 1
    const bool c1 = sx >= 0 && sx < W;          // column sx
    const bool c0 = sx - 1 >= 0 && sx - 1 < W;  // column sx - 1
    const float s11 = (r1 && c1) ? to_f(src[sy * W + sx]) : 0.f;
    const float s10 = (r1 && c0) ? to_f(src[sy * W + sx - 1]) : 0.f;
    const float s01 = (r0 && c1) ? to_f(src[(sy - 1) * W + sx]) : 0.f;
    const float s00 = (r0 && c0) ? to_f(src[(sy - 1) * W + sx - 1]) : 0.f;
    const float top = s00 * fx + s01 * (1.f - fx);
    const float bot = s10 * fx + s11 * (1.f - fx);
    dst_n[e] = from_f<T>(top * fy + bot * (1.f - fy));
  }
}

template <typename T>
cudaError_t launch(const void* img, const float* offsets, void* out, int N,
                   int C, int H, int W, float max_shift, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  if (N == 0 || C == 0 || H == 0 || W == 0) return cudaSuccess;
  if (N > 65535) return cudaErrorInvalidValue;
  const bool vec = W % V == 0 && reinterpret_cast<uintptr_t>(img) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long long work = vec ? (long long)C * ((H + kBand - 1) / kBand) * (W / V)
                             : (long long)C * H * W;
  long long blocks = (work + kThreads - 1) / kThreads;
  if (!vec && blocks > 1024) blocks = 1024;  // grid-stride
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  warp_translate_kernel<T><<<dim3((unsigned)blocks, (unsigned)N), kThreads, 0,
                             s>>>(static_cast<const T*>(img), offsets,
                                  static_cast<T*>(out), C, H, W, max_shift,
                                  vec ? 1 : 0);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (images and out); offsets are (N, 2)
// float32 (tx, ty).
extern "C" int fami_warp_translate(const void* images, const void* offsets,
                                   void* out, int dtype, int N, int C, int H,
                                   int W, float max_shift, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* off = static_cast<const float*>(offsets);
  if (dtype == 0)
    return (int)launch<float>(images, off, out, N, C, H, W, max_shift, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(images, off, out, N, C, H, W, max_shift,
                                      s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* fami_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
