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
//   - the V outputs are blended (below) and written with one 16-byte
//     store.
// The grid's y axis walks the images, so a block never spans two translations
// and the clamp, floor and fraction are computed per block from the image's
// two floats. Where a row is not a whole number of 16-byte vectors (W % V,
// or a pointer not 16-byte aligned) the same kernel takes a scalar path: a
// thread per output element with 4 scalar corner reads.
//
// The blend. The JAX package's three warps compute one function and round
// a bf16 warp at different points; `blend` names the one to follow
// (ops/warp.py::BLEND_CODES; TPU.WARP_IMPL picks it): the Pallas kernel's
// f32 blend, rounded once; the matmul form's two passes, rows first, with
// the weights and the row pass rounded to bf16; the slice form's bf16
// elementwise ops, every product and sum rounded. A bf16 product of two
// bf16 values is exact in f32, so a fused multiply-add gives the same bits
// as the plain version's separate product and sum in the last two. f32
// images always take the first (the three agree to an ulp there).
//
// Build (nvcc 12.9, -Xptxas -v, sm_90a): 38 registers (bf16, the first two
// blends), 40 (the slice blend), 34 (f32), no spills, no shared memory. The
// slice blend's ten roundings an output make it 2.3 times the others' time
// at 32 images (31.4 us against 13.4-13.7, chip_smoke.py).

#include <string.h>

#include "warp_common.cuh"

namespace {

constexpr int kBand = 8;  // output rows a vector thread walks

// ops/warp.py::BLEND_CODES
enum Blend : int { kOnce = 0, kRows = 1, kEachOp = 2 };

// v rounded to T, as f32
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  return to_f(from_f<T>(v));
}

// the weights of one image: fx, 1 - fx, fy, 1 - fy as blend B rounds them
struct Weights {
  float x, x1, y, y1;
};
template <typename T, int B>
__device__ __forceinline__ Weights weights(float fx, float fy) {
  if (B == kRows) return {rnd<T>(fx), rnd<T>(1.f - fx), rnd<T>(fy),
                          rnd<T>(1.f - fy)};
  if (B == kEachOp) {
    const float x = rnd<T>(fx), y = rnd<T>(fy);
    return {x, rnd<T>(1.f - x), y, rnd<T>(1.f - y)};
  }
  return {fx, 1.f - fx, fy, 1.f - fy};
}

// the output from its corners s00 (row y - ty0 - 1, column x - tx0 - 1),
// s01 (same row, column x - tx0), s10 and s11 (row y - ty0), before its
// last rounding to T
template <typename T, int B>
__device__ __forceinline__ float blend(float s00, float s01, float s10,
                                       float s11, const Weights& w) {
  if (B == kRows) {
    const float left = rnd<T>(w.y * s00 + w.y1 * s10);
    const float right = rnd<T>(w.y * s01 + w.y1 * s11);
    return w.x * left + w.x1 * right;
  }
  if (B == kEachOp) {
    const float top = rnd<T>(rnd<T>(s00 * w.x) + rnd<T>(s01 * w.x1));
    const float bot = rnd<T>(rnd<T>(s10 * w.x) + rnd<T>(s11 * w.x1));
    return rnd<T>(top * w.y) + rnd<T>(bot * w.y1);
  }
  const float top = s00 * w.x + s01 * w.x1;
  const float bot = s10 * w.x + s11 * w.x1;
  return top * w.y + bot * w.y1;
}

// one strip of V columns over a band of rows; W % V == 0
template <typename T, int SH, int B>
__device__ void warp_strip(const T* __restrict__ src, T* __restrict__ dst,
                           int H, int W, int x, int y_begin, int y_end,
                           int tx0, int ty0, const Weights& wt) {
  constexpr int V = 16 / sizeof(T);
  const int a = x - tx0 - 1 - SH;  // a multiple of V
  float prev[V + 1], cur[V + 1];
  load_row<T, SH>(src, y_begin - ty0 - 1, a, H, W, prev);
  for (int y = y_begin; y < y_end; ++y) {
    load_row<T, SH>(src, y - ty0, a, H, W, cur);
    T o[V];
#pragma unroll
    for (int i = 0; i < V; ++i)
      o[i] = from_f<T>(blend<T, B>(prev[i], prev[i + 1], cur[i], cur[i + 1],
                                   wt));
    uint4 w;
    memcpy(&w, o, 16);
    *reinterpret_cast<uint4*>(dst + (size_t)y * W + x) = w;
#pragma unroll
    for (int i = 0; i <= V; ++i) prev[i] = cur[i];
  }
}

// grid (blocks over one image's work, N): blockIdx.y is the image
template <typename T, int B>
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
  const Weights wt = weights<T, B>(fx, fy);
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
    dispatch_shift<V>(sh, [&](auto s) {
      warp_strip<T, decltype(s)::value, B>(src_n + c * hw, dst_n + c * hw, H,
                                           W, strip * V, y0,
                                           min(H, y0 + kBand), tx0, ty0, wt);
    });
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
    dst_n[e] = from_f<T>(blend<T, B>(s00, s01, s10, s11, wt));
  }
}

template <typename T>
cudaError_t launch(const void* img, const float* offsets, void* out,
                   int blend_impl, int N, int C, int H, int W,
                   float max_shift, cudaStream_t s) {
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
  // f32 images take kOnce whatever the blend: the three agree to an ulp
  auto* kernel = warp_translate_kernel<T, kOnce>;
  if (!std::is_same<T, float>::value && blend_impl == kRows)
    kernel = warp_translate_kernel<T, kRows>;
  if (!std::is_same<T, float>::value && blend_impl == kEachOp)
    kernel = warp_translate_kernel<T, kEachOp>;
  kernel<<<dim3((unsigned)blocks, (unsigned)N), kThreads, 0, s>>>(
      static_cast<const T*>(img), offsets, static_cast<T*>(out), C, H, W,
      max_shift, vec ? 1 : 0);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (images and out); offsets are (N, 2)
// float32 (tx, ty); blend: a Blend (ops/warp.py::BLEND_CODES).
extern "C" int fami_warp_translate(const void* images, const void* offsets,
                                   void* out, int dtype, int blend, int N,
                                   int C, int H, int W, float max_shift,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* off = static_cast<const float*>(offsets);
  if (blend < kOnce || blend > kEachOp) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)launch<float>(images, off, out, blend, N, C, H, W, max_shift,
                              s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(images, off, out, blend, N, C, H, W,
                                      max_shift, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* fami_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
