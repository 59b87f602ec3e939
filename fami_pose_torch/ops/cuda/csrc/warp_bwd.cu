// Backward of the per-image translation warp of warp.cu, for Hopper.
//
// The JAX package has no TPU kernel for this gradient: the custom_vjp of
// fami_pose_tpu/ops/pallas/warp.py differentiates the XLA form
// (fami_pose_tpu/ops/warp.py::warp_translate). The port's train path runs on
// the card, so the gradient gets a kernel of its own. With the forward
//   t = clamp((tx, ty), +-max_shift), t0 = floor(t), f = t - t0
//   out(p) = fy * (fx * s00 + (1 - fx) * s01)
//          + (1 - fy) * (fx * s10 + (1 - fx) * s11),
//   s11 = src(p - t0), s10 = src(p - t0 - (0, 1)),
//   s01 = src(p - t0 - (1, 0)), s00 = src(p - t0 - (1, 1)),
// and g the gradient of out:
//   d_images(q)  = the 4-corner adjoint: g sampled at q + t0, q + t0 + (0, 1),
//                  q + t0 + (1, 0), q + t0 + (1, 1) with the same weights. The
//                  translation is per image, so this is a pure gather.
//   d_offsets[n] = sum over channels and pixels of g * d out / d t. As the
//                  forward splits t into floor and fraction, the derivative
//                  at an integer translation is the right-hand one (the JAX
//                  warps on the train path do the same); it is zero on an
//                  axis whose raw translation lies outside +-max_shift.
//
// What bounds it on an H100: images and g are read once, d_images written
// once (~5.3 MB each at (8, 48, 96, 72) bf16), ~30 flops per element: the
// bytes set the least time (~4.8 us at 3.35 TB/s). Measured (chip_smoke.py
// device_ms, both launches, H100 80GB HBM3, 700 W): 9.8-9.9 us there,
// 36.3-36.8 at 32 images, and 15.3-15.6 us with the L2 flushed before each
// call; the kernel it replaced (a thread an element, nine guarded scalar
// loads, atomics into a zeroed d_offsets) took 34.6 and 112.7 us in turns
// with it.
//
// Design: row strips, as in warp.cu. A thread owns V = 16 / sizeof(T)
// consecutive columns x .. x + V - 1 (8 in bf16, 4 in f32) of one (image,
// channel) plane and walks a band of 32 / V rows; the grid's y axis walks the
// images, so the clamp, floor and fraction are worked out once per block.
// At each row y of its band the thread
//   - writes d_images(y, x .. x + V) with one 16-byte store, from g rows
//     y + ty0 and y + ty0 + 1 at columns x + tx0 .. x + tx0 + V: two aligned
//     vectors a row at the sub-vector shift SH = tx0 mod V;
//   - adds the terms of d_offsets of the outputs (y, x .. x + V), from g row
//     y at columns x .. x + V - 1 (one aligned vector) and src rows
//     y - ty0 - 1 and y - ty0 at columns x - tx0 - 1 .. x - tx0 + V - 1: two
//     vectors a row at the shift (-tx0 - 1) mod V = V - 1 - SH.
// One instance per SH covers both shifts, so every value is picked out of
// its vectors by register moves fixed at compile time. The lower g row and
// the lower src row of one step are the upper rows of the next, kept in
// registers: device memory is read about (band + 1) / band times. Where a
// row is not a whole number of 16-byte vectors (W % V, or a pointer not
// 16-byte aligned) the same kernel takes a scalar path, a thread per
// element with guarded scalar reads, over the same blocks.
//
// d_offsets without atomics, in a fixed order: each block reduces its
// threads' terms in f32 (warp shuffles, then the warps' sums in order) and
// writes one (tx, ty) partial to the scratch buffer the wrapper allocates;
// a second launch of one warp an image then sums that image's partials in
// an order fixed by the shape and writes d_offsets. So two calls on the
// same inputs give the same bits. A second launch rather than the last
// block of each image: finding the last block needs a per-image counter
// that is zero before every launch, so either a memset launch or counters
// kept by the library between launches, which two launches on two streams
// would share. The second launch replaces the memset of the atomics'
// d_offsets, so a call is still two launches, and it keeps no state.
//
// Build (nvcc 12.9, -Xptxas -v, sm_90a): 64 registers (bf16 and f32), no
// spills, 64 bytes of shared memory; the finishing kernel 50 registers.

#include <string.h>

#include "warp_common.cuh"

namespace {

// rows a vector thread walks: a band of 32 / V rows, so a thread covers 32
// elements whatever the type (4 rows in bf16, 8 in f32) and a plane gives
// as many threads in both (chip_smoke.py on an H100 80GB HBM3 at 700 W, at
// (8, 48, 96, 72): band 4 took 9.1 us in bf16 against band 8's 10.9; band
// 8 took 12.1 us in f32 against band 4's 13.5)
template <typename T>
__host__ __device__ constexpr int band_rows() {
  return 32 / (16 / sizeof(T));
}
constexpr int kMaxImages = 65535;  // the grid's y limit

// one strip of V columns over a band of rows; W % V == 0, SH = tx0 mod V
template <typename T, int SH>
__device__ void bwd_strip(const T* __restrict__ src, const T* __restrict__ g,
                          T* __restrict__ dst, int H, int W, int x,
                          int y_begin, int y_end, int tx0, int ty0, float fx,
                          float fy, float& acc_x, float& acc_y) {
  constexpr int V = 16 / sizeof(T);
  constexpr int SS = V - 1 - SH;   // (-tx0 - 1) mod V
  const int ag = x + tx0 - SH;     // g: columns x + tx0 + i
  const int as = x - tx0 - 1 - SS; // src: columns x - tx0 - 1 + i
  float g_top[V + 1], g_bot[V + 1], s_top[V + 1], s_bot[V + 1];
  load_row<T, SH>(g, y_begin + ty0, ag, H, W, g_top);
  load_row<T, SS>(src, y_begin - ty0 - 1, as, H, W, s_top);
  for (int y = y_begin; y < y_end; ++y) {
    load_row<T, SH>(g, y + ty0 + 1, ag, H, W, g_bot);
    load_row<T, SS>(src, y - ty0, as, H, W, s_bot);
    const uint4 gv =
        __ldg(reinterpret_cast<const uint4*>(g + (size_t)y * W + x));
    T o[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      // d_images(y, x + i): g at rows y + ty0 (+1), columns x + i + tx0 (+1)
      o[i] = from_f<T>(fy * (fx * g_bot[i + 1] + (1.f - fx) * g_bot[i]) +
                       (1.f - fy) * (fx * g_top[i + 1] + (1.f - fx) * g_top[i]));
      // the d_offsets terms of output (y, x + i)
      const float s00 = s_top[i], s01 = s_top[i + 1];
      const float s10 = s_bot[i], s11 = s_bot[i + 1];
      const float gp = elem<T>(gv, gv, i);
      acc_x = fmaf(gp, fy * (s00 - s01) + (1.f - fy) * (s10 - s11), acc_x);
      acc_y = fmaf(gp, (fx * s00 + (1.f - fx) * s01) -
                           (fx * s10 + (1.f - fx) * s11), acc_y);
    }
    uint4 w;
    memcpy(&w, o, 16);
    *reinterpret_cast<uint4*>(dst + (size_t)y * W + x) = w;
#pragma unroll
    for (int i = 0; i <= V; ++i) {
      g_top[i] = g_bot[i];
      s_top[i] = s_bot[i];
    }
  }
}

// plane(y, x) as f32, zero outside the image (the scalar path)
template <typename T>
__device__ __forceinline__ float at(const T* plane, int y, int x, int H,
                                    int W) {
  return (y >= 0 && y < H && x >= 0 && x < W) ? to_f(plane[y * W + x]) : 0.f;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(0xffffffffu, v, d);
  return v;
}

// grid (blocks over one image's work, N): blockIdx.y is the image. Four
// blocks an SM cap the registers at 64: left free, nvcc gives the bf16
// instance 74 and three blocks an SM, and 32 images took 39.4-39.9 us
// against 36.3-36.8 capped (chip_smoke.py device_ms, H100 80GB HBM3, 700 W)
template <typename T>
__global__ void __launch_bounds__(kThreads, 4)
    warp_translate_bwd_kernel(const T* __restrict__ img,
                              const float* __restrict__ offsets,
                              const T* __restrict__ gout,
                              T* __restrict__ dimg,
                              float* __restrict__ partials, int C, int H,
                              int W, float max_shift, int vec) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kBand = band_rows<T>();
  __shared__ float red[2][kThreads / 32];
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
  const T* g_n = gout + (size_t)n * C * hw;
  T* dst_n = dimg + (size_t)n * C * hw;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  float acc_x = 0.f, acc_y = 0.f;
  if (vec) {
    const int strips = W / V;
    const int bands = (H + kBand - 1) / kBand;
    if (t < (long long)C * bands * strips) {
      const int strip = (int)(t % strips);
      const int rest = (int)(t / strips);
      const int band = rest % bands;
      const size_t c = rest / bands;
      const int y0 = band * kBand;
      dispatch_shift<V>((tx0 % V + V) % V, [&](auto s) {
        bwd_strip<T, decltype(s)::value>(
            src_n + c * hw, g_n + c * hw, dst_n + c * hw, H, W, strip * V, y0,
            min(H, y0 + kBand), tx0, ty0, fx, fy, acc_x, acc_y);
      });
    }
  } else {
    for (long long e = t; e < (long long)C * hw;
         e += (long long)gridDim.x * blockDim.x) {
      const size_t c = e / hw;
      const int p = (int)(e - c * hw);
      const T* src = src_n + c * hw;
      const T* g = g_n + c * hw;
      const int y = p / W;
      const int x = p - y * W;
      const float g11 = at(g, y + ty0, x + tx0, H, W);
      const float g10 = at(g, y + ty0, x + tx0 + 1, H, W);
      const float g01 = at(g, y + ty0 + 1, x + tx0, H, W);
      const float g00 = at(g, y + ty0 + 1, x + tx0 + 1, H, W);
      dst_n[e] = from_f<T>(fy * (fx * g00 + (1.f - fx) * g01) +
                           (1.f - fy) * (fx * g10 + (1.f - fx) * g11));
      const int sy = y - ty0;
      const int sx = x - tx0;
      const float s11 = at(src, sy, sx, H, W);
      const float s10 = at(src, sy, sx - 1, H, W);
      const float s01 = at(src, sy - 1, sx, H, W);
      const float s00 = at(src, sy - 1, sx - 1, H, W);
      const float gp = to_f(g[p]);
      acc_x = fmaf(gp, fy * (s00 - s01) + (1.f - fy) * (s10 - s11), acc_x);
      acc_y = fmaf(gp, (fx * s00 + (1.f - fx) * s01) -
                           (fx * s10 + (1.f - fx) * s11), acc_y);
    }
  }
  // the block's partial: warp sums, then the warps' sums in order
  acc_x = warp_sum(acc_x);
  acc_y = warp_sum(acc_y);
  const int lane = threadIdx.x % 32;
  if (lane == 0) {
    red[0][threadIdx.x / 32] = acc_x;
    red[1][threadIdx.x / 32] = acc_y;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float sum_x = 0.f, sum_y = 0.f;
#pragma unroll
    for (int i = 0; i < kThreads / 32; ++i) {
      sum_x += red[0][i];
      sum_y += red[1][i];
    }
    float* part = partials + 2 * ((size_t)n * gridDim.x + blockIdx.x);
    part[0] = sum_x;
    part[1] = sum_y;
  }
}

// grid N blocks of one warp: image n's `blocks` partials summed in an order
// fixed by `blocks` (lane-strided, then the warp's shuffle tree), zero on an
// axis whose raw translation lies past +-max_shift
__global__ void __launch_bounds__(32)
    warp_translate_bwd_finish_kernel(const float* __restrict__ offsets,
                                     const float* __restrict__ partials,
                                     float* __restrict__ doffsets, int blocks,
                                     float max_shift) {
  const int n = blockIdx.x;
  const float* part = partials + 2 * (size_t)n * blocks;
  float sum_x = 0.f, sum_y = 0.f;
  for (int b = threadIdx.x; b < blocks; b += 32) {
    sum_x += part[2 * b];
    sum_y += part[2 * b + 1];
  }
  sum_x = warp_sum(sum_x);
  sum_y = warp_sum(sum_y);
  if (threadIdx.x == 0) {
    const float tx_raw = offsets[2 * n];
    const float ty_raw = offsets[2 * n + 1];
    doffsets[2 * n] =
        (tx_raw >= -max_shift && tx_raw <= max_shift) ? sum_x : 0.f;
    doffsets[2 * n + 1] =
        (ty_raw >= -max_shift && ty_raw <= max_shift) ? sum_y : 0.f;
  }
}

// blocks per image: one thread per V-column strip of a band, for either path
template <typename T>
long long blocks_per_image(int C, int H, int W) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kBand = band_rows<T>();
  const long long work = (long long)C * ((H + kBand - 1) / kBand) *
                         ((W + V - 1) / V);
  const long long blocks = (work + kThreads - 1) / kThreads;
  return blocks < 1 ? 1 : blocks;
}

template <typename T>
cudaError_t launch(const void* img, const float* offsets, const void* gout,
                   void* dimg, float* doffsets, float* partials, int N, int C,
                   int H, int W, float max_shift, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  if (N == 0) return cudaSuccess;
  if (N < 0 || N > kMaxImages || C < 0 || H < 0 || W < 0)
    return cudaErrorInvalidValue;
  const long long blocks = blocks_per_image<T>(C, H, W);
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  const bool vec = W % V == 0 && reinterpret_cast<uintptr_t>(img) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(gout) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dimg) % 16 == 0;
  warp_translate_bwd_kernel<T><<<dim3((unsigned)blocks, (unsigned)N),
                                 kThreads, 0, s>>>(
      static_cast<const T*>(img), offsets, static_cast<const T*>(gout),
      static_cast<T*>(dimg), partials, C, H, W, max_shift, vec ? 1 : 0);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  warp_translate_bwd_finish_kernel<<<N, 32, 0, s>>>(
      offsets, partials, doffsets, (int)blocks, max_shift);
  return cudaGetLastError();
}

}  // namespace

// Blocks a launch gives each image, for the scratch buffer of partials
// (2 floats a block and image); -1 for an unknown dtype or a bad shape.
extern "C" long long fami_warp_translate_bwd_blocks(int dtype, int C, int H,
                                                    int W) {
  if (C < 0 || H < 0 || W < 0) return -1;
  if (dtype == 0) return blocks_per_image<float>(C, H, W);
  if (dtype == 1) return blocks_per_image<__nv_bfloat16>(C, H, W);
  return -1;
}

// dtype: 0 = float32, 1 = bfloat16 (images, gout and d_images); offsets and
// d_offsets are (N, 2) float32 (tx, ty); d_offsets is written, not added
// into; partials is float32 scratch of 2 * N * fami_warp_translate_bwd_blocks
// values.
extern "C" int fami_warp_translate_bwd(const void* images, const void* offsets,
                                       const void* gout, void* d_images,
                                       void* d_offsets, void* partials,
                                       int dtype, int N, int C, int H, int W,
                                       float max_shift, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* off = static_cast<const float*>(offsets);
  float* doff = static_cast<float*>(d_offsets);
  float* part = static_cast<float*>(partials);
  if (dtype == 0)
    return (int)launch<float>(images, off, gout, d_images, doff, part, N, C, H,
                              W, max_shift, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(images, off, gout, d_images, doff, part,
                                      N, C, H, W, max_shift, s);
  return (int)cudaErrorInvalidValue;
}
