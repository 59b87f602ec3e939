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
// One thread per element as in warp.cu (the grid's y axis walks the (image,
// channel) planes). Each thread gathers its d_images value and forms its term
// of d_offsets; the block reduces the terms (warp shuffles, then shared
// memory) and adds one pair per block into the float32 d_offsets with
// atomicAdd, so its last bits vary from run to run.
//
// What bounds it on an H100: images and g are read once, d_images written
// once (~5.3 MB each at (8, 48, 96, 72) bf16), ~30 flops per element: the
// bytes set the least time (~4.8 us at 3.35 TB/s). At that size the launch
// and the tail of the reduction weigh as much as the traffic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

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

template <typename T>
__device__ __forceinline__ float at(const T* plane, int y, int x, int H,
                                    int W) {
  return (y >= 0 && y < H && x >= 0 && x < W) ? to_f(plane[y * W + x]) : 0.f;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    warp_translate_bwd_kernel(const T* __restrict__ img,
                              const float* __restrict__ offsets,
                              const T* __restrict__ gout,
                              T* __restrict__ dimg,
                              float* __restrict__ doffsets, int planes, int C,
                              int H, int W, float max_shift) {
  __shared__ float red[2][kThreads / 32];
  const int hw = H * W;
  for (int plane = blockIdx.y; plane < planes; plane += gridDim.y) {
    const int n = plane / C;
    const float tx_raw = offsets[2 * n];
    const float ty_raw = offsets[2 * n + 1];
    const float tx = fminf(fmaxf(tx_raw, -max_shift), max_shift);
    const float ty = fminf(fmaxf(ty_raw, -max_shift), max_shift);
    const float tx0 = floorf(tx);
    const float ty0 = floorf(ty);
    const float fx = tx - tx0;
    const float fy = ty - ty0;
    const int ix = (int)tx0;
    const int iy = (int)ty0;
    const T* src = img + (size_t)plane * hw;
    const T* g = gout + (size_t)plane * hw;
    T* dst = dimg + (size_t)plane * hw;
    float acc_x = 0.f, acc_y = 0.f;
    for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < hw;
         p += gridDim.x * blockDim.x) {
      const int y = p / W;
      const int xq = p - y * W;
      // d_images at (y, xq): the outputs that read this source element
      const float g11 = at(g, y + iy, xq + ix, H, W);
      const float g10 = at(g, y + iy, xq + ix + 1, H, W);
      const float g01 = at(g, y + iy + 1, xq + ix, H, W);
      const float g00 = at(g, y + iy + 1, xq + ix + 1, H, W);
      dst[p] = from_f<T>(fy * (fx * g00 + (1.f - fx) * g01) +
                         (1.f - fy) * (fx * g10 + (1.f - fx) * g11));
      // this output element's term of d_offsets
      const int sy = y - iy;
      const int sx = xq - ix;
      const float s11 = at(src, sy, sx, H, W);
      const float s10 = at(src, sy, sx - 1, H, W);
      const float s01 = at(src, sy - 1, sx, H, W);
      const float s00 = at(src, sy - 1, sx - 1, H, W);
      const float gp = to_f(g[p]);
      acc_x = fmaf(gp, fy * (s00 - s01) + (1.f - fy) * (s10 - s11), acc_x);
      acc_y = fmaf(gp, (fx * s00 + (1.f - fx) * s01) -
                           (fx * s10 + (1.f - fx) * s11), acc_y);
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      acc_x += __shfl_down_sync(0xffffffffu, acc_x, d);
      acc_y += __shfl_down_sync(0xffffffffu, acc_y, d);
    }
    const int warp = threadIdx.x / 32;
    if (threadIdx.x % 32 == 0) {
      red[0][warp] = acc_x;
      red[1][warp] = acc_y;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float sum_x = 0.f, sum_y = 0.f;
      for (int i = 0; i < kThreads / 32; ++i) {
        sum_x += red[0][i];
        sum_y += red[1][i];
      }
      if (tx_raw >= -max_shift && tx_raw <= max_shift)
        atomicAdd(doffsets + 2 * n, sum_x);
      if (ty_raw >= -max_shift && ty_raw <= max_shift)
        atomicAdd(doffsets + 2 * n + 1, sum_y);
    }
    __syncthreads();  // red is reused by the block's next plane
  }
}

template <typename T>
cudaError_t launch(const void* img, const float* offsets, const void* gout,
                   void* dimg, float* doffsets, int N, int C, int H, int W,
                   float max_shift, cudaStream_t s) {
  const int planes = N * C;
  const int hw = H * W;
  if (planes == 0 || hw == 0) return cudaSuccess;
  const int bx = (hw + kThreads - 1) / kThreads;
  const dim3 grid((unsigned)(bx < 1024 ? bx : 1024),
                  (unsigned)(planes < 65535 ? planes : 65535));
  warp_translate_bwd_kernel<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(img), offsets, static_cast<const T*>(gout),
      static_cast<T*>(dimg), doffsets, planes, C, H, W, max_shift);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (images, gout and d_images); offsets are
// (N, 2) float32 (tx, ty); d_offsets is (N, 2) float32 and must arrive
// zeroed: the kernel adds into it.
extern "C" int fami_warp_translate_bwd(const void* images, const void* offsets,
                                       const void* gout, void* d_images,
                                       void* d_offsets, int dtype, int N,
                                       int C, int H, int W, float max_shift,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* off = static_cast<const float*>(offsets);
  float* doff = static_cast<float*>(d_offsets);
  if (dtype == 0)
    return (int)launch<float>(images, off, gout, d_images, doff, N, C, H, W,
                              max_shift, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(images, off, gout, d_images, doff, N, C,
                                      H, W, max_shift, s);
  return (int)cudaErrorInvalidValue;
}
