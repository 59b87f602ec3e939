// Per-image sub-pixel translation warp, dst(p) = src(p - t), for Hopper.
//
// Replaces the TPU kernel fami_pose_tpu/ops/pallas/warp.py::warp_translate_pallas
// (_warp_kernel), the same function as fami_pose_tpu/ops/warp.py::warp_translate:
// t = (tx, ty) is clamped to +-max_shift per image, split into floor and
// fraction, and each output value is the 4-corner bilinear blend of the
// source around p - t, zero outside the image.
//
// The TPU kernel pads the image in VMEM and shifts it with lane rolls and
// sublane slices because the TPU has no cheap gather. Here each thread
// computes one output element (NCHW, so neighbouring threads read
// neighbouring source columns) and reads its 4 corners directly. The grid's
// y axis walks the (image, channel) planes, so the clamp, floor and fraction
// are computed once per plane from the image's 2 floats, and the index
// arithmetic inside a plane stays 32-bit.
//
// What bounds it on an H100: it reads each input once and writes each output
// once (~21 MB each way at (32, 48, 96, 72) bf16) and does ~10 flops per
// element, so the bytes set the least time (~13 us at 3.35 TB/s).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

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
__global__ void warp_translate_kernel(const T* __restrict__ img,
                                      const float* __restrict__ offsets,
                                      T* __restrict__ out, int planes, int C,
                                      int H, int W, float max_shift) {
  const int hw = H * W;
  for (int plane = blockIdx.y; plane < planes; plane += gridDim.y) {
    const int n = plane / C;
    const float tx = fminf(fmaxf(offsets[2 * n], -max_shift), max_shift);
    const float ty = fminf(fmaxf(offsets[2 * n + 1], -max_shift), max_shift);
    const float tx0 = floorf(tx);
    const float ty0 = floorf(ty);
    const float fx = tx - tx0;
    const float fy = ty - ty0;
    const T* src = img + (size_t)plane * hw;
    T* dst = out + (size_t)plane * hw;
    for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < hw;
         p += gridDim.x * blockDim.x) {
      const int y = p / W;
      const int sx = p - y * W - (int)tx0;
      const int sy = y - (int)ty0;
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
      dst[p] = from_f<T>(top * fy + bot * (1.f - fy));
    }
  }
}

template <typename T>
cudaError_t launch(const void* img, const float* offsets, void* out, int N,
                   int C, int H, int W, float max_shift, cudaStream_t s) {
  const int planes = N * C;
  const int hw = H * W;
  if (planes == 0 || hw == 0) return cudaSuccess;
  const int threads = 256;
  const dim3 grid((unsigned)((hw + threads - 1) / threads < 1024
                                 ? (hw + threads - 1) / threads
                                 : 1024),
                  (unsigned)(planes < 65535 ? planes : 65535));
  warp_translate_kernel<T><<<grid, threads, 0, s>>>(
      static_cast<const T*>(img), offsets, static_cast<T*>(out), planes, C, H,
      W, max_shift);
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
