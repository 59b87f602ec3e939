// Device helpers shared by the translation warp and its backward (warp.cu,
// warp_bwd.cu): conversions between an element and f32, the V + 1 shifted
// values of a row read as two aligned 16-byte vectors, and the dispatch of
// a run-time sub-vector shift to the instance compiled for it. Everything
// is inline in an anonymous namespace, so each source compiles its own
// copy.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// r[i] = row y of `plane` at column a + SH + i (0 <= i <= V), as f32, zero
// outside the image: the two aligned vectors at a and a + V. a is a
// multiple of V and W % V == 0, so a vector lies wholly in or out of a row.
template <typename T, int SH>
__device__ __forceinline__ void load_row(const T* __restrict__ plane, int y,
                                         int a, int H, int W,
                                         float (&r)[16 / sizeof(T) + 1]) {
  constexpr int V = 16 / sizeof(T);
  uint4 lo = make_uint4(0u, 0u, 0u, 0u), hi = lo;
  if ((unsigned)y < (unsigned)H) {
    const T* row = plane + (size_t)y * W;
    if ((unsigned)a < (unsigned)W)
      lo = __ldg(reinterpret_cast<const uint4*>(row + a));
    if ((unsigned)(a + V) < (unsigned)W)
      hi = __ldg(reinterpret_cast<const uint4*>(row + a + V));
  }
#pragma unroll
  for (int i = 0; i <= V; ++i) r[i] = elem<T>(lo, hi, SH + i);
}

// f(std::integral_constant<int, sh>{}) for a run-time 0 <= sh < V: each
// shift gets an instance whose register moves are fixed at compile time
template <int V, typename F>
__device__ __forceinline__ void dispatch_shift(int sh, F&& f) {
  using std::integral_constant;
  switch (sh) {
    case 0: f(integral_constant<int, 0>{}); break;
    case 1: f(integral_constant<int, 1>{}); break;
    case 2: f(integral_constant<int, 2>{}); break;
    case 3: f(integral_constant<int, 3>{}); break;
    default:
      if constexpr (V == 8) {
        switch (sh) {
          case 4: f(integral_constant<int, 4>{}); break;
          case 5: f(integral_constant<int, 5>{}); break;
          case 6: f(integral_constant<int, 6>{}); break;
          default: f(integral_constant<int, 7>{}); break;
        }
      }
  }
}

}  // namespace
