// Modulated deformable convolution (DCNv2) forward, stride 1, for Hopper.
//
// Replaces the TPU kernel fami_pose_tpu/ops/pallas/dcn.py::deform_conv2d_pallas
// (live bodies _dcn_kernel_v3 and _dcn_kernel_v9). The function, per output
// pixel p, offset group g and tap k (3x3 on the main path, dilation 3, pad 3):
//   t      = offset[g][k] (dy, dx), clamped to [-D, D] per axis when D > 0
//            (D <= 0: the exact, unclamped DCN)
//   s      = bilinear sample of x at p - pad + k_pos * dil + t, zeros outside
//   col    = s * mask[g][k]            (the raw mask, no sigmoid)
//   out[o] = sum over (k, c) of W[o][c][k] * col[k][c]
// No bias inside: the wrapper adds it, as the TPU kernel's caller does.
//
// The TPU form (128-lane row staging, group-minor channel permutation, the
// hat-window sums over every integer shift in [-D, D]) exists because the TPU
// has no fast gather. Here each sample is a direct 4-corner gather.
//
// Design. A block walks over tiles of 64 consecutive output pixels of one
// image (grid-stride, so the weights are staged once per block):
//   1. W is copied into shared memory once per block, as f32 [k*C + c][Cout];
//   2. for each (group, tap, pixel) of the tile a thread reads the offset
//      pair and the mask (coalesced: neighbouring threads take neighbouring
//      pixels), clamps, computes the 4 corner weights times the mask and
//      writes the Cg sampled values into the column tile, f32 [k*C + c][64],
//      in shared memory;
//   3. the tile is contracted with W inside the kernel: each thread holds
//      4 pixels x (Cout / 16) output channels in registers and runs an FMA
//      loop over the K*C reduction (float4 loads of the column tile, the
//      weight row broadcast). No library GEMM.
// Accumulation is f32 for f32 and bf16 inputs; the output has the input type.
//
// What bounds it on an H100. At the main-path shape (B=8, 96x72, C=Cout=48,
// G=12, bf16) one call must move about 52 MB (offsets ~24 MB, mask ~12 MB,
// out ~11 MB in f32 / ~5 MB in bf16, x ~5 MB): ~16 us at 3.35 TB/s. It must
// do ~2.3 GFLOP of contraction plus ~0.5 GFLOP of sampling: ~3 us at the bf16
// tensor-core rate. So the least time is set by the bytes. This first kernel
// runs the contraction on the CUDA cores from shared memory, so its time is
// set by that FMA loop instead; a wgmma/TMA redesign is the later step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTilePix = 64;                          // output pixels per tile
constexpr int kThreads = 256;
constexpr int kPixPerThread = 4;                      // contraction: 4 pixels
constexpr int kPixGroups = kTilePix / kPixPerThread;  // 16
constexpr int kOcGroups = kThreads / kPixGroups;      // 16

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

// NOC = Cout / 16 output channels per thread (Cout in {16, 32, 48, 64})
template <typename T, int NOC>
__global__ void __launch_bounds__(kThreads)
    dcn_fwd_kernel(const T* __restrict__ x, const T* __restrict__ offset,
                   const T* __restrict__ mask, const T* __restrict__ weight,
                   T* __restrict__ out, int B, int C, int H, int W, int Ho,
                   int Wo, int kh, int kw, int pad, int dil, int G,
                   float dmax) {
  constexpr int Cout = NOC * kOcGroups;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int K = kh * kw;
  const int R = K * C;  // reduction length
  float* w_s = smem;                             // [R][Cout]
  float* col = smem + R * Cout;                  // [R][kTilePix]

  for (int i = threadIdx.x; i < R * Cout; i += kThreads) {
    const int o = i % Cout;
    const int r = i / Cout;
    const int k = r / C;
    const int c = r % C;
    w_s[i] = to_f(weight[((size_t)o * C + c) * K + k]);
  }

  const int HWo = Ho * Wo;
  const size_t plane_in = (size_t)H * W;
  const int tiles_per_img = (HWo + kTilePix - 1) / kTilePix;
  const int n_tiles = B * tiles_per_img;
  const int Cg = C / G;
  const bool clamp = dmax > 0.f;
  const int pg = threadIdx.x % kPixGroups;
  const int og = threadIdx.x / kPixGroups;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int b = tile / tiles_per_img;
    const int p0 = (tile % tiles_per_img) * kTilePix;
    // the weights are staged (first pass) / the last contraction is done
    __syncthreads();

    const T* off_b = offset + (size_t)b * 2 * G * K * HWo;
    const T* msk_b = mask ? mask + (size_t)b * G * K * HWo : nullptr;
    for (int it = threadIdx.x; it < G * K * kTilePix; it += kThreads) {
      const int p = it % kTilePix;
      const int gk = it / kTilePix;  // g * K + k, the canonical channel order
      const int g = gk / K;
      const int k = gk % K;
      const int pix = p0 + p;
      float* col_r = col + (size_t)(k * C + g * Cg) * kTilePix + p;
      if (pix >= HWo) {
        for (int ci = 0; ci < Cg; ++ci) col_r[ci * kTilePix] = 0.f;
        continue;
      }
      float ty = to_f(off_b[(size_t)(2 * gk) * HWo + pix]);
      float tx = to_f(off_b[(size_t)(2 * gk + 1) * HWo + pix]);
      const float m = msk_b ? to_f(msk_b[(size_t)gk * HWo + pix]) : 1.f;
      if (clamp) {
        ty = fminf(fmaxf(ty, -dmax), dmax);
        tx = fminf(fmaxf(tx, -dmax), dmax);
      }
      const float fy = floorf(ty);
      const float fx = floorf(tx);
      const float ly = ty - fy;
      const float lx = tx - fx;
      const int y0 = pix / Wo - pad + (k / kw) * dil + (int)fy;
      const int x0 = pix % Wo - pad + (k % kw) * dil + (int)fx;
      const bool vy0 = y0 >= 0 && y0 < H;
      const bool vy1 = y0 + 1 >= 0 && y0 + 1 < H;
      const bool vx0 = x0 >= 0 && x0 < W;
      const bool vx1 = x0 + 1 >= 0 && x0 + 1 < W;
      const float w00 = (1.f - ly) * (1.f - lx) * m;
      const float w01 = (1.f - ly) * lx * m;
      const float w10 = ly * (1.f - lx) * m;
      const float w11 = ly * lx * m;
      const T* xg = x + ((size_t)b * C + g * Cg) * plane_in;
      const int i00 = y0 * W + x0;
      for (int ci = 0; ci < Cg; ++ci) {
        const T* xc = xg + (size_t)ci * plane_in;
        float v = 0.f;
        if (vy0 && vx0) v += w00 * to_f(xc[i00]);
        if (vy0 && vx1) v += w01 * to_f(xc[i00 + 1]);
        if (vy1 && vx0) v += w10 * to_f(xc[i00 + W]);
        if (vy1 && vx1) v += w11 * to_f(xc[i00 + W + 1]);
        col_r[ci * kTilePix] = v;
      }
    }
    __syncthreads();

    float acc[NOC][kPixPerThread];
#pragma unroll
    for (int j = 0; j < NOC; ++j)
#pragma unroll
      for (int q = 0; q < kPixPerThread; ++q) acc[j][q] = 0.f;
    const float* colp = col + pg * kPixPerThread;
    for (int r = 0; r < R; ++r) {
      const float4 a =
          *reinterpret_cast<const float4*>(colp + (size_t)r * kTilePix);
      const float* wr = w_s + r * Cout + og;
#pragma unroll
      for (int j = 0; j < NOC; ++j) {
        const float wv = wr[j * kOcGroups];
        acc[j][0] = fmaf(a.x, wv, acc[j][0]);
        acc[j][1] = fmaf(a.y, wv, acc[j][1]);
        acc[j][2] = fmaf(a.z, wv, acc[j][2]);
        acc[j][3] = fmaf(a.w, wv, acc[j][3]);
      }
    }
    T* out_b = out + (size_t)b * Cout * HWo;
#pragma unroll
    for (int j = 0; j < NOC; ++j) {
      const int o = og + j * kOcGroups;
#pragma unroll
      for (int q = 0; q < kPixPerThread; ++q) {
        const int pix = p0 + pg * kPixPerThread + q;
        if (pix < HWo) out_b[(size_t)o * HWo + pix] = from_f<T>(acc[j][q]);
      }
    }
  }
}

template <typename T, int NOC>
cudaError_t launch(const void* x, const void* offset, const void* mask,
                   const void* weight, void* out, int B, int C, int H, int W,
                   int Ho, int Wo, int kh, int kw, int pad, int dil, int G,
                   float dmax, cudaStream_t stream) {
  auto kernel = dcn_fwd_kernel<T, NOC>;
  const int R = kh * kw * C;
  const size_t smem = (size_t)R * (NOC * kOcGroups + kTilePix) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  const int n_tiles = B * ((Ho * Wo + kTilePix - 1) / kTilePix);
  int grid = sms * (per_sm > 0 ? per_sm : 1);
  if (grid > n_tiles) grid = n_tiles;
  if (grid < 1) return cudaSuccess;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(offset),
      static_cast<const T*>(mask), static_cast<const T*>(weight),
      static_cast<T*>(out), B, C, H, W, Ho, Wo, kh, kw, pad, dil, G, dmax);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int Cout, const void* x, const void* offset,
                     const void* mask, const void* weight, void* out, int B,
                     int C, int H, int W, int Ho, int Wo, int kh, int kw,
                     int pad, int dil, int G, float dmax, cudaStream_t s) {
  switch (Cout) {
    case 16:
      return launch<T, 1>(x, offset, mask, weight, out, B, C, H, W, Ho, Wo,
                          kh, kw, pad, dil, G, dmax, s);
    case 32:
      return launch<T, 2>(x, offset, mask, weight, out, B, C, H, W, Ho, Wo,
                          kh, kw, pad, dil, G, dmax, s);
    case 48:
      return launch<T, 3>(x, offset, mask, weight, out, B, C, H, W, Ho, Wo,
                          kh, kw, pad, dil, G, dmax, s);
    case 64:
      return launch<T, 4>(x, offset, mask, weight, out, B, C, H, W, Ho, Wo,
                          kh, kw, pad, dil, G, dmax, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, offset, mask, weight and out share
// it). mask may be null (DCNv1: mask 1). max_offset <= 0: exact, no clamp.
extern "C" int fami_dcn_fwd(const void* x, const void* offset,
                            const void* mask, const void* weight, void* out,
                            int dtype, int B, int C, int H, int W, int Cout,
                            int Ho, int Wo, int kh, int kw, int pad, int dil,
                            int groups, float max_offset, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch<float>(Cout, x, offset, mask, weight, out, B, C, H,
                                W, Ho, Wo, kh, kw, pad, dil, groups,
                                max_offset, s);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(Cout, x, offset, mask, weight, out, B,
                                        C, H, W, Ho, Wo, kh, kw, pad, dil,
                                        groups, max_offset, s);
  return (int)cudaErrorInvalidValue;
}
