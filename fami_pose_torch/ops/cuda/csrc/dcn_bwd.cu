// Modulated deformable convolution (DCNv2) backward, stride 1, for Hopper.
//
// Replaces the TPU kernel
// fami_pose_tpu/ops/pallas/dcn_bwd.py::deform_conv2d_windowed_bwd_pallas
// (_bwd_fwdside_kernel for dW / dmask / doffset and _bwd_dx_kernel for dx,
// and their _v9 forms). With the forward of dcn_fwd.cu,
//   t        = offset[g][k] (dy, dx), clamped to [-D, D] per axis when D > 0
//   S[k][c]  = bilinear sample of x[c] at p - pad + k_pos * dil + t
//   out[o]   = sum over (k, c) of W[o][c][k] * m[g][k] * S[k][c],
// and gout the gradient of out, it computes, per output pixel p and tap k,
//   dcol[k][c]   = sum_o W[o][c][k] * gout[o]          (inside the kernel)
//   dW[o][c][k] += gout[o] * m * S[k][c]               (summed over all p)
//   dmask[g][k]  = sum_{c in g} S[k][c] * dcol[k][c]
//   doffset      = m * sum_{c in g} dcol[k][c] * (slope of the bilinear blend
//                  along that axis), zero where the clamped offset is an
//                  integer on that axis (the TPU kernel's hat derivative
//                  -sign(u) * (|u| < 1) vanishes at u = 0 and |u| = 1) and
//                  zero where the raw offset lies outside [-D, D]
//   dx[c][corner] += m * w_corner * dcol[k][c]         (the sampling adjoint)
// No bias: its gradient is a plain sum of gout outside the kernel, as on the
// TPU.
//
// The TPU form (128-lane rows, group-minor channels, a loop over the (2D+1)^2
// integer shifts of the hat window, rolls for the dx adjoint, two kernels) is
// not carried over. Here the offset is clamped and the 4 corners are touched
// directly, so the work does not grow with D, and one kernel does everything:
// the dx adjoint is a scatter with atomicAdd into a float32 buffer, the only
// form that also serves the exact (unclamped) mode, where the adjoint has no
// bounded gather window.
//
// Design. A block walks over tiles of 64 consecutive output pixels of one
// image (grid-stride, one block per SM). W is staged once per block in shared
// memory as f32 [k][o][c], beside the block's dW partial, f32 [k][c][o]. For
// each tile the gout tile [o][64] is staged, then for each tap k:
//   A. dcol_k[c][64] = W_k^T . gout, an FMA loop from shared memory (each
//      thread 4 pixels x up to 4 channels);
//   B. one thread per (group, pixel) reads the offset pair and the mask,
//      clamps, gathers the 4 corners of its Cg channels, writes m * S into
//      col_k[c][64], accumulates dmask and doffset and writes them, and adds
//      m * w_corner * dcol into dx with atomicAdd (corners of weight 0, as at
//      an integer offset, are skipped);
//   C. dW_k[c][o] += col_k . gout^T over the 64 pixels, each thread its own
//      entries of the shared partial.
// At the end the block adds its partial into the global f32 dW, one atomicAdd
// per entry. Tile rows are padded to 68 floats so that the float4 reads of
// phase C, whose threads walk over channels, fall into distinct banks.
// Accumulation is f32 for f32 and bf16 inputs; doffset and dmask have the
// input type, dx and dW are f32 buffers the wrapper zeroes and casts.
//
// What bounds it on an H100. At the main-path shape (B=8, 96x72, C=Cout=48,
// G=12, bf16) it must move ~100 MB (offsets and doffset ~24 MB each, mask and
// dmask ~12 MB each, x and gout ~5 MB each, dx f32 ~11 MB): ~30 us at
// 3.35 TB/s, and do ~4.6 GFLOP of contraction: ~5 us at the bf16 tensor-core
// rate. So the least time is set by the bytes. This first kernel runs both
// contractions on the CUDA cores and the adjoint through ~10^8 atomics, which
// set its time instead; wgmma and a gather-form adjoint are the later step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTilePix = 64;   // output pixels per tile
constexpr int kStride = 68;    // floats per tile row (padded, 16 B aligned)
constexpr int kThreads = 256;
constexpr int kQuads = kTilePix / 4;       // 16 groups of 4 pixels
constexpr int kLanes = kThreads / kQuads;  // 16 channel lanes
constexpr int kMaxCi = 4;                  // C <= 64

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

// NOC = Cout / 16 (Cout in {16, 32, 48, 64}); C <= 64
template <typename T, int NOC>
__global__ void __launch_bounds__(kThreads)
    dcn_bwd_kernel(const T* __restrict__ x, const T* __restrict__ offset,
                   const T* __restrict__ mask, const T* __restrict__ weight,
                   const T* __restrict__ gout, float* __restrict__ dx,
                   T* __restrict__ doffset, T* __restrict__ dmask,
                   float* __restrict__ dweight, int B, int C, int H, int W,
                   int Ho, int Wo, int kh, int kw, int pad, int dil, int G,
                   float dmax) {
  constexpr int Cout = NOC * kLanes;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int K = kh * kw;
  const int n_w = K * Cout * C;
  float* w_s = smem;                      // [k][o][c]
  float* dw_s = w_s + n_w;                // [k][c][o]
  float* g_s = dw_s + n_w;                // [o][kStride]
  float* dcol_s = g_s + Cout * kStride;   // [c][kStride]
  float* col_s = dcol_s + C * kStride;    // [c][kStride]

  for (int i = threadIdx.x; i < n_w; i += kThreads) {
    const int c = i % C;
    const int o = (i / C) % Cout;
    const int k = i / (C * Cout);
    w_s[i] = to_f(weight[((size_t)o * C + c) * K + k]);
    dw_s[i] = 0.f;
  }

  const int HWo = Ho * Wo;
  const size_t plane_in = (size_t)H * W;
  const int tiles_per_img = (HWo + kTilePix - 1) / kTilePix;
  const int n_tiles = B * tiles_per_img;
  const int Cg = C / G;
  const bool clamp = dmax > 0.f;
  const int quad = threadIdx.x % kQuads;  // phase A: 4 pixels
  const int lane = threadIdx.x / kQuads;  // phase A: channel lane
  const int ct = threadIdx.x % kLanes;    // phase C: input-channel lane
  const int og = threadIdx.x / kLanes;    // phase C: output-channel lane

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int b = tile / tiles_per_img;
    const int p0 = (tile % tiles_per_img) * kTilePix;
    // the weights are staged (first pass) / the last phase C is done
    __syncthreads();
    const T* gout_b = gout + (size_t)b * Cout * HWo;
    for (int i = threadIdx.x; i < Cout * kTilePix; i += kThreads) {
      const int o = i / kTilePix;
      const int p = i % kTilePix;
      const int pix = p0 + p;
      g_s[o * kStride + p] =
          pix < HWo ? to_f(gout_b[(size_t)o * HWo + pix]) : 0.f;
    }
    __syncthreads();

    const T* off_b = offset + (size_t)b * 2 * G * K * HWo;
    T* doff_b = doffset + (size_t)b * 2 * G * K * HWo;
    const T* msk_b = mask ? mask + (size_t)b * G * K * HWo : nullptr;
    T* dmsk_b = dmask ? dmask + (size_t)b * G * K * HWo : nullptr;

    for (int k = 0; k < K; ++k) {
      // A. dcol_k = W_k^T . gout
      {
        float acc[kMaxCi][4];
#pragma unroll
        for (int i = 0; i < kMaxCi; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;
        const float* wk = w_s + (size_t)k * Cout * C;
        for (int o = 0; o < Cout; ++o) {
          const float4 gv =
              *reinterpret_cast<const float4*>(g_s + o * kStride + quad * 4);
#pragma unroll
          for (int i = 0; i < kMaxCi; ++i) {
            const int c = lane + i * kLanes;
            if (c < C) {
              const float wv = wk[o * C + c];
              acc[i][0] = fmaf(gv.x, wv, acc[i][0]);
              acc[i][1] = fmaf(gv.y, wv, acc[i][1]);
              acc[i][2] = fmaf(gv.z, wv, acc[i][2]);
              acc[i][3] = fmaf(gv.w, wv, acc[i][3]);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < kMaxCi; ++i) {
          const int c = lane + i * kLanes;
          if (c < C)
            *reinterpret_cast<float4*>(dcol_s + c * kStride + quad * 4) =
                make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        }
      }
      __syncthreads();

      // B. sampling side: col_k, dmask, doffset, dx
      for (int it = threadIdx.x; it < G * kTilePix; it += kThreads) {
        const int p = it % kTilePix;
        const int g = it / kTilePix;
        const int pix = p0 + p;
        float* col_r = col_s + (size_t)(g * Cg) * kStride + p;
        if (pix >= HWo) {
          for (int ci = 0; ci < Cg; ++ci) col_r[ci * kStride] = 0.f;
          continue;
        }
        const int gk = g * K + k;  // the canonical channel order
        const float ty_raw = to_f(off_b[(size_t)(2 * gk) * HWo + pix]);
        const float tx_raw = to_f(off_b[(size_t)(2 * gk + 1) * HWo + pix]);
        const float m = msk_b ? to_f(msk_b[(size_t)gk * HWo + pix]) : 1.f;
        float ty = ty_raw, tx = tx_raw;
        bool pass_y = true, pass_x = true;
        if (clamp) {
          ty = fminf(fmaxf(ty, -dmax), dmax);
          tx = fminf(fmaxf(tx, -dmax), dmax);
          pass_y = ty_raw >= -dmax && ty_raw <= dmax;
          pass_x = tx_raw >= -dmax && tx_raw <= dmax;
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
        const float w00 = (1.f - ly) * (1.f - lx);
        const float w01 = (1.f - ly) * lx;
        const float w10 = ly * (1.f - lx);
        const float w11 = ly * lx;
        const bool a00 = vy0 && vx0, a01 = vy0 && vx1;
        const bool a10 = vy1 && vx0, a11 = vy1 && vx1;
        const size_t base = ((size_t)b * C + g * Cg) * plane_in;
        const T* xg = x + base;
        float* dxg = dx + base;
        const int i00 = y0 * W + x0;
        const float* dcol_r = dcol_s + (size_t)(g * Cg) * kStride + p;
        float dm = 0.f, gy = 0.f, gx = 0.f;
        for (int ci = 0; ci < Cg; ++ci) {
          const T* xc = xg + (size_t)ci * plane_in;
          float* dxc = dxg + (size_t)ci * plane_in;
          const float d = dcol_r[ci * kStride];
          const float v00 = a00 ? to_f(xc[i00]) : 0.f;
          const float v01 = a01 ? to_f(xc[i00 + 1]) : 0.f;
          const float v10 = a10 ? to_f(xc[i00 + W]) : 0.f;
          const float v11 = a11 ? to_f(xc[i00 + W + 1]) : 0.f;
          const float s = w00 * v00 + w01 * v01 + w10 * v10 + w11 * v11;
          col_r[ci * kStride] = m * s;
          dm = fmaf(s, d, dm);
          gy = fmaf(d, (v10 - v00) * (1.f - lx) + (v11 - v01) * lx, gy);
          gx = fmaf(d, (v01 - v00) * (1.f - ly) + (v11 - v10) * ly, gx);
          const float md = m * d;
          if (a00 && w00 != 0.f) atomicAdd(dxc + i00, w00 * md);
          if (a01 && w01 != 0.f) atomicAdd(dxc + i00 + 1, w01 * md);
          if (a10 && w10 != 0.f) atomicAdd(dxc + i00 + W, w10 * md);
          if (a11 && w11 != 0.f) atomicAdd(dxc + i00 + W + 1, w11 * md);
        }
        doff_b[(size_t)(2 * gk) * HWo + pix] =
            from_f<T>(pass_y && ly != 0.f ? m * gy : 0.f);
        doff_b[(size_t)(2 * gk + 1) * HWo + pix] =
            from_f<T>(pass_x && lx != 0.f ? m * gx : 0.f);
        if (dmsk_b) dmsk_b[(size_t)gk * HWo + pix] = from_f<T>(dm);
      }
      __syncthreads();

      // C. dW_k[c][o] += col_k . gout^T over the tile's pixels
      {
        float acc[kMaxCi][NOC];
#pragma unroll
        for (int i = 0; i < kMaxCi; ++i)
#pragma unroll
          for (int j = 0; j < NOC; ++j) acc[i][j] = 0.f;
        for (int q = 0; q < kQuads; ++q) {
          float4 gv[NOC];
#pragma unroll
          for (int j = 0; j < NOC; ++j)
            gv[j] = *reinterpret_cast<const float4*>(
                g_s + (og + j * kLanes) * kStride + q * 4);
#pragma unroll
          for (int i = 0; i < kMaxCi; ++i) {
            const int c = ct + i * kLanes;
            if (c < C) {
              const float4 cv = *reinterpret_cast<const float4*>(
                  col_s + c * kStride + q * 4);
#pragma unroll
              for (int j = 0; j < NOC; ++j) {
                acc[i][j] = fmaf(cv.x, gv[j].x, acc[i][j]);
                acc[i][j] = fmaf(cv.y, gv[j].y, acc[i][j]);
                acc[i][j] = fmaf(cv.z, gv[j].z, acc[i][j]);
                acc[i][j] = fmaf(cv.w, gv[j].w, acc[i][j]);
              }
            }
          }
        }
        float* dwk = dw_s + (size_t)k * C * Cout;
#pragma unroll
        for (int i = 0; i < kMaxCi; ++i) {
          const int c = ct + i * kLanes;
          if (c < C) {
#pragma unroll
            for (int j = 0; j < NOC; ++j)
              dwk[c * Cout + og + j * kLanes] += acc[i][j];
          }
        }
      }
    }
  }

  __syncthreads();
  for (int i = threadIdx.x; i < n_w; i += kThreads) {
    const int o = i % Cout;
    const int c = (i / Cout) % C;
    const int k = i / (Cout * C);
    atomicAdd(dweight + ((size_t)o * C + c) * K + k, dw_s[i]);
  }
}

template <typename T, int NOC>
cudaError_t launch(const void* x, const void* offset, const void* mask,
                   const void* weight, const void* gout, float* dx,
                   void* doffset, void* dmask, float* dweight, int B, int C,
                   int H, int W, int Ho, int Wo, int kh, int kw, int pad,
                   int dil, int G, float dmax, cudaStream_t stream) {
  auto kernel = dcn_bwd_kernel<T, NOC>;
  constexpr int Cout = NOC * kLanes;
  const size_t smem =
      ((size_t)2 * kh * kw * C * Cout + (size_t)(Cout + 2 * C) * kStride) *
      sizeof(float);
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
      static_cast<const T*>(gout), dx, static_cast<T*>(doffset),
      static_cast<T*>(dmask), dweight, B, C, H, W, Ho, Wo, kh, kw, pad, dil,
      G, dmax);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int Cout, const void* x, const void* offset,
                     const void* mask, const void* weight, const void* gout,
                     float* dx, void* doffset, void* dmask, float* dweight,
                     int B, int C, int H, int W, int Ho, int Wo, int kh,
                     int kw, int pad, int dil, int G, float dmax,
                     cudaStream_t s) {
  if (C > kMaxCi * kLanes || G < 1 || C % G != 0) return cudaErrorInvalidValue;
  switch (Cout) {
    case 16:
      return launch<T, 1>(x, offset, mask, weight, gout, dx, doffset, dmask,
                          dweight, B, C, H, W, Ho, Wo, kh, kw, pad, dil, G,
                          dmax, s);
    case 32:
      return launch<T, 2>(x, offset, mask, weight, gout, dx, doffset, dmask,
                          dweight, B, C, H, W, Ho, Wo, kh, kw, pad, dil, G,
                          dmax, s);
    case 48:
      return launch<T, 3>(x, offset, mask, weight, gout, dx, doffset, dmask,
                          dweight, B, C, H, W, Ho, Wo, kh, kw, pad, dil, G,
                          dmax, s);
    case 64:
      return launch<T, 4>(x, offset, mask, weight, gout, dx, doffset, dmask,
                          dweight, B, C, H, W, Ho, Wo, kh, kw, pad, dil, G,
                          dmax, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, offset, mask, weight, gout, doffset
// and dmask share it). dx (B, C, H, W) and dweight (Cout, C, kh, kw) are
// float32 and must arrive zeroed: the kernel adds into them. mask and dmask
// may be null together (DCNv1). max_offset <= 0: exact, no clamp.
extern "C" int fami_dcn_bwd(const void* x, const void* offset,
                            const void* mask, const void* weight,
                            const void* gout, void* dx, void* doffset,
                            void* dmask, void* dweight, int dtype, int B,
                            int C, int H, int W, int Cout, int Ho, int Wo,
                            int kh, int kw, int pad, int dil, int groups,
                            float max_offset, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dxf = static_cast<float*>(dx);
  float* dwf = static_cast<float*>(dweight);
  if (dtype == 0)
    return (int)dispatch<float>(Cout, x, offset, mask, weight, gout, dxf,
                                doffset, dmask, dwf, B, C, H, W, Ho, Wo, kh,
                                kw, pad, dil, groups, max_offset, s);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(Cout, x, offset, mask, weight, gout,
                                        dxf, doffset, dmask, dwf, B, C, H, W,
                                        Ho, Wo, kh, kw, pad, dil, groups,
                                        max_offset, s);
  return (int)cudaErrorInvalidValue;
}
