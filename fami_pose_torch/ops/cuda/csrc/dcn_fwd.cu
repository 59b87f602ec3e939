// Modulated deformable convolution (DCNv2) forward, stride 1, for Hopper.
//
// Replaces the TPU kernel fami_pose_tpu/ops/pallas/dcn.py::deform_conv2d_pallas
// (live bodies _dcn_kernel_v3 and _dcn_kernel_v9, pallas_call at :1005 and
// :1063) and _deform_conv2d_pallas_v6 (:440). The function, per output pixel
// p, offset group g and tap k (3x3 on the main path, dilation 3, pad 3):
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
// What bounds it on an H100. At the main-path shape (B=8, 96x72,
// C=Cout=48, G=12, bf16) one call must move ~46 MB (offsets ~24 MB, mask
// ~12 MB, x and out ~5 MB each): ~14 us at 3.35 TB/s, and do ~2.3 GFLOP of
// contraction: ~2.4 us at the bf16 tensor-core rate. So the bytes set the
// least time. What sets this kernel's time is neither: it is the issue of
// the sample loop's instructions (~140 a sample of 4 channels), 16 warps an
// SM; the gathers' L1 traffic adds ~15% with i.i.d. random offsets
// (PERF.md).
//
// Design (two launches on the caller's stream, counted as one DCN call):
//   0. grouped_channels_last_kernel copies x (B, C, H, W) to a scratch
//      buffer in (B, G, H, W, Cg) order, so that the Cg channels of one
//      group at one corner are one vector load (8 bytes for Cg = 4 in
//      bf16) and the two x-neighbouring corners of a sample share a 32-byte
//      sector; the samples of one tile and group fall in a ~12 KB window
//      that L1 keeps while the block walks the group's taps.
//   1. dcn_fwd_bf16_kernel: persistent blocks of 256 threads, two a SM at
//      the main-path shape (~109 KB of shared memory each), walk tiles of
//      64 output pixels of one image. W is staged once per block in bf16 as
//      the wgmma B operand, [k*C + c] x Cout, K-major in the no-swizzle
//      core-matrix layout (8 rows x 16 bytes per core matrix), beside a
//      table of the gather's units (group, tap, 4-channel chunk) so that
//      the sample loop does no integer division. All 256 threads sample a
//      tile into the A operand, 64 pixels x (k*C + c) in bf16, the same
//      layout, zero-padded in k to a multiple of 16: 4 units in flight a
//      thread, each reading its offsets and mask from device memory, its 4
//      corners as 8-byte loads, and writing the 4 channels of its column
//      as one 8-byte store. Each warpgroup then runs ceil(9C / 16)
//      wgmma.m64n(Cout/2)k16 steps for its half of the output channels
//      (bf16 x bf16 -> f32 in registers), stages the f32 result in shared
//      memory [o][64], and all threads write NCHW rows of 64 pixels with
//      16-byte stores, rounding once to bf16. The other block on the SM
//      samples while one contracts.
//      A 2-stage cp.async ring for the tile's offsets and mask (83 KB) was
//      measured and dropped: it allows one block a SM, and the kernel was
//      14% (B=8) and 19% (B=32) slower with it.
//   2. dcn_fwd_f32_kernel (float32 inputs: the card-vs-CPU checks): the same
//      gathers, the column kept in f32 [k*C + c][64] and contracted on the
//      CUDA cores with full-f32 FMAs (each thread 4 pixels x Cout/16
//      channels); TF32 would miss the 1e-4 tolerance of those checks.
// Numerics (bf16): the column s * mask is rounded to bf16 once, the products
// are exact in the tensor cores and summed in f32, the output rounded once.
// The column's rounding moves the f32 sum by ~0.3 of the ulp of the largest
// output (tests/test_torch_dcn_numerics.py), so one bf16 column (no hi/lo
// pair) keeps the kernel within one output ulp of the plain version.
//
// Build (nvcc 12.9, -Xptxas -v, sm_90a): dcn_fwd_bf16_kernel<48, 4> 123
// registers, 0 spills, 111,616 B of dynamic shared memory at the main-path
// shape (2 blocks a SM), 8 HGMMA.64x24x16.F32.BF16 in its SASS; the other
// bf16 instances 96-121 registers; dcn_fwd_f32_kernel 74-128 registers and
// 195,264 B; grouped_channels_last_kernel 40 registers; no spills anywhere.
// On an H100 80GB HBM3 at 700 W (chip_smoke.py): 0.0886 ms at B=8, D = 4,
// against the 0.0139 ms bound.

#include "dcn_common.cuh"

namespace {

constexpr int kTilePix = 64;   // output pixels per tile: wgmma's M
constexpr int kThreads = 256;  // two warpgroups, each a wgmma issuer
constexpr int kUnroll = 4;     // samples a thread keeps in flight
constexpr int kEpiStride = kTilePix + 4;  // f32 result rows, bank-spread
constexpr int kPixPerThread = 4;          // f32 contraction: 4 pixels
constexpr int kPixGroups = kTilePix / kPixPerThread;  // 16
constexpr int kOcGroups = kThreads / kPixGroups;      // 16

// Byte offsets of the bf16 kernel's dynamic shared memory: B operand (W),
// A operand (the sampled column), the f32 result tile, the table of gather
// units (16 bytes each).
struct BfLayout {
  size_t w, a, epi, tab, total;
};

__host__ __device__ inline BfLayout bf16_layout(int Rp, int cout, int units) {
  BfLayout l;
  l.w = 0;
  l.a = align128((size_t)Rp * cout * 2);
  l.epi = l.a + align128((size_t)Rp * kTilePix * 2);
  l.tab = l.epi + align128((size_t)cout * kEpiStride * 4);
  l.total = l.tab + align128((size_t)units * 16);
  return l;
}

// f32 kernel: W [R][Cout] and the column [R][64] in f32, then the table
__host__ __device__ inline size_t f32_smem(int R, int cout, int units) {
  return (size_t)R * (cout + kTilePix) * 4 + (size_t)units * 16;
}

// ---- column stores -----------------------------------------------------------

// bf16 A operand: element (pixel m, reduction index r) of the K-major
// no-swizzle layout, core matrices of 8 pixels x 8 r (16 bytes a row):
// byte (r / 8) * 1024 + m * 16 + (r % 8) * 2.
struct StoreA {
  unsigned char* a;
  template <int VW>
  __device__ __forceinline__ void put(int r, int m, const float (&v)[VW]) const {
    unsigned char* dst = a + (r >> 3) * (kTilePix * 16) + m * 16 + (r & 7) * 2;
    if constexpr (VW == 4) {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
      uint2 w;
      w.x = *reinterpret_cast<const uint32_t*>(&lo);
      w.y = *reinterpret_cast<const uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(dst) = w;
    } else {
      *reinterpret_cast<bf16*>(dst) = __float2bfloat16_rn(v[0]);
    }
  }
};

// f32 column for the FMA contraction: [r][64 pixels]
struct StoreCol {
  float* col;
  template <int VW>
  __device__ __forceinline__ void put(int r, int m, const float (&v)[VW]) const {
#pragma unroll
    for (int i = 0; i < VW; ++i) col[(r + i) * kTilePix + m] = v[i];
  }
};

// ---- the gather --------------------------------------------------------------

struct Conv {
  int C, H, W, Wo, HWo, kw, K, pad, dil, GK, Cg;
  float dmax;
};

// One unit of the gather: (group, tap, VW-channel chunk). Built once per
// block, so that the sample loop does no integer division:
//   x = column index r = k*C + g*Cg + j*VW,  y = offset of the chunk in the
//   image's (G, H, W, Cg) copy,  z = 2 * (g*K + k) * HWo, the offset of its
//   dy row in the image's offsets (dx: + HWo; its mask row: z / 2),
//   w = the tap's displacement, (ky*dil - pad) << 16 | (kx*dil - pad).
__device__ __forceinline__ void build_units(int4* tab, const Conv& cv,
                                            int VW) {
  const int nch = cv.Cg / VW;
  for (int u = threadIdx.x; u < cv.GK * nch; u += kThreads) {
    const int gk = u / nch;
    const int j = u - gk * nch;
    const int g = gk / cv.K;
    const int k = gk - g * cv.K;
    const int ky = k / cv.kw;
    const int kx = k - ky * cv.kw;
    tab[u] = make_int4(k * cv.C + g * cv.Cg + j * VW,
                       g * cv.H * cv.W * cv.Cg + j * VW, 2 * gk * cv.HWo,
                       ((ky * cv.dil - cv.pad) << 16) |
                           ((kx * cv.dil - cv.pad) & 0xffff));
  }
}

// Samples one tile into the column. Thread t takes pixel t % 64 and the
// units t / 64, t / 64 + 4, ... in group-major order, kUnroll units at a
// time: their corner loads are issued together, then blended. off and msk
// point at this thread's pixel in the image's first offset and mask row;
// msk null means no mask. A pixel past the image reads the tile's first
// pixel's offsets and gets weight 0.
template <typename T, int VW, class Store>
__device__ __forceinline__ void sample_tile(
    const T* __restrict__ xg, const T* __restrict__ off,
    const T* __restrict__ msk, const int4* tab, int p, bool pvalid, int oy,
    int ox, const Conv& cv, const Store& store) {
  constexpr int kStep = kThreads / kTilePix;
  const int n_units = cv.GK * (cv.Cg / VW);
  const int wc = cv.W * cv.Cg;
  for (int u0 = threadIdx.x / kTilePix; u0 < n_units; u0 += kStep * kUnroll) {
    Corner<T, VW> v[kUnroll][4];
    float wt[kUnroll][4];
    int rr[kUnroll];
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      const int4 e = tab[min(u0 + q * kStep, n_units - 1)];
      float ty = to_f(__ldg(off + e.z));
      float tx = to_f(__ldg(off + e.z + cv.HWo));
      float m = msk ? to_f(__ldg(msk + (e.z >> 1))) : 1.f;
      m = pvalid ? m : 0.f;
      if (cv.dmax > 0.f) {
        ty = fminf(fmaxf(ty, -cv.dmax), cv.dmax);
        tx = fminf(fmaxf(tx, -cv.dmax), cv.dmax);
      }
      const float fy = floorf(ty);
      const float fx = floorf(tx);
      const float ly = ty - fy;
      const float lx = tx - fx;
      // the bilinear weights times the mask, per corner
      wt[q][0] = (1.f - ly) * (1.f - lx) * m;
      wt[q][1] = (1.f - ly) * lx * m;
      wt[q][2] = ly * (1.f - lx) * m;
      wt[q][3] = ly * lx * m;
      rr[q] = e.x;
      const int y0 = oy + (e.w >> 16) + (int)fy;
      const int x0 = ox + (int)(short)(e.w & 0xffff) + (int)fx;
      const bool vy0 = (unsigned)y0 < (unsigned)cv.H;
      const bool vy1 = (unsigned)(y0 + 1) < (unsigned)cv.H;
      const bool vx0 = (unsigned)x0 < (unsigned)cv.W;
      const bool vx1 = (unsigned)(x0 + 1) < (unsigned)cv.W;
      const T* c00 = xg + e.y + (y0 * cv.W + x0) * cv.Cg;
      if (vy0 && vx0) v[q][0].load(c00); else v[q][0].zero();
      if (vy0 && vx1) v[q][1].load(c00 + cv.Cg); else v[q][1].zero();
      if (vy1 && vx0) v[q][2].load(c00 + wc); else v[q][2].zero();
      if (vy1 && vx1) v[q][3].load(c00 + wc + cv.Cg); else v[q][3].zero();
    }
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      if (u0 + q * kStep >= n_units) break;
      float out[VW];
#pragma unroll
      for (int i = 0; i < VW; ++i)
        out[i] = wt[q][0] * v[q][0].get(i) + wt[q][1] * v[q][1].get(i) +
                 wt[q][2] * v[q][2].get(i) + wt[q][3] * v[q][3].get(i);
      store.template put<VW>(rr[q], p, out);
    }
  }
}

// ---- kernels -----------------------------------------------------------------

// x (B, C, H, W) -> xg (B, G, H, W, Cg)
template <typename T>
__global__ void grouped_channels_last_kernel(const T* __restrict__ x,
                                             T* __restrict__ xg, int B, int G,
                                             int Cg, int HW, int vec4) {
  const long long total = (long long)B * G * HW;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const long long bg = i / HW;
    const T* src = x + bg * Cg * HW + (i - bg * HW);
    T* dst = xg + i * Cg;
    if (vec4) {  // Cg == 4: one 8-byte (bf16) or 16-byte (f32) store
      if constexpr (sizeof(T) == 2) {
        const uint16_t* s16 = reinterpret_cast<const uint16_t*>(src);
        *reinterpret_cast<uint2*>(dst) = make_uint2(
            (uint32_t)s16[0] | ((uint32_t)s16[HW] << 16),
            (uint32_t)s16[2 * (size_t)HW] | ((uint32_t)s16[3 * (size_t)HW] << 16));
      } else {
        *reinterpret_cast<float4*>(dst) = make_float4(
            src[0], src[HW], src[2 * (size_t)HW], src[3 * (size_t)HW]);
      }
    } else {
      for (int c = 0; c < Cg; ++c) dst[c] = src[(size_t)c * HW];
    }
  }
}

struct Args {
  int B, C, H, W, Ho, Wo, kh, kw, pad, dil, G;
  float dmax;
  int vec_out;  // output rows of 64 pixels are 16-byte aligned
};

__device__ __forceinline__ Conv make_conv(const Args& a) {
  Conv cv;
  cv.C = a.C; cv.H = a.H; cv.W = a.W; cv.Wo = a.Wo; cv.HWo = a.Ho * a.Wo;
  cv.kw = a.kw;
  cv.K = a.kh * a.kw; cv.pad = a.pad; cv.dil = a.dil; cv.GK = a.G * cv.K;
  cv.Cg = a.C / a.G; cv.dmax = a.dmax;
  return cv;
}

template <int COUT, int VW>
__global__ void __launch_bounds__(kThreads, 2)
    dcn_fwd_bf16_kernel(const bf16* __restrict__ xg,
                        const bf16* __restrict__ offset,
                        const bf16* __restrict__ mask,
                        const bf16* __restrict__ weight,
                        bf16* __restrict__ out, Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Conv cv = make_conv(a);
  const int R = cv.K * cv.C;
  const int Rp = (R + 15) & ~15;
  const BfLayout L = bf16_layout(Rp, COUT, cv.GK * (cv.Cg / VW));
  unsigned char* w_s = smem + L.w;
  unsigned char* a_s = smem + L.a;
  float* epi = reinterpret_cast<float*>(smem + L.epi);
  int4* tab = reinterpret_cast<int4*>(smem + L.tab);
  const int tid = threadIdx.x;
  build_units(tab, cv, VW);

  // W[o][c][k] -> B operand (r = k*C + c, o): byte (r/8)*Cout*16 + o*16 + (r%8)*2
  for (int i = tid; i < COUT * R; i += kThreads) {
    const int k = i % cv.K;
    const int oc = i / cv.K;
    const int c = oc % cv.C;
    const int o = oc / cv.C;
    const int r = k * cv.C + c;
    *reinterpret_cast<bf16*>(w_s + (r >> 3) * (COUT * 16) + o * 16 +
                             (r & 7) * 2) = weight[i];
  }
  const bf16 zero = __ushort_as_bfloat16(0);
  for (int i = tid; i < (Rp - R) * COUT; i += kThreads) {
    const int r = R + i / COUT;
    *reinterpret_cast<bf16*>(w_s + (r >> 3) * (COUT * 16) + (i % COUT) * 16 +
                             (r & 7) * 2) = zero;
  }
  for (int i = tid; i < (Rp - R) * kTilePix; i += kThreads) {
    const int r = R + i / kTilePix;
    *reinterpret_cast<bf16*>(a_s + (r >> 3) * (kTilePix * 16) +
                             (i % kTilePix) * 16 + (r & 7) * 2) = zero;
  }
  __syncthreads();  // the table, W and the padding are staged

  const int HWo = cv.HWo;
  const int tiles_per_img = (HWo + kTilePix - 1) / kTilePix;
  const int n_tiles = a.B * tiles_per_img;
  const size_t img = (size_t)cv.C * cv.H * cv.W;
  const int p = tid % kTilePix;
  const StoreA store{a_s};

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int b = tile / tiles_per_img;
    const int p0 = (tile - b * tiles_per_img) * kTilePix;
    const int pix = p0 + p;
    const bool pvalid = pix < HWo;
    const int oy = pvalid ? pix / cv.Wo : 0;
    const int ox = pvalid ? pix - oy * cv.Wo : 0;
    const int pe = p0 + (pvalid ? p : 0);
    // the column (A) was last read by the previous tile's wgmma, which both
    // warpgroups waited for before the barrier that ends that tile's
    // contraction; the result tile is next written after the barrier below
    sample_tile<bf16, VW>(xg + b * img,
                          offset + (size_t)b * 2 * cv.GK * HWo + pe,
                          mask ? mask + (size_t)b * cv.GK * HWo + pe : nullptr,
                          tab, p, pvalid, oy, ox, cv, store);
    fence_proxy_async();  // the column's stores, visible to wgmma
    __syncthreads();

    {  // the contraction on the tensor cores, Cout / 2 channels a warpgroup
      constexpr int NH = COUT / 2;
      const int wg = tid >> 7;
      float acc[NH / 2];
#pragma unroll
      for (int j = 0; j < NH / 2; ++j) acc[j] = 0.f;
      fence_acc(acc);
      wgmma_fence();
      const uint64_t da = make_desc(a_s, kTilePix * 16, 128);
      const uint64_t db = make_desc(w_s + wg * NH * 16, COUT * 16, 128);
      for (int s = 0; s < Rp / 16; ++s)
        wgmma_bf16<NH>(acc, da + (uint64_t)(s * 2 * kTilePix),
                       db + (uint64_t)(s * 2 * COUT));
      wgmma_commit();
      wgmma_wait0();
      fence_acc(acc);
      // accumulator fragment: rows warp*16 + lane/4 (+8), columns
      // 8j + 2*(lane%4) (+1) of this warpgroup's half
      const int m0 = ((tid & 127) >> 5) * 16 + ((tid & 31) >> 2);
      const int n0 = wg * NH + 2 * (tid & 3);
#pragma unroll
      for (int j = 0; j < NH / 8; ++j) {
        const int n = 8 * j + n0;
        epi[n * kEpiStride + m0] = acc[4 * j];
        epi[(n + 1) * kEpiStride + m0] = acc[4 * j + 1];
        epi[n * kEpiStride + m0 + 8] = acc[4 * j + 2];
        epi[(n + 1) * kEpiStride + m0 + 8] = acc[4 * j + 3];
      }
    }
    __syncthreads();

    bf16* out_b = out + (size_t)b * COUT * HWo + p0;
    if (a.vec_out) {  // 8 pixels a thread, one 16-byte store
      for (int e = tid; e < COUT * 8; e += kThreads) {
        const int n = e >> 3;
        const int q = (e & 7) * 8;
        if (p0 + q >= HWo) continue;
        const float4 f0 = *reinterpret_cast<const float4*>(epi + n * kEpiStride + q);
        const float4 f1 =
            *reinterpret_cast<const float4*>(epi + n * kEpiStride + q + 4);
        const __nv_bfloat162 h0 = __floats2bfloat162_rn(f0.x, f0.y);
        const __nv_bfloat162 h1 = __floats2bfloat162_rn(f0.z, f0.w);
        const __nv_bfloat162 h2 = __floats2bfloat162_rn(f1.x, f1.y);
        const __nv_bfloat162 h3 = __floats2bfloat162_rn(f1.z, f1.w);
        uint4 w;
        w.x = *reinterpret_cast<const uint32_t*>(&h0);
        w.y = *reinterpret_cast<const uint32_t*>(&h1);
        w.z = *reinterpret_cast<const uint32_t*>(&h2);
        w.w = *reinterpret_cast<const uint32_t*>(&h3);
        *reinterpret_cast<uint4*>(out_b + (size_t)n * HWo + q) = w;
      }
    } else {
      for (int e = tid; e < COUT * kTilePix; e += kThreads) {
        const int n = e / kTilePix;
        const int q = e % kTilePix;
        if (p0 + q < HWo)
          out_b[(size_t)n * HWo + q] = __float2bfloat16_rn(epi[n * kEpiStride + q]);
      }
    }
  }
}

// NOC = Cout / 16 output channels per thread (Cout in {16, 32, 48, 64})
template <int NOC, int VW>
__global__ void __launch_bounds__(kThreads)
    dcn_fwd_f32_kernel(const float* __restrict__ xg,
                       const float* __restrict__ offset,
                       const float* __restrict__ mask,
                       const float* __restrict__ weight,
                       float* __restrict__ out, Args a) {
  constexpr int Cout = NOC * kOcGroups;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Conv cv = make_conv(a);
  const int R = cv.K * cv.C;
  float* w_s = smem;             // [R][Cout]
  float* col = smem + R * Cout;  // [R][kTilePix]
  int4* tab = reinterpret_cast<int4*>(col + R * kTilePix);
  build_units(tab, cv, VW);
  for (int i = threadIdx.x; i < R * Cout; i += kThreads) {
    const int o = i % Cout;
    const int r = i / Cout;
    const int k = r / cv.C;
    const int c = r % cv.C;
    w_s[i] = weight[((size_t)o * cv.C + c) * cv.K + k];
  }

  const int HWo = a.Ho * a.Wo;
  const int tiles_per_img = (HWo + kTilePix - 1) / kTilePix;
  const int n_tiles = a.B * tiles_per_img;
  const size_t img = (size_t)cv.C * cv.H * cv.W;
  const int p = threadIdx.x % kTilePix;
  const int pg = threadIdx.x % kPixGroups;
  const int og = threadIdx.x / kPixGroups;
  const StoreCol store{col};

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int b = tile / tiles_per_img;
    const int p0 = (tile % tiles_per_img) * kTilePix;
    __syncthreads();  // weights staged / the last contraction is done
    const int pix = p0 + p;
    const bool pvalid = pix < HWo;
    const int oy = pvalid ? pix / cv.Wo : 0;
    const int ox = pvalid ? pix - oy * cv.Wo : 0;
    const int pe = p0 + (pvalid ? p : 0);
    sample_tile<float, VW>(
        xg + b * img, offset + (size_t)b * 2 * cv.GK * HWo + pe,
        mask ? mask + (size_t)b * cv.GK * HWo + pe : nullptr, tab, p, pvalid,
        oy, ox, cv, store);
    __syncthreads();

    float acc[NOC][kPixPerThread];
#pragma unroll
    for (int j = 0; j < NOC; ++j)
#pragma unroll
      for (int q = 0; q < kPixPerThread; ++q) acc[j][q] = 0.f;
    const float* colp = col + pg * kPixPerThread;
    for (int r = 0; r < R; ++r) {
      const float4 v =
          *reinterpret_cast<const float4*>(colp + (size_t)r * kTilePix);
      const float* wr = w_s + r * Cout + og;
#pragma unroll
      for (int j = 0; j < NOC; ++j) {
        const float wv = wr[j * kOcGroups];
        acc[j][0] = fmaf(v.x, wv, acc[j][0]);
        acc[j][1] = fmaf(v.y, wv, acc[j][1]);
        acc[j][2] = fmaf(v.z, wv, acc[j][2]);
        acc[j][3] = fmaf(v.w, wv, acc[j][3]);
      }
    }
    float* out_b = out + (size_t)b * Cout * HWo;
#pragma unroll
    for (int j = 0; j < NOC; ++j) {
      const int o = og + j * kOcGroups;
#pragma unroll
      for (int q = 0; q < kPixPerThread; ++q) {
        const int px = p0 + pg * kPixPerThread + q;
        if (px < HWo) out_b[(size_t)o * HWo + px] = acc[j][q];
      }
    }
  }
}

// ---- launches ----------------------------------------------------------------

template <typename T>
cudaError_t launch_persistent(void (*kernel)(const T*, const T*, const T*,
                                             const T*, T*, Args),
                              size_t smem, const void* xg, const void* offset,
                              const void* mask, const void* weight, void* out,
                              const Args& a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  const int n_tiles =
      a.B * ((a.Ho * a.Wo + kTilePix - 1) / kTilePix);
  int grid = device_attr(cudaDevAttrMultiProcessorCount) *
             (per_sm > 0 ? per_sm : 1);
  if (grid > n_tiles) grid = n_tiles;
  if (grid < 1) return cudaSuccess;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(xg), static_cast<const T*>(offset),
      static_cast<const T*>(mask), static_cast<const T*>(weight),
      static_cast<T*>(out), a);
  return cudaGetLastError();
}

template <int COUT>
cudaError_t launch_bf16(bool vec4, const void* xg, const void* offset,
                        const void* mask, const void* weight, void* out,
                        const Args& a, cudaStream_t s) {
  const int K = a.kh * a.kw;
  const int Rp = (K * a.C + 15) & ~15;
  const int units = a.G * K * (vec4 ? a.C / a.G / 4 : a.C / a.G);
  const size_t smem = bf16_layout(Rp, COUT, units).total;
  if (smem > (size_t)device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin))
    return cudaErrorInvalidValue;
  return vec4 ? launch_persistent<bf16>(dcn_fwd_bf16_kernel<COUT, 4>, smem,
                                        xg, offset, mask, weight, out, a, s)
              : launch_persistent<bf16>(dcn_fwd_bf16_kernel<COUT, 1>, smem,
                                        xg, offset, mask, weight, out, a, s);
}

template <int NOC>
cudaError_t launch_f32(bool vec4, const void* xg, const void* offset,
                       const void* mask, const void* weight, void* out,
                       const Args& a, cudaStream_t s) {
  const int units = a.G * a.kh * a.kw * (vec4 ? a.C / a.G / 4 : a.C / a.G);
  const size_t smem = f32_smem(a.kh * a.kw * a.C, NOC * kOcGroups, units);
  if (smem > (size_t)device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin))
    return cudaErrorInvalidValue;
  return vec4 ? launch_persistent<float>(dcn_fwd_f32_kernel<NOC, 4>, smem, xg,
                                         offset, mask, weight, out, a, s)
              : launch_persistent<float>(dcn_fwd_f32_kernel<NOC, 1>, smem, xg,
                                         offset, mask, weight, out, a, s);
}

template <typename T>
cudaError_t launch_transpose(const void* x, void* xg, const Args& a, int Cg,
                             cudaStream_t s) {
  const long long total = (long long)a.B * a.G * a.H * a.W;
  if (total == 0) return cudaSuccess;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  const long long cap =
      (long long)device_attr(cudaDevAttrMultiProcessorCount) * 16;
  if (blocks > cap) blocks = cap;
  const bool vec4 = Cg == 4 && reinterpret_cast<uintptr_t>(xg) % (4 * sizeof(T)) == 0;
  grouped_channels_last_kernel<T><<<(unsigned)blocks, threads, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(xg), a.B, a.G, Cg,
      a.H * a.W, vec4 ? 1 : 0);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, x_grouped, offset, mask, weight and
// out share it). x_grouped is scratch of x's size: the kernel writes x there
// in (B, G, H, W, C/G) order and gathers from it. mask may be null (DCNv1:
// mask 1). max_offset <= 0: exact, no clamp. Returns a cudaError_t;
// cudaErrorInvalidValue for a shape the kernels do not take.
extern "C" int fami_dcn_fwd(const void* x, void* x_grouped, const void* offset,
                            const void* mask, const void* weight, void* out,
                            int dtype, int B, int C, int H, int W, int Cout,
                            int Ho, int Wo, int kh, int kw, int pad, int dil,
                            int groups, float max_offset, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (groups < 1 || C % groups != 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (Cout != 16 && Cout != 32 && Cout != 48 && Cout != 64)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.B = B; a.C = C; a.H = H; a.W = W; a.Ho = Ho; a.Wo = Wo; a.kh = kh;
  a.kw = kw; a.pad = pad; a.dil = dil; a.G = groups; a.dmax = max_offset;
  const int HWo = Ho * Wo;
  a.vec_out = HWo % 8 == 0 && aligned16(out);
  const int Cg = C / groups;
  const size_t elem = dtype == 0 ? 4 : 2;
  const bool vec4 =
      Cg % 4 == 0 && reinterpret_cast<uintptr_t>(x_grouped) % (4 * elem) == 0;
  cudaError_t err = dtype == 0 ? launch_transpose<float>(x, x_grouped, a, Cg, s)
                               : launch_transpose<bf16>(x, x_grouped, a, Cg, s);
  if (err != cudaSuccess) return (int)err;
  if (dtype == 0) {
    switch (Cout) {
      case 16: return (int)launch_f32<1>(vec4, x_grouped, offset, mask, weight, out, a, s);
      case 32: return (int)launch_f32<2>(vec4, x_grouped, offset, mask, weight, out, a, s);
      case 48: return (int)launch_f32<3>(vec4, x_grouped, offset, mask, weight, out, a, s);
      default: return (int)launch_f32<4>(vec4, x_grouped, offset, mask, weight, out, a, s);
    }
  }
  switch (Cout) {
    case 16: return (int)launch_bf16<16>(vec4, x_grouped, offset, mask, weight, out, a, s);
    case 32: return (int)launch_bf16<32>(vec4, x_grouped, offset, mask, weight, out, a, s);
    case 48: return (int)launch_bf16<48>(vec4, x_grouped, offset, mask, weight, out, a, s);
    default: return (int)launch_bf16<64>(vec4, x_grouped, offset, mask, weight, out, a, s);
  }
}
