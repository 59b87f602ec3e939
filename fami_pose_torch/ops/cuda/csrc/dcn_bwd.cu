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
// directly, so the work does not grow with D. The dx adjoint is a scatter
// with atomics into a float32 buffer, the only form that also serves the
// exact (unclamped) mode, where the adjoint has no bounded gather window; a
// gather form would test (2D+1)^2 = 81 candidate pixels at D = 4 for every
// (input pixel, group, tap), ~20x the scatter's instructions.
//
// What bounds it on an H100. At the main-path shape (B=8, 96x72, C=Cout=48,
// G=12, bf16) one call must move ~88 MB (offsets and doffset ~24 MB each,
// mask and dmask ~12 MB each, x, gout and dx ~5.3 MB each): ~26 us at
// 3.35 TB/s; its two contractions are ~4.6 GFLOP, ~5 us at the bf16
// tensor-core rate. So the bytes set the least time. What sets this
// kernel's time (PERF.md) is the issue of the sample loop's instructions
// (~1.9x the forward's a unit of 4 channels) and the L2's rate of atomic
// operations (~190 G a second, a float4 atomic counting as one).
//
// Design (three launches on the caller's stream, counted as one call):
//   0. prep_kernel copies x (B, C, H, W) to a scratch buffer in grouped
//      channels-last order (B, G, H, W, Cg), as the forward does, so that
//      the Cg channels of one group at one corner are one vector load, and
//      zeroes the float32 dx accumulator of the same order.
//   1. dcn_bwd_bf16_kernel: persistent blocks of 256 threads, two an SM at
//      the main-path shape. The taps are cut into groups of 3 (the dW
//      accumulators of all 9 would not fit in registers); a block owns one
//      tap group (blockIdx % tap groups) and walks 64-pixel tiles with it.
//      Its slice of W (3 taps: Cout x 3C, bf16) is staged once as the
//      wgmma B operand, beside a table of its gather units (group, tap).
//      For each tile:
//        a. the gout tile is staged twice in bf16: [pixel][o] (the A
//           operand of dcol) and [o][pixel] (the A operand of dW);
//        b. dcol[64 px][3C] = gout^T . W_slice on the tensor cores (wgmma
//           m64 n24 k16, Cout / 16 k-steps, each warpgroup half of the
//           columns), the f32 result stored to shared memory;
//        c. all 256 threads sample: one unit is (pixel, group, tap), all Cg
//           channels. It reads its offsets and mask, gathers the 4 corners
//           (one 8-byte load each for Cg = 4 in bf16), reads dcol (one
//           16-byte shared load), writes m * S to the column in bf16 (the
//           wgmma B operand of dW), writes doffset and dmask, and adds
//           m * w_corner * dcol into the dx accumulator with one float4
//           atomic a corner (vector atomics exist for global memory on
//           compute capability 9.x; corners of weight 0 are skipped; Cg not
//           a multiple of 4 takes scalar atomics). A tile's dx summed in
//           shared memory first was 3x slower: a float atomicAdd to shared
//           memory is a compare-and-swap loop on this card.
//        d. dW[o][3C] += gout . column on the tensor cores (M = Cout padded
//           to 64, K = the 64 pixels), the f32 accumulators held in
//           registers across all the block's tiles.
//      At the end each block writes its dW slice to a float32 partial of
//      its own (no atomics: dW is deterministic).
//   2. finish_kernel turns the dx accumulator into NCHW in x's type and
//      sums the blocks' dW partials into (Cout, C, kh, kw) in W's type.
//   dcn_bwd_f32_kernel (float32 inputs: the card-vs-CPU checks) has the
//   same tap groups, gathers and atomics with the column and W in f32 and
//   both contractions as full-f32 FMA loops on the CUDA cores; TF32 would
//   miss the 1e-4 tolerance of those checks.
// Numerics (bf16): gout and W are bf16 already, so dcol is exact products
// summed in f32, as before; the column m * S is rounded to bf16 once for the
// dW contraction (the one new rounding: 0.19-0.28 of the 2^-7-of-scale
// tolerance, tests/test_torch_dcn_numerics.py); dx, dmask and doffset are
// computed in f32 and rounded once.
//
// Build (nvcc 12.9, -Xptxas -v, sm_90a): dcn_bwd_bf16_kernel<48, 4> 127
// registers, no spills, 85,120 B of dynamic shared memory at the main-path
// shape (2 blocks an SM); the other bf16 instances 80-123 registers, no
// spills; 33 HGMMA.64x24x16.F32.BF16 (and one HGMMA.64x8x16.F16 the
// compiler adds) in the SASS of each C = 48 instance, 11 / 22 / 44 at C
// padded to 16 / 32 / 64; dcn_bwd_f32_kernel 70-128 registers, 118,400 B
// at the main-path shape, <32, 3, 1> spilling 12 bytes; prep_kernel 32-40
// and finish_kernel 48 registers.
// On an H100 80GB HBM3 at 700 W (chip_smoke.py, device-side): 0.2440-0.2461
// ms at B=8, D = 4 (the previous scalar-atomic design 0.9871) against the
// 0.0262 ms bound.

#include "dcn_common.cuh"

namespace {

constexpr int kTilePix = 64;   // output pixels per tile: wgmma's M
constexpr int kThreads = 256;  // two warpgroups
constexpr int kTaps = 3;       // taps of one block's slice
constexpr int kColStride = kTilePix + 4;  // f32 rows of 64 pixels, padded

// Byte offsets of the bf16 kernel's dynamic shared memory, for the padded
// channel count cp (C rounded up to 16) and nw = 3 * cp slice columns:
// W slice (B of dcol, Cout x nw), gout^T (A of dcol, 64 x Cout), gout (A of
// dW, 64 x 64, rows past Cout zero), the column (B of dW, 64 x nw), dcol
// (f32, 64 rows of nw + 4), the unit table (16 bytes a unit).
struct BfLayout {
  size_t w, ga, gb, col, dcol, tab, total;
};

__host__ __device__ inline BfLayout bf16_layout(int cp, int cout, int units) {
  const int nw = kTaps * cp;
  BfLayout l;
  l.w = 0;
  l.ga = align128((size_t)cout * nw * 2);
  l.gb = l.ga + align128((size_t)kTilePix * cout * 2);
  l.col = l.gb + align128((size_t)64 * kTilePix * 2);
  l.dcol = l.col + align128((size_t)kTilePix * nw * 2);
  l.tab = l.dcol + align128((size_t)kTilePix * (nw + 4) * 4);
  l.total = l.tab + align128((size_t)units * 16);
  return l;
}

// f32 kernel: W slice [o][nw], gout [o][68], column [nw][68], dcol
// [64][nw + 4], the unit table
struct F32Layout {
  size_t w, g, col, dcol, tab, total;
};

__host__ __device__ inline F32Layout f32_layout(int cp, int cout, int units) {
  const int nw = kTaps * cp;
  F32Layout l;
  l.w = 0;
  l.g = align128((size_t)cout * nw * 4);
  l.col = l.g + align128((size_t)cout * kColStride * 4);
  l.dcol = l.col + align128((size_t)nw * kColStride * 4);
  l.tab = l.dcol + align128((size_t)kTilePix * (nw + 4) * 4);
  l.total = l.tab + align128((size_t)units * 16);
  return l;
}

// ---- conversions, atomics ----------------------------------------------------

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// dx[p .. p + VW) += s * md[0 .. VW): one 16-byte atomic for VW = 4
template <int VW>
__device__ __forceinline__ void add_corner(float* p, float s,
                                           const float (&md)[VW]) {
  if constexpr (VW == 4) {
    atomicAdd(reinterpret_cast<float4*>(p),
              make_float4(s * md[0], s * md[1], s * md[2], s * md[3]));
  } else {
    atomicAdd(p, s * md[0]);
  }
}

// ---- column stores -----------------------------------------------------------

// bf16 B operand of dW: element (pixel m, column n) of the K-major
// no-swizzle layout, K = the pixels, core matrices of 8 columns x 8 pixels:
// byte (m / 8) * nw * 16 + n * 16 + (m % 8) * 2.
struct StoreColBf16 {
  unsigned char* col;
  int row_bytes;  // nw * 16
  template <int VW>
  __device__ __forceinline__ void put(int n, int m, const float (&v)[VW]) const {
    unsigned char* dst = col + (m >> 3) * row_bytes + n * 16 + (m & 7) * 2;
#pragma unroll
    for (int i = 0; i < VW; ++i)
      *reinterpret_cast<bf16*>(dst + i * 16) = __float2bfloat16_rn(v[i]);
  }
};

// f32 column for the FMA contraction: [n][kColStride]
struct StoreColF32 {
  float* col;
  template <int VW>
  __device__ __forceinline__ void put(int n, int m, const float (&v)[VW]) const {
#pragma unroll
    for (int i = 0; i < VW; ++i) col[(n + i) * kColStride + m] = v[i];
  }
};

// ---- the sampling side -------------------------------------------------------

struct Args {
  int B, C, H, W, Ho, Wo, kh, kw, pad, dil, G, Cout;
  int tap_groups;  // ceil(K / 3)
  float dmax;
};

struct Conv {
  int C, H, W, Wo, HWo, kw, K, pad, dil, G, Cg;
  float dmax;
};

__device__ __forceinline__ Conv make_conv(const Args& a) {
  Conv cv;
  cv.C = a.C; cv.H = a.H; cv.W = a.W; cv.Wo = a.Wo; cv.HWo = a.Ho * a.Wo;
  cv.kw = a.kw; cv.K = a.kh * a.kw; cv.pad = a.pad; cv.dil = a.dil;
  cv.G = a.G; cv.Cg = a.C / a.G; cv.dmax = a.dmax;
  return cv;
}

// The block's units (group g, tap k0 + kk) for kk < kt, built once so that
// the sample loop does no integer division:
//   x = the unit's first column in the slice, kk * cp + g * Cg (also its
//       place in a dcol row),
//   y = offset of the group's plane in the image's (G, H, W, Cg) arrays,
//   z = (g * K + k) * HWo: its dy row in the image's offsets is 2z, its dx
//       row 2z + HWo, its mask row z,
//   w = the tap's displacement, (ky*dil - pad) << 16 | (kx*dil - pad).
__device__ __forceinline__ int build_units(int4* tab, const Conv& cv, int cp,
                                           int k0, int kt) {
  const int n = cv.G * kt;
  for (int u = threadIdx.x; u < n; u += kThreads) {
    const int g = u / kt;
    const int kk = u - g * kt;
    const int k = k0 + kk;
    const int ky = k / cv.kw;
    const int kx = k - ky * cv.kw;
    tab[u] = make_int4(kk * cp + g * cv.Cg, g * cv.H * cv.W * cv.Cg,
                       (g * cv.K + k) * cv.HWo,
                       ((ky * cv.dil - cv.pad) << 16) |
                           ((kx * cv.dil - cv.pad) & 0xffff));
  }
  return n;
}

// The sampling side of one tile for this thread's pixel p. Thread t takes
// the units t / 64, t / 64 + 4, ..., one at a time (two in flight, their
// loads issued together, measured 2-4% slower at the 128-register cap of
// two blocks an SM). off / msk / doff / dmsk point at the pixel in the
// image's first offset and mask row (a pixel past the image points at the
// tile's first pixel and neither gathers nor writes); xg and dxa at the
// image's (G, H, W, Cg) arrays; dcol_p at the pixel's dcol row.
template <typename T, int VW, class Store>
__device__ __forceinline__ void sample_tile(
    const T* __restrict__ xg, float* __restrict__ dxa,
    const T* __restrict__ off, const T* __restrict__ msk,
    T* __restrict__ doff, T* __restrict__ dmsk, const int4* tab, int n_units,
    const float* dcol_p, int p, bool pvalid, int oy, int ox, const Conv& cv,
    const Store& store) {
  const int wc = cv.W * cv.Cg;
  const int corner[4] = {0, cv.Cg, wc, wc + cv.Cg};  // 00, 01, 10, 11
  for (int u = threadIdx.x / kTilePix; u < n_units;
       u += kThreads / kTilePix) {
    const int4 e = tab[u];
    const float ty_raw = to_f(__ldg(off + 2 * e.z));
    const float tx_raw = to_f(__ldg(off + 2 * e.z + cv.HWo));
    const float m = msk ? to_f(__ldg(msk + e.z)) : 1.f;
    float ty = ty_raw, tx = tx_raw;
    bool pass_y = true, pass_x = true;
    if (cv.dmax > 0.f) {
      ty = fminf(fmaxf(ty, -cv.dmax), cv.dmax);
      tx = fminf(fmaxf(tx, -cv.dmax), cv.dmax);
      pass_y = ty_raw >= -cv.dmax && ty_raw <= cv.dmax;
      pass_x = tx_raw >= -cv.dmax && tx_raw <= cv.dmax;
    }
    const float fy = floorf(ty);
    const float fx = floorf(tx);
    const float ly = ty - fy;
    const float lx = tx - fx;
    const float w[4] = {(1.f - ly) * (1.f - lx), (1.f - ly) * lx,
                        ly * (1.f - lx), ly * lx};
    const int y0 = oy + (e.w >> 16) + (int)fy;
    const int x0 = ox + (int)(short)(e.w & 0xffff) + (int)fx;
    const bool vy0 = pvalid && (unsigned)y0 < (unsigned)cv.H;
    const bool vy1 = pvalid && (unsigned)(y0 + 1) < (unsigned)cv.H;
    const bool vx0 = (unsigned)x0 < (unsigned)cv.W;
    const bool vx1 = (unsigned)(x0 + 1) < (unsigned)cv.W;
    const bool ok[4] = {vy0 && vx0, vy0 && vx1, vy1 && vx0, vy1 && vx1};
    const int cb = e.y + (y0 * cv.W + x0) * cv.Cg;
    float dm = 0.f, gy = 0.f, gx = 0.f;
    for (int j = 0; j < cv.Cg; j += VW) {
      Corner<T, VW> v[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (ok[c]) v[c].load(xg + cb + j + corner[c]); else v[c].zero();
      }
      const int n = e.x + j;
      float d[VW];
      if constexpr (VW == 4) {
        const float4 dv = *reinterpret_cast<const float4*>(dcol_p + n);
        d[0] = dv.x; d[1] = dv.y; d[2] = dv.z; d[3] = dv.w;
      } else {
        d[0] = dcol_p[n];
      }
      float col[VW], md[VW];
#pragma unroll
      for (int i = 0; i < VW; ++i) {
        // the blend along x on both rows, then along y; the slopes along
        // y (bottom - top) and along x (the rows' x slopes blended in y)
        const float v00 = v[0].get(i), v10 = v[2].get(i);
        const float sx0 = v[1].get(i) - v00;
        const float sx1 = v[3].get(i) - v10;
        const float top = fmaf(lx, sx0, v00);
        const float sy = fmaf(lx, sx1, v10) - top;
        const float s = fmaf(ly, sy, top);
        col[i] = m * s;
        md[i] = m * d[i];
        dm = fmaf(s, d[i], dm);
        gy = fmaf(d[i], sy, gy);
        gx = fmaf(d[i], fmaf(ly, sx1 - sx0, sx0), gx);
      }
      store.template put<VW>(n, p, col);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (ok[c] && w[c] != 0.f)
          add_corner<VW>(dxa + cb + j + corner[c], w[c], md);
      }
    }
    if (pvalid) {
      doff[2 * e.z] = from_f<T>(pass_y && ly != 0.f ? m * gy : 0.f);
      doff[2 * e.z + cv.HWo] = from_f<T>(pass_x && lx != 0.f ? m * gx : 0.f);
      if (dmsk) dmsk[e.z] = from_f<T>(dm);
    }
  }
}

// ---- wgmma --------------------------------------------------------------------

// D[64 x NH] += A . B over `steps` k16 steps, as NH / 24 wgmma n24 each
// (the 12 accumulators of chunk i are d[12i .. 12i + 12)); a_step and
// b_step advance the descriptors by one k-step, in 16-byte units, and chunk
// i's B starts 24 columns (24 rows of 16 bytes) after chunk i - 1's
template <int NH>
__device__ __forceinline__ void wgmma_rows(float (&d)[NH / 2], uint64_t da,
                                           uint64_t db, int steps,
                                           uint32_t a_step, uint32_t b_step) {
  for (int s = 0; s < steps; ++s) {
#pragma unroll
    for (int i = 0; i < NH / 24; ++i)
      wgmma_bf16<24>(*reinterpret_cast<float(*)[12]>(d + 12 * i),
                     da + (uint64_t)s * a_step,
                     db + (uint64_t)(s * b_step + i * 24));
  }
}

// ---- kernels -----------------------------------------------------------------

// x (B, C, H, W) -> xg (B, G, H, W, Cg); dxa, of xg's size in f32, zeroed
template <typename T>
__global__ void prep_kernel(const T* __restrict__ x, T* __restrict__ xg,
                            float* __restrict__ dxa, int B, int G, int Cg,
                            int HW, int vec4) {
  const long long total = (long long)B * G * HW;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const long long bg = i / HW;
    const T* src = x + bg * Cg * HW + (i - bg * HW);
    T* dst = xg + i * Cg;
    float* acc = dxa + i * Cg;
    if (vec4) {  // Cg == 4: one 8-byte (bf16) or 16-byte (f32) store each
      if constexpr (sizeof(T) == 2) {
        const uint16_t* s16 = reinterpret_cast<const uint16_t*>(src);
        *reinterpret_cast<uint2*>(dst) = make_uint2(
            (uint32_t)s16[0] | ((uint32_t)s16[HW] << 16),
            (uint32_t)s16[2 * (size_t)HW] | ((uint32_t)s16[3 * (size_t)HW] << 16));
      } else {
        *reinterpret_cast<float4*>(dst) = make_float4(
            src[0], src[HW], src[2 * (size_t)HW], src[3 * (size_t)HW]);
      }
      *reinterpret_cast<float4*>(acc) = make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      for (int c = 0; c < Cg; ++c) {
        dst[c] = src[(size_t)c * HW];
        acc[c] = 0.f;
      }
    }
  }
}

// The geometry of tile `tile` for this thread's pixel (a block of tap group
// blockIdx % tap_groups walks the tiles slot, slot + slots, ...).
struct Tile {
  int b, p0, pix, oy, ox, pe;
  bool pvalid;
  __device__ __forceinline__ Tile(int tile, int tiles_per_img, const Conv& cv) {
    b = tile / tiles_per_img;
    p0 = (tile - b * tiles_per_img) * kTilePix;
    const int p = threadIdx.x % kTilePix;
    pix = p0 + p;
    pvalid = pix < cv.HWo;
    oy = pvalid ? pix / cv.Wo : 0;
    ox = pvalid ? pix - oy * cv.Wo : 0;
    pe = p0 + (pvalid ? p : 0);
  }
};

template <int CP, int VW>
__global__ void __launch_bounds__(kThreads, 2)
    dcn_bwd_bf16_kernel(const bf16* __restrict__ xg,
                        const bf16* __restrict__ offset,
                        const bf16* __restrict__ mask,
                        const bf16* __restrict__ weight,
                        const bf16* __restrict__ gout, float* __restrict__ dxa,
                        bf16* __restrict__ doffset, bf16* __restrict__ dmask,
                        float* __restrict__ dw_part, Args a, int vec_gout) {
  constexpr int NW = kTaps * CP;
  constexpr int NH = NW / 2;  // columns a warpgroup
  extern __shared__ __align__(128) unsigned char smem[];
  const Conv cv = make_conv(a);
  const int cout = a.Cout;
  const int tg = blockIdx.x % a.tap_groups;
  const int slot = blockIdx.x / a.tap_groups;
  const int slots = gridDim.x / a.tap_groups;
  const int k0 = tg * kTaps;
  const int kt = min(kTaps, cv.K - k0);
  const BfLayout L = bf16_layout(CP, cout, cv.G * kTaps);
  unsigned char* w_s = smem + L.w;
  unsigned char* ga_s = smem + L.ga;
  unsigned char* gb_s = smem + L.gb;
  unsigned char* col_s = smem + L.col;
  float* dcol_s = reinterpret_cast<float*>(smem + L.dcol);
  int4* tab = reinterpret_cast<int4*>(smem + L.tab);
  const int tid = threadIdx.x;
  const int n_units = build_units(tab, cv, CP, k0, kt);

  // W[o][c][k0 + kk] -> B of dcol (K = o, N = n = kk*CP + c), zero past C
  // and past the last tap: byte (o/8)*NW*16 + n*16 + (o%8)*2
  const bf16 zero = __ushort_as_bfloat16(0);
  for (int i = tid; i < cout * NW; i += kThreads) {
    const int o = i / NW;
    const int n = i - o * NW;
    const int kk = n / CP;
    const int c = n - kk * CP;
    *reinterpret_cast<bf16*>(w_s + (o >> 3) * (NW * 16) + n * 16 +
                             (o & 7) * 2) =
        kk < kt && c < cv.C ? weight[((size_t)o * cv.C + c) * cv.K + k0 + kk]
                            : zero;
  }
  // gout's rows past Cout and the column's padding stay zero
  for (int i = tid; i < 64 * kTilePix / 8; i += kThreads)
    reinterpret_cast<uint4*>(gb_s)[i] = make_uint4(0u, 0u, 0u, 0u);
  for (int i = tid; i < kTilePix * NW / 8; i += kThreads)
    reinterpret_cast<uint4*>(col_s)[i] = make_uint4(0u, 0u, 0u, 0u);

  float acc_dw[NH / 2];
#pragma unroll
  for (int j = 0; j < NH / 2; ++j) acc_dw[j] = 0.f;

  const int HWo = cv.HWo;
  const int tiles_per_img = (HWo + kTilePix - 1) / kTilePix;
  const int n_tiles = a.B * tiles_per_img;
  const size_t img = (size_t)cv.C * cv.H * cv.W;
  const size_t offs_img = (size_t)2 * cv.G * cv.K * HWo;
  const size_t msk_img = (size_t)cv.G * cv.K * HWo;
  const int p = tid % kTilePix;
  const int wg = tid >> 7;
  const StoreColBf16 store{col_s, NW * 16};

  for (int tile = slot; tile < n_tiles; tile += slots) {
    const Tile t(tile, tiles_per_img, cv);
    // the previous tile's wgmma have been waited for by their warpgroups
    __syncthreads();
    // a. gout tile -> ga_s [px][o] (byte (o/8)*1024 + px*16 + (o%8)*2) and
    //    gb_s [o][px] (byte (px/8)*1024 + o*16 + (px%8)*2)
    const bf16* g_b = gout + (size_t)t.b * cout * HWo + t.p0;
    for (int i = tid; i < kTilePix * cout / 8; i += kThreads) {
      const int px = i % kTilePix;
      const int oc = i / kTilePix;
      uint32_t h[8];
#pragma unroll
      for (int r = 0; r < 8; ++r)
        h[r] = t.p0 + px < HWo
                   ? (uint32_t)__bfloat16_as_ushort(
                         g_b[(size_t)(oc * 8 + r) * HWo + px])
                   : 0u;
      *reinterpret_cast<uint4*>(ga_s + oc * 1024 + px * 16) =
          make_uint4(h[0] | h[1] << 16, h[2] | h[3] << 16, h[4] | h[5] << 16,
                     h[6] | h[7] << 16);
    }
    for (int i = tid; i < cout * 8; i += kThreads) {
      const int pc = i & 7;
      const int o = i >> 3;
      const bf16* src = g_b + (size_t)o * HWo + pc * 8;
      uint4 v;
      if (vec_gout && t.p0 + pc * 8 + 8 <= HWo) {
        v = __ldg(reinterpret_cast<const uint4*>(src));
      } else {
        uint32_t h[8];
#pragma unroll
        for (int r = 0; r < 8; ++r)
          h[r] = t.p0 + pc * 8 + r < HWo
                     ? (uint32_t)__bfloat16_as_ushort(src[r]) : 0u;
        v = make_uint4(h[0] | h[1] << 16, h[2] | h[3] << 16,
                       h[4] | h[5] << 16, h[6] | h[7] << 16);
      }
      *reinterpret_cast<uint4*>(gb_s + pc * 1024 + o * 16) = v;
    }
    fence_proxy_async();
    __syncthreads();

    // b. dcol[px][n] = sum_o gout[o][px] * W[o][n], this warpgroup's half
    {
      float acc[NH / 2];
#pragma unroll
      for (int j = 0; j < NH / 2; ++j) acc[j] = 0.f;
      fence_acc(acc);
      wgmma_fence();
      wgmma_rows<NH>(acc, make_desc(ga_s, kTilePix * 16, 128),
                     make_desc(w_s + wg * NH * 16, NW * 16, 128), cout / 16,
                     2 * kTilePix, 2 * NW);
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
        *reinterpret_cast<float2*>(dcol_s + m0 * (NW + 4) + n) =
            make_float2(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<float2*>(dcol_s + (m0 + 8) * (NW + 4) + n) =
            make_float2(acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
    __syncthreads();

    // c. the sampling side
    sample_tile<bf16, VW>(
        xg + t.b * img, dxa + t.b * img, offset + t.b * offs_img + t.pe,
        mask ? mask + t.b * msk_img + t.pe : nullptr,
        doffset + t.b * offs_img + t.pe,
        dmask ? dmask + t.b * msk_img + t.pe : nullptr, tab, n_units,
        dcol_s + p * (NW + 4), p, t.pvalid, t.oy, t.ox, cv, store);
    fence_proxy_async();  // the column's stores, visible to wgmma
    __syncthreads();

    // d. dW[o][n] += sum_px gout[o][px] * col[px][n], this warpgroup's half
    fence_acc(acc_dw);
    wgmma_fence();
    wgmma_rows<NH>(acc_dw, make_desc(gb_s, kTilePix * 16, 128),
                   make_desc(col_s + wg * NH * 16, NW * 16, 128),
                   kTilePix / 16, 2 * kTilePix, 2 * NW);
    wgmma_commit();
    wgmma_wait0();
    fence_acc(acc_dw);
  }

  // this block's dW slice -> its partial [o][kk][c] (o < Cout, kk < kt,
  // c < C); the finish kernel sums the partials of the tap group
  float* part = dw_part + (size_t)blockIdx.x * cout * kTaps * cv.C;
  const int m0 = ((tid & 127) >> 5) * 16 + ((tid & 31) >> 2);
  const int n0 = wg * NH + 2 * (tid & 3);
#pragma unroll
  for (int j = 0; j < NH / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int o = m0 + (e >> 1) * 8;
      const int n = 8 * j + n0 + (e & 1);
      const int kk = n / CP;
      const int c = n - kk * CP;
      if (o < cout && kk < kt && c < cv.C)
        part[((size_t)o * kTaps + kk) * cv.C + c] = acc_dw[4 * j + e];
    }
  }
}

// float32: the same tap groups, gathers and atomics; both contractions as
// full-f32 FMA loops. NOC = Cout / 16.
template <int CP, int NOC, int VW>
__global__ void __launch_bounds__(kThreads)
    dcn_bwd_f32_kernel(const float* __restrict__ xg,
                       const float* __restrict__ offset,
                       const float* __restrict__ mask,
                       const float* __restrict__ weight,
                       const float* __restrict__ gout, float* __restrict__ dxa,
                       float* __restrict__ doffset, float* __restrict__ dmask,
                       float* __restrict__ dw_part, Args a, int) {
  constexpr int NW = kTaps * CP;
  constexpr int COUT = NOC * 16;
  constexpr int NI = NW / 16;  // columns a thread: dcol and dW
  extern __shared__ __align__(128) unsigned char smem[];
  const Conv cv = make_conv(a);
  const int tg = blockIdx.x % a.tap_groups;
  const int slot = blockIdx.x / a.tap_groups;
  const int slots = gridDim.x / a.tap_groups;
  const int k0 = tg * kTaps;
  const int kt = min(kTaps, cv.K - k0);
  const F32Layout L = f32_layout(CP, COUT, cv.G * kTaps);
  float* w_s = reinterpret_cast<float*>(smem + L.w);      // [o][NW]
  float* g_s = reinterpret_cast<float*>(smem + L.g);      // [o][68]
  float* col_s = reinterpret_cast<float*>(smem + L.col);  // [NW][68]
  float* dcol_s = reinterpret_cast<float*>(smem + L.dcol);
  int4* tab = reinterpret_cast<int4*>(smem + L.tab);
  const int tid = threadIdx.x;
  const int n_units = build_units(tab, cv, CP, k0, kt);
  for (int i = tid; i < COUT * NW; i += kThreads) {
    const int o = i / NW;
    const int n = i - o * NW;
    const int kk = n / CP;
    const int c = n - kk * CP;
    w_s[i] = kk < kt && c < cv.C
                 ? weight[((size_t)o * cv.C + c) * cv.K + k0 + kk] : 0.f;
  }
  for (int i = tid; i < NW * kColStride; i += kThreads) col_s[i] = 0.f;

  // dcol: 4 pixels (quad) x NI columns n = lane + 16 i a thread;
  // dW: NOC rows o = ol + 16 j x NI columns n = nl + 16 i a thread
  const int quad = tid % 16, lane = tid / 16;
  const int ol = tid % 16, nl = tid / 16;
  float acc_dw[NOC][NI];
#pragma unroll
  for (int j = 0; j < NOC; ++j)
#pragma unroll
    for (int i = 0; i < NI; ++i) acc_dw[j][i] = 0.f;

  const int HWo = cv.HWo;
  const int tiles_per_img = (HWo + kTilePix - 1) / kTilePix;
  const int n_tiles = a.B * tiles_per_img;
  const size_t img = (size_t)cv.C * cv.H * cv.W;
  const size_t offs_img = (size_t)2 * cv.G * cv.K * HWo;
  const size_t msk_img = (size_t)cv.G * cv.K * HWo;
  const int p = tid % kTilePix;
  const StoreColF32 store{col_s};

  for (int tile = slot; tile < n_tiles; tile += slots) {
    const Tile t(tile, tiles_per_img, cv);
    __syncthreads();  // the previous tile's dW loop is done
    const float* g_b = gout + (size_t)t.b * COUT * HWo + t.p0;
    for (int i = tid; i < COUT * kTilePix; i += kThreads) {
      const int o = i / kTilePix;
      const int px = i % kTilePix;
      g_s[o * kColStride + px] =
          t.p0 + px < HWo ? g_b[(size_t)o * HWo + px] : 0.f;
    }
    __syncthreads();
    {
      float acc[NI][4];
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;
      for (int o = 0; o < COUT; ++o) {
        const float4 gv =
            *reinterpret_cast<const float4*>(g_s + o * kColStride + quad * 4);
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          const float wv = w_s[o * NW + lane + 16 * i];
          acc[i][0] = fmaf(gv.x, wv, acc[i][0]);
          acc[i][1] = fmaf(gv.y, wv, acc[i][1]);
          acc[i][2] = fmaf(gv.z, wv, acc[i][2]);
          acc[i][3] = fmaf(gv.w, wv, acc[i][3]);
        }
      }
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          dcol_s[(quad * 4 + q) * (NW + 4) + lane + 16 * i] = acc[i][q];
    }
    __syncthreads();
    sample_tile<float, VW>(
        xg + t.b * img, dxa + t.b * img, offset + t.b * offs_img + t.pe,
        mask ? mask + t.b * msk_img + t.pe : nullptr,
        doffset + t.b * offs_img + t.pe,
        dmask ? dmask + t.b * msk_img + t.pe : nullptr, tab, n_units,
        dcol_s + p * (NW + 4), p, t.pvalid, t.oy, t.ox, cv, store);
    __syncthreads();
    for (int q = 0; q < kTilePix / 4; ++q) {
      float4 gv[NOC];
#pragma unroll
      for (int j = 0; j < NOC; ++j)
        gv[j] = *reinterpret_cast<const float4*>(
            g_s + (ol + 16 * j) * kColStride + q * 4);
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const float4 cv4 = *reinterpret_cast<const float4*>(
            col_s + (nl + 16 * i) * kColStride + q * 4);
#pragma unroll
        for (int j = 0; j < NOC; ++j) {
          acc_dw[j][i] = fmaf(cv4.x, gv[j].x, acc_dw[j][i]);
          acc_dw[j][i] = fmaf(cv4.y, gv[j].y, acc_dw[j][i]);
          acc_dw[j][i] = fmaf(cv4.z, gv[j].z, acc_dw[j][i]);
          acc_dw[j][i] = fmaf(cv4.w, gv[j].w, acc_dw[j][i]);
        }
      }
    }
  }

  float* part = dw_part + (size_t)blockIdx.x * COUT * kTaps * cv.C;
#pragma unroll
  for (int j = 0; j < NOC; ++j)
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int n = nl + 16 * i;
      const int kk = n / CP;
      const int c = n - kk * CP;
      if (kk < kt && c < cv.C)
        part[((size_t)(ol + 16 * j) * kTaps + kk) * cv.C + c] = acc_dw[j][i];
    }
}

// dxa (B, G, H, W, Cg) f32 -> dx (B, C, H, W) in T; then dW: for each
// (o, c, k), 8 lanes sum the partials of the blocks of k's tap group and
// write dweight (Cout, C, K) in T
template <typename T>
__global__ void finish_kernel(const float* __restrict__ dxa,
                              T* __restrict__ dx,
                              const float* __restrict__ dw_part,
                              T* __restrict__ dweight, int B, int G, int Cg,
                              int HW, int cout, int C, int K, int groups,
                              int slots, int vec4) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long start = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long total = (long long)B * G * HW;
  for (long long i = start; i < total; i += stride) {
    const long long bg = i / HW;
    T* dst = dx + bg * Cg * HW + (i - bg * HW);
    const float* src = dxa + i * Cg;
    if (vec4) {
      const float4 v = *reinterpret_cast<const float4*>(src);
      dst[0] = from_f<T>(v.x);
      dst[HW] = from_f<T>(v.y);
      dst[2 * (size_t)HW] = from_f<T>(v.z);
      dst[3 * (size_t)HW] = from_f<T>(v.w);
    } else {
      for (int c = 0; c < Cg; ++c) dst[(size_t)c * HW] = from_f<T>(src[c]);
    }
  }
  const long long n_dw = (long long)cout * C * K;
  const int l8 = threadIdx.x & 7;
  const unsigned lanes = 0xffu << (threadIdx.x & 24);
  for (long long i = start; i < n_dw * 8; i += stride) {
    const long long e = i >> 3;
    const int k = (int)(e % K);
    const int c = (int)((e / K) % C);
    const int o = (int)(e / ((long long)K * C));
    const int tg = k / kTaps;
    const size_t at = ((size_t)o * kTaps + (k - tg * kTaps)) * C + c;
    const size_t slice = (size_t)cout * kTaps * C;
    float s = 0.f;
    for (int q = l8; q < slots; q += 8)
      s += dw_part[(size_t)(q * groups + tg) * slice + at];
    s += __shfl_xor_sync(lanes, s, 4);
    s += __shfl_xor_sync(lanes, s, 2);
    s += __shfl_xor_sync(lanes, s, 1);
    if (l8 == 0) dweight[e] = from_f<T>(s);
  }
}

// ---- launches ----------------------------------------------------------------

bool aligned(const void* p, size_t n) {
  return reinterpret_cast<uintptr_t>(p) % n == 0;
}

// Sets the kernel's shared memory and returns the grid: tap groups x
// slots, at most `max_slots` blocks a tap group, no more than there are
// tiles, as many as fit on the card.
template <class K>
cudaError_t persistent_grid(K kernel, size_t smem, const Args& a,
                            int max_slots, int* grid) {
  *grid = 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  const int n_tiles = a.B * ((a.Ho * a.Wo + kTilePix - 1) / kTilePix);
  int slots = device_attr(cudaDevAttrMultiProcessorCount) *
              (per_sm > 0 ? per_sm : 1) / a.tap_groups;
  if (slots > n_tiles) slots = n_tiles;
  if (slots > max_slots) slots = max_slots;
  if (slots < 1) slots = 1;
  *grid = slots * a.tap_groups;
  return cudaSuccess;
}

// The main kernels' pointer arguments
struct Bufs {
  const void *xg, *offset, *mask, *weight, *gout;
  float* dxa;
  void *doffset, *dmask;
  float* dw_part;
};

template <typename T, class K>
cudaError_t launch_main(K kernel, size_t smem, const Bufs& p, const Args& a,
                        int max_slots, int vec_gout, int* grid,
                        cudaStream_t s) {
  if (smem > (size_t)device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin))
    return cudaErrorInvalidValue;
  cudaError_t err = persistent_grid(kernel, smem, a, max_slots, grid);
  if (err != cudaSuccess) return err;
  kernel<<<*grid, kThreads, smem, s>>>(
      static_cast<const T*>(p.xg), static_cast<const T*>(p.offset),
      static_cast<const T*>(p.mask), static_cast<const T*>(p.weight),
      static_cast<const T*>(p.gout), p.dxa, static_cast<T*>(p.doffset),
      static_cast<T*>(p.dmask), p.dw_part, a, vec_gout);
  return cudaGetLastError();
}

template <int CP>
cudaError_t launch_bf16(bool vec4, const Bufs& p, const Args& a,
                        int max_slots, int vec_gout, int* grid,
                        cudaStream_t s) {
  const size_t smem = bf16_layout(CP, a.Cout, a.G * kTaps).total;
  return vec4 ? launch_main<bf16>(dcn_bwd_bf16_kernel<CP, 4>, smem, p, a,
                                  max_slots, vec_gout, grid, s)
              : launch_main<bf16>(dcn_bwd_bf16_kernel<CP, 1>, smem, p, a,
                                  max_slots, vec_gout, grid, s);
}

template <int CP, int NOC>
cudaError_t launch_f32(bool vec4, const Bufs& p, const Args& a, int max_slots,
                       int* grid, cudaStream_t s) {
  const size_t smem = f32_layout(CP, NOC * 16, a.G * kTaps).total;
  return vec4 ? launch_main<float>(dcn_bwd_f32_kernel<CP, NOC, 4>, smem, p,
                                   a, max_slots, 0, grid, s)
              : launch_main<float>(dcn_bwd_f32_kernel<CP, NOC, 1>, smem, p,
                                   a, max_slots, 0, grid, s);
}

template <int CP>
cudaError_t launch_f32_cout(bool vec4, const Bufs& p, const Args& a,
                            int max_slots, int* grid, cudaStream_t s) {
  switch (a.Cout) {
    case 16: return launch_f32<CP, 1>(vec4, p, a, max_slots, grid, s);
    case 32: return launch_f32<CP, 2>(vec4, p, a, max_slots, grid, s);
    case 48: return launch_f32<CP, 3>(vec4, p, a, max_slots, grid, s);
    default: return launch_f32<CP, 4>(vec4, p, a, max_slots, grid, s);
  }
}

template <typename T>
cudaError_t run_all(const void* x, void* xg, const void* offset,
                    const void* mask, const void* weight, const void* gout,
                    void* dx, void* doffset, void* dmask, void* dweight,
                    float* dxa, float* dw_part, int max_slots, const Args& a,
                    cudaStream_t s) {
  const int Cg = a.C / a.G;
  const int HW = a.H * a.W;
  const int sms = device_attr(cudaDevAttrMultiProcessorCount);
  // 0. the channels-last copy of x and the zeroed dx accumulator
  const long long items = (long long)a.B * a.G * HW;
  const bool vec4 = Cg % 4 == 0 && aligned(xg, 4 * sizeof(T)) &&
                    aligned(dxa, 16);
  if (items > 0) {
    long long blocks = (items + 255) / 256;
    if (blocks > 16LL * sms) blocks = 16LL * sms;
    prep_kernel<T><<<(unsigned)blocks, 256, 0, s>>>(
        static_cast<const T*>(x), static_cast<T*>(xg), dxa, a.B, a.G, Cg, HW,
        Cg == 4 && vec4 ? 1 : 0);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  // 1. the main kernel, for C padded to 16, 32, 48 or 64
  const Bufs p{xg, offset, mask, weight, gout, dxa, doffset, dmask, dw_part};
  const int cp = (a.C + 15) & ~15;
  int grid = 0;
  cudaError_t err = cudaErrorInvalidValue;
  if constexpr (sizeof(T) == 2) {
    const int vg = (a.Ho * a.Wo) % 8 == 0 && aligned(gout, 16);
    switch (cp) {
      case 16: err = launch_bf16<16>(vec4, p, a, max_slots, vg, &grid, s); break;
      case 32: err = launch_bf16<32>(vec4, p, a, max_slots, vg, &grid, s); break;
      case 48: err = launch_bf16<48>(vec4, p, a, max_slots, vg, &grid, s); break;
      case 64: err = launch_bf16<64>(vec4, p, a, max_slots, vg, &grid, s); break;
    }
  } else {
    switch (cp) {
      case 16: err = launch_f32_cout<16>(vec4, p, a, max_slots, &grid, s); break;
      case 32: err = launch_f32_cout<32>(vec4, p, a, max_slots, &grid, s); break;
      case 48: err = launch_f32_cout<48>(vec4, p, a, max_slots, &grid, s); break;
      case 64: err = launch_f32_cout<64>(vec4, p, a, max_slots, &grid, s); break;
    }
  }
  if (err != cudaSuccess) return err;
  // 2. dx to NCHW in T, the dW partials summed into dweight
  const long long dw_threads = 8LL * a.Cout * a.C * a.kh * a.kw;
  const long long need = items > dw_threads ? items : dw_threads;
  long long blocks = (need + 255) / 256;
  if (blocks > 16LL * sms) blocks = 16LL * sms;
  if (blocks < 1) blocks = 1;
  finish_kernel<T><<<(unsigned)blocks, 256, 0, s>>>(
      dxa, static_cast<T*>(dx), dw_part, static_cast<T*>(dweight), a.B, a.G,
      Cg, HW, a.Cout, a.C, a.kh * a.kw, a.tap_groups, grid / a.tap_groups,
      Cg == 4 && vec4 ? 1 : 0);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, x_grouped, offset, mask, weight,
// gout and the four gradients share it). Scratch the caller allocates, none
// of it initialised: x_grouped of x's size and type; dx_acc, float32 of x's
// element count; dw_part, float32 of dw_slots * Cout * C * 3 * ceil(K / 3)
// elements (the kernel uses at most dw_slots blocks a tap group of 3 taps).
// mask and dmask may be null together (DCNv1). max_offset <= 0: exact, no
// clamp. Returns a cudaError_t; cudaErrorInvalidValue for a shape the
// kernels do not take (C > 64, Cout not 16/32/48/64, groups not dividing C,
// too much shared memory).
extern "C" int fami_dcn_bwd(const void* x, void* x_grouped,
                            const void* offset, const void* mask,
                            const void* weight, const void* gout, void* dx,
                            void* doffset, void* dmask, void* dweight,
                            void* dx_acc, void* dw_part, int dw_slots,
                            int dtype, int B, int C, int H, int W, int Cout,
                            int Ho, int Wo, int kh, int kw, int pad, int dil,
                            int groups, float max_offset, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (groups < 1 || C % groups != 0 || C > 64 || dw_slots < 1 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (Cout != 16 && Cout != 32 && Cout != 48 && Cout != 64)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.B = B; a.C = C; a.H = H; a.W = W; a.Ho = Ho; a.Wo = Wo; a.kh = kh;
  a.kw = kw; a.pad = pad; a.dil = dil; a.G = groups; a.Cout = Cout;
  a.tap_groups = (kh * kw + kTaps - 1) / kTaps; a.dmax = max_offset;
  float* dxa = static_cast<float*>(dx_acc);
  float* part = static_cast<float*>(dw_part);
  if (dtype == 0)
    return (int)run_all<float>(x, x_grouped, offset, mask, weight, gout, dx,
                               doffset, dmask, dweight, dxa, part, dw_slots,
                               a, s);
  return (int)run_all<bf16>(x, x_grouped, offset, mask, weight, gout, dx,
                            doffset, dmask, dweight, dxa, part, dw_slots, a,
                            s);
}
