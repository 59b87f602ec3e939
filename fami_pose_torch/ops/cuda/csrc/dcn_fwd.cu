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
// for any C >= 1 with C % G == 0 and any Cout >= 1. No bias inside: the
// wrapper adds it, as the TPU kernel's caller does.
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
// Design (launches on the caller's stream, counted as one DCN call):
//   0. grouped_channels_last_kernel copies x (B, C, H, W) to a scratch
//      buffer in (B, G, H, W, Cg) order, so that the Cg channels of one
//      group at one corner are one vector load (8 bytes for Cg = 4 in
//      bf16) and the two x-neighbouring corners of a sample share a 32-byte
//      sector; the samples of one tile and group fall in a ~12 KB window
//      that L1 keeps while the block walks the group's taps.
//   1. dcn_fwd_bf16_kernel, the resident form (bf16, Cout in {16, 32, 48,
//      64} and the reduction k*C + c at most kResidentRows = 576 rows: the
//      main path's widths, unchanged since the wgmma redesign): persistent
//      blocks of 256 threads, two a SM at the main-path shape (~109 KB of
//      shared memory each), walk tiles of 64 output pixels of one image. W is
//      staged once per block in bf16 as the wgmma B operand, [k*C + c] x
//      Cout, K-major in the no-swizzle core-matrix layout (8 rows x 16 bytes
//      per core matrix), beside a table of the gather's units (group, tap,
//      4-channel chunk) so that the sample loop does no integer division.
//      All 256 threads sample a tile into the A operand, 64 pixels x (k*C +
//      c) in bf16, the same layout, zero-padded in k to a multiple of 16: 4
//      units in flight a thread, each reading its offsets and mask from
//      device memory, its 4 corners as 8-byte loads, and writing the 4
//      channels of its column as one 8-byte store. Each warpgroup then runs
//      ceil(9C / 16) wgmma.m64n(Cout/2)k16 steps for its half of the output
//      channels (bf16 x bf16 -> f32 in registers), stages the f32 result in
//      shared memory [o][64], and all threads write NCHW rows of 64 pixels
//      with 16-byte stores, rounding once to bf16. The other block on the SM
//      samples while one contracts. (A form of it that rounded Cout up to
//      16 and masked its stores was 3.6% slower at B=8 in turns, PERF.md:
//      other widths take the chunked form instead.)
//      A 2-stage cp.async ring for the tile's offsets and mask (83 KB) was
//      measured and dropped: it allows one block a SM, and the kernel was
//      14% (B=8) and 19% (B=32) slower with it.
//   2. Every other width (bf16 with another Cout or more than 576
//      reduction rows, and every float32 call) takes the chunked forms,
//      whose shared memory does not grow with C or Cout. pack_kernel first
//      writes W into a workspace, cut into (Cout tile, chunk) blocks of
//      kChunkRows = 128 consecutive reduction rows by NT columns (bf16:
//      NT = 64 in the wgmma B layout; f32: NT = Cout rounded up to 16, at
//      most 64, [r][o]), each block zero past C and Cout, so that a chunk's
//      W is one straight 16-byte copy; and the table of gather units in
//      reduction order (r = k*C + c, VW channels a unit), which the kernels
//      read through L1. A work item is (image, 64-pixel tile, split): the
//      split's chunks of the reduction. Where pixel tiles are few (the
//      branch maps: 16 tiles at 12x9, B = 8), the reduction is cut into as
//      many splits as fill two waves of two blocks an SM (make_plan); each
//      split writes an f32 partial of the output and sum_kernel adds the
//      splits' partials in split order and rounds once (no float
//      atomics). Before, an item was (tile, Cout tile) walking every chunk
//      in sequence: 96 items for 264 block slots at C = 384, 12x9, each a
//      chain of 27 chunks, and each Cout tile sampled the column again.
//      dcn_fwd_bf16_chunked_kernel (one Cout tile; two blocks an SM,
//      82,944 B): two column and two W buffers; while the wgmma of chunk q
//      run asynchronously on one pair, all threads copy W's chunk q + 1
//      and sample the column chunk q + 1 into the other, then wait; the
//      accumulators stay in registers across the split's chunks.
//      dcn_fwd_bf16_staged_kernel (more than one Cout tile, the same
//      82,944 B): the item's chunks, at most kStagedChunks = 2, are
//      sampled once into the two column buffers, then every Cout tile is
//      contracted from them, W's blocks streaming through the two W
//      buffers (the next copied while the wgmma of this one run), so a
//      pixel is sampled once whatever Cout is.
//      dcn_fwd_f32_kernel (float32 inputs: the card-vs-CPU checks): the
//      same items, W's chunk and the column chunk [r][64] in f32 shared
//      memory, contracted on the CUDA cores with full-f32 FMAs (each thread
//      4 pixels x NT/16 channels); with more than one Cout tile an item
//      holds one chunk, sampled once for every Cout tile; TF32 would miss
//      the 1e-4 tolerance of those checks.
//   The copy of x for Cg != 4 runs a thread an element (a thread a pixel
//   looping over Cg channels left 864 threads at C = 384, 12x9, B = 8).
// Numerics (bf16): the column s * mask is rounded to bf16 once, the products
// are exact in the tensor cores and summed in f32, the output rounded once.
// The column's rounding moves the f32 sum by ~0.3 of the ulp of the largest
// output (tests/test_torch_dcn_numerics.py), so one bf16 column (no hi/lo
// pair) keeps the kernel within one output ulp of the plain version.
//
// Build (-Xptxas -v, sm_90a): dcn_fwd_bf16_kernel<48, 4> 123 registers, 0
// spills, 111,616 B of dynamic shared memory at the main-path shape (2
// blocks a SM), 8 HGMMA.64x24x16.F32.BF16 in its SASS. Every instance of
// this form (chip_smoke.py phase build): the resident form 96-123
// registers, the chunked and staged bf16 forms 112-128, sum_kernel 32, the
// f32 forms 63-162, no spills but dcn_fwd_f32_kernel<3, 4> (128 registers,
// 24 bytes stored and loaded; the f32 check path's C_out 33-48).
// On an H100 80GB HBM3 at 700 W (chip_smoke.py): 0.0886 ms at B=8, D = 4,
// against the 0.0139 ms bound; the branch maps' chunked forms in turns
// with the form before the cut (tools/dcn_turns.py, PERF.md): at B=8,
// exact, C = 96 / 192 / 384 on 48x36 / 24x18 / 12x9 maps, one and two
// groups, the six calls took 0.4755-0.4772 ms against 0.9875-0.9918.

#include "dcn_common.cuh"

namespace {

constexpr int kTilePix = 64;   // output pixels per tile: wgmma's M
constexpr int kThreads = 256;  // two warpgroups, each a wgmma issuer
constexpr int kUnroll = 4;     // samples a thread keeps in flight
constexpr int kEpiStride = kTilePix + 4;  // f32 result rows, bank-spread
constexpr int kPixPerThread = 4;          // f32 contraction: 4 pixels
constexpr int kPixGroups = kTilePix / kPixPerThread;  // 16
constexpr int kOcGroups = kThreads / kPixGroups;      // 16
constexpr int kResidentRows = 576;  // the resident form's widest reduction
constexpr int kChunkRows = 128;     // reduction rows of one chunk
constexpr int kChunkNT = 64;        // the bf16 chunked form's Cout tile

// Byte offsets of the bf16 kernel's dynamic shared memory: B operand (W),
// A operand (the sampled column), the f32 result tile, the table of gather
// units (16 bytes each).
struct BfLayout {
  size_t w, a, epi, tab, total;
};

__host__ __device__ inline BfLayout bf16_layout(int Rp, int nt, int units) {
  BfLayout l;
  l.w = 0;
  l.a = align128((size_t)Rp * nt * 2);
  l.epi = l.a + align128((size_t)Rp * kTilePix * 2);
  l.tab = l.epi + align128((size_t)nt * kEpiStride * 4);
  l.total = l.tab + align128((size_t)units * 16);
  return l;
}

// bf16 chunked kernel: two column buffers, two W buffers, the result tile
constexpr size_t kChunkA = (size_t)kChunkRows * kTilePix * 2;
constexpr size_t kChunkW = (size_t)kChunkRows * kChunkNT * 2;
constexpr size_t kChunkSmem = 2 * kChunkA + 2 * kChunkW +
                              (size_t)kChunkNT * kEpiStride * 4;

// f32 kernel: W's chunk [r][nt] and the column chunk [r][64] in f32
__host__ __device__ inline size_t f32_smem(int nt) {
  return (size_t)kChunkRows * (nt + kTilePix) * 4;
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

__host__ __device__ inline int tap_shift(int k, int kw, int dil, int pad) {
  const int ky = k / kw;
  const int kx = k - ky * kw;
  return ((ky * dil - pad) << 16) | ((kx * dil - pad) & 0xffff);
}

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
    tab[u] = make_int4(k * cv.C + g * cv.Cg + j * VW,
                       g * cv.H * cv.W * cv.Cg + j * VW, 2 * gk * cv.HWo,
                       tap_shift(k, cv.kw, cv.dil, cv.pad));
  }
}

// Samples units [0, n_units) of `tab` for one tile into the column, at row
// e.x - r0. Thread t takes pixel t % 64 and the units t / 64, t / 64 + 4,
// ..., kUnroll units at a time: their corner loads are issued together,
// then blended. off and msk point at this thread's pixel in the image's
// first offset and mask row; msk null means no mask. A pixel past the image
// reads the tile's first pixel's offsets and gets weight 0.
template <typename T, int VW, class Store>
__device__ __forceinline__ void sample_tile(
    const T* __restrict__ xg, const T* __restrict__ off,
    const T* __restrict__ msk, const int4* tab, int n_units, int r0, int p,
    bool pvalid, int oy, int ox, const Conv& cv, const Store& store) {
  constexpr int kStep = kThreads / kTilePix;
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
      rr[q] = e.x - r0;
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

// x (B, C, H, W) -> xg (B, G, H, W, Cg): 4 channels a thread where Cg is 4,
// else one element a thread (in dcn_bwd.cu's copy, a thread a pixel with Cg
// channels took 135 us at C = 384, 12x9, B = 8: 864 threads; PERF.md)
template <typename T>
__global__ void grouped_channels_last_kernel(const T* __restrict__ x,
                                             T* __restrict__ xg, int B, int G,
                                             int Cg, int HW, int vec4) {
  if (!vec4) {  // one element a thread, the stores consecutive in c
    const long long n = (long long)B * G * HW * Cg;
    for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         e < n; e += (long long)gridDim.x * blockDim.x) {
      const long long i = e / Cg;  // (b, g, pixel)
      const int c = (int)(e - i * Cg);
      const long long bg = i / HW;
      xg[e] = x[(bg * Cg + c) * HW + (i - bg * HW)];
    }
    return;
  }
  const long long total = (long long)B * G * HW;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const long long bg = i / HW;
    const T* src = x + bg * Cg * HW + (i - bg * HW);
    T* dst = xg + i * Cg;
    // Cg == 4: one 8-byte (bf16) or 16-byte (f32) store
    if constexpr (sizeof(T) == 2) {
      const uint16_t* s16 = reinterpret_cast<const uint16_t*>(src);
      *reinterpret_cast<uint2*>(dst) = make_uint2(
          (uint32_t)s16[0] | ((uint32_t)s16[HW] << 16),
          (uint32_t)s16[2 * (size_t)HW] | ((uint32_t)s16[3 * (size_t)HW] << 16));
    } else {
      *reinterpret_cast<float4*>(dst) = make_float4(
          src[0], src[HW], src[2 * (size_t)HW], src[3 * (size_t)HW]);
    }
  }
}

struct Args {
  int B, C, H, W, Ho, Wo, kh, kw, pad, dil, G, Cout;
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

// The chunked form's plan for one call: Cout tile, tiles, chunks, how the
// reduction is cut across work items, and the workspace (the unit table,
// the packed W, then the f32 partial sums of the cut). A work item is
// (64-pixel tile, split): the split's chunks q0 .. q0 + cpi. With one Cout
// tile (n_ct == 1) an item streams its chunks; with more (staged) it
// samples its chunks once, at most kStagedChunks (bf16) or 1 (f32), and
// contracts every Cout tile from them. The splits are as many as it takes
// for the items to fill kItemWaves waves of two blocks an SM (a serial
// chain of chunks a tile left most SMs idle at the branch maps, PERF.md),
// no fewer than the staged chunks need; with more than one split each
// writes its f32 partial of the output and sum_kernel adds them in split
// order.
struct Plan {
  int resident, nt, n_ct, n_chunks, splits, cpi;
  size_t units_bytes, w_bytes, part_bytes;
};

constexpr int kStagedChunks = 2;  // the bf16 staged item's column buffers
constexpr int kItemWaves = 2;

__host__ __device__ inline Plan make_plan(int dtype, int B, int C, int Cout,
                                          int HWo, int K, int sms) {
  Plan pl;
  const int R = K * C;
  const int c16 = (Cout + 15) & ~15;
  pl.resident = dtype == 1 && Cout % 16 == 0 && Cout <= 64 &&
                ((R + 15) & ~15) <= kResidentRows;
  pl.nt = pl.resident ? Cout : dtype == 1 ? kChunkNT : (c16 < 64 ? c16 : 64);
  pl.n_ct = (Cout + pl.nt - 1) / pl.nt;
  pl.n_chunks = (R + kChunkRows - 1) / kChunkRows;
  const long long tiles = (long long)B * ((HWo + kTilePix - 1) / kTilePix);
  const long long want = (long long)kItemWaves * 2 * sms;
  long long splits = tiles > 0 ? (want + tiles - 1) / tiles : 1;
  if (pl.n_ct > 1) {
    const int most = dtype == 1 ? kStagedChunks : 1;
    const long long fewest = (pl.n_chunks + most - 1) / most;
    if (splits < fewest) splits = fewest;
  }
  if (splits > pl.n_chunks) splits = pl.n_chunks;
  if (splits < 1) splits = 1;
  pl.cpi = (pl.n_chunks + (int)splits - 1) / (int)splits;
  pl.splits = pl.resident ? 1 : (pl.n_chunks + pl.cpi - 1) / pl.cpi;
  // one unit a reduction row at most (VW = 1)
  pl.units_bytes = pl.resident ? 0 : align128((size_t)R * 16);
  pl.w_bytes = pl.resident ? 0
                           : align128((size_t)pl.n_ct * pl.n_chunks *
                                      kChunkRows * pl.nt *
                                      (dtype == 1 ? 2 : 4));
  pl.part_bytes =
      pl.splits > 1 ? align128((size_t)pl.splits * B * Cout * HWo * 4) : 0;
  return pl;
}

// W (Cout, C, K) -> wp, blocks of (Cout tile ct, chunk q), each kChunkRows
// x nt: in the wgmma B layout (core = 1: element (r / 8) * nt * 8 + o * 8 +
// r % 8) or [r][o] (core = 0); zero past R and Cout. Then the unit table in
// reduction order: unit u is row r = u * VW.
template <typename T>
__global__ void pack_kernel(const T* __restrict__ weight, T* __restrict__ wp,
                            int4* __restrict__ units, Args a, int nt,
                            int n_ct, int n_chunks, int vw, int core) {
  const int K = a.kh * a.kw;
  const int C = a.C;
  const int R = K * C;
  const int Cg = C / a.G;
  const int HWo = a.Ho * a.Wo;
  const long long blk = (long long)kChunkRows * nt;
  const long long n_w = (long long)n_ct * n_chunks * blk;
  const long long n_u = R / vw;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_w + n_u; i += (long long)gridDim.x * blockDim.x) {
    if (i < n_w) {
      const long long bi = i / blk;
      const int e = (int)(i - bi * blk);
      const int ct = (int)(bi / n_chunks);
      const int q = (int)(bi - (long long)ct * n_chunks);
      int rr, o;
      if (core) {
        const int r8 = e / (nt * 8);
        const int rem = e - r8 * nt * 8;
        o = rem >> 3;
        rr = r8 * 8 + (rem & 7);
      } else {
        rr = e / nt;
        o = e - rr * nt;
      }
      const int r = q * kChunkRows + rr;
      const int oo = ct * nt + o;
      float v = 0.f;
      if (r < R && oo < a.Cout) {
        const int k = r / C;
        const int c = r - k * C;
        v = to_f(weight[((size_t)oo * C + c) * K + k]);
      }
      wp[i] = from_f<T>(v);
    } else {
      const int u = (int)(i - n_w);
      const int r = u * vw;
      const int k = r / C;
      const int c = r - k * C;
      const int g = c / Cg;
      units[u] = make_int4(r, g * a.H * a.W * Cg + (c - g * Cg),
                           2 * (g * K + k) * HWo,
                           tap_shift(k, a.kw, a.dil, a.pad));
    }
  }
}

// The geometry of one 64-pixel tile for this thread's pixel
struct Tile {
  int b, p0, oy, ox, pe;
  bool pvalid;
  __device__ __forceinline__ Tile(int pt, int tiles_per_img, const Conv& cv,
                                  int p) {
    b = pt / tiles_per_img;
    p0 = (pt - b * tiles_per_img) * kTilePix;
    const int pix = p0 + p;
    pvalid = pix < cv.HWo;
    oy = pvalid ? pix / cv.Wo : 0;
    ox = pvalid ? pix - oy * cv.Wo : 0;
    pe = p0 + (pvalid ? p : 0);
  }
};

// Writes the f32 result tile epi [n][kEpiStride] (n < nt) as bf16 NCHW rows
// of output channels o0 + n < Cout: 16-byte stores of 8 pixels where the
// rows allow, else one pixel at a time.
__device__ __forceinline__ void store_tile(const float* epi, bf16* out_b,
                                           int nt, int n_valid, int p0,
                                           int HWo, int vec_out) {
  const int tid = threadIdx.x;
  if (vec_out) {  // 8 pixels a thread, one 16-byte store
    for (int e = tid; e < nt * 8; e += kThreads) {
      const int n = e >> 3;
      const int q = (e & 7) * 8;
      if (p0 + q >= HWo || n >= n_valid) continue;
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
    for (int e = tid; e < nt * kTilePix; e += kThreads) {
      const int n = e / kTilePix;
      const int q = e % kTilePix;
      if (p0 + q < HWo && n < n_valid)
        out_b[(size_t)n * HWo + q] = __float2bfloat16_rn(epi[n * kEpiStride + q]);
    }
  }
}

// A warpgroup's m64n(NT/2) accumulator fragment -> epi [n][kEpiStride]:
// rows warp*16 + lane/4 (+8), columns 8j + 2*(lane%4) (+1) of its half
template <int NH>
__device__ __forceinline__ void acc_to_epi(float* epi, const float (&acc)[NH / 2]) {
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
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
                          tab, cv.GK * (cv.Cg / VW), 0, p, pvalid, oy, ox, cv,
                          store);
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

// A f32 result tile epi [n][kEpiStride] (n < n_valid) -> a split's f32
// partial of the output, rows of 64 pixels
__device__ __forceinline__ void store_part(const float* epi, float* part_b,
                                           int nt, int n_valid, int p0,
                                           int HWo) {
  for (int e = threadIdx.x; e < nt * kTilePix; e += kThreads) {
    const int n = e / kTilePix;
    const int q = e % kTilePix;
    if (p0 + q < HWo && n < n_valid)
      part_b[(size_t)n * HWo + q] = epi[n * kEpiStride + q];
  }
}

// The reduction's cut as the kernels see it: splits of cpi chunks; part
// holds the splits' f32 partials (null with one split)
struct Cut {
  int splits, cpi;
  float* part;
};

// The output tile of Cout tile ct: bf16 rows of out with one split, else
// this split's partial
__device__ __forceinline__ void put_tile(const float* epi, bf16* out,
                                         const Cut& cut, int sp, const Args& a,
                                         const Tile& t, int ct, int nt) {
  const int HWo = a.Ho * a.Wo;
  const size_t at = ((size_t)t.b * a.Cout + ct * nt) * HWo + t.p0;
  if (cut.splits == 1)
    store_tile(epi, out + at, nt, a.Cout - ct * nt, t.p0, HWo, a.vec_out);
  else
    store_part(epi, cut.part + (size_t)sp * a.B * a.Cout * HWo + at, nt,
               a.Cout - ct * nt, t.p0, HWo);
}

// Every other bf16 width with one Cout tile: chunks of kChunkRows reduction
// rows, a work item a (pixel tile, split), two buffers (module comment)
template <int VW>
__global__ void __launch_bounds__(kThreads, 2)
    dcn_fwd_bf16_chunked_kernel(const bf16* __restrict__ xg,
                                const bf16* __restrict__ offset,
                                const bf16* __restrict__ mask,
                                const bf16* __restrict__ wp,
                                const int4* __restrict__ units,
                                bf16* __restrict__ out, Args a, Cut cut) {
  constexpr int NT = kChunkNT;
  constexpr int NH = NT / 2;
  constexpr int kChunkElems = kChunkRows * NT;
  extern __shared__ __align__(128) unsigned char smem[];
  const Conv cv = make_conv(a);
  const int R = cv.K * cv.C;
  const int n_chunks = (R + kChunkRows - 1) / kChunkRows;
  unsigned char* const a_s[2] = {smem, smem + kChunkA};
  unsigned char* const w_s[2] = {smem + 2 * kChunkA,
                                 smem + 2 * kChunkA + kChunkW};
  float* epi = reinterpret_cast<float*>(smem + 2 * kChunkA + 2 * kChunkW);
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int p = tid % kTilePix;
  const int HWo = cv.HWo;
  const int tiles_per_img = (HWo + kTilePix - 1) / kTilePix;
  const int n_items = a.B * tiles_per_img * cut.splits;
  const size_t img = (size_t)cv.C * cv.H * cv.W;
  const bf16 zero = __ushort_as_bfloat16(0);
  constexpr int ct = 0;  // one Cout tile

  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int sp = item % cut.splits;
    const int q0 = sp * cut.cpi;
    const int q1 = min(q0 + cut.cpi, n_chunks);
    const Tile t(item / cut.splits, tiles_per_img, cv, p);
    const bf16* xb = xg + t.b * img;
    const bf16* offb = offset + (size_t)t.b * 2 * cv.GK * HWo + t.pe;
    const bf16* mskb = mask ? mask + (size_t)t.b * cv.GK * HWo + t.pe : nullptr;
    const bf16* wct = wp + (size_t)ct * n_chunks * kChunkElems;

    // W's chunk q and the column chunk q into buffer `buf`; the rows past
    // the reduction up to the next 16 zero
    auto stage = [&](int q, int buf) {
      const uint4* src = reinterpret_cast<const uint4*>(wct + (size_t)q * kChunkElems);
      uint4* dst = reinterpret_cast<uint4*>(w_s[buf]);
      for (int i = tid; i < kChunkElems / 8; i += kThreads) dst[i] = __ldg(src + i);
      const int r0 = q * kChunkRows;
      const int rows = min(kChunkRows, R - r0);
      sample_tile<bf16, VW>(xb, offb, mskb, units + r0 / VW, rows / VW, r0, p,
                            t.pvalid, t.oy, t.ox, cv, StoreA{a_s[buf]});
      const int pad = ((rows + 15) & ~15) - rows;
      for (int i = tid; i < pad * kTilePix; i += kThreads) {
        const int r = rows + i / kTilePix;
        *reinterpret_cast<bf16*>(a_s[buf] + (r >> 3) * (kTilePix * 16) +
                                 (i % kTilePix) * 16 + (r & 7) * 2) = zero;
      }
    };

    // the buffers were last read by the previous tile's wgmma, waited for
    // before the barrier that ended its last chunk
    stage(q0, 0);
    fence_proxy_async();  // the stores, visible to wgmma
    __syncthreads();
    float acc[NH / 2];
#pragma unroll
    for (int j = 0; j < NH / 2; ++j) acc[j] = 0.f;
    for (int q = q0; q < q1; ++q) {
      const int buf = (q - q0) & 1;
      const int steps = (min(kChunkRows, R - q * kChunkRows) + 15) / 16;
      fence_acc(acc);
      wgmma_fence();
      const uint64_t da = make_desc(a_s[buf], kTilePix * 16, 128);
      const uint64_t db = make_desc(w_s[buf] + wg * NH * 16, NT * 16, 128);
      for (int s = 0; s < steps; ++s)
        wgmma_bf16<NH>(acc, da + (uint64_t)(s * 2 * kTilePix),
                       db + (uint64_t)(s * 2 * NT));
      wgmma_commit();
      // the next chunk into the other buffers while these wgmma run
      if (q + 1 < q1) stage(q + 1, buf ^ 1);
      wgmma_wait0();
      fence_acc(acc);
      fence_proxy_async();
      __syncthreads();
    }
    acc_to_epi<NH>(epi, acc);
    __syncthreads();
    put_tile(epi, out, cut, sp, a, t, ct, NT);
  }
}

// bf16 with more than one Cout tile: a work item (pixel tile, split) samples
// its (at most kStagedChunks) chunks once into the column buffers, then for
// each Cout tile contracts them against W's blocks, which stream through
// the two W buffers (the next one copied while the wgmma of this one run),
// and writes the tile
template <int VW>
__global__ void __launch_bounds__(kThreads, 2)
    dcn_fwd_bf16_staged_kernel(const bf16* __restrict__ xg,
                               const bf16* __restrict__ offset,
                               const bf16* __restrict__ mask,
                               const bf16* __restrict__ wp,
                               const int4* __restrict__ units,
                               bf16* __restrict__ out, Args a, Cut cut) {
  constexpr int NT = kChunkNT;
  constexpr int NH = NT / 2;
  constexpr int kChunkElems = kChunkRows * NT;
  extern __shared__ __align__(128) unsigned char smem[];
  const Conv cv = make_conv(a);
  const int R = cv.K * cv.C;
  const int n_chunks = (R + kChunkRows - 1) / kChunkRows;
  const int n_ct = (a.Cout + NT - 1) / NT;
  unsigned char* const a_s[kStagedChunks] = {smem, smem + kChunkA};
  unsigned char* const w_s[2] = {smem + 2 * kChunkA,
                                 smem + 2 * kChunkA + kChunkW};
  float* epi = reinterpret_cast<float*>(smem + 2 * kChunkA + 2 * kChunkW);
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int p = tid % kTilePix;
  const int HWo = cv.HWo;
  const int tiles_per_img = (HWo + kTilePix - 1) / kTilePix;
  const int n_items = a.B * tiles_per_img * cut.splits;
  const size_t img = (size_t)cv.C * cv.H * cv.W;
  const bf16 zero = __ushort_as_bfloat16(0);

  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int sp = item % cut.splits;
    const int q0 = sp * cut.cpi;
    const int nq = min(cut.cpi, n_chunks - q0);
    const Tile t(item / cut.splits, tiles_per_img, cv, p);
    const bf16* xb = xg + t.b * img;
    const bf16* offb = offset + (size_t)t.b * 2 * cv.GK * HWo + t.pe;
    const bf16* mskb = mask ? mask + (size_t)t.b * cv.GK * HWo + t.pe : nullptr;
    // W's block (Cout tile ct, chunk q0 + j) into W buffer `buf`
    auto copy_w = [&](int i, int buf) {
      const int ct = i / nq;
      const int q = q0 + i - ct * nq;
      const uint4* src = reinterpret_cast<const uint4*>(
          wp + ((size_t)ct * n_chunks + q) * kChunkElems);
      uint4* dst = reinterpret_cast<uint4*>(w_s[buf]);
      for (int e = tid; e < kChunkElems / 8; e += kThreads) dst[e] = __ldg(src + e);
    };
    // the previous item's wgmma and epilogue are done with every buffer
    __syncthreads();
    for (int j = 0; j < nq; ++j) {
      const int r0 = (q0 + j) * kChunkRows;
      const int rows = min(kChunkRows, R - r0);
      sample_tile<bf16, VW>(xb, offb, mskb, units + r0 / VW, rows / VW, r0, p,
                            t.pvalid, t.oy, t.ox, cv, StoreA{a_s[j]});
      const int pad = ((rows + 15) & ~15) - rows;
      for (int i = tid; i < pad * kTilePix; i += kThreads) {
        const int r = rows + i / kTilePix;
        *reinterpret_cast<bf16*>(a_s[j] + (r >> 3) * (kTilePix * 16) +
                                 (i % kTilePix) * 16 + (r & 7) * 2) = zero;
      }
    }
    copy_w(0, 0);
    fence_proxy_async();  // the stores, visible to wgmma
    __syncthreads();
    const int n_steps = n_ct * nq;
    for (int ct = 0, i = 0; ct < n_ct; ++ct) {
      float acc[NH / 2];
#pragma unroll
      for (int e = 0; e < NH / 2; ++e) acc[e] = 0.f;
      for (int j = 0; j < nq; ++j, ++i) {
        const int buf = i & 1;
        const int rows = min(kChunkRows, R - (q0 + j) * kChunkRows);
        const int steps = (rows + 15) / 16;
        fence_acc(acc);
        wgmma_fence();
        const uint64_t da = make_desc(a_s[j], kTilePix * 16, 128);
        const uint64_t db = make_desc(w_s[buf] + wg * NH * 16, NT * 16, 128);
        for (int s = 0; s < steps; ++s)
          wgmma_bf16<NH>(acc, da + (uint64_t)(s * 2 * kTilePix),
                         db + (uint64_t)(s * 2 * NT));
        wgmma_commit();
        // the next W block into the other buffer while these wgmma run
        if (i + 1 < n_steps) copy_w(i + 1, buf ^ 1);
        wgmma_wait0();
        fence_acc(acc);
        fence_proxy_async();
        __syncthreads();
      }
      acc_to_epi<NH>(epi, acc);
      __syncthreads();
      put_tile(epi, out, cut, sp, a, t, ct, NT);
      __syncthreads();  // epi is rewritten by the next Cout tile
    }
  }
}

// out = the splits' f32 partials summed in split order, rounded once
template <typename T>
__global__ void sum_kernel(const float* __restrict__ part, T* __restrict__ out,
                           int splits, long long total) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int sp = 0; sp < splits; ++sp) s += part[sp * total + i];
    out[i] = from_f<T>(s);
  }
}

// float32, any width: the work items of the bf16 forms, contracted with
// full-f32 FMAs. NOC = NT / 16 output channels a thread. With one Cout tile
// an item streams its chunks through one column buffer; with more, its one
// chunk (the plan's cpi) is sampled once and every Cout tile contracted
// from it.
template <int NOC, int VW>
__global__ void __launch_bounds__(kThreads)
    dcn_fwd_f32_kernel(const float* __restrict__ xg,
                       const float* __restrict__ offset,
                       const float* __restrict__ mask,
                       const float* __restrict__ wp,
                       const int4* __restrict__ units,
                       float* __restrict__ out, Args a, Cut cut) {
  constexpr int NT = NOC * kOcGroups;
  constexpr int kChunkElems = kChunkRows * NT;
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);  // [r][NT]
  float* col = w_s + kChunkElems;                // [r][kTilePix]
  const Conv cv = make_conv(a);
  const int R = cv.K * cv.C;
  const int n_chunks = (R + kChunkRows - 1) / kChunkRows;
  const int n_ct = (a.Cout + NT - 1) / NT;
  const int HWo = cv.HWo;
  const int tiles_per_img = (HWo + kTilePix - 1) / kTilePix;
  const int n_items = a.B * tiles_per_img * cut.splits;
  const size_t img = (size_t)cv.C * cv.H * cv.W;
  const int p = threadIdx.x % kTilePix;
  const int pg = threadIdx.x % kPixGroups;
  const int og = threadIdx.x / kPixGroups;
  const StoreCol store{col};

  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int sp = item % cut.splits;
    const int q0 = sp * cut.cpi;
    const int q1 = min(q0 + cut.cpi, n_chunks);
    const Tile t(item / cut.splits, tiles_per_img, cv, p);
    float* dst = cut.splits == 1
                     ? out + (size_t)t.b * a.Cout * HWo
                     : cut.part + ((size_t)sp * a.B + t.b) * a.Cout * HWo;
    for (int ct = 0; ct < n_ct; ++ct) {
      const float* wct = wp + (size_t)ct * n_chunks * kChunkElems;
      float acc[NOC][kPixPerThread];
#pragma unroll
      for (int j = 0; j < NOC; ++j)
#pragma unroll
        for (int q = 0; q < kPixPerThread; ++q) acc[j][q] = 0.f;
      for (int q = q0; q < q1; ++q) {
        const int r0 = q * kChunkRows;
        const int rows = min(kChunkRows, R - r0);
        __syncthreads();  // the last contraction is done with both buffers
        const float4* src =
            reinterpret_cast<const float4*>(wct + (size_t)q * kChunkElems);
        float4* w4 = reinterpret_cast<float4*>(w_s);
        for (int i = threadIdx.x; i < rows * NT / 4; i += kThreads)
          w4[i] = __ldg(src + i);
        if (ct == 0)  // more than one Cout tile: one chunk, kept
          sample_tile<float, VW>(
              xg + t.b * img, offset + (size_t)t.b * 2 * cv.GK * HWo + t.pe,
              mask ? mask + (size_t)t.b * cv.GK * HWo + t.pe : nullptr,
              units + r0 / VW, rows / VW, r0, p, t.pvalid, t.oy, t.ox, cv,
              store);
        __syncthreads();
        const float* colp = col + pg * kPixPerThread;
        for (int r = 0; r < rows; ++r) {
          const float4 v =
              *reinterpret_cast<const float4*>(colp + (size_t)r * kTilePix);
          const float* wr = w_s + r * NT + og;
#pragma unroll
          for (int j = 0; j < NOC; ++j) {
            const float wv = wr[j * kOcGroups];
            acc[j][0] = fmaf(v.x, wv, acc[j][0]);
            acc[j][1] = fmaf(v.y, wv, acc[j][1]);
            acc[j][2] = fmaf(v.z, wv, acc[j][2]);
            acc[j][3] = fmaf(v.w, wv, acc[j][3]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < NOC; ++j) {
        const int o = ct * NT + og + j * kOcGroups;
        if (o >= a.Cout) continue;
#pragma unroll
        for (int q = 0; q < kPixPerThread; ++q) {
          const int px = t.p0 + pg * kPixPerThread + q;
          if (px < HWo) dst[(size_t)o * HWo + px] = acc[j][q];
        }
      }
    }
  }
}

// ---- launches ----------------------------------------------------------------

// Sets the kernel's shared memory and launches as many persistent blocks as
// fit on the card, no more than there are work items
template <class Kern, class... P>
cudaError_t launch_persistent(Kern kernel, size_t smem, int n_items,
                              cudaStream_t stream, P... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  int grid = device_attr(cudaDevAttrMultiProcessorCount) *
             (per_sm > 0 ? per_sm : 1);
  if (grid > n_items) grid = n_items;
  if (grid < 1) return cudaSuccess;
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

int n_pixel_tiles(const Args& a) {
  return a.B * ((a.Ho * a.Wo + kTilePix - 1) / kTilePix);
}

template <int COUT>
cudaError_t launch_resident(bool vec4, const void* xg, const void* offset,
                            const void* mask, const void* weight, void* out,
                            const Args& a, cudaStream_t s) {
  const int K = a.kh * a.kw;
  const int Rp = (K * a.C + 15) & ~15;
  const int units = a.G * K * (vec4 ? a.C / a.G / 4 : a.C / a.G);
  const size_t smem = bf16_layout(Rp, COUT, units).total;
  const bf16 *x = static_cast<const bf16*>(xg),
             *o = static_cast<const bf16*>(offset),
             *m = static_cast<const bf16*>(mask),
             *w = static_cast<const bf16*>(weight);
  bf16* y = static_cast<bf16*>(out);
  return vec4 ? launch_persistent(dcn_fwd_bf16_kernel<COUT, 4>, smem,
                                  n_pixel_tiles(a), s, x, o, m, w, y, a)
              : launch_persistent(dcn_fwd_bf16_kernel<COUT, 1>, smem,
                                  n_pixel_tiles(a), s, x, o, m, w, y, a);
}

template <int NOC>
cudaError_t launch_f32(bool vec4, const void* xg, const void* offset,
                       const void* mask, const void* wp, const int4* units,
                       void* out, const Args& a, const Cut& cut,
                       cudaStream_t s) {
  const float *x = static_cast<const float*>(xg),
              *o = static_cast<const float*>(offset),
              *m = static_cast<const float*>(mask),
              *w = static_cast<const float*>(wp);
  float* y = static_cast<float*>(out);
  const size_t smem = f32_smem(NOC * kOcGroups);
  const int items = n_pixel_tiles(a) * cut.splits;
  return vec4 ? launch_persistent(dcn_fwd_f32_kernel<NOC, 4>, smem, items, s,
                                  x, o, m, w, units, y, a, cut)
              : launch_persistent(dcn_fwd_f32_kernel<NOC, 1>, smem, items, s,
                                  x, o, m, w, units, y, a, cut);
}

template <typename T>
cudaError_t launch_sum(const Cut& cut, void* out, const Args& a,
                       cudaStream_t s) {
  const long long total = (long long)a.B * a.Cout * a.Ho * a.Wo;
  if (cut.splits == 1 || total == 0) return cudaSuccess;
  long long blocks = (total + 255) / 256;
  const long long cap =
      (long long)device_attr(cudaDevAttrMultiProcessorCount) * 16;
  if (blocks > cap) blocks = cap;
  sum_kernel<T><<<(unsigned)blocks, 256, 0, s>>>(cut.part,
                                                 static_cast<T*>(out),
                                                 cut.splits, total);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_transpose(const void* x, void* xg, const Args& a, int Cg,
                             cudaStream_t s) {
  const bool vec4 = Cg == 4 && reinterpret_cast<uintptr_t>(xg) % (4 * sizeof(T)) == 0;
  // a thread (b, g, pixel) for Cg = 4, else a thread an element
  const long long total = (long long)a.B * a.G * a.H * a.W * (vec4 ? 1 : Cg);
  if (total == 0) return cudaSuccess;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  const long long cap =
      (long long)device_attr(cudaDevAttrMultiProcessorCount) * 16;
  if (blocks > cap) blocks = cap;
  grouped_channels_last_kernel<T><<<(unsigned)blocks, threads, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(xg), a.B, a.G, Cg,
      a.H * a.W, vec4 ? 1 : 0);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_pack(const void* weight, void* work, const Args& a,
                        const Plan& pl, int vw, cudaStream_t s) {
  const long long n = (long long)pl.w_bytes / sizeof(T) +
                      (long long)a.kh * a.kw * a.C / vw;
  long long blocks = (n + 255) / 256;
  const long long cap =
      (long long)device_attr(cudaDevAttrMultiProcessorCount) * 16;
  if (blocks > cap) blocks = cap;
  unsigned char* base = static_cast<unsigned char*>(work);
  pack_kernel<T><<<(unsigned)blocks, 256, 0, s>>>(
      static_cast<const T*>(weight),
      reinterpret_cast<T*>(base + pl.units_bytes),
      reinterpret_cast<int4*>(base), a, pl.nt, pl.n_ct, pl.n_chunks, vw,
      sizeof(T) == 2 ? 1 : 0);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Bytes of the workspace fami_dcn_fwd needs for this call on the current
// device (0 where the resident form takes it): the unit table, W packed in
// chunks, and where the reduction is cut across work items their f32
// partial sums.
extern "C" long long fami_dcn_fwd_workspace(int dtype, int B, int C, int Cout,
                                            int Ho, int Wo, int kh, int kw) {
  const Plan pl = make_plan(dtype, B, C, Cout, Ho * Wo, kh * kw,
                            device_attr(cudaDevAttrMultiProcessorCount));
  return (long long)(pl.units_bytes + pl.w_bytes + pl.part_bytes);
}

// dtype: 0 = float32, 1 = bfloat16 (x, x_grouped, offset, mask, weight and
// out share it). x_grouped is scratch of x's size: the kernel writes x there
// in (B, G, H, W, C/G) order and gathers from it. work is scratch of
// fami_dcn_fwd_workspace bytes, 16-byte aligned (null when that is 0). mask
// may be null (DCNv1: mask 1). max_offset <= 0: exact, no clamp. Returns a
// cudaError_t; cudaErrorInvalidValue for arguments no kernel takes (groups
// not dividing C, an unknown dtype, no channels).
extern "C" int fami_dcn_fwd(const void* x, void* x_grouped, const void* offset,
                            const void* mask, const void* weight, void* out,
                            void* work, int dtype, int B, int C, int H, int W,
                            int Cout, int Ho, int Wo, int kh, int kw, int pad,
                            int dil, int groups, float max_offset,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (groups < 1 || C < 1 || Cout < 1 || C % groups != 0 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.B = B; a.C = C; a.H = H; a.W = W; a.Ho = Ho; a.Wo = Wo; a.kh = kh;
  a.kw = kw; a.pad = pad; a.dil = dil; a.G = groups; a.Cout = Cout;
  a.dmax = max_offset;
  const int HWo = Ho * Wo;
  a.vec_out = HWo % 8 == 0 && aligned16(out);
  const int Cg = C / groups;
  const size_t elem = dtype == 0 ? 4 : 2;
  const bool vec4 =
      Cg % 4 == 0 && reinterpret_cast<uintptr_t>(x_grouped) % (4 * elem) == 0;
  const Plan pl = make_plan(dtype, B, C, Cout, HWo, kh * kw,
                            device_attr(cudaDevAttrMultiProcessorCount));
  if (!pl.resident && !aligned16(work)) return (int)cudaErrorInvalidValue;
  cudaError_t err = dtype == 0 ? launch_transpose<float>(x, x_grouped, a, Cg, s)
                               : launch_transpose<bf16>(x, x_grouped, a, Cg, s);
  if (err != cudaSuccess) return (int)err;
  if (pl.resident) {
    switch (pl.nt) {
      case 16: return (int)launch_resident<16>(vec4, x_grouped, offset, mask, weight, out, a, s);
      case 32: return (int)launch_resident<32>(vec4, x_grouped, offset, mask, weight, out, a, s);
      case 48: return (int)launch_resident<48>(vec4, x_grouped, offset, mask, weight, out, a, s);
      default: return (int)launch_resident<64>(vec4, x_grouped, offset, mask, weight, out, a, s);
    }
  }
  const int vw = vec4 ? 4 : 1;
  err = dtype == 0 ? launch_pack<float>(weight, work, a, pl, vw, s)
                   : launch_pack<bf16>(weight, work, a, pl, vw, s);
  if (err != cudaSuccess) return (int)err;
  unsigned char* base = static_cast<unsigned char*>(work);
  const int4* units = reinterpret_cast<const int4*>(base);
  const void* wp = base + pl.units_bytes;
  const Cut cut{pl.splits, pl.cpi,
                pl.splits > 1 ? reinterpret_cast<float*>(
                                    base + pl.units_bytes + pl.w_bytes)
                              : nullptr};
  if (dtype == 1) {
    const bf16 *xb = static_cast<const bf16*>(x_grouped),
               *ob = static_cast<const bf16*>(offset),
               *mb = static_cast<const bf16*>(mask),
               *wb = static_cast<const bf16*>(wp);
    bf16* yb = static_cast<bf16*>(out);
    const int items = n_pixel_tiles(a) * pl.splits;
    if (pl.n_ct > 1)
      err = vec4 ? launch_persistent(dcn_fwd_bf16_staged_kernel<4>,
                                     kChunkSmem, items, s, xb, ob, mb, wb,
                                     units, yb, a, cut)
                 : launch_persistent(dcn_fwd_bf16_staged_kernel<1>,
                                     kChunkSmem, items, s, xb, ob, mb, wb,
                                     units, yb, a, cut);
    else
      err = vec4 ? launch_persistent(dcn_fwd_bf16_chunked_kernel<4>,
                                     kChunkSmem, items, s, xb, ob, mb, wb,
                                     units, yb, a, cut)
                 : launch_persistent(dcn_fwd_bf16_chunked_kernel<1>,
                                     kChunkSmem, items, s, xb, ob, mb, wb,
                                     units, yb, a, cut);
    if (err != cudaSuccess) return (int)err;
    return (int)launch_sum<bf16>(cut, out, a, s);
  }
  switch (pl.nt) {
    case 16: err = launch_f32<1>(vec4, x_grouped, offset, mask, wp, units, out, a, cut, s); break;
    case 32: err = launch_f32<2>(vec4, x_grouped, offset, mask, wp, units, out, a, cut, s); break;
    case 48: err = launch_f32<3>(vec4, x_grouped, offset, mask, wp, units, out, a, cut, s); break;
    default: err = launch_f32<4>(vec4, x_grouped, offset, mask, wp, units, out, a, cut, s); break;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)launch_sum<float>(cut, out, a, s);
}
