// The int8 convolution of the serving path (TPU.INT8_EVAL) in two
// hand-written kernels: a quantize pass that writes an int8 channels-last
// copy of the input, then an s8 implicit-GEMM conv on the tensor cores with
// the dequant in its epilogue (ops/int8_conv.py::int8_conv2d).
//
// Replaces no Pallas kernel: the JAX package's int8 convolution is XLA's s8
// conv_general_dilated with preferred_element_type=int32
// (fami_pose_tpu/models/quant.py:102-111, QuantConv in mode "int8"); XLA
// fuses the quantize into the convolution's input and the dequant into its
// epilogue. Both kernels follow QuantConv's arithmetic bit for bit:
//
//   fami_int8_quant_nhwc - xq = clip(rint(x_f32 * (1 / act_scale)), -127,
//     127) as int8, read from NCHW x (f32 or bf16) once and written as
//     (B, H, W, Cp), the channels zero-padded to Cp, a multiple of 16 (the
//     stem's 3 become 16). Each element is quantized once.
//   fami_int8_implicit_gemm - acc = conv(xq, kq), exact in s32, with the
//     reduction index K in (ky, kx, c) order, Cp channels a tap, zero-padded
//     to a multiple of 32 (sums of integers are exact in any order); then
//     y = float(acc) * (w_scale[n] * act_scale), the product of the two
//     scales formed first, + bias[n] in f32, rounded once to the output
//     type and written NCHW. A tap outside the image is a zero, the
//     quantized zero JAX pads with.
//
// Every multiply and add is an explicit _rn intrinsic, so nvcc fuses nothing
// into an FMA (its default --fmad=true would), and the reciprocal is
// __frcp_rn, the IEEE quotient 1 / s that XLA and torch compute. act_scale is
// read from device memory, so a forward has no host synchronisation and can
// be captured in a CUDA graph.
//
// What bounds them on an H100 (3.35 TB/s; 1,979 dense int8 TOP/s): the
// quantize pass reads x once and writes one byte an element, bound by
// bytes. The conv reads the int8 copy and the packed weight and writes the
// output: over one B=8 W48 forward (307 convs) ~2.4 ms of bytes against
// ~1.45 ms of int8 operations, so bytes set the bound there too, except at
// the 12x9 branch (384 channels), where the operations do. The route they
// replace (an int8 im2col matrix written to device memory, a cuBLASLt s8
// product, a dequant pass over s32 sums) moved ~9x the input's bytes for a
// 3x3 twice and the s32 sums twice; here neither reaches device memory.
//
// Design.
//   quant_nhwc_kernel - a block quantizes 64 consecutive pixels of every
//     channel into a byte tile in shared memory (each load of a warp: 32
//     consecutive pixels of one channel), then writes the tile, 64 * Cp
//     contiguous bytes of the copy, in 128-byte warp stores. A pixel is
//     decoded once, by a multiply and a shift (FastDiv). Writing whole
//     lines matters where the copy outgrows the L2 (256 channels at
//     96x72): 16-byte stores a (pixel, chunk) left sectors half written.
//   igemm_kernel<T, NT> - persistent blocks of two warpgroups. Block (x, y)
//     copies N tile y's packed weights (NT x Kp, at most kWeightBudget: N
//     is cut into as many tiles as that needs, 384 x 3x3 x 384 into twelve
//     of 32) into shared memory once, then walks the M tiles x, x +
//     gridDim.x, ... of 128 output pixels (64 a warpgroup, wgmma's M). K
//     runs over 16-byte chunks (tap, 16 channels) in stages of 8 chunks
//     through a cp.async ring of kStages stages that streams across tile
//     boundaries (the next tile's copies run during this tile's
//     epilogue). Each chunk of A is one 16-byte cp.async from the int8
//     NHWC copy through the L1 (a 3x3 reads each pixel up to 9 times), its
//     address a row offset decoded once a tile plus the chunk's offset
//     from a table; a tap outside the image, a row past M or K padding is
//     zero-filled (src-size 0, from the copy's first byte). A and B sit in
//     the no-swizzle K-major core-matrix layout ([chunk][row] 16 bytes),
//     eight lanes on eight consecutive rows of one chunk, so a warp's
//     copies fill four whole 128-byte lines of shared memory. Each stage is
//     four wgmma.m64nNTk32.s32.s8.s8 a warpgroup (a tile's first sets the
//     accumulators, scale-d 0), left running while the next stage's
//     barrier passes and its copies start (wait_group 1). The
//     epilogue dequantizes from the s32 registers and stores NCHW (eight
//     lanes write 16 consecutive bytes of one channel).
//   What the first versions taught (each timed in turns with
//   chip_smoke.py's device_ms, summed over a B=8 forward, H100 80GB HBM3
//   at 700 W): one warpgroup a tile with the weights streamed each K
//   stage (39.7 ms) spent half its time on those weight copies; keeping
//   them resident (30.7), two warpgroups a tile with a multiply-shift
//   division (25.1), the tiled quantize pass (24.4) and the table-offset
//   addressing through the L1 (20.0) each bought 3-23%; 4 ring stages
//   beat 6 by 3% (more blocks a SM), and a shared-memory-staged epilogue
//   with 4- and 8-byte stores lost 4%. A later form for the stride-1 convs
//   (each channel chunk's halo box loaded once by TMA, each tap's A read
//   in place by wgmma from a descriptor start 16 bytes apart, the weights
//   streamed by TMA, a loader warp and two consumer warpgroups on
//   mbarriers) gave the same bits and, in turns with this kernel
//   (tools/int8_turns.py), 13.15 ms a forward against 14.38: 2.3x faster
//   at the 12x9 branch, 1.2x at 24x18, slower at 96x72 and at every 1x1.
//   Its epilogue, these same NCHW stores from the accumulators, took the
//   largest share of its time. Not kept (PERF.md).
//
// Measured (chip_smoke.py phase int8, the same card): over the 307 int8
// convs of a B=8 W48 forward, the quantize pass 4.75 ms (bound 2.34,
// bytes) and the implicit GEMM 14.33 (bound 2.45, bytes), the conv 19.5
// against the im2col route's 54.9 in turns, torch._int_mm alone on the
// same products 12.9 and cuDNN's bf16 convs 21.1; at 48 -> 48 channels,
// 3x3, 40 frames of 96x72: 0.0242 + 0.0493 ms (bounds 0.0119 each), the
// conv 0.078 against cuDNN bf16's 0.135. What sets the GEMM's time is the
// gather of A, one 16-byte request a chunk and row (removing those copies
// halved it); the 12x9 branch's narrow N tiles (32) read A twelve times.
// Build (nvcc 12.9, -Xptxas -v, sm_90a): igemm_kernel 66 (NT 48) to 178
// (NT 256) registers, quant_nhwc_kernel 32, no spills; 4 IGMMA a stage in
// every instance.
// Host side: each launch asks the runtime for the shared-memory limit,
// the blocks a SM and the SM count; a variant that kept them per kernel,
// device and size took the same host time a conv in turns (under 1 us of
// the ~24 us of a small conv's two launches), so they are asked each time.

#include "dcn_common.cuh"

namespace {

// QuantConv's activation quantization of one value, as a byte
__device__ __forceinline__ uint32_t quant8(float v, float inv) {
  float q = rintf(__fmul_rn(v, inv));  // round half to even
  q = fminf(fmaxf(q, -127.f), 127.f);
  return (uint32_t)(uint8_t)(int8_t)(int)q;
}

// n / d for 0 <= n < 2^31 by a multiply and a shift (Granlund and
// Montgomery): m = ceil(2^(31 + l) / d), l = ceil(log2 d), so that
// floor(n * m / 2^(31 + l)) = floor(n / d); m < 2^32.
struct FastDiv {
  uint32_t m;
  int l;
  int d;
};

FastDiv fast_div(int d) {
  int l = 0;
  while ((1LL << l) < d) ++l;
  const unsigned long long m = ((1ULL << (31 + l)) + d - 1) / d;
  return FastDiv{(uint32_t)m, l, d};
}

__device__ __forceinline__ int divide(int n, const FastDiv& f) {
  return f.l == 0 ? n : (int)(__umulhi((uint32_t)n, f.m) >> (f.l - 1));
}

// ---- the quantize pass ------------------------------------------------------

constexpr int kQuantThreads = 256;
constexpr int kQuantPixels = 64;  // pixels a block

// x (B, C, H, W) -> out (B, H, W, Cp): a block quantizes 64 consecutive
// pixels (flattened b * H * W + p) of every channel into a byte tile in
// shared memory ([pixel][Cp + 4]: a warp's byte stores, 32 pixels of one
// channel, fall in 32 banks), then writes the tile, 64 * Cp contiguous
// bytes of the copy, as 4-byte words: each load of a warp reads 32
// consecutive pixels of one channel, each store 128 contiguous bytes.
template <typename T>
__global__ void __launch_bounds__(kQuantThreads)
    quant_nhwc_kernel(const T* __restrict__ x,
                      const float* __restrict__ act_scale,
                      int8_t* __restrict__ out, int P, int C, FastDiv hw,
                      int Cp, FastDiv words) {
  extern __shared__ __align__(16) unsigned char tile[];
  const int stride = Cp + 4;
  const int m0 = blockIdx.x * kQuantPixels;
  const int tid = threadIdx.x;
  const int px = tid % kQuantPixels;  // this thread's pixel, in every pass
  const int m = m0 + px;
  const T* src = x;
  if (m < P) {
    const int b = divide(m, hw);
    src = x + (long long)b * C * hw.d + (m - b * hw.d);
  }
  const float inv = __frcp_rn(*act_scale);
#pragma unroll 8
  for (int c = tid / kQuantPixels; c < Cp; c += kQuantThreads / kQuantPixels)
    tile[px * stride + c] = (uint8_t)(
        m < P && c < C ? quant8(to_f(src[(long long)c * hw.d]), inv) : 0u);
  __syncthreads();
  const int n = min(kQuantPixels, P - m0) * words.d;  // words.d = Cp / 4
  uint32_t* dst = reinterpret_cast<uint32_t*>(out + (long long)m0 * Cp);
  for (int w = tid; w < n; w += kQuantThreads) {
    const int r = divide(w, words);
    dst[w] = *reinterpret_cast<const uint32_t*>(
        tile + r * stride + (w - r * words.d) * 4);
  }
}

template <typename T>
cudaError_t launch_quant(const void* x, const float* act_scale, int8_t* out,
                         int P, int C, int HW, int Cp, cudaStream_t s) {
  const size_t smem = (size_t)kQuantPixels * (Cp + 4);
  if (smem > (size_t)device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin))
    return cudaErrorInvalidValue;
  auto kernel = quant_nhwc_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)((P + kQuantPixels - 1) / kQuantPixels);
  kernel<<<blocks, kQuantThreads, smem, s>>>(static_cast<const T*>(x),
                                            act_scale, out, P, C,
                                            fast_div(HW), Cp,
                                            fast_div(Cp / 4));
  return cudaGetLastError();
}

// ---- the implicit GEMM ------------------------------------------------------

constexpr int kRows = 128;       // output pixels a tile: 64 a warpgroup
constexpr int kThreads = 256;    // two warpgroups
constexpr int kStageChunks = 8;  // 16-byte K chunks a stage: 4 k32 steps
constexpr int kStageBytes = kStageChunks * kRows * 16;
constexpr int kStages = 4;       // the cp.async ring of A
constexpr int kAhead = kStages - 2;  // items loaded ahead of the one read
// the most shared memory the resident weight tile (NT x Kp) may take; N is
// cut into tiles narrow enough to fit
constexpr size_t kWeightBudget = 112 * 1024;
constexpr int kWidths[] = {32, 48, 64, 96, 128, 192, 256};  // s8 wgmma N

struct Geo {
  int H, W, Cp, kh, kw, sh, sw, ph, pw, dh, dw, Ho, Wo, N, Np, Kc;
  int M, m_tiles;  // Kc = Kp / 16 chunks, m_tiles = ceil(M / kRows)
  FastDiv hwo, wo;
};

// Byte offsets of the dynamic shared memory: the weight tile ([Kc chunks,
// rounded up to whole stages][NT][16 B], resident; the chunks past Kc
// zero), the ring of A stages ([8 chunks][128 rows][16 B] each), the K
// chunks' table (int4: dy, dx, the chunk's byte offset from its row's
// top-left pixel, unused; K padding: dy far outside the image; whole
// stages), the N tile's scales and bias.
struct Layout {
  size_t ring, ctab, cols, total;
};

__host__ __device__ inline int whole_stages(int kc) {
  return (kc + kStageChunks - 1) / kStageChunks;
}

__host__ __device__ inline Layout igemm_layout(int nt, int kc) {
  const size_t chunks = (size_t)whole_stages(kc) * kStageChunks;
  Layout l;
  l.ring = align128(chunks * nt * 16);
  l.ctab = l.ring + (size_t)kStages * kStageBytes;
  l.cols = l.ctab + align128(chunks * 16);
  l.total = l.cols + align128((size_t)nt * 8);
  return l;
}

// 16 bytes global -> shared, the bytes past src_bytes zero; the weights
// through the L2 only (cg), the activations through the L1 too (ca): the
// taps of a tile's rows read each input pixel up to kh * kw times
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async16_l1(void* smem, const void* gmem,
                                              int src_bytes) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The A rows one thread copies in every stage of a tile: rows (tid & 7) +
// 8 * ((tid >> 6) + 4 i), i < 4, of chunk (tid >> 3) & 7 (eight lanes on
// eight consecutive rows of one chunk, so a warp's copies fill four whole
// 128-byte lines of shared memory), each decoded once a tile: its top-left
// input pixel (iy, ix; far outside the image past M) and that pixel's byte
// offset in the copy (a chunk adds its table entry's offset).
struct Rows {
  long long off[4];
  int iy[4], ix[4];
  __device__ __forceinline__ void decode(const Geo& g, int tile, int tid) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = tile * kRows + (tid & 7) + 8 * ((tid >> 6) + 4 * i);
      off[i] = 0;
      iy[i] = ix[i] = -(1 << 29);
      if (m < g.M) {
        const int b = divide(m, g.hwo);
        const int p = m - b * g.Ho * g.Wo;
        const int oy = divide(p, g.wo);
        iy[i] = oy * g.sh - g.ph;
        ix[i] = (p - oy * g.Wo) * g.sw - g.pw;
        off[i] = ((long long)b * g.H * g.W + (long long)iy[i] * g.W + ix[i]) *
                 g.Cp;
      }
    }
  }
};

// Persistent blocks: block (x, y) keeps N tile y's weights resident in
// shared memory and walks the M tiles x, x + gridDim.x, ...; its A stages
// stream through one ring across tile boundaries, so the next tile's loads
// run while this tile's epilogue stores. Warpgroup w takes rows 64 w ..
// 64 w + 63 of each tile.
template <typename T, int NT>
__global__ void __launch_bounds__(kThreads)
    igemm_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ wp,
                 const float* __restrict__ w_scale,
                 const float* __restrict__ act_scale,
                 const float* __restrict__ bias, T* __restrict__ out, Geo g) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int kst = whole_stages(g.Kc);  // stages a tile
  const int kc = kst * kStageChunks;   // chunks, whole stages
  const Layout L = igemm_layout(NT, g.Kc);
  unsigned char* b_s = smem;
  unsigned char* ring = smem + L.ring;
  int4* ctab = reinterpret_cast<int4*>(smem + L.ctab);
  float* col_scale = reinterpret_cast<float*>(smem + L.cols);
  float* col_bias = col_scale + NT;
  const int tid = threadIdx.x;
  const int n0 = blockIdx.y * NT;
  const int HWo = g.Ho * g.Wo;
  const int first = blockIdx.x;
  if (first >= g.m_tiles) return;
  const int items = (g.m_tiles - first + gridDim.x - 1) / gridDim.x * kst;

  const int cpt = g.Cp >> 4;  // chunks a tap
  for (int q = tid; q < kc; q += kThreads) {
    const int tap = q / cpt;
    int4 e = make_int4(1 << 29, 0, 0, 0);
    if (q < g.Kc && tap < g.kh * g.kw) {
      const int ky = tap / g.kw;
      const int dy = ky * g.dh, dx = (tap - ky * g.kw) * g.dw;
      e = make_int4(dy, dx, (dy * g.W + dx) * g.Cp + (q - tap * cpt) * 16, 0);
    }
    ctab[q] = e;
  }
  for (int j = tid; j < NT; j += kThreads) {
    const int n = n0 + j;
    // the two scales' product first, as QuantConv forms it
    col_scale[j] = n < g.N ? __fmul_rn(w_scale[n], *act_scale) : 0.f;
    col_bias[j] = n < g.N && bias != nullptr ? bias[n] : 0.f;
  }
  // the weight tile, once: rows past Np and chunks past Kc are zero
  // (src-size 0)
  const size_t kp = (size_t)g.Kc * 16;
  for (int idx = tid; idx < NT * kc; idx += kThreads) {
    const int n = (idx & 7) + 8 * (idx / (8 * kc));
    const int q = (idx >> 3) % kc;
    const bool ok = n0 + n < g.Np && q < g.Kc;
    cp_async16(b_s + (size_t)q * (NT * 16) + n * 16,
               ok ? wp + (size_t)(n0 + n) * kp + (size_t)q * 16 : wp,
               ok ? 16 : 0);
  }
  __syncthreads();  // the chunk table

  // the loader: item i is stage i % kst of this block's tile i / kst
  const int jj = (tid >> 3) & 7;
  Rows rows;
  int ld_tile = first, ld_k = 0, ld_item = 0, ld_slot = 0;
  rows.decode(g, ld_tile, tid);
  auto load_next = [&]() {
    if (ld_item < items) {
      unsigned char* a_s = ring + (size_t)ld_slot * kStageBytes;
      const int4 e = ctab[ld_k * kStageChunks + jj];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = (tid & 7) + 8 * ((tid >> 6) + 4 * i);
        const bool ok = (unsigned)(rows.iy[i] + e.x) < (unsigned)g.H &&
                        (unsigned)(rows.ix[i] + e.y) < (unsigned)g.W;
        cp_async16_l1(a_s + jj * (kRows * 16) + r * 16,
                      ok ? xq + (rows.off[i] + e.z) : xq, ok ? 16 : 0);
      }
      if (++ld_k == kst) {
        ld_k = 0;
        ld_tile += gridDim.x;
        if (ld_item + 1 < items) rows.decode(g, ld_tile, tid);
      }
      ++ld_item;
      ld_slot = ld_slot + 1 == kStages ? 0 : ld_slot + 1;
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };
#pragma unroll 1
  // the weights ride in the first group
  for (int s = 0; s < kAhead; ++s) load_next();

  int acc[NT / 2];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) acc[i] = 0;  // before any wgmma
  const int wg = tid >> 7;
  const int mr = wg * 64 + ((tid & 127) >> 5) * 16 + ((tid & 31) >> 2);
  const int nc = 2 * (tid & 3);  // fragment columns 8j + nc (+1), rows mr, +8
  const bool with_bias = bias != nullptr;
  int tile = first, k = 0, slot = 0;
  for (int item = 0; item < items; ++item) {
    cp_async_wait<kAhead - 1>();  // this thread's copies of this item
    fence_proxy_async();          // visible to wgmma (the async proxy)
    __syncthreads();  // every thread's copies of this item have landed, and
                      // the wgmma of two items back (each warpgroup waited
                      // for it) is done
    load_next();      // into the slot that item read
    const uint64_t da = make_desc(ring + (size_t)slot * kStageBytes +
                                      wg * 64 * 16, kRows * 16, 128);
    const uint64_t db =
        make_desc(b_s + (size_t)k * kStageChunks * NT * 16, NT * 16, 128);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < kStageChunks / 2; ++t)  // two chunks a k32 step;
      wgmma_s8<NT>(acc, da + (uint64_t)(t * 2 * kRows),  // a tile's first
                   db + (uint64_t)(t * 2 * NT), k > 0 || t > 0);  // sets acc
    wgmma_commit();
    slot = slot + 1 == kStages ? 0 : slot + 1;
    if (++k < kst) {
      // the previous item's products are done, this one's run on; nothing
      // but wgmma touches acc until the tile's last item
      wgmma_wait1();
      continue;
    }
    wgmma_wait0();
    fence_acc(acc);

    // the tile's epilogue, from the accumulator registers: dequant, one
    // rounding, NCHW stores (eight lanes write 16 consecutive bytes of one
    // channel, the other half of each 32-byte sector the same warp's next
    // store)
    k = 0;
    long long o[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = tile * kRows + mr + 8 * h;
      o[h] = -1;
      if (m < g.M) {
        const int b = divide(m, g.hwo);
        o[h] = (long long)b * g.N * HWo + (m - b * HWo);
      }
    }
#pragma unroll
    for (int j = 0; j < NT / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int n = 8 * j + nc + (h & 1);
        const long long oo = o[h >> 1];
        if (oo >= 0 && n0 + n < g.N) {
          float y = __fmul_rn(__int2float_rn(acc[4 * j + h]), col_scale[n]);
          if (with_bias) y = __fadd_rn(y, col_bias[n]);
          out[oo + (long long)(n0 + n) * HWo] = from_f<T>(y);
        }
      }
    }
    tile += gridDim.x;
  }
  cp_async_wait<0>();
}

// The N tile: the widest wgmma width whose weight tile fits
// kWeightBudget, then the narrowest width that covers N in as many tiles.
// 0 where none fits.
int tile_n(int N, int Kp, int* tiles) {
  int widest = 0;
  for (int v : kWidths)
    if ((size_t)v * Kp <= kWeightBudget) widest = v;
  if (N <= 0 || widest == 0) return 0;
  *tiles = (N + widest - 1) / widest;
  const int w = (N + *tiles - 1) / *tiles;
  for (int v : kWidths)
    if (v >= w) return v;
  return 0;
}

template <typename T, int NT>
cudaError_t launch_igemm(const void* xq, const void* wp, const float* w_scale,
                         const float* act_scale, const float* bias, void* out,
                         const Geo& g, int tiles, cudaStream_t s) {
  const size_t smem = igemm_layout(NT, g.Kc).total;
  if (smem > (size_t)device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin))
    return cudaErrorInvalidValue;
  auto kernel = igemm_kernel<T, NT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  // enough blocks to fill the card once, shared out over the N tiles
  long long bx = (long long)device_attr(cudaDevAttrMultiProcessorCount) *
                 (per_sm > 0 ? per_sm : 1) / tiles;
  if (bx < 1) bx = 1;
  if (bx > g.m_tiles) bx = g.m_tiles;
  kernel<<<dim3((unsigned)bx, (unsigned)tiles), kThreads, smem, s>>>(
      static_cast<const int8_t*>(xq), static_cast<const int8_t*>(wp), w_scale,
      act_scale, bias, static_cast<T*>(out), g);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_igemm(int nt, const void* xq, const void* wp,
                           const float* ws, const float* sc, const float* bs,
                           void* out, const Geo& g, int tiles,
                           cudaStream_t s) {
  switch (nt) {
    case 32: return launch_igemm<T, 32>(xq, wp, ws, sc, bs, out, g, tiles, s);
    case 48: return launch_igemm<T, 48>(xq, wp, ws, sc, bs, out, g, tiles, s);
    case 64: return launch_igemm<T, 64>(xq, wp, ws, sc, bs, out, g, tiles, s);
    case 96: return launch_igemm<T, 96>(xq, wp, ws, sc, bs, out, g, tiles, s);
    case 128: return launch_igemm<T, 128>(xq, wp, ws, sc, bs, out, g, tiles, s);
    case 192: return launch_igemm<T, 192>(xq, wp, ws, sc, bs, out, g, tiles, s);
    case 256: return launch_igemm<T, 256>(xq, wp, ws, sc, bs, out, g, tiles, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x (B, C, H, W) f32 or bf16 (dtype 0 / 1), act_scale one f32 on the card,
// out (B, H, W, Cp) int8, Cp = C rounded up to a multiple of 16
extern "C" int fami_int8_quant_nhwc(const void* x, const void* act_scale,
                                    void* out, int dtype, int B, int C, int H,
                                    int W, int Cp, void* stream) {
  const long long P = (long long)B * H * W;
  if (P <= 0 || P > 0x7fffffffLL || C <= 0 || Cp % 16 != 0 || Cp < C ||
      Cp - C >= 16)
    return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* sc = static_cast<const float*>(act_scale);
  auto* o = static_cast<int8_t*>(out);
  if (dtype == 0)
    return (int)launch_quant<float>(x, sc, o, (int)P, C, H * W, Cp, s);
  if (dtype == 1)
    return (int)launch_quant<bf16>(x, sc, o, (int)P, C, H * W, Cp, s);
  return (int)cudaErrorInvalidValue;
}

// xq (B, H, W, Cp) int8 (fami_int8_quant_nhwc), wp (Np, Kp) int8 (the packed
// weight: K = kh * kw * Cp in (ky, kx, c) order, Kp = K rounded up to a
// multiple of 32, Np = N rounded up to a multiple of 16), w_scale (N,) f32,
// act_scale one f32, bias (N,) f32 or null, out (B, N, Ho, Wo) f32 or bf16
// (dtype 0 / 1)
extern "C" int fami_int8_implicit_gemm(
    const void* xq, const void* wp, const void* w_scale, const void* act_scale,
    const void* bias, void* out, int dtype, int B, int H, int W, int Cp,
    int kh, int kw, int sh, int sw, int ph, int pw, int dh, int dw, int Ho,
    int Wo, int N, int Np, int Kp, void* stream) {
  const long long M = (long long)B * Ho * Wo;
  const long long K = (long long)kh * kw * Cp;
  if (N <= 0 || Np != (N + 15) / 16 * 16 || M <= 0 || M > 0x7fffffffLL ||
      (long long)B * H * W > 0x7fffffffLL || Cp <= 0 || Cp % 16 != 0 ||
      K <= 0 || Kp != (K + 31) / 32 * 32 || sh <= 0 || sw <= 0 || dh <= 0 ||
      dw <= 0 || ph < 0 || pw < 0 || (dtype != 0 && dtype != 1) ||
      // a chunk's offset from its row's top-left pixel is an int
      ((long long)(kh - 1) * dh * W + (long long)(kw - 1) * dw + 1) * Cp >
          0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  int tiles = 0;
  const int nt = tile_n(N, Kp, &tiles);
  if (nt == 0 || tiles > 65535) return (int)cudaErrorInvalidValue;
  const Geo g{H,      W,  Cp, kh, kw, sh, sw, ph, pw, dh, dw, Ho, Wo, N, Np,
              Kp / 16, (int)M, (int)((M + kRows - 1) / kRows),
              fast_div(Ho * Wo), fast_div(Wo)};
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* ws = static_cast<const float*>(w_scale);
  const auto* sc = static_cast<const float*>(act_scale);
  const auto* bs = static_cast<const float*>(bias);
  if (dtype == 0)
    return (int)dispatch_igemm<float>(nt, xq, wp, ws, sc, bs, out, g, tiles,
                                      s);
  return (int)dispatch_igemm<bf16>(nt, xq, wp, ws, sc, bs, out, g, tiles, s);
}
