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
// for any C >= 1 with C % G == 0 and any Cout >= 1. No bias: its gradient is
// a plain sum of gout outside the kernel, as on the TPU.
//
// The TPU form of dW / dmask / doffset (128-lane rows, group-minor channels,
// a loop over the (2D+1)^2 integer shifts of the hat window) is not carried
// over: here the offset is clamped and the 4 corners are touched directly,
// so that work does not grow with D. dx is _bwd_dx_kernel's gather (the
// owner computes): in windowed mode (D > 0) each dx element is the sum, in
// one fixed order, of the sources in its window,
//   dx(q) = sum over taps k, then d in [-R, R]^2 (row by row) of
//           [w_y w_x m dcol]_k(q - s_k - d),   s_k = k_pos * dil - pad,
// R = ceil(D); a source p contributes where q - (p + s_k) - floor(t) is a
// corner, in {0, 1}^2. The window is exact: floor(t) lies in [-R, R], and
// the corner at d = R + 1 needs t = D exactly, where its weight is 0
// (fami_pose_tpu/ops/pallas/dcn_bwd.py:47-55). No float atomics: every run
// gives the same dx, bit for bit, as the TPU kernel does. Windows up to
// kMaxGatherR = 31 px are taken; a wider one is refused
// (cudaErrorInvalidValue). The exact mode (no clamp) has no bounded window,
// so it gathers from lists: every source (group, tap, pixel) is keyed by the
// floor corner (y0, x0) of its sample, keys in [-1, H-1] x [-1, W-1] (the
// others cannot touch the image), and a two-level counting sort written
// here (the sources bucketed by tile of 16 x 16 keys, then each tile's by
// key, both stable, ranks taken within a warp by __match_any_sync, no
// atomics on the entries' places) gives every key one order whatever the
// threads' order. dx(q) sums the lists of its four candidate keys,
// (qy-1, qx-1), (qy-1, qx), (qy, qx-1), (qy, qx), in that order, each by
// ascending source index (ops/deform_conv.py::deform_conv2d_dx_sorted_plain
// is this order in PyTorch). No float atomics in either mode, and no
// library sort: both give the same dx on every run.
//
// What bounds it on an H100. At the main-path shape (B=8, 96x72, C=Cout=48,
// G=12, bf16) one call must move ~88 MB (offsets and doffset ~24 MB each,
// mask and dmask ~12 MB each, x, gout and dx ~5.3 MB each): ~26 us at
// 3.35 TB/s; its two contractions are ~4.6 GFLOP, ~5 us at the bf16
// tensor-core rate. So the bytes set the least time. What sets this
// kernel's time (PERF.md) is the issue of the sample loop's instructions
// (~1.9x the forward's a unit of 4 channels) and, for dx, the gather's
// hit-mask atomics and its walk's chains of shared-memory loads. Its
// float32 scratch of m * dcol (B * 9C * HWo floats: 95.6 MB at the main
// path, written once and read back) does not set its time: a image the
// gather gets cheaper from B = 4 (the scratch in L2) to B = 16 (through
// device memory). Forming dcol inside the gather instead, from gout's
// window staged in shared memory, was 1.6-5x slower: the copies and
// products it adds cost more than the scratch they replace (PERF.md).
//
// Design (launches on the caller's stream, counted as one call):
//   0. prep_kernel copies x (B, C, H, W) to a scratch buffer in grouped
//      channels-last order (B, G, H, W, Cg), as the forward does, so that
//      the Cg channels of one group at one corner are one vector load.
//   1. dcn_bwd_bf16_kernel: persistent blocks of 256 threads, two an SM at
//      the main-path shape. A block owns one work item (tap group, channel
//      chunk, Cout chunk) and walks 64-pixel tiles with it:
//        - the taps are cut into groups of 3 (the dW accumulators of all 9
//          would not fit in registers);
//        - the channels into chunks of at most 64 (padded to CP = 16, 32,
//          48 or 64 columns a tap): whole offset groups where a group has
//          at most 64 channels (C = 48, G = 12 on the main path is one
//          chunk), else 64-channel slices of one group;
//        - the output channels into chunks of 64 (one on the main path),
//          the M of the dW tile. In float32 an item also owns one Cout
//          chunk: only the block of the first forms dcol (all of Cout) and
//          writes the sampling side's outputs, the others sample their
//          column for their rows of dW alone. In bf16 with more than one
//          Cout chunk (the split form: C_out past 64, the deform blocks at
//          HRNet-W48's narrower branches) an item owns them all: its block
//          forms dcol, samples the column once and stores it (the 64 x 3CP
//          bf16 tile as it lies in shared memory), and dw_split_kernel
//          contracts each Cout chunk's dW from the stored columns. Its two
//          gout buffers are one (107,648 B a block at CP = 64, not 115,840:
//          two blocks an SM).
//      Where Cout <= 64 the block stages its slice of W (3 taps: Cout x
//      3CP, bf16) once as the wgmma B operand, else one 64-row chunk of it
//      at a time, beside a table of its gather units (group, tap). For each
//      tile:
//        a. the gout tile is staged in bf16: [pixel][o] (the A operand of
//           dcol, one 64-row Cout chunk at a time) and [o][pixel] (the A
//           operand of dW, the block's Cout chunk);
//        b. dcol[64 px][3CP] = gout^T . W_slice on the tensor cores (wgmma
//           m64 n24 k16, each warpgroup half of the columns), summed in
//           registers over the Cout chunks, the f32 result stored to shared
//           memory;
//        c. all 256 threads sample: one unit is (pixel, group, tap), the
//           chunk's channels of that group. It reads its offsets and mask,
//           gathers the 4 corners (one 8-byte load each for Cg = 4 in bf16),
//           reads dcol (one 16-byte shared load), writes m * S to the column
//           in bf16 (the wgmma B operand of dW), writes doffset and dmask,
//           and writes m * dcol to the float32 scratch (B, G, K, HWo, Cg)
//           that the dx gathers read (one 16-byte store for 4 channels), in
//           both modes. Where a group spans several chunks (more than 64
//           channels), doffset and dmask are sums over the chunks: each
//           chunk writes its f32 partial to scratch, and the finish kernel
//           sums them in a fixed order (no float atomics there);
//        d. dW[o][3CP] += gout . column on the tensor cores (M = the Cout
//           chunk padded to 64, K = the 64 pixels), the f32 accumulators
//           held in registers across all the block's tiles.
//      At the end each block writes its dW slice to a float32 partial of
//      its own (no atomics: dW is deterministic; a block's tiles are fixed
//      by its index, none is taken dynamically).
//      dw_split_kernel (the split form): a block a (item, Cout chunk,
//      split of the tiles), enough splits for ~4 blocks an SM; for each
//      tile of its split it copies the stored column and stages gout's
//      rows, dW += gout . column in registers; it writes its split's
//      partial, which finish_kernel sums with the others in a fixed order.
//      The form it replaced sampled every (tile, tap group, channel chunk)
//      once a Cout chunk, and at 12x9 its 108 items had one block each (of
//      115,840 B: one an SM) walking all 16 tiles.
//   2. dx_gather_kernel (windowed mode): a block owns a 16 x 16 tile of dx
//      and one group's channels (4 at a time where Cg % 4 == 0, else 1).
//      For each tap it stages its halo of (16 + 2R)^2 sources in shared
//      memory (floor(t) of both axes packed in one int, the fractions,
//      m * dcol), and each source sets, for each corner of non-zero weight
//      that lands on the tile, the bit of its displacement d in that
//      pixel's mask (2R + 1 words of 2R + 1 bits: 32-bit words up to R =
//      15, 64-bit ones up to 31; atomicOr, whose result does not depend on
//      the threads' order). Each thread then walks its
//      pixel's set bits, dy then dx ascending (the order of a scan of all
//      (2R+1)^2 candidates, whose 81 tests a pixel and tap made the whole
//      call 0.72 ms at B=8, D = 4 against 0.43 with the masks, PERF.md),
//      and sums the products; the sum is rounded once into x's type and
//      written NCHW.
//      The exact mode, after the main kernel (its four sorting passes read
//      the offsets and the entries alone; no float atomics, no library
//      sort, every step linear in the lists' lengths):
//        - bucket_count_kernel: a warp a chunk of a plane's sources counts
//          them by key tile (16 x 16 keys; shared-memory counters of its
//          own);
//        - bucket_scan_kernel: each plane's counts in (key tile, chunk)
//          order -> starts;
//        - bucket_place_kernel: each source's entry (its key in the tile,
//          its index, its offsets: 8 bytes in bf16) at its tile's start for
//          the chunk + its rank among the chunk's sources of that tile
//          (__match_any_sync a round), so each tile's entries lie in
//          ascending source index;
//        - key_sort_kernel: a block a key tile sorts its entries by key,
//          in shared memory where they fit (stable: counts of (key, warp),
//          a scan, the placement ranked by ballots), so each key's list
//          lies in ascending source index;
//        - dx_tiles_kernel (a group of 4 channels, the main path): a block
//          a 16 x 16 pixel tile lays its 17 x 17 keys' lists end to end
//          and streams them through shared memory in windows of 2,816
//          entries: each entry's fractions and its m * dcol
//          row read once from device memory for the four pixels that share
//          its key; a thread a pixel then adds the part of its four lists
//          in the window, keys in order, each list by source index, its
//          corner weight from the entry's offsets (their fractions, as the
//          main kernel takes them); rounded once, NCHW. A tile with more
//          entries than a window (a hot spot) takes more windows;
//        - dx_lists_kernel (other groups: the deform blocks): a thread a
//          (pixel, 4 channels or 1), the chunks of a pixel side by side
//          reading each entry together and its m * dcol row in one run,
//          each list read in place, in the same order.
//      The form before this one (PERF.md) sorted every key's list in device
//      memory: ranks by one integer atomic a source, placement, each list
//      sorted by one thread (insertion past 16 entries: O(L^2)), then a
//      thread a pixel read each list and each m * dcol row four times from
//      device memory. Measured and not kept on the way (PERF.md): sorting
//      each pixel tile's lists on chip from buckets split by the keys two
//      tiles share, a thread a 2 x 2 pixel quad, lanes ranked by ballots in
//      the placement or by __match_any_sync in the key sort.
//   3. finish_kernel sums the blocks' dW partials into (Cout, C, kh, kw) in
//      W's type, and, where groups span chunks, the doffset and dmask
//      partials.
//   dcn_bwd_f32_kernel (float32 inputs: the card-vs-CPU checks) has the
//   same work items, gathers and dx outputs with the column and W in f32
//   and both contractions as full-f32 FMA loops on the CUDA cores over
//   64-row Cout chunks; TF32 would miss the 1e-4 tolerance of those checks.
// A block's shared memory is bounded by the widest chunk (CP = 64, a Cout
// chunk of 64) whatever C and Cout are. The bf16 kernel is compiled twice:
// the main path's calls (one Cout chunk, no group split in slices, Cout a
// multiple of 16) without the wide branches, whose runtime forms made the
// main-path call 5% slower in turns (PERF.md).
// Numerics (bf16): gout and W are bf16 already, so dcol is exact products
// summed in f32, as before; the column m * S is rounded to bf16 once for the
// dW contraction (the one new rounding: 0.19-0.28 of the 2^-7-of-scale
// tolerance, tests/test_torch_dcn_numerics.py); dx, dmask and doffset are
// computed in f32 and rounded once.
//
// Build (nvcc 12.9, -Xptxas -v, sm_90a), before this form took every
// width: dcn_bwd_bf16_kernel<48, 4> 127 registers, no spills, 85,120 B of
// dynamic shared memory at the main-path shape (2 blocks an SM); 33
// HGMMA.64x24x16.F32.BF16 in the SASS of each C = 48 instance.
// On an H100 80GB HBM3 at 700 W (chip_smoke.py, device-side), with a dx
// scatter of float4 atomics (before the gather): 0.2440-0.2461 ms at B=8,
// D = 4 (the scalar-atomic design before it 0.9871) against the 0.0262 ms
// bound; with the dx gather 0.4259-0.4268 ms, of which the gather kernel
// takes ~0.24 (PERF.md). In turns with the form of before the sorted lists
// and the split form (tools/dcn_turns.py, PERF.md): the exact mode at the
// main-path shape 0.6710-0.6737 ms against its atomics' 0.2992-0.3014; the
// deform blocks' six branch calls (C = 96 / 192 / 384, G = 1 and 2, 48x36
// / 24x18 / 12x9, B = 8) 1.9620-1.9660 ms against 5.3567-5.4027. The
// exact mode's dx of this form, in turns with the form before it (global
// per-key lists: 0.6762-0.6767 ms): 0.4933-0.4943 ms at the main-path
// shape, of which the main kernel 0.175, bucket_count_kernel 0.038,
// bucket_scan_kernel 0.005, bucket_place_kernel 0.062, key_sort_kernel
// 0.061, dx_tiles_kernel 0.134 (the dx part's bytes, m * dcol and the
// offsets read once and dx written once, ~0.037 ms at 3.35 TB/s); with
// 1,000 sources of each plane on one corner 0.589-0.591 against 19.1-19.8;
// the deform blocks' exact calls within -7..+2% (PERF.md). Registers of
// every instance of this form (-Xptxas -v): dcn_bwd_bf16_kernel
// 114-128, spilling only in the wide CP = 64
// instances (<64, 1, true> 28 bytes stored, 32 loaded; <64, 4, true> 24
// and 24: the split form's and a group past 64 channels' calls);
// dcn_bwd_f32_kernel 128-232, dw_split_kernel 64-118, dx_gather_kernel
// 43-48; the exact mode's bucket_count_kernel 58-60, bucket_scan_kernel
// 32, bucket_place_kernel 71-74, key_sort_kernel 48-62, dx_tiles_kernel
// 100-115 (<bf16> 100: two blocks an SM; bounding it to three was 35%
// slower), dx_lists_kernel 48-64; no spills.

#include "dcn_common.cuh"

namespace {

constexpr int kTilePix = 64;   // output pixels per tile: wgmma's M
constexpr int kThreads = 256;  // two warpgroups
constexpr int kTaps = 3;       // taps of one block's slice
constexpr int kColStride = kTilePix + 4;  // f32 rows of 64 pixels, padded
constexpr int kChunk = 64;     // channels of a chunk, rows of a Cout chunk
constexpr int kBlocksPerSm = 2;  // the bf16 kernel's __launch_bounds__
constexpr int kDxTile = 16;    // the dx gather's tile: 16 x 16 input pixels
// the gather's window radii: a window row of 2R + 1 candidates is one
// 32-bit mask word up to kMaxGatherR32, one 64-bit word up to kMaxGatherR
constexpr int kMaxGatherR32 = 15;
constexpr int kMaxGatherR = 31;

// The gather's window radius, ceil(D); 0 in the exact mode (sorted lists);
// -1 for a window wider than kMaxGatherR, which is refused
int gather_radius(float dmax) {
  if (!(dmax > 0.f)) return 0;
  const float r = ceilf(dmax);
  return r <= (float)kMaxGatherR ? (int)r : -1;
}

// Byte offsets of the dx gather's shared memory, for radius r, cw channels
// a pass and mask words of wb bytes: for each of the (16 + 2r)^2 halo
// sources its packed floors (int), fractions (float2) and m * dcol (cw
// floats); then the hit masks, 2r + 1 rows (dy) of one word (dx) for each
// of the tile's 256 pixels
struct DxLayout {
  size_t code, frac, md, mask, total;
};

__host__ __device__ inline DxLayout dx_layout(int r, int cw, int wb) {
  const size_t n = (size_t)(kDxTile + 2 * r) * (kDxTile + 2 * r);
  DxLayout l;
  l.code = 0;
  l.frac = align128(n * 4);
  l.md = l.frac + align128(n * 8);
  l.mask = l.md + align128(n * cw * 4);
  l.total = l.mask + align128((size_t)(2 * r + 1) * kThreads * wb);
  return l;
}

// Byte offsets of the bf16 kernel's dynamic shared memory, for the padded
// chunk width cp and nw = 3 * cp slice columns, ocp = the Cout chunk's rows
// (Cout rounded up to 16, at most 64): W slice (B of dcol, ocp x nw), gout^T
// (A of dcol, 64 x ocp), gout (A of dW, 64 x 64, rows past Cout zero), the
// column (B of dW, 64 x nw), dcol (f32, 64 rows of nw + 4), the unit table
// (16 bytes a unit). The split form (below) contracts dW in another kernel,
// so its gout buffers are one: at cp = 64 a block takes 107,648 bytes, not
// 115,840, and two fit an SM.
struct BfLayout {
  size_t w, ga, gb, col, dcol, tab, total;
};

__host__ __device__ inline BfLayout bf16_layout(int cp, int ocp, int units,
                                                bool split) {
  const int nw = kTaps * cp;
  BfLayout l;
  l.w = 0;
  l.ga = align128((size_t)ocp * nw * 2);
  l.gb = split ? l.ga : l.ga + align128((size_t)kTilePix * ocp * 2);
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

__host__ __device__ inline F32Layout f32_layout(int cp, int ocp, int units) {
  const int nw = kTaps * cp;
  F32Layout l;
  l.w = 0;
  l.g = align128((size_t)ocp * nw * 4);
  l.col = l.g + align128((size_t)ocp * kColStride * 4);
  l.dcol = l.col + align128((size_t)nw * kColStride * 4);
  l.tab = l.dcol + align128((size_t)kTilePix * (nw + 4) * 4);
  l.total = l.tab + align128((size_t)units * 16);
  return l;
}

// ---- the plan: work items and scratch ----------------------------------------

// How a call is cut: channel chunks (cc channels of whole groups, or n_sub
// 64-channel slices of each group), Cout chunks of 64, tap groups of 3. A
// work item is (tap group, channel chunk, Cout chunk), except in the split
// form (bf16 with more than one Cout chunk): there an item is (tap group,
// channel chunk), whose block forms dcol over every Cout chunk, samples
// the column once and stores it, and dw_split_kernel contracts each Cout
// chunk's dW from the stored columns.
struct Plan {
  int cc, n_sub, n_ci, n_oc, n_oc_items, cp, ocp, gpc, tap_groups, work;
  bool split;
};

__host__ __device__ inline Plan make_plan(int C, int Cout, int K, int G,
                                          bool bf16) {
  Plan pl;
  const int Cg = C / G;
  if (Cg <= kChunk) {
    pl.gpc = kChunk / Cg;  // whole groups a chunk
    if (pl.gpc > G) pl.gpc = G;
    pl.cc = pl.gpc * Cg;
    pl.n_sub = 1;
    pl.n_ci = (G + pl.gpc - 1) / pl.gpc;
  } else {
    pl.gpc = 1;
    pl.cc = kChunk;
    pl.n_sub = (Cg + kChunk - 1) / kChunk;
    pl.n_ci = G * pl.n_sub;
  }
  pl.cp = (pl.cc + 15) & ~15;
  const int c16 = (Cout + 15) & ~15;
  pl.ocp = c16 < kChunk ? c16 : kChunk;
  pl.n_oc = (Cout + kChunk - 1) / kChunk;
  pl.split = bf16 && pl.n_oc > 1;
  pl.n_oc_items = pl.split ? 1 : pl.n_oc;
  pl.tap_groups = (K + kTaps - 1) / kTaps;
  pl.work = pl.tap_groups * pl.n_ci * pl.n_oc_items;
  return pl;
}

// Blocks a work item at most, given the SMs (kBlocksPerSm blocks an SM)
int max_slots(const Plan& pl, int sms) {
  return (kBlocksPerSm * sms + pl.work - 1) / pl.work;
}

// ---- the exact mode's grid of keys --------------------------------------

// A source (group, tap k, output pixel p) of a plane (image, group) is keyed
// by the floor corner (y0, x0) of its sample, taken as (ky, kx) = (y0 + 1,
// x0 + 1) in [0, H] x [0, W]. The key space is cut into tiles of 16 x 16
// keys, kt = (ky / 16) * ktx + kx / 16; a key's place in its tile is lk =
// (ky % 16) * 16 + kx % 16. An entry's word holds lk << 24 | s, the source
// index s = k * HWo + p in the low 24 bits.
constexpr int kKeyTile = 16;
constexpr int kTileKeys = kKeyTile * kKeyTile;  // 256: one a thread
constexpr int kHalo = kKeyTile + 1;             // a pixel tile's 17 x 17 keys
constexpr int kHaloKeys = kHalo * kHalo;
constexpr int kSrcBits = 24;
constexpr int kSrcMask = (1 << kSrcBits) - 1;
constexpr int kWarps = kThreads / 32;
// the bucket kernels' counters, kWarps ints a key tile: 48 KB at most
constexpr int kMaxKeyTiles = 1536;
constexpr int kBatch = 8;  // rounds of 32 a lane loads before it ranks them
// the gather's window: entries and their m * dcol, 3 blocks an SM
constexpr int kWindowSmem = 66 * 1024;
// the key sort's tile in shared memory: the entries and their sorted copy,
// 4 blocks an SM
constexpr int kSortSmem = 44 * 1024;
static_assert(kThreads == kTileKeys, "key_sort_kernel: a thread a key");

// How a plane's sources are cut: ktx key tiles a row, kt in all, ptx_n x
// pty_n pixel tiles; the bucket kernels' warps take
// `rounds` rounds of 32 sources each (a chunk), nc chunks a plane; rows of
// ints a plane for the counts (kt x nc, then the plane's total) and for
// the keys' starts (kt x 257: a key tile's 256 starts, then its end). At
// least kt / 8 rounds, so that the counts stay under a quarter of the
// sources.
struct ExactGrid {
  int ktx, kt, rounds, nc, ptx_n, pty_n;
  long long cnt_row, kst_row;
};

__host__ __device__ inline ExactGrid exact_grid(int H, int W, int K,
                                                int HWo) {
  ExactGrid e;
  e.ktx = (W + kKeyTile) / kKeyTile;  // ceil((W + 1) / 16)
  e.kt = (H + kKeyTile) / kKeyTile * e.ktx;
  e.ptx_n = (W + kKeyTile - 1) / kKeyTile;  // pixel tiles
  e.pty_n = (H + kKeyTile - 1) / kKeyTile;
  // 16 rounds a chunk, fewer where a plane has too few sources for 32
  // chunks, but at least kt / 8
  const long long sources = (long long)K * HWo;
  e.rounds = sources >= 16LL * 32 * 32 ? 16 : (int)((sources + 1023) / 1024);
  if (e.rounds < (e.kt + kWarps - 1) / kWarps)
    e.rounds = (e.kt + kWarps - 1) / kWarps;
  if (e.rounds < 1) e.rounds = 1;
  const long long per_chunk = 32LL * e.rounds;
  e.nc = (int)((sources + per_chunk - 1) / per_chunk);
  e.cnt_row = (long long)e.kt * e.nc + 1;
  e.kst_row = (long long)e.kt * (kTileKeys + 1);
  return e;
}

// float32 scratch: the dW partials (a slot's copy of dW for each of its tap
// groups), then, where groups span chunks, the doffset and dmask partials
// of each slice, then m * dcol in (B, G, K, HWo, Cg) order from the 16-byte
// aligned element `md`, which the dx gathers read; in the split form the
// stored columns (`col`). In the exact mode the bucket sort's arrays
// follow, each 16-byte aligned: `cnt`, a row of kt * nc + 1 int32 a plane
// (ExactGrid), the counts and after the scan each (key tile, chunk)'s
// start (slot kt * nc: the plane's total); `kst`, a row of kt * 257 int32
// a plane, each key's start in its plane's sorted entries and each key
// tile's end; `ent` and `ent2`, K * HWo entries a plane each (8 bytes in
// bf16, 16 in f32; room for 16), the entries by key tile, then by key.
struct Scratch {
  long long dw, doff, dmsk, md, col, cnt, kst, ent, ent2, total;
};

inline long long align4(long long n) { return (n + 3) & ~3LL; }

Scratch scratch_floats(const Plan& pl, int slots, int B, int C, int Cout,
                       int H, int W, int G, int K, int HWo, bool sorted) {
  Scratch s;
  s.dw = (long long)slots * pl.tap_groups * Cout * kTaps * C;
  const long long n_msk = (long long)B * G * K * HWo;
  s.doff = pl.n_sub > 1 ? pl.n_sub * 2 * n_msk : 0;
  s.dmsk = pl.n_sub > 1 ? pl.n_sub * n_msk : 0;
  s.md = align4(s.dw + s.doff + s.dmsk);
  // the split form's stored columns: a 64 x 3cp bf16 block a (tile, item)
  const long long tiles = (long long)B * ((HWo + kTilePix - 1) / kTilePix);
  s.col = align4(s.md + (long long)B * K * C * HWo);
  s.cnt = s.col + (pl.split ? tiles * pl.tap_groups * pl.n_ci *
                                  kTilePix * kTaps * pl.cp / 2
                            : 0);
  const ExactGrid eg = exact_grid(H, W, K, HWo);
  s.kst = align4(s.cnt + (long long)B * G * eg.cnt_row);
  s.ent = align4(s.kst + (long long)B * G * eg.kst_row);
  s.ent2 = align4(s.ent + 4 * n_msk);
  // the regions from `col` on start at a 16-byte aligned base, 3 floats
  // of slack
  s.total = (sorted ? s.ent2 + 4 * n_msk : s.cnt) + 3;
  return s;
}

// ---- dx outputs of the sampling side ----------------------------------------

// the gather's scratch: m * dcol of VW channels, one 16-byte store for 4
template <int VW>
__device__ __forceinline__ void put_md(float* p, const float (&md)[VW]) {
  if constexpr (VW == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(md[0], md[1], md[2], md[3]);
  } else {
    *p = md[0];
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
  float dmax;
  Plan pl;
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

// One block's work item: tap group tg (taps k0 .. k0 + kt), channel chunk
// ci (groups g_lo .. g_lo + gpc, channels j0 .. j0 + nc of each, which are
// the chunk's columns c_lo .. c_lo + cw of x), Cout chunk oi (rows o0 ..
// o0 + orows), the slice sub of its group where groups span chunks, and
// whether it forms dcol and the sampling side's outputs (side: oi == 0).
struct Item {
  int tg, ci, k0, kt, g_lo, gpc, j0, nc, c_lo, cw, sub, oi, o0, orows;
  bool side;
  __device__ __forceinline__ Item(int w, const Args& a, const Conv& cv) {
    const Plan& pl = a.pl;
    tg = w / (pl.n_ci * pl.n_oc_items);
    const int rem = w - tg * pl.n_ci * pl.n_oc_items;
    ci = rem / pl.n_oc_items;
    oi = rem - ci * pl.n_oc_items;
    k0 = tg * kTaps;
    kt = min(kTaps, cv.K - k0);
    if (pl.n_sub == 1) {
      g_lo = ci * pl.gpc;
      gpc = min(pl.gpc, cv.G - g_lo);
      j0 = 0;
      nc = cv.Cg;
      sub = 0;
      c_lo = g_lo * cv.Cg;
      cw = gpc * cv.Cg;
    } else {
      g_lo = ci / pl.n_sub;
      sub = ci - g_lo * pl.n_sub;
      gpc = 1;
      j0 = sub * kChunk;
      nc = min(kChunk, cv.Cg - j0);
      c_lo = g_lo * cv.Cg + j0;
      cw = nc;
    }
    o0 = oi * kChunk;
    orows = min(kChunk, a.Cout - o0);
    side = oi == 0;
  }
};

// The block's units (group g_lo + gi, tap k0 + kk) for kk < kt, built once
// so that the sample loop does no integer division:
//   x = the unit's first column in the slice, kk * cp + (its channels' first
//       column in the chunk) (also its place in a dcol row),
//   y = offset of the unit's first channel in the image's (G, H, W, Cg)
//       arrays,
//   z = (g * K + k) * HWo: its dy row in the image's offsets is 2z, its dx
//       row 2z + HWo, its mask row z,
//   w = the tap's displacement, (ky*dil - pad) << 16 | (kx*dil - pad).
__device__ __forceinline__ int build_units(int4* tab, const Conv& cv, int cp,
                                           const Item& it) {
  const int n = it.gpc * it.kt;
  for (int u = threadIdx.x; u < n; u += kThreads) {
    const int gi = u / it.kt;
    const int kk = u - gi * it.kt;
    const int g = it.g_lo + gi;
    const int k = it.k0 + kk;
    const int ky = k / cv.kw;
    const int kx = k - ky * cv.kw;
    tab[u] = make_int4(kk * cp + g * cv.Cg + it.j0 - it.c_lo,
                       g * cv.H * cv.W * cv.Cg + it.j0,
                       (g * cv.K + k) * cv.HWo,
                       ((ky * cv.dil - cv.pad) << 16) |
                           ((kx * cv.dil - cv.pad) & 0xffff));
  }
  return n;
}

// The per-pixel outputs of one tile: doffset and dmask in T, or, where
// groups span chunks (pdoff non-null), this slice's f32 partials of them;
// each points at the pixel in the image's first row
template <typename T>
struct SideOut {
  T *doff, *dmsk;
  float *pdoff, *pdmsk;
};

// The sampling side of one tile for this thread's pixel p. Thread t takes
// the units t / 64, t / 64 + 4, ..., one at a time (two in flight, their
// loads issued together, measured 2-4% slower at the 128-register cap of
// two blocks an SM), nc channels each. off / msk point at the pixel in the
// image's first offset and mask row (a pixel past the image points at the
// tile's first pixel and neither gathers nor writes); xg at the image's
// (G, H, W, Cg) array; dcol_p at the pixel's dcol row. md_out points at the
// image's m * dcol scratch at this pixel and the chunk's first channel of
// its group (the unit's (g, k) rows are e.z * Cg further), which the dx
// gathers read. Without `side` a unit only writes its column (a block of a
// later Cout chunk).
template <typename T, int VW, class Store>
__device__ __forceinline__ void sample_tile(
    const T* __restrict__ xg, float* __restrict__ md_out,
    const T* __restrict__ off,
    const T* __restrict__ msk, const SideOut<T>& so, const int4* tab,
    int n_units, int nc, bool side, const float* dcol_p, int p, bool pvalid,
    int oy, int ox, const Conv& cv, const Store& store) {
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
    const int y0 = oy + (e.w >> 16) + (int)fy;
    const int x0 = ox + (int)(short)(e.w & 0xffff) + (int)fx;
    const bool vy0 = pvalid && (unsigned)y0 < (unsigned)cv.H;
    const bool vy1 = pvalid && (unsigned)(y0 + 1) < (unsigned)cv.H;
    const bool vx0 = (unsigned)x0 < (unsigned)cv.W;
    const bool vx1 = (unsigned)(x0 + 1) < (unsigned)cv.W;
    const bool ok[4] = {vy0 && vx0, vy0 && vx1, vy1 && vx0, vy1 && vx1};
    const int cb = e.y + (y0 * cv.W + x0) * cv.Cg;
    float dm = 0.f, gy = 0.f, gx = 0.f;
    for (int j = 0; j < nc; j += VW) {
      Corner<T, VW> v[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (ok[c]) v[c].load(xg + cb + j + corner[c]); else v[c].zero();
      }
      const int n = e.x + j;
      float d[VW];
      if (side) {
        if constexpr (VW == 4) {
          const float4 dv = *reinterpret_cast<const float4*>(dcol_p + n);
          d[0] = dv.x; d[1] = dv.y; d[2] = dv.z; d[3] = dv.w;
        } else {
          d[0] = dcol_p[n];
        }
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
        if (side) {
          md[i] = m * d[i];
          dm = fmaf(s, d[i], dm);
          gy = fmaf(d[i], sy, gy);
          gx = fmaf(d[i], fmaf(ly, sx1 - sx0, sx0), gx);
        }
      }
      store.template put<VW>(n, p, col);
      if (side && pvalid) put_md<VW>(md_out + (size_t)e.z * cv.Cg + j, md);
    }
    if (side && pvalid) {
      const float oy_v = pass_y && ly != 0.f ? m * gy : 0.f;
      const float ox_v = pass_x && lx != 0.f ? m * gx : 0.f;
      if (so.pdoff) {
        so.pdoff[2 * e.z] = oy_v;
        so.pdoff[2 * e.z + cv.HWo] = ox_v;
        if (so.pdmsk) so.pdmsk[e.z] = dm;
      } else {
        so.doff[2 * e.z] = from_f<T>(oy_v);
        so.doff[2 * e.z + cv.HWo] = from_f<T>(ox_v);
        if (so.dmsk) so.dmsk[e.z] = from_f<T>(dm);
      }
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

// x (B, C, H, W) -> xg (B, G, H, W, Cg): 4 channels a thread where Cg is 4,
// else one element a thread (a thread a pixel with Cg channels took 135 us
// at C = 384, 12x9, B = 8: 864 threads; PERF.md)
template <typename T>
__global__ void prep_kernel(const T* __restrict__ x, T* __restrict__ xg,
                            int B, int G, int Cg, int HW, int vec4) {
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
    // Cg == 4: one 8-byte (bf16) or 16-byte (f32) store each
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

// The geometry of tile `tile` for this thread's pixel (a block of work
// item w walks the tiles slot, slot + slots, ...).
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

// The sampling side's per-pixel outputs of image b for this thread's pixel
template <typename T>
__device__ __forceinline__ SideOut<T> side_out(
    T* doffset, T* dmask, float* pdoff, float* pdmsk, const Args& a,
    const Item& it, int b, int pe) {
  const size_t msk_img = (size_t)a.G * a.kh * a.kw * a.Ho * a.Wo;
  SideOut<T> so;
  so.doff = doffset + b * 2 * msk_img + pe;
  so.dmsk = dmask ? dmask + b * msk_img + pe : nullptr;
  so.pdoff = nullptr;
  so.pdmsk = nullptr;
  if (pdoff) {  // groups span chunks: this slice's partials
    const size_t all = (size_t)a.B * msk_img;
    so.pdoff = pdoff + it.sub * 2 * all + b * 2 * msk_img + pe;
    so.pdmsk = dmask ? pdmsk + it.sub * all + b * msk_img + pe : nullptr;
  }
  return so;
}

// W[o][c][k0 + kk] for the Cout chunk starting at o0 -> the slice
// [o - o0][n = kk*CP + c - c_lo], zero past the chunk's channels, the
// block's taps and Cout, through `put(o', n, value)`
template <int CP, typename T, class Put>
__device__ __forceinline__ void stage_w(const T* __restrict__ weight,
                                        const Args& a, const Item& it, int o0,
                                        int ocp, const Put& put) {
  constexpr int NW = kTaps * CP;
  const int K = a.kh * a.kw;
  for (int i = threadIdx.x; i < ocp * NW; i += kThreads) {
    const int o = i / NW;
    const int n = i - o * NW;
    const int kk = n / CP;
    const int c = n - kk * CP;
    const bool ok = kk < it.kt && c < it.cw && o0 + o < a.Cout;
    put(o, n, ok ? weight[((size_t)(o0 + o) * a.C + it.c_lo + c) * K +
                          it.k0 + kk]
                 : from_f<T>(0.f));
  }
}

// WIDE: a call with more than one Cout chunk, groups split in slices or
// Cout not a multiple of 16; the main path's calls compile without those
// branches
template <int CP, int VW, bool WIDE>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    dcn_bwd_bf16_kernel(const bf16* __restrict__ xg,
                        const bf16* __restrict__ offset,
                        const bf16* __restrict__ mask,
                        const bf16* __restrict__ weight,
                        const bf16* __restrict__ gout,
                        float* __restrict__ mdc,
                        bf16* __restrict__ doffset, bf16* __restrict__ dmask,
                        float* __restrict__ dw_part, float* __restrict__ pdoff,
                        float* __restrict__ pdmsk, uint4* __restrict__ colbuf,
                        Args a, int vec_gout) {
  constexpr int NW = kTaps * CP;
  constexpr int NH = NW / 2;  // columns a warpgroup
  extern __shared__ __align__(128) unsigned char smem[];
  const Conv cv = make_conv(a);
  const Plan& pl = a.pl;
  const int ocp = pl.ocp;
  const int work = pl.work;
  const Item it(blockIdx.x % work, a, cv);
  // a bf16 item owns every Cout chunk (make_plan): it forms dcol and
  // writes the sampling side's outputs
  constexpr bool side = true;
  const int n_oc = WIDE ? pl.n_oc : 1;
  // the split form: the column stored for dw_split_kernel, no dW here
  const bool split = WIDE && pl.split;
  const int slot = blockIdx.x / work;
  const int slots = gridDim.x / work;
  const BfLayout L = bf16_layout(CP, ocp, pl.gpc * kTaps, split);
  unsigned char* w_s = smem + L.w;
  unsigned char* ga_s = smem + L.ga;
  unsigned char* gb_s = smem + L.gb;
  unsigned char* col_s = smem + L.col;
  float* dcol_s = reinterpret_cast<float*>(smem + L.dcol);
  int4* tab = reinterpret_cast<int4*>(smem + L.tab);
  const int tid = threadIdx.x;
  const int n_units = build_units(tab, cv, CP, it);

  // W's slice as the B operand of dcol (K = o, N = n):
  // byte (o/8)*NW*16 + n*16 + (o%8)*2
  auto put_w = [&](int o, int n, bf16 v) {
    *reinterpret_cast<bf16*>(w_s + (o >> 3) * (NW * 16) + n * 16 +
                             (o & 7) * 2) = v;
  };
  const bool w_once = n_oc == 1;
  if (w_once) stage_w<CP>(weight, a, it, 0, ocp, put_w);
  // gout's rows past the block's Cout chunk and the column's padding stay
  // zero
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
  const size_t md_img = (size_t)cv.K * cv.C * HWo;
  const int p = tid % kTilePix;
  const int wg = tid >> 7;
  const StoreColBf16 store{col_s, NW * 16};

  for (int tile = slot; tile < n_tiles; tile += slots) {
    const Tile t(tile, tiles_per_img, cv);
    const bf16* g_img = gout + (size_t)t.b * a.Cout * HWo + t.p0;
    // the previous tile's wgmma have been waited for by their warpgroups
    __syncthreads();
    // gout rows o0 .. o0 + orows -> gb_s [o][px] (byte (px/8)*1024 + o*16 +
    // (px%8)*2): the A operand of this block's dW rows
    for (int i = tid; i < (split ? 0 : it.orows * 8); i += kThreads) {
      const int pc = i & 7;
      const int o = i >> 3;
      const bf16* src = g_img + (size_t)(it.o0 + o) * HWo + pc * 8;
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

    {
      // dcol[px][n] = sum_o gout[o][px] * W[o][n], this warpgroup's half,
      // summed over the Cout chunks
      float acc[NH / 2];
#pragma unroll
      for (int j = 0; j < NH / 2; ++j) acc[j] = 0.f;
      for (int oc = 0; oc < n_oc; ++oc) {
        const int o0 = oc * kChunk;
        if (oc > 0) __syncthreads();  // the last chunk's wgmma are done
        if (!w_once) stage_w<CP>(weight, a, it, o0, ocp, put_w);
        // gout^T -> ga_s [px][o] (byte (o/8)*1024 + px*16 + (o%8)*2), zero
        // past Cout
        for (int i = tid; i < kTilePix * ocp / 8; i += kThreads) {
          const int px = i % kTilePix;
          const int oc8 = i / kTilePix;
          uint32_t h[8];
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            const int o = o0 + oc8 * 8 + r;
            h[r] = t.p0 + px < HWo && (!WIDE || o < a.Cout)
                       ? (uint32_t)__bfloat16_as_ushort(
                             g_img[(size_t)o * HWo + px])
                       : 0u;
          }
          *reinterpret_cast<uint4*>(ga_s + oc8 * 1024 + px * 16) =
              make_uint4(h[0] | h[1] << 16, h[2] | h[3] << 16,
                         h[4] | h[5] << 16, h[6] | h[7] << 16);
        }
        fence_proxy_async();
        __syncthreads();
        const int rows = min(kChunk, a.Cout - o0);
        fence_acc(acc);
        wgmma_fence();
        wgmma_rows<NH>(acc, make_desc(ga_s, kTilePix * 16, 128),
                       make_desc(w_s + wg * NH * 16, NW * 16, 128),
                       (rows + 15) / 16, 2 * kTilePix, 2 * NW);
        wgmma_commit();
        wgmma_wait0();
        fence_acc(acc);
      }
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
    fence_proxy_async();  // gb_s's stores, visible to wgmma
    __syncthreads();

    // c. the sampling side
    sample_tile<bf16, VW>(
        xg + t.b * img, mdc + t.b * md_img + (size_t)t.pe * cv.Cg + it.j0,
        offset + t.b * offs_img + t.pe,
        mask ? mask + t.b * msk_img + t.pe : nullptr,
        side_out(doffset, dmask, WIDE ? pdoff : nullptr, pdmsk, a, it, t.b,
                 t.pe),
        tab, n_units, it.nc, side, dcol_s + p * (NW + 4), p, t.pvalid, t.oy,
        t.ox, cv, store);
    fence_proxy_async();  // the column's stores, visible to wgmma
    __syncthreads();

    if (split) {  // the column, as it lies in shared memory, for dW's kernel
      uint4* dst = colbuf + (((size_t)tile * pl.tap_groups + it.tg) * pl.n_ci +
                             it.ci) * (kTilePix * NW / 8);
      for (int i = tid; i < kTilePix * NW / 8; i += kThreads)
        dst[i] = reinterpret_cast<const uint4*>(col_s)[i];
      continue;
    }
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

  // this block's dW slice -> its slot's partial [o][kk][c] (o in its Cout
  // chunk, kk < kt, c in its channel chunk); the finish kernel sums the
  // slots' partials
  if (split) return;
  float* part = dw_part + ((size_t)slot * pl.tap_groups + it.tg) * a.Cout *
                              kTaps * cv.C;
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
      if (o < it.orows && kk < it.kt && c < it.cw)
        part[((size_t)(it.o0 + o) * kTaps + kk) * cv.C + it.c_lo + c] =
            acc_dw[4 * j + e];
    }
  }
}

// The split form's dW: block (item (tap group, channel chunk), Cout chunk
// oc, split sp) contracts dW's rows oc * 64 .. + 64 over the tiles of its
// split, [sp * per, (sp + 1) * per), from the stored columns, the product
// of each tile added in registers, and stores them as split sp's partial
// (the finish kernel sums the splits'). Each column is sampled once and
// read n_oc times here, where the items of a Cout chunk each sampled it.
template <int CP>
__global__ void __launch_bounds__(kThreads)
    dw_split_kernel(const bf16* __restrict__ gout,
                    const uint4* __restrict__ colbuf,
                    float* __restrict__ dw_part, Args a, int splits,
                    int vec_gout) {
  constexpr int NW = kTaps * CP;
  constexpr int NH = NW / 2;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* col_s = smem;                     // 64 x NW, B of dW
  unsigned char* gb_s = smem + kTilePix * NW * 2;  // 64 x 64, A of dW
  const Conv cv = make_conv(a);
  const Plan& pl = a.pl;
  const Item it(blockIdx.x % pl.work, a, cv);
  const int rest = blockIdx.x / pl.work;
  const int oc = rest % pl.n_oc;
  const int sp = rest / pl.n_oc;
  const int o0 = oc * kChunk;
  const int rows = min(kChunk, a.Cout - o0);
  const int HWo = cv.HWo;
  const int tiles_per_img = (HWo + kTilePix - 1) / kTilePix;
  const int n_tiles = a.B * tiles_per_img;
  const int per = (n_tiles + splits - 1) / splits;
  const int t_end = min(n_tiles, (sp + 1) * per);
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  float acc[NH / 2];
#pragma unroll
  for (int j = 0; j < NH / 2; ++j) acc[j] = 0.f;
  for (int tile = sp * per; tile < t_end; ++tile) {
    const int b = tile / tiles_per_img;
    const int p0 = (tile - b * tiles_per_img) * kTilePix;
    const bf16* g_img = gout + (size_t)b * a.Cout * HWo + p0;
    __syncthreads();  // the last tile's wgmma are done with both buffers
    const uint4* src = colbuf + (((size_t)tile * pl.tap_groups + it.tg) *
                                     pl.n_ci + it.ci) * (kTilePix * NW / 8);
    for (int i = tid; i < kTilePix * NW / 8; i += kThreads)
      reinterpret_cast<uint4*>(col_s)[i] = __ldg(src + i);
    // gout rows o0 .. o0 + 64 -> gb_s [o][px], zero past Cout and the image
    for (int i = tid; i < kChunk * 8; i += kThreads) {
      const int pc = i & 7;
      const int o = i >> 3;
      const bf16* g = g_img + (size_t)(o0 + o) * HWo + pc * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (o < rows) {
        if (vec_gout && p0 + pc * 8 + 8 <= HWo) {
          v = __ldg(reinterpret_cast<const uint4*>(g));
        } else {
          uint32_t h[8];
#pragma unroll
          for (int r = 0; r < 8; ++r)
            h[r] = p0 + pc * 8 + r < HWo
                       ? (uint32_t)__bfloat16_as_ushort(g[r]) : 0u;
          v = make_uint4(h[0] | h[1] << 16, h[2] | h[3] << 16,
                         h[4] | h[5] << 16, h[6] | h[7] << 16);
        }
      }
      *reinterpret_cast<uint4*>(gb_s + pc * 1024 + o * 16) = v;
    }
    fence_proxy_async();
    __syncthreads();
    fence_acc(acc);
    wgmma_fence();
    wgmma_rows<NH>(acc, make_desc(gb_s, kTilePix * 16, 128),
                   make_desc(col_s + wg * NH * 16, NW * 16, 128),
                   kTilePix / 16, 2 * kTilePix, 2 * NW);
    wgmma_commit();
    wgmma_wait0();
    fence_acc(acc);
  }
  float* part = dw_part + ((size_t)sp * pl.tap_groups + it.tg) * a.Cout *
                              kTaps * cv.C;
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
      if (o < rows && kk < it.kt && c < it.cw)
        part[((size_t)(o0 + o) * kTaps + kk) * cv.C + it.c_lo + c] =
            acc[4 * j + e];
    }
  }
}

// float32: the same work items, gathers and dx outputs; both contractions as
// full-f32 FMA loops over Cout chunks of 64 rows (rows past Cout zero: one
// instance a chunk width, NOC = 4, for the check path's few calls)
template <int CP, int NOC, int VW>
__global__ void __launch_bounds__(kThreads)
    dcn_bwd_f32_kernel(const float* __restrict__ xg,
                       const float* __restrict__ offset,
                       const float* __restrict__ mask,
                       const float* __restrict__ weight,
                       const float* __restrict__ gout,
                       float* __restrict__ mdc,
                       float* __restrict__ doffset, float* __restrict__ dmask,
                       float* __restrict__ dw_part, float* __restrict__ pdoff,
                       float* __restrict__ pdmsk, uint4* __restrict__, Args a,
                       int) {
  constexpr int NW = kTaps * CP;
  constexpr int OCP = NOC * 16;
  constexpr int NI = NW / 16;  // columns a thread: dcol and dW
  extern __shared__ __align__(128) unsigned char smem[];
  const Conv cv = make_conv(a);
  const Plan& pl = a.pl;
  const int work = pl.work;
  const Item it(blockIdx.x % work, a, cv);
  const int slot = blockIdx.x / work;
  const int slots = gridDim.x / work;
  const F32Layout L = f32_layout(CP, OCP, pl.gpc * kTaps);
  float* w_s = reinterpret_cast<float*>(smem + L.w);      // [o][NW]
  float* g_s = reinterpret_cast<float*>(smem + L.g);      // [o][68]
  float* col_s = reinterpret_cast<float*>(smem + L.col);  // [NW][68]
  float* dcol_s = reinterpret_cast<float*>(smem + L.dcol);
  int4* tab = reinterpret_cast<int4*>(smem + L.tab);
  const int tid = threadIdx.x;
  const int n_units = build_units(tab, cv, CP, it);
  auto put_w = [&](int o, int n, float v) { w_s[o * NW + n] = v; };
  const bool w_once = pl.n_oc == 1;
  if (w_once && it.side) stage_w<CP>(weight, a, it, 0, OCP, put_w);
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
  const size_t md_img = (size_t)cv.K * cv.C * HWo;
  const int p = tid % kTilePix;
  const StoreColF32 store{col_s};

  // gout rows o0 .. o0 + OCP of the tile -> g_s [o][68], zero past Cout
  auto stage_g = [&](const float* g_img, int p0, int o0) {
    for (int i = tid; i < OCP * kTilePix; i += kThreads) {
      const int o = i / kTilePix;
      const int px = i % kTilePix;
      g_s[o * kColStride + px] = p0 + px < HWo && o0 + o < a.Cout
                                     ? g_img[(size_t)(o0 + o) * HWo + px]
                                     : 0.f;
    }
  };

  for (int tile = slot; tile < n_tiles; tile += slots) {
    const Tile t(tile, tiles_per_img, cv);
    const float* g_img = gout + (size_t)t.b * a.Cout * HWo + t.p0;
    __syncthreads();  // the previous tile's dW loop is done
    if (it.side) {
      float acc[NI][4];
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;
      // the Cout chunks last to first, so that g_s ends on this block's
      // (the first) for dW
      for (int oc = pl.n_oc - 1; oc >= 0; --oc) {
        if (oc < pl.n_oc - 1) __syncthreads();  // the last chunk is summed
        if (!w_once) stage_w<CP>(weight, a, it, oc * kChunk, OCP, put_w);
        stage_g(g_img, t.p0, oc * kChunk);
        __syncthreads();
        for (int o = 0; o < OCP; ++o) {
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
      }
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          dcol_s[(quad * 4 + q) * (NW + 4) + lane + 16 * i] = acc[i][q];
    } else {
      stage_g(g_img, t.p0, it.o0);
    }
    __syncthreads();
    sample_tile<float, VW>(
        xg + t.b * img, mdc + t.b * md_img + (size_t)t.pe * cv.Cg + it.j0,
        offset + t.b * offs_img + t.pe,
        mask ? mask + t.b * msk_img + t.pe : nullptr,
        side_out(doffset, dmask, pdoff, pdmsk, a, it, t.b, t.pe), tab,
        n_units, it.nc, it.side, dcol_s + p * (NW + 4), p, t.pvalid, t.oy,
        t.ox, cv, store);
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

  float* part = dw_part + ((size_t)slot * pl.tap_groups + it.tg) * a.Cout *
                              kTaps * cv.C;
#pragma unroll
  for (int j = 0; j < NOC; ++j)
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int o = ol + 16 * j;
      const int n = nl + 16 * i;
      const int kk = n / CP;
      const int c = n - kk * CP;
      if (o < it.orows && kk < it.kt && c < it.cw)
        part[((size_t)(it.o0 + o) * kTaps + kk) * cv.C + it.c_lo + c] =
            acc_dw[j][i];
    }
}

// dx by the gather (windowed mode): dx(q) = sum over taps k, then d in
// [-R, R]^2 row by row, of w_y w_x * md_k(q - s_k - d), md = m * dcol from
// the main kernel's scratch (B, G, K, HWo, Cg); rounded once into T and
// written NCHW. Block: a 16 x 16 tile of q, one group g, channels c0 ..
// c0 + CW of it; grid (tiles, G * Cg / CW, B). For each tap the block
// stages the halo of sources that can reach the tile, (16 + 2R)^2 cells
// from (qy0 - sy - R, qx0 - sx - R), and each source marks the (up to 4)
// pixels of the tile its corners of non-zero weight land on: bit dx + R of
// the word (q, dy + R), d = q - s - p, by a shared-memory atomicOr. An OR
// does not depend on the order of the threads, so the masks are the same
// in every run; each pixel then walks its set bits, dy then dx ascending,
// the order in which it would test the (2R+1)^2 candidates, and sums the
// products in that order. Mask words M: unsigned up to R = 15, unsigned
// long long up to 31 (64-bit words at R <= 15 made the whole call 19-32%
// slower in turns: twice the mask bytes, fewer blocks an SM; PERF.md).
template <typename T, int CW, typename M>
__global__ void __launch_bounds__(kThreads)
    dx_gather_kernel(const T* __restrict__ offset,
                     const float* __restrict__ mdc, T* __restrict__ dx,
                     Args a, int R) {
  extern __shared__ __align__(128) unsigned char smem[];
  const DxLayout L = dx_layout(R, CW, sizeof(M));
  int* code_s = reinterpret_cast<int*>(smem + L.code);
  float2* frac_s = reinterpret_cast<float2*>(smem + L.frac);
  float* md_s = reinterpret_cast<float*>(smem + L.md);
  M* mask_s = reinterpret_cast<M*>(smem + L.mask);
  const int Cg = a.C / a.G;
  const int K = a.kh * a.kw;
  const int HWo = a.Ho * a.Wo;
  const int tiles_x = (a.W + kDxTile - 1) / kDxTile;
  const int qx0 = (blockIdx.x % tiles_x) * kDxTile;
  const int qy0 = (blockIdx.x / tiles_x) * kDxTile;
  const int passes = Cg / CW;
  const int g = blockIdx.y / passes;
  const int c0 = (blockIdx.y - g * passes) * CW;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lx = tid % kDxTile;
  const int ly = tid / kDxTile;
  const bool qvalid = qy0 + ly < a.H && qx0 + lx < a.W;
  const int qh = min(kDxTile, a.H - qy0);  // the tile's pixels in the image
  const int qw = min(kDxTile, a.W - qx0);
  const int side = kDxTile + 2 * R;  // the halo's rows and columns
  const T* off_b = offset + (size_t)b * 2 * a.G * K * HWo;
  const float* md_b = mdc + (size_t)b * K * a.C * HWo;
  float acc[CW];
#pragma unroll
  for (int j = 0; j < CW; ++j) acc[j] = 0.f;
  // each pixel's masks start empty; its owner clears what it has read
  for (int r = 0; r <= 2 * R; ++r) mask_s[r * kThreads + tid] = 0;

  for (int k = 0; k < K; ++k) {
    const int ky = k / a.kw;
    const int sy = ky * a.dil - a.pad;
    const int sx = (k - ky * a.kw) * a.dil - a.pad;
    // halo cell (hy, hx) is the source p = (qy0 - sy - R + hy,
    // qx0 - sx - R + hx); its corner (cy, cx) lands on the tile's pixel
    // (hy - R + dy, hx - R + dx), dy = floor(ty) + cy, dx = floor(tx) + cx
    const int py0 = qy0 - sy - R;
    const int px0 = qx0 - sx - R;
    const size_t plane = (size_t)(g * K + k) * HWo;
    __syncthreads();  // the previous tap's halo has been read
    for (int h = tid; h < side * side; h += kThreads) {
      const int hy = h / side;
      const int hx = h - hy * side;
      const int py = py0 + hy;
      const int px = px0 + hx;
      if ((unsigned)py >= (unsigned)a.Ho || (unsigned)px >= (unsigned)a.Wo)
        continue;  // off the output plane: no source, nothing marked
      const int p = py * a.Wo + px;
      // the clamp and floor of sample_tile
      const float ty =
          fminf(fmaxf(to_f(__ldg(off_b + 2 * plane + p)), -a.dmax), a.dmax);
      const float tx = fminf(
          fmaxf(to_f(__ldg(off_b + 2 * plane + HWo + p)), -a.dmax), a.dmax);
      const int fy = (int)floorf(ty);
      const int fx = (int)floorf(tx);
      const float2 fr = make_float2(ty - (float)fy, tx - (float)fx);
      code_s[h] = ((fy + R) << 16) | (fx + R);
      frac_s[h] = fr;
      const float* src = md_b + (plane + p) * Cg + c0;
      if constexpr (CW == 4) {
        *reinterpret_cast<float4*>(md_s + h * 4) =
            __ldg(reinterpret_cast<const float4*>(src));
      } else {
        md_s[h] = __ldg(src);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int cy = c >> 1, cx = c & 1;
        const int dy = fy + cy, ddx = fx + cx;  // in [-R, R + 1]
        const int y = hy - R + dy, x = hx - R + ddx;
        const float w = (cy ? fr.x : 1.f - fr.x) * (cx ? fr.y : 1.f - fr.y);
        // d = R + 1 needs t = D, where that corner's weight is 0
        if ((unsigned)y < (unsigned)qh && (unsigned)x < (unsigned)qw &&
            dy <= R && ddx <= R && w != 0.f)
          atomicOr(mask_s + (dy + R) * kThreads + y * kDxTile + x,
                   (M)1 << (ddx + R));
      }
    }
    __syncthreads();
    if (!qvalid) continue;
    for (int r = 0; r <= 2 * R; ++r) {
      M bits = mask_s[r * kThreads + tid];
      if (!bits) continue;
      mask_s[r * kThreads + tid] = 0;
      const int row = (ly + 2 * R - r) * side + lx + R;  // dy = r - R
      while (bits) {
        int bit;
        if constexpr (sizeof(M) == 8) {
          bit = __ffsll((long long)bits) - 1;
        } else {
          bit = __ffs((int)bits) - 1;
        }
        bits &= bits - 1;
        const int h = row + R - bit;  // dx = bit - R
        // the corner: d - floor(t)
        const int e = ((r << 16) | bit) - code_s[h];
        const float2 fr = frac_s[h];
        const float w = ((e >> 16) ? fr.x : 1.f - fr.x) *
                        ((e & 1) ? fr.y : 1.f - fr.y);
        if constexpr (CW == 4) {
          const float4 m4 = *reinterpret_cast<const float4*>(md_s + h * 4);
          acc[0] = fmaf(w, m4.x, acc[0]);
          acc[1] = fmaf(w, m4.y, acc[1]);
          acc[2] = fmaf(w, m4.z, acc[2]);
          acc[3] = fmaf(w, m4.w, acc[3]);
        } else {
          acc[0] = fmaf(w, md_s[h], acc[0]);
        }
      }
    }
  }
  if (qvalid) {
    const size_t hw = (size_t)a.H * a.W;
    T* out = dx + ((size_t)b * a.C + g * Cg + c0) * hw +
             (size_t)(qy0 + ly) * a.W + qx0 + lx;
#pragma unroll
    for (int j = 0; j < CW; ++j) out[j * hw] = from_f<T>(acc[j]);
  }
}

// ---- the exact mode: sources bucketed by key tile, sorted in each tile ------

// A list entry: the word (lk << 24 | s) and the source's offsets as given,
// from which the gather takes the fractions ty - floor(ty), tx - floor(tx)
// as the main kernel does. bf16: int2 (the word, the two offsets' bits);
// f32: int4.
template <typename T>
struct Entry;
template <>
struct Entry<bf16> {
  using V = int2;
  static __device__ __forceinline__ V make(int word, float ty, float tx) {
    // ty, tx came from bf16: the conversion back is exact
    return make_int2(word, (int)((uint32_t)__bfloat16_as_ushort(
                                     __float2bfloat16_rn(ty)) |
                                 ((uint32_t)__bfloat16_as_ushort(
                                      __float2bfloat16_rn(tx)) << 16)));
  }
  static __device__ __forceinline__ float ty(V e) {
    return __bfloat162float(__ushort_as_bfloat16((uint16_t)(e.y & 0xffff)));
  }
  static __device__ __forceinline__ float tx(V e) {
    return __bfloat162float(
        __ushort_as_bfloat16((uint16_t)((uint32_t)e.y >> 16)));
  }
};
template <>
struct Entry<float> {
  using V = int4;
  static __device__ __forceinline__ V make(int word, float ty, float tx) {
    return make_int4(word, __float_as_int(ty), __float_as_int(tx), 0);
  }
  static __device__ __forceinline__ float ty(V e) {
    return __int_as_float(e.y);
  }
  static __device__ __forceinline__ float tx(V e) {
    return __int_as_float(e.z);
  }
};

// A lane's walk over its chunk's sources s, s + 32, s + 64, ... of a plane:
// the tap k (its row and column in the kernel) and the output pixel p = (oy,
// ox) of s, kept by additions, so that the loop does no integer division
struct Walk {
  int s, k, p, oy, ox, tky, tkx;
  __device__ __forceinline__ Walk(int s0, const Args& a, int HWo) {
    s = s0;
    k = s0 / HWo;
    p = s0 - k * HWo;
    oy = p / a.Wo;
    ox = p - oy * a.Wo;
    tky = k / a.kw;
    tkx = k - tky * a.kw;
  }
  __device__ __forceinline__ void step(const Args& a, int HWo) {
    s += 32;
    p += 32;
    ox += 32;
    while (ox >= a.Wo) {
      ox -= a.Wo;
      ++oy;
    }
    while (oy >= a.Ho) {
      oy -= a.Ho;
      p -= HWo;
      ++k;
      if (++tkx == a.kw) {
        tkx = 0;
        ++tky;
      }
    }
  }
};

// The key tile of a source whose sample lies at (py + ty, px + tx), and its
// entry word, or -1 where its floor corner lies outside [-1, H-1] x [-1,
// W-1] (no corner of the sample touches the image; NaN offsets too). The
// sums are taken in float, exact for the integers they hold, so a huge
// offset never reaches an int conversion.
__device__ __forceinline__ int key_tile_of(float ty, float tx, int py,
                                           int px, int s, const Args& a,
                                           int ktx, int* word) {
  const float yf = (float)py + floorf(ty);
  const float xf = (float)px + floorf(tx);
  if (!(yf >= -1.f && yf <= (float)(a.H - 1) && xf >= -1.f &&
        xf <= (float)(a.W - 1)))
    return -1;
  const int ky = (int)yf + 1;
  const int kx = (int)xf + 1;
  const uint32_t lk = (ky % kKeyTile) * kKeyTile + kx % kKeyTile;
  *word = (int)((lk << kSrcBits) | (uint32_t)s);
  return (ky / kKeyTile) * ktx + kx / kKeyTile;
}

// The next kBatch rounds of a lane's walk (u < n_rounds, s < n): each
// source's offsets (one coalesced row of 32 a round), key tile (or -1) and
// entry word
template <typename T>
__device__ __forceinline__ void walk_batch(const T* __restrict__ offset,
                                           int plane, Walk& wk, int n_rounds,
                                           int n, const Args& a, int K,
                                           int HWo, int ktx,
                                           int (&kt)[kBatch],
                                           int (&word)[kBatch],
                                           float (&ty)[kBatch],
                                           float (&tx)[kBatch]) {
  int py[kBatch], px[kBatch], s[kBatch];
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    s[u] = u < n_rounds && wk.s < n ? wk.s : -1;
    py[u] = wk.oy + wk.tky * a.dil - a.pad;
    px[u] = wk.ox + wk.tkx * a.dil - a.pad;
    ty[u] = 0.f;
    tx[u] = 0.f;
    if (s[u] >= 0) {
      const T* o = offset + 2 * ((long long)plane * K + wk.k) * HWo + wk.p;
      ty[u] = to_f(__ldg(o));
      tx[u] = to_f(__ldg(o + HWo));
    }
    wk.step(a, HWo);
  }
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    word[u] = 0;
    kt[u] = s[u] >= 0 ? key_tile_of(ty[u], tx[u], py[u], px[u], s[u], a,
                                     ktx, &word[u])
                      : -1;
  }
}

// Within a warp, the lanes whose `bin` (-1 or more) equals this lane's
// (every lane takes part): their mask, the leader (the first of them) and
// this lane's place among them
struct Peers {
  unsigned mask;
  int leader, before;
  __device__ __forceinline__ explicit Peers(int bin) {
    mask = __match_any_sync(0xffffffffu, bin);
    leader = __ffs(mask) - 1;
    before = __popc(mask & ((1u << (threadIdx.x & 31)) - 1u));
  }
  // the same from one ballot a bit, for bins of `bits` bits (faster than
  // __match_any_sync for the key sort's 8-bit keys); `all_keyed`: no lane
  // holds -1
  __device__ __forceinline__ Peers(int bin, int bits, bool all_keyed) {
    const unsigned keyed =
        all_keyed ? 0xffffffffu : __ballot_sync(0xffffffffu, bin >= 0);
    mask = bin >= 0 ? keyed : ~keyed;
#pragma unroll
    for (int i = 0; i < bits; ++i) {
      const bool set = (bin >> i) & 1;
      const unsigned b = __ballot_sync(0xffffffffu, set);
      mask &= set ? b : ~b;
    }
    leader = __ffs(mask) - 1;
    before = __popc(mask & ((1u << (threadIdx.x & 31)) - 1u));
  }
};

// The bucket kernels: global warp w = plane * nc + chunk takes the chunk's
// sources s in [chunk * 32 * rounds, ...), in order, each warp with kt
// counters of its own in shared memory.
//   bucket_count_kernel: each key tile's sources in the chunk, stored at
//     [plane][kt * nc + chunk] of the counts (every slot written);
//   bucket_scan_kernel: each plane's counts, in (key tile, chunk) order,
//     -> their exclusive prefix sums; the row's last slot, the total;
//   bucket_place_kernel: each source's entry at its key tile's start for
//     the chunk + its rank among the chunk's sources of that tile (one
//     __match_any_sync a round ranks the lanes). So each key tile's entries
//     lie in ascending source index, whatever order the blocks ran in.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    bucket_count_kernel(const T* __restrict__ offset, int* __restrict__ cnt,
                        Args a, ExactGrid eg, int planes) {
  extern __shared__ int bucket_ctr[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int* c = bucket_ctr + warp * eg.kt;
  const long long gw = (long long)blockIdx.x * kWarps + warp;
  if (gw >= (long long)planes * eg.nc) return;
  for (int i = lane; i < eg.kt; i += 32) c[i] = 0;
  __syncwarp();
  const int plane = (int)(gw / eg.nc);
  const int chunk = (int)(gw - (long long)plane * eg.nc);
  const int K = a.kh * a.kw, HWo = a.Ho * a.Wo, n = K * HWo;
  Walk wk(chunk * eg.rounds * 32 + lane, a, HWo);
  for (int r0 = 0; r0 < eg.rounds; r0 += kBatch) {
    int kt[kBatch], word[kBatch];
    float ty[kBatch], tx[kBatch];
    walk_batch(offset, plane, wk, eg.rounds - r0, n, a, K, HWo, eg.ktx, kt,
               word, ty, tx);
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (kt[u] >= 0) atomicAdd(c + kt[u], 1);
  }
  __syncwarp();
  int* row = cnt + plane * eg.cnt_row;
  for (int i = lane; i < eg.kt; i += 32)
    row[(long long)i * eg.nc + chunk] = c[i];
}

constexpr int kScanThreads = 1024;

// One row of n ints: the first n - 1 (the counts; the last slot is taken
// as 0) -> their exclusive prefix sums, so that slot n - 1 gets the total;
// 4 entries a thread and 4096 a step, the carry between steps
__global__ void __launch_bounds__(kScanThreads)
    bucket_scan_kernel(int* __restrict__ rows, long long n) {
  __shared__ int warp_sum[kScanThreads / 32];
  __shared__ int step_total;
  int* row = rows + blockIdx.x * n;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int carry = 0;
  for (long long base = 0; base < n; base += 4 * kScanThreads) {
    int v[4], sum = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long i = base + 4 * tid + j;
      v[j] = i < n - 1 ? row[i] : 0;
      sum += v[j];
    }
    int incl = sum;  // inclusive over the warp's threads
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += t;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int own = warp_sum[lane];
      int w_incl = own;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, w_incl, d);
        if (lane >= d) w_incl += t;
      }
      warp_sum[lane] = w_incl - own;
      if (lane == 31) step_total = w_incl;
    }
    __syncthreads();
    int run = carry + warp_sum[warp] + incl - sum;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long i = base + 4 * tid + j;
      if (i < n) row[i] = run;
      run += v[j];
    }
    carry += step_total;
    __syncthreads();  // warp_sum and step_total are rewritten next step
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    bucket_place_kernel(const T* __restrict__ offset,
                        const int* __restrict__ cnt,
                        typename Entry<T>::V* __restrict__ ent, Args a,
                        ExactGrid eg, int planes) {
  extern __shared__ int bucket_ctr[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int* c = bucket_ctr + warp * eg.kt;
  const long long gw = (long long)blockIdx.x * kWarps + warp;
  if (gw >= (long long)planes * eg.nc) return;
  const int plane = (int)(gw / eg.nc);
  const int chunk = (int)(gw - (long long)plane * eg.nc);
  const int* row = cnt + plane * eg.cnt_row;
  for (int i = lane; i < eg.kt; i += 32)
    c[i] = row[(long long)i * eg.nc + chunk];
  __syncwarp();
  const int K = a.kh * a.kw, HWo = a.Ho * a.Wo, n = K * HWo;
  typename Entry<T>::V* e = ent + (long long)plane * n;
  Walk wk(chunk * eg.rounds * 32 + lane, a, HWo);
  for (int r0 = 0; r0 < eg.rounds; r0 += kBatch) {
    int kt[kBatch], word[kBatch];
    float ty[kBatch], tx[kBatch];
    walk_batch(offset, plane, wk, eg.rounds - r0, n, a, K, HWo, eg.ktx, kt,
               word, ty, tx);
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const Peers pr(kt[u]);
      int at = 0;
      if (lane == pr.leader && kt[u] >= 0) {
        at = c[kt[u]];
        c[kt[u]] = at + __popc(pr.mask);
      }
      at = __shfl_sync(0xffffffffu, at, pr.leader) + pr.before;
      if (kt[u] >= 0) e[at] = Entry<T>::make(word[u], ty[u], tx[u]);
      __syncwarp();
    }
  }
}

// Exclusive prefix sum over the block's 256 threads of v; `total` gets the
// sum. Every thread calls it.
__device__ __forceinline__ int block_scan(int v, int* warp_sum, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += t;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int own = lane < kWarps ? warp_sum[lane] : 0;
    int w_incl = own;
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, w_incl, d);
      if (lane >= d) w_incl += t;
    }
    if (lane < kWarps) warp_sum[lane] = w_incl - own;
    if (lane == kWarps - 1) warp_sum[kWarps] = w_incl;
  }
  __syncthreads();
  *total = warp_sum[kWarps];
  return warp_sum[warp] + incl - v;
}

// Each key tile's entries (in ascending source index) by key, a block a
// (key tile, plane): a stable counting sort of the 256 keys. Warp w takes
// the w-th eighth of the entries in rounds of 32 and counts (key, w); a
// scan in (key, w) order gives each (key, w) its start; a second pass ranks
// each round's lanes by key (Peers) and puts every entry at its start +
// rank. So each key's list lies in ascending source index, and `kst` gets
// each key's start and the tile's end. A tile of at most kSortSmem / (2 *
// entry) entries (the main path's and the deform blocks' tiles) is sorted
// in shared memory, read and written back in whole rows; a fuller one (a
// hot spot) from one array to the other in device memory, by the same two
// passes: linear in the lists' lengths either way.
template <typename V>
__global__ void __launch_bounds__(kThreads)
    key_sort_kernel(const int* __restrict__ cnt, const V* __restrict__ ent,
                    V* __restrict__ ent2, int* __restrict__ kst, ExactGrid eg,
                    int per_plane) {
  constexpr int cap = kSortSmem / (2 * (int)sizeof(V));
  extern __shared__ __align__(16) unsigned char sort_smem[];
  __shared__ int c[kTileKeys * kWarps];
  __shared__ int warp_sum[kWarps + 1];
  const int kt = blockIdx.x, plane = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int* row = cnt + plane * eg.cnt_row;
  const int a0 = row[(long long)kt * eg.nc];
  const int n = row[(long long)(kt + 1) * eg.nc] - a0;
  const V* g_src = ent + (long long)plane * per_plane + a0;
  V* g_dst = ent2 + (long long)plane * per_plane + a0;
  const bool staged = n <= cap;
  V* s_in = reinterpret_cast<V*>(sort_smem);
  const V* src = staged ? s_in : g_src;
  V* dst = staged ? s_in + cap : g_dst;
  if (staged)
#pragma unroll 8
    for (int x = tid; x < n; x += kThreads) s_in[x] = g_src[x];
#pragma unroll
  for (int w = 0; w < kWarps; ++w) c[w * kThreads + tid] = 0;
  __syncthreads();
  const int per_warp = (n + kThreads - 1) / kThreads * 32;
  const int lo = warp * per_warp;
  const int hi = min(lo + per_warp, n);
  for (int x0 = lo; x0 < hi; x0 += 32 * kBatch) {
    int lk[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int x = x0 + 32 * u + lane;
      lk[u] = x < hi ? (int)((uint32_t)src[x].x >> kSrcBits) : -1;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (lk[u] >= 0) atomicAdd(c + lk[u] * kWarps + warp, 1);
  }
  __syncthreads();
  int v[kWarps], sum = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    v[w] = c[tid * kWarps + w];
    sum += v[w];
  }
  int total;
  int run = block_scan(sum, warp_sum, &total);
  int* krow = kst + plane * eg.kst_row + (long long)kt * (kTileKeys + 1);
  krow[tid] = a0 + run;
  if (tid == 0) krow[kTileKeys] = a0 + n;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    c[tid * kWarps + w] = run;
    run += v[w];
  }
  __syncthreads();
  for (int x0 = lo; x0 < hi; x0 += 32 * kBatch) {
    V e[kBatch];
    int lk[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int x = x0 + 32 * u + lane;
      if (x < hi) e[u] = src[x];
      lk[u] = x < hi ? (int)((uint32_t)e[u].x >> kSrcBits) : -1;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (x0 + 32 * u >= hi) break;  // the warp's range ends
      const Peers pr(lk[u], 8, x0 + 32 * u + 32 <= hi);
      int at = 0;
      if (lane == pr.leader && lk[u] >= 0) {
        at = c[lk[u] * kWarps + warp];
        c[lk[u] * kWarps + warp] = at + __popc(pr.mask);
      }
      at = __shfl_sync(0xffffffffu, at, pr.leader) + pr.before;
      if (lk[u] >= 0) dst[at] = e[u];
      __syncwarp();
    }
  }
  if (staged) {
    __syncthreads();
#pragma unroll 8
    for (int x = tid; x < n; x += kThreads) g_dst[x] = dst[x];
  }
}

// The tiled gather's window: the entries a block holds, for each its
// fractions and its m * dcol row (8 + 16 bytes)
constexpr int kWindow = kWindowSmem / 24 & ~15;

constexpr int kGatherIlp = 4;  // list entries a thread takes together
constexpr int kStageIlp = 8;   // rows a thread stages together

// dx by pixel tile (the exact mode where a group has 4 channels: the main
// path): a block a (16 x 16 pixel tile, plane). Pixel q's four
// candidate keys (qy-1+ry, qx-1+rx) are (ky, kx) = (qy+ry, qx+rx), so the
// tile's sums read the 17 x 17 keys from its corner on: rows of 16 in its
// own key tiles and one key of the next key tile to the right, the last
// row in the key tiles below. The block lays those keys' sorted lists end
// to end in key order (row by row) and streams that sequence through
// shared memory in windows of kWindow entries, a thread an entry
// (kStageIlp entries, then their m * dcol rows, in flight): each entry's
// fractions ty - floor(ty), tx - floor(tx) taken once, its row read once
// from the scratch for the four pixels that share its key. Then a thread a
// pixel adds the part of its four lists in the window: keys in order, each
// list in ascending source index, corners of weight 0 skipped, one fmaf
// each, the sum rounded once into T and written NCHW. A tile whose lists
// hold more than one window (a hot spot: offsets that draw many samples to
// a few corners) takes as many windows as it needs, each entry read once:
// its cost is linear in the lists' lengths, and the order is the same.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    dx_tiles_kernel(const int* __restrict__ kst,
                    const typename Entry<T>::V* __restrict__ ent2,
                    const float* __restrict__ mdc, T* __restrict__ dx, Args a,
                    ExactGrid eg) {
  using V = typename Entry<T>::V;
  constexpr int cap = kWindow;
  extern __shared__ __align__(16) unsigned char window_smem[];
  float2* fr = reinterpret_cast<float2*>(window_smem);
  float4* ms = reinterpret_cast<float4*>(window_smem + (size_t)cap * 8);
  __shared__ int kbeg[kHaloKeys + 1];  // each key's start in the sequence
  __shared__ int kdel[kHaloKeys];      // its start in ent2 minus that
  __shared__ int warp_sum[kWarps + 1];
  const int tid = threadIdx.x;
  const int pty = blockIdx.x / eg.ptx_n, ptx = blockIdx.x - pty * eg.ptx_n;
  const int plane = blockIdx.z;
  const int Cg = 4;
  const int per_plane = a.kh * a.kw * a.Ho * a.Wo;
  const int* krow = kst + plane * eg.kst_row;
  // 1. the 289 keys' lists: thread t takes keys 2t and 2t + 1
  int kn[2], ks[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = 2 * tid + h;
    const int ky = pty * kKeyTile + j / kHalo;
    const int kx = ptx * kKeyTile + j % kHalo;
    kn[h] = 0;
    ks[h] = 0;
    if (j < kHaloKeys && ky <= a.H && kx <= a.W) {
      const long long at =
          (long long)((ky / kKeyTile) * eg.ktx + kx / kKeyTile) *
              (kTileKeys + 1) +
          (ky % kKeyTile) * kKeyTile + kx % kKeyTile;
      ks[h] = krow[at];
      kn[h] = krow[at + 1] - ks[h];
    }
  }
  int n;
  const int first = block_scan(kn[0] + kn[1], warp_sum, &n);
  if (2 * tid < kHaloKeys) {
    kbeg[2 * tid] = first;
    kdel[2 * tid] = ks[0] - first;
  }
  if (2 * tid + 1 < kHaloKeys) {
    kbeg[2 * tid + 1] = first + kn[0];
    kdel[2 * tid + 1] = ks[1] - first - kn[0];
  }
  if (tid == 0) kbeg[kHaloKeys] = n;
  __syncthreads();
  const int py = tid / kKeyTile, px = tid % kKeyTile;
  const V* e_plane = ent2 + (long long)plane * per_plane;
  const float4* md =
      reinterpret_cast<const float4*>(mdc) + (long long)plane * per_plane;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int w0 = 0; w0 < n; w0 += cap) {
    const int wn = min(cap, n - w0);
    // 2. the window, a thread an entry, kStageIlp in flight: its key row
    //    by a search of the rows' starts, then the row's own run (16 keys
    //    of its key tile) or its last key (of the key tile to the right);
    //    its fractions and its m * dcol row
    for (int x0 = tid; x0 < wn; x0 += kThreads * kStageIlp) {
      V e[kStageIlp];
#pragma unroll
      for (int u = 0; u < kStageIlp; ++u) {
        const int at = w0 + x0 + u * kThreads;
        if (at < w0 + wn) {
          int lo = 0, hi = kHalo;  // the last row with kbeg[row * 17] <= at
          while (hi - lo > 1) {
            const int mid = (lo + hi) >> 1;
            if (kbeg[mid * kHalo] <= at) lo = mid; else hi = mid;
          }
          const int k0 =
              lo * kHalo + (at >= kbeg[lo * kHalo + kKeyTile] ? kKeyTile : 0);
          e[u] = __ldg(e_plane + at + kdel[k0]);
        }
      }
      float4 mv[kStageIlp];
#pragma unroll
      for (int u = 0; u < kStageIlp; ++u)
        if (x0 + u * kThreads < wn) mv[u] = __ldg(md + (e[u].x & kSrcMask));
#pragma unroll
      for (int u = 0; u < kStageIlp; ++u) {
        const int x = x0 + u * kThreads;
        if (x < wn) {
          const float ty = Entry<T>::ty(e[u]), tx = Entry<T>::tx(e[u]);
          fr[x] = make_float2(ty - floorf(ty), tx - floorf(tx));
          ms[x] = mv[u];
        }
      }
    }
    __syncthreads();
    // 3. the pixel's four lists, the part in this window
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int key = (py + (r >> 1)) * kHalo + px + (r & 1);
      const int lo = max(kbeg[key], w0) - w0;
      const int hi = min(kbeg[key + 1], w0 + wn) - w0;
      for (int x0 = lo; x0 < hi; x0 += kGatherIlp) {
        float w[kGatherIlp];
        float4 mv[kGatherIlp];
#pragma unroll
        for (int u = 0; u < kGatherIlp; ++u) {
          w[u] = 0.f;
          if (x0 + u < hi) {
            const float2 f = fr[x0 + u];
            w[u] = ((r >> 1) ? 1.f - f.x : f.x) * ((r & 1) ? 1.f - f.y : f.y);
          }
        }
#pragma unroll
        for (int u = 0; u < kGatherIlp; ++u)
          if (w[u] != 0.f) mv[u] = ms[x0 + u];
#pragma unroll
        for (int u = 0; u < kGatherIlp; ++u) {
          if (w[u] != 0.f) {
            acc[0] = fmaf(w[u], mv[u].x, acc[0]);
            acc[1] = fmaf(w[u], mv[u].y, acc[1]);
            acc[2] = fmaf(w[u], mv[u].z, acc[2]);
            acc[3] = fmaf(w[u], mv[u].w, acc[3]);
          }
        }
      }
    }
    __syncthreads();  // the next window overwrites fr and ms
  }
  const int qy = pty * kKeyTile + py, qx = ptx * kKeyTile + px;
  if (qy < a.H && qx < a.W) {
    const int b = plane / a.G;
    const int g = plane - b * a.G;
    const size_t hw = (size_t)a.H * a.W;
    T* out = dx + ((size_t)b * a.C + g * Cg) * hw + (size_t)qy * a.W + qx;
#pragma unroll
    for (int j = 0; j < 4; ++j) out[j * hw] = from_f<T>(acc[j]);
  }
}

// dx by lists (the exact mode where a group has other than 4 channels: the
// deform blocks' widths): a thread a
// (plane, input pixel, CW channels), the chunks of one pixel side by side,
// so that they read each entry together and its m * dcol row in one run;
// the pixel's four keys in order, each key's sorted list read in place
// (its start from `kst`), kGatherIlp entries' loads in flight at a time;
// the same sums, one fmaf each in the same order, rounded once, NCHW.
template <typename T, int CW>
__global__ void __launch_bounds__(kThreads)
    dx_lists_kernel(const int* __restrict__ kst,
                    const typename Entry<T>::V* __restrict__ ent2,
                    const float* __restrict__ mdc, T* __restrict__ dx, Args a,
                    ExactGrid eg, long long n_threads) {
  using V = typename Entry<T>::V;
  const int Cg = a.C / a.G;
  const int chunks = Cg / CW;
  const int HW = a.H * a.W;
  const int per_plane = a.kh * a.kw * a.Ho * a.Wo;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_threads; i += (long long)gridDim.x * blockDim.x) {
    const long long pq = i / chunks;
    const int c0 = (int)(i - pq * chunks) * CW;
    const int plane = (int)(pq / HW);
    const int q = (int)(pq - (long long)plane * HW);
    const int qy = q / a.W;
    const int qx = q - qy * a.W;
    const int* krow = kst + plane * eg.kst_row;
    const V* e = ent2 + (long long)plane * per_plane;
    const float* md = mdc + (long long)plane * per_plane * Cg + c0;
    float acc[CW];
#pragma unroll
    for (int j = 0; j < CW; ++j) acc[j] = 0.f;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int ky = qy + (r >> 1), kx = qx + (r & 1);
      const long long at =
          (long long)((ky / kKeyTile) * eg.ktx + kx / kKeyTile) *
              (kTileKeys + 1) +
          (ky % kKeyTile) * kKeyTile + kx % kKeyTile;
      const int lo = krow[at], hi = krow[at + 1];
      for (int x0 = lo; x0 < hi; x0 += kGatherIlp) {
        float w[kGatherIlp], mv[kGatherIlp][CW];
        int src[kGatherIlp];
#pragma unroll
        for (int u = 0; u < kGatherIlp; ++u) {
          w[u] = 0.f;
          src[u] = 0;
          if (x0 + u < hi) {
            const V ev = __ldg(e + x0 + u);
            const float ty = Entry<T>::ty(ev), tx = Entry<T>::tx(ev);
            const float ly = ty - floorf(ty), lx = tx - floorf(tx);
            w[u] = ((r >> 1) ? 1.f - ly : ly) * ((r & 1) ? 1.f - lx : lx);
            src[u] = ev.x & kSrcMask;
          }
        }
#pragma unroll
        for (int u = 0; u < kGatherIlp; ++u) {
          if (w[u] != 0.f) {
            const float* m = md + (size_t)src[u] * Cg;
            if constexpr (CW == 4) {
              const float4 m4 = __ldg(reinterpret_cast<const float4*>(m));
              mv[u][0] = m4.x; mv[u][1] = m4.y; mv[u][2] = m4.z; mv[u][3] = m4.w;
            } else {
              mv[u][0] = __ldg(m);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kGatherIlp; ++u) {
          if (w[u] != 0.f) {
#pragma unroll
            for (int j = 0; j < CW; ++j) acc[j] = fmaf(w[u], mv[u][j], acc[j]);
          }
        }
      }
    }
    const int b = plane / a.G;
    const int g = plane - b * a.G;
    T* out = dx + ((size_t)b * a.C + g * Cg + c0) * HW + q;
#pragma unroll
    for (int j = 0; j < CW; ++j) out[(size_t)j * HW] = from_f<T>(acc[j]);
  }
}

// dW: for each (o, c, k), 8 lanes sum the partials of the slots of k's tap
// group and write dweight (Cout, C, K) in T; then, where groups span chunks
// (n_sub > 1), doffset and dmask as the sums of their slices' partials, in
// slice order
template <typename T>
__global__ void finish_kernel(const float* __restrict__ dw_part,
                              T* __restrict__ dweight,
                              const float* __restrict__ pdoff,
                              const float* __restrict__ pdmsk,
                              T* __restrict__ doffset, T* __restrict__ dmask,
                              int cout, int C, int K, int groups, int slots,
                              long long n_msk, int n_sub) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long start = (long long)blockIdx.x * blockDim.x + threadIdx.x;
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
  if (n_sub > 1) {
    for (long long i = start; i < 2 * n_msk; i += stride) {
      float s = 0.f;
      for (int q = 0; q < n_sub; ++q) s += pdoff[q * 2 * n_msk + i];
      doffset[i] = from_f<T>(s);
    }
    if (dmask) {
      for (long long i = start; i < n_msk; i += stride) {
        float s = 0.f;
        for (int q = 0; q < n_sub; ++q) s += pdmsk[q * n_msk + i];
        dmask[i] = from_f<T>(s);
      }
    }
  }
}

// ---- launches ----------------------------------------------------------------

bool aligned(const void* p, size_t n) {
  return reinterpret_cast<uintptr_t>(p) % n == 0;
}

// Sets the kernel's shared memory and returns the grid: work items x
// slots, at most `max_slots` blocks a work item, no more than there are
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
              (per_sm > 0 ? per_sm : 1) / a.pl.work;
  if (slots > n_tiles) slots = n_tiles;
  if (slots > max_slots) slots = max_slots;
  if (slots < 1) slots = 1;
  *grid = slots * a.pl.work;
  return cudaSuccess;
}

// The main kernels' pointer arguments
struct Bufs {
  const void *xg, *offset, *mask, *weight, *gout;
  float* mdc;
  void *doffset, *dmask;
  float *dw_part, *pdoff, *pdmsk;
  uint4* colbuf;
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
      static_cast<const T*>(p.gout), p.mdc, static_cast<T*>(p.doffset),
      static_cast<T*>(p.dmask), p.dw_part, p.pdoff, p.pdmsk, p.colbuf, a,
      vec_gout);
  return cudaGetLastError();
}

template <int CP, bool WIDE>
cudaError_t launch_bf16_vw(bool vec4, const Bufs& p, const Args& a,
                           int max_slots, int vec_gout, int* grid,
                           cudaStream_t s) {
  const size_t smem =
      bf16_layout(CP, a.pl.ocp, a.pl.gpc * kTaps, WIDE && a.pl.split).total;
  return vec4 ? launch_main<bf16>(dcn_bwd_bf16_kernel<CP, 4, WIDE>, smem, p,
                                  a, max_slots, vec_gout, grid, s)
              : launch_main<bf16>(dcn_bwd_bf16_kernel<CP, 1, WIDE>, smem, p,
                                  a, max_slots, vec_gout, grid, s);
}

// The split form's dW kernel: as many splits of the tiles as make ~4
// blocks an SM, at most the slots the dW partials have room for
template <int CP>
cudaError_t launch_dw_split(const Bufs& p, const Args& a, int max_slots,
                            int vec_gout, int* splits, cudaStream_t s) {
  const int n_tiles = a.B * ((a.Ho * a.Wo + kTilePix - 1) / kTilePix);
  const int blocks_a_split = a.pl.work * a.pl.n_oc;
  int sp = (4 * device_attr(cudaDevAttrMultiProcessorCount) +
            blocks_a_split - 1) / blocks_a_split;
  if (sp > n_tiles) sp = n_tiles;
  if (sp > max_slots) sp = max_slots;
  if (sp < 1) sp = 1;
  *splits = sp;
  const size_t smem = (size_t)kTilePix * kTaps * CP * 2 + 64 * kTilePix * 2;
  dw_split_kernel<CP><<<blocks_a_split * sp, kThreads, smem, s>>>(
      static_cast<const bf16*>(p.gout), p.colbuf, p.dw_part, a, sp, vec_gout);
  return cudaGetLastError();
}

template <int CP>
cudaError_t launch_bf16(bool vec4, const Bufs& p, const Args& a,
                        int max_slots, int vec_gout, int* grid,
                        cudaStream_t s) {
  const bool wide = a.pl.n_oc > 1 || a.pl.n_sub > 1 || a.Cout % 16 != 0;
  return wide ? launch_bf16_vw<CP, true>(vec4, p, a, max_slots, vec_gout,
                                         grid, s)
              : launch_bf16_vw<CP, false>(vec4, p, a, max_slots, vec_gout,
                                          grid, s);
}

template <int CP, int NOC>
cudaError_t launch_f32(bool vec4, const Bufs& p, const Args& a, int max_slots,
                       int* grid, cudaStream_t s) {
  const size_t smem = f32_layout(CP, NOC * 16, a.pl.gpc * kTaps).total;
  return vec4 ? launch_main<float>(dcn_bwd_f32_kernel<CP, NOC, 4>, smem, p,
                                   a, max_slots, 0, grid, s)
              : launch_main<float>(dcn_bwd_f32_kernel<CP, NOC, 1>, smem, p,
                                   a, max_slots, 0, grid, s);
}

template <typename T, int CW, typename M>
cudaError_t launch_gather_m(const void* offset, const float* mdc, void* dx,
                            const Args& a, int R, cudaStream_t s) {
  auto kernel = dx_gather_kernel<T, CW, M>;
  const size_t smem = dx_layout(R, CW, sizeof(M)).total;
  if (smem > (size_t)device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles = ((a.H + kDxTile - 1) / kDxTile) *
                    ((a.W + kDxTile - 1) / kDxTile);
  const dim3 grid(tiles, a.C / CW, a.B);
  kernel<<<grid, kThreads, smem, s>>>(static_cast<const T*>(offset), mdc,
                                      static_cast<T*>(dx), a, R);
  return cudaGetLastError();
}

// The gather at radius R: 4 channels a pass where Cg allows it (vec4) and
// the halo's m * dcol fits in shared memory (R <= 25 with 64-bit words),
// else one
template <typename T>
cudaError_t launch_gather(bool vec4, const void* offset, const float* mdc,
                          void* dx, const Args& a, int R, cudaStream_t s) {
  const size_t optin = device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin);
  if (R <= kMaxGatherR32)
    return vec4 ? launch_gather_m<T, 4, unsigned>(offset, mdc, dx, a, R, s)
                : launch_gather_m<T, 1, unsigned>(offset, mdc, dx, a, R, s);
  using u64 = unsigned long long;
  return vec4 && dx_layout(R, 4, sizeof(u64)).total <= optin
             ? launch_gather_m<T, 4, u64>(offset, mdc, dx, a, R, s)
             : launch_gather_m<T, 1, u64>(offset, mdc, dx, a, R, s);
}

template <typename T>
cudaError_t launch_dx_tiles(const int* kst, const void* ent2, const float* mdc,
                            void* dx, const Args& a, const ExactGrid& eg,
                            int planes, cudaStream_t s) {
  auto kernel = dx_tiles_kernel<T>;
  const size_t smem = (size_t)kWindow * 24;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(eg.pty_n * eg.ptx_n, 1, planes);
  kernel<<<grid, kThreads, smem, s>>>(
      kst, static_cast<const typename Entry<T>::V*>(ent2), mdc,
      static_cast<T*>(dx), a, eg);
  return cudaGetLastError();
}

template <typename T, int CW>
cudaError_t launch_dx_lists(const int* kst, const void* ent2, const float* mdc,
                            void* dx, const Args& a, const ExactGrid& eg,
                            int planes, int sms, cudaStream_t s) {
  const long long n_threads = (long long)planes * a.H * a.W * (a.C / a.G / CW);
  long long blocks = (n_threads + kThreads - 1) / kThreads;
  if (blocks > 64LL * sms) blocks = 64LL * sms;
  dx_lists_kernel<T, CW><<<(unsigned)blocks, kThreads, 0, s>>>(
      kst, static_cast<const typename Entry<T>::V*>(ent2), mdc,
      static_cast<T*>(dx), a, eg, n_threads);
  return cudaGetLastError();
}

// Whether the exact mode's dx takes the call: at most 2^24 sources (taps x
// output pixels) a plane, whose index fits an entry's word, at most
// kMaxKeyTiles key tiles ((H + 1) x (W + 1) keys), whose counters fit a
// block's shared memory, and at most 65535 planes (a grid's y and z)
bool exact_takes(const Args& a) {
  const int K = a.kh * a.kw;
  return (long long)K * a.Ho * a.Wo <= (1LL << kSrcBits) &&
         exact_grid(a.H, a.W, K, a.Ho * a.Wo).kt <= kMaxKeyTiles &&
         (long long)a.B * a.G <= 65535;
}

// The exact mode's dx: the sources bucketed by key tile (count, scan,
// placement: two passes over the offsets), each key tile's entries sorted
// by key, then the gather by pixel tile (a group of 4 channels, the main
// path) or by lists (other groups, a pixel's chunks side by side reading
// each m * dcol row in one run)
template <typename T>
cudaError_t exact_dx(const void* offset, const float* mdc, void* dx,
                     float* work, const Scratch& sc, bool vec4, const Args& a,
                     int sms, cudaStream_t s) {
  const int K = a.kh * a.kw;
  const int HWo = a.Ho * a.Wo;
  const int planes = a.B * a.G;
  const ExactGrid eg = exact_grid(a.H, a.W, K, HWo);
  // the arrays from a 16-byte aligned base (the f32 entries are int4; the
  // workspace holds 3 floats of slack for it)
  float* base = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(work) + 15) & ~uintptr_t(15));
  int* cnt = reinterpret_cast<int*>(base + sc.cnt);
  int* kst = reinterpret_cast<int*>(base + sc.kst);
  using V = typename Entry<T>::V;
  V* ent = reinterpret_cast<V*>(base + sc.ent);
  V* ent2 = reinterpret_cast<V*>(base + sc.ent2);
  const T* off = static_cast<const T*>(offset);
  if (planes == 0) return cudaSuccess;
  const long long warps = (long long)planes * eg.nc;
  const unsigned blocks = (unsigned)((warps + kWarps - 1) / kWarps);
  const size_t ctr = (size_t)kWarps * eg.kt * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      key_sort_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSortSmem);
  if (err != cudaSuccess) return err;
  if (blocks > 0) {
    bucket_count_kernel<T><<<blocks, kThreads, ctr, s>>>(off, cnt, a, eg,
                                                         planes);
  }
  bucket_scan_kernel<<<planes, kScanThreads, 0, s>>>(cnt, eg.cnt_row);
  if (blocks > 0) {
    bucket_place_kernel<T><<<blocks, kThreads, ctr, s>>>(off, cnt, ent, a,
                                                         eg, planes);
  }
  key_sort_kernel<V><<<dim3(eg.kt, planes), kThreads, kSortSmem, s>>>(
      cnt, ent, ent2, kst, eg, K * HWo);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (vec4 && a.C == 4 * a.G)
    return launch_dx_tiles<T>(kst, ent2, mdc, dx, a, eg, planes, s);
  if (vec4)
    return launch_dx_lists<T, 4>(kst, ent2, mdc, dx, a, eg, planes, sms, s);
  return launch_dx_lists<T, 1>(kst, ent2, mdc, dx, a, eg, planes, sms, s);
}

template <typename T>
cudaError_t run_all(const void* x, void* xg, const void* offset,
                    const void* mask, const void* weight, const void* gout,
                    void* dx, void* doffset, void* dmask, void* dweight,
                    float* work, const Args& a, cudaStream_t s) {
  const Plan& pl = a.pl;
  const int Cg = a.C / a.G;
  const int HW = a.H * a.W;
  const int K = a.kh * a.kw;
  const int sms = device_attr(cudaDevAttrMultiProcessorCount);
  const int slot_cap = max_slots(pl, sms);
  // the dx gather's window radius, or 0 for the exact mode's sorted lists
  const int R = gather_radius(a.dmax);
  if (R < 0 || (R == 0 && !exact_takes(a))) return cudaErrorInvalidValue;
  const Scratch sc = scratch_floats(pl, slot_cap, a.B, a.C, a.Cout, a.H, a.W,
                                    a.G, K, a.Ho * a.Wo, R == 0);
  float* mdc = work + sc.md;
  // 0. the channels-last copy of x
  const long long items = (long long)a.B * a.G * HW;
  const bool vec4 = Cg % 4 == 0 && aligned(xg, 4 * sizeof(T)) &&
                    aligned(mdc, 16);
  if (items > 0) {
    // a thread (b, g, pixel) for Cg = 4, else a thread an element
    long long blocks = (items * (Cg == 4 && vec4 ? 1 : Cg) + 255) / 256;
    if (blocks > 16LL * sms) blocks = 16LL * sms;
    prep_kernel<T><<<(unsigned)blocks, 256, 0, s>>>(
        static_cast<const T*>(x), static_cast<T*>(xg), a.B, a.G, Cg, HW,
        Cg == 4 && vec4 ? 1 : 0);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  // 1. the main kernel, for chunks padded to 16, 32, 48 or 64 channels
  float* pdoff = sc.doff ? work + sc.dw : nullptr;
  float* pdmsk = sc.doff && mask ? work + sc.dw + sc.doff : nullptr;
  // the stored columns of the split form, from the 16-byte aligned base
  float* base = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(work) + 15) & ~uintptr_t(15));
  const Bufs p{xg, offset, mask, weight, gout, mdc, doffset, dmask,
               work, pdoff, pdmsk,
               pl.split ? reinterpret_cast<uint4*>(base + sc.col) : nullptr};
  int grid = 0;
  int dw_slots = 0;  // the dW partials the finish kernel sums
  cudaError_t err = cudaErrorInvalidValue;
  if constexpr (sizeof(T) == 2) {
    const int vg = (a.Ho * a.Wo) % 8 == 0 && aligned(gout, 16);
    switch (pl.cp) {
      case 16: err = launch_bf16<16>(vec4, p, a, slot_cap, vg, &grid, s); break;
      case 32: err = launch_bf16<32>(vec4, p, a, slot_cap, vg, &grid, s); break;
      case 48: err = launch_bf16<48>(vec4, p, a, slot_cap, vg, &grid, s); break;
      case 64: err = launch_bf16<64>(vec4, p, a, slot_cap, vg, &grid, s); break;
    }
    if (err == cudaSuccess && pl.split) {
      switch (pl.cp) {
        case 16: err = launch_dw_split<16>(p, a, slot_cap, vg, &dw_slots, s); break;
        case 32: err = launch_dw_split<32>(p, a, slot_cap, vg, &dw_slots, s); break;
        case 48: err = launch_dw_split<48>(p, a, slot_cap, vg, &dw_slots, s); break;
        case 64: err = launch_dw_split<64>(p, a, slot_cap, vg, &dw_slots, s); break;
      }
    }
  } else {
    switch (pl.cp) {
      case 16: err = launch_f32<16, 4>(vec4, p, a, slot_cap, &grid, s); break;
      case 32: err = launch_f32<32, 4>(vec4, p, a, slot_cap, &grid, s); break;
      case 48: err = launch_f32<48, 4>(vec4, p, a, slot_cap, &grid, s); break;
      case 64: err = launch_f32<64, 4>(vec4, p, a, slot_cap, &grid, s); break;
    }
  }
  if (err != cudaSuccess) return err;
  if (!pl.split) dw_slots = grid / pl.work;
  // 2. dx: the gather in windowed mode, the tiles' sorted lists in the exact
  //    mode
  if (HW > 0) {
    err = R > 0 ? launch_gather<T>(vec4, offset, mdc, dx, a, R, s)
                : exact_dx<T>(offset, mdc, dx, work, sc, vec4, a, sms, s);
    if (err != cudaSuccess) return err;
  }
  // 3. the dW partials summed into dweight, the doffset and dmask partials
  //    summed where groups span chunks
  const long long n_msk = (long long)a.B * a.G * K * a.Ho * a.Wo;
  long long need = 8LL * a.Cout * a.C * K;
  if (pl.n_sub > 1 && 2 * n_msk > need) need = 2 * n_msk;
  long long blocks = (need + 255) / 256;
  if (blocks > 16LL * sms) blocks = 16LL * sms;
  if (blocks < 1) blocks = 1;
  finish_kernel<T><<<(unsigned)blocks, 256, 0, s>>>(
      work, static_cast<T*>(dweight), pdoff, pdmsk, static_cast<T*>(doffset),
      static_cast<T*>(dmask), a.Cout, a.C, K, pl.tap_groups, dw_slots,
      n_msk, pl.n_sub);
  return cudaGetLastError();
}

}  // namespace

// float32 elements of the scratch `work` that fami_dcn_bwd needs for this
// call on the current device: the dW partials, the doffset / dmask partials
// where an offset group has more than 64 channels, the dx gathers' m *
// dcol, and in the exact mode (max_offset <= 0) the sort's arrays, whose
// size depends on the input plane H x W.
extern "C" long long fami_dcn_bwd_workspace(int B, int C, int Cout, int H,
                                            int W, int Ho, int Wo, int kh,
                                            int kw, int groups,
                                            float max_offset) {
  if (groups < 1 || C < 1 || Cout < 1 || C % groups != 0) return 0;
  // the larger of the two types' plans (the bf16 split form has more
  // slots and stores its columns)
  const int sms = device_attr(cudaDevAttrMultiProcessorCount);
  long long most = 0;
  for (int bf = 0; bf < 2; ++bf) {
    const Plan pl = make_plan(C, Cout, kh * kw, groups, bf == 1);
    const long long n =
        scratch_floats(pl, max_slots(pl, sms), B, C, Cout, H, W, groups,
                       kh * kw, Ho * Wo, gather_radius(max_offset) == 0)
            .total;
    if (n > most) most = n;
  }
  return most;
}

// dtype: 0 = float32, 1 = bfloat16 (x, x_grouped, offset, mask, weight,
// gout and the four gradients share it). Scratch the caller allocates, none
// of it initialised: x_grouped of x's size and type; work, float32 of
// fami_dcn_bwd_workspace elements. mask and dmask may be null together
// (DCNv1). Returns a cudaError_t; cudaErrorInvalidValue for arguments no
// kernel takes (groups not dividing C, an unknown dtype, no channels, a
// window over kMaxGatherR = 31 px).
extern "C" int fami_dcn_bwd(const void* x, void* x_grouped,
                            const void* offset, const void* mask,
                            const void* weight, const void* gout, void* dx,
                            void* doffset, void* dmask, void* dweight,
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
  a.pl = make_plan(C, Cout, kh * kw, groups, dtype == 1);
  float* wk = static_cast<float*>(work);
  if (dtype == 0)
    return (int)run_all<float>(x, x_grouped, offset, mask, weight, gout, dx,
                               doffset, dmask, dweight, wk, a, s);
  return (int)run_all<bf16>(x, x_grouped, offset, mask, weight, gout, dx,
                            doffset, dmask, dweight, wk, a, s);
}
