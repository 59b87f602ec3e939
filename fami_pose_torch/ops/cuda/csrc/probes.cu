// On-chip gather and rotate probes for Hopper.
//
// Replace the four Mosaic capability probes of tools/mosaic_watch.py
// (bf16_gather, gather_3d, cross_tile_gather, dynamic_roll). Each TPU probe
// asks its compiler for one data movement *inside on-chip memory* (VMEM): a
// gather along the lane axis of a bf16 tile, the same on a batch of f32
// tiles, a gather across rows (the sublane axis), and a lane rotation whose
// amount is only known at run time. The DCN and warp kernels of the TPU
// package were shaped by which of these Mosaic refuses.
//
// The kernels here compute exactly those functions at the probes' shapes and
// types, and they do it the same way: the tile is first staged into shared
// memory (or, in the shuffle variants, into registers), and the gather or
// rotation reads the staged copy, never device memory. A launch that
// builds, runs and returns the input's values bit for bit says that a Hopper
// kernel can rely on the mechanism.
//
// What bounds them on an H100: nothing but the launch. Each moves 4-32 KB in
// and as much out (a few nanoseconds at 3.35 TB/s) and does no arithmetic,
// so the time is the ~1.1 us an empty kernel's launch occupies the card
// (an empty node of a replayed CUDA graph) plus the dependent trips to
// memory. They are probes, not hot-path kernels. Each kernel makes one
// round trip: every thread issues its loads of the tile and of the indices
// (or the shift) together, before the one barrier. The lane gathers split
// their tile into groups of rows, one block each (a lane gather never
// mixes rows; the 3-D probe has several blocks a batch entry), and the row
// gather into strips of 32 columns (its columns never mix), so that what a
// block gathers from sits in its SM's shared memory, which is the point.
// The rotation at the probe's shape ((16, 128) f32) runs from registers,
// one warp a row, with its shift read from device memory while the tile's
// loads are in flight, as torch.roll with a host shift makes one trip
// (PERF.md: 1.42-1.49 us against torch.roll's 1.58-1.70 on an H100 80GB
// HBM3 at 700 W, device-side; nvcc 12.9: 20 registers, no shared memory,
// no spills).
//
// Indices must lie inside the gathered axis, as for torch.gather; the kernels
// clamp them so that no thread ever reads outside the staged tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;  // one block does all the work: make it wide
constexpr int kMaxStaticTileBytes = 48 * 1024;

__device__ __forceinline__ int clamp_index(int i, int n) {
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// Stage `count` elements of `src` into shared memory with the whole block.
template <typename T>
__device__ __forceinline__ void stage(T* tile, const T* __restrict__ src,
                                      int count) {
  for (int e = threadIdx.x; e < count; e += blockDim.x) tile[e] = src[e];
  __syncthreads();
}

// The lane gathers move element bits (16 for bf16, 32 for f32), so one
// template serves both types: E is the element's unsigned integer of the
// same width. A chunk is V neighbouring elements of one row, moved as one
// access of V * sizeof(E) bytes, and their V indices: on the vector path V
// = 4 (8 bytes of bf16 or 16 of f32, the indices one 16-byte load), on the
// scalar path one element (rows of a column count that is not a multiple
// of 4, or a pointer not 16-byte aligned). Four bf16 values a chunk, not
// eight: half the serial shared-memory reads a thread, twice the threads
// (1.51-1.54 us against 1.69-1.73 for 16-byte bf16 chunks in turns on an
// H100 80GB HBM3 at 700 W, PERF.md).
template <int Bytes> struct RawOf;
template <> struct RawOf<16> { using type = uint4; };
template <> struct RawOf<8> { using type = uint2; };
template <> struct RawOf<4> { using type = unsigned; };
template <> struct RawOf<2> { using type = unsigned short; };

template <typename E, int V>
union Chunk {
  typename RawOf<sizeof(E) * V>::type raw;
  E e[V];
};

// A chunk's indices: V = 4, one 16-byte load; V = 1, one int in i[0].
union IdxChunk {
  int4 q;
  int i[4];
};

template <int V>
__device__ __forceinline__ IdxChunk load_idx(const int* __restrict__ p,
                                             int c) {
  static_assert(V == 1 || V == 4, "a chunk is 1 or 4 elements");
  IdxChunk id;
  if constexpr (V == 4)
    id.q = __ldg(reinterpret_cast<const int4*>(p) + c);
  else
    id.i[0] = __ldg(p + c);
  return id;
}

constexpr int kChunksAhead = 2;  // chunks a thread holds in registers
constexpr int kChunksPerBlock = 64;  // the row group's size, in chunks
constexpr int kLaneMaxThreads = 256;

// out[r][j] = x[r][idx[r][j]] on a group of `group` rows of one (rows, cols)
// tile: block b takes tile b / groups, rows (b % groups) * group onward. A
// lane gather never mixes rows, so the blocks need nothing of each other.
// Each thread issues the loads of its chunks of x AND of idx together,
// before the barrier, into registers (one round trip to memory; the
// earlier form staged the whole tile by a strided loop of scalar loads in
// one block and read idx only after the barrier: two dependent trips);
// then it writes its x chunks into the staged rows, passes the one
// barrier, gathers V values from the staged row and stores them as one
// chunk. Thread j of a warp reads random words of its row: up to 32 threads
// can meet in one bank (a gather's own pattern; two bf16 values share a
// bank word).
template <typename E, int V>
__device__ __forceinline__ void gather_lane_group(const E* __restrict__ x,
                                                  const int* __restrict__ idx,
                                                  E* __restrict__ out,
                                                  int rows, int cols,
                                                  int group, int groups) {
  extern __shared__ __align__(16) unsigned char smem[];
  using Raw = typename RawOf<sizeof(E) * V>::type;
  const int tile = blockIdx.x / groups;
  const int r0 = (blockIdx.x - tile * groups) * group;
  const int nr = rows - r0 < group ? rows - r0 : group;
  const size_t base = ((size_t)tile * rows + r0) * cols;
  const Raw* xs = reinterpret_cast<const Raw*>(x + base);
  const int* is = idx + base;
  Raw* os = reinterpret_cast<Raw*>(out + base);
  Raw* staged = reinterpret_cast<Raw*>(smem);
  const E* rowsm = reinterpret_cast<const E*>(smem);
  const int chunks = nr * cols / V;  // cols % V == 0: no chunk spans rows
  Chunk<E, V> vals[kChunksAhead];
  IdxChunk ids[kChunksAhead];
#pragma unroll
  for (int k = 0; k < kChunksAhead; ++k) {
    const int c = threadIdx.x + k * blockDim.x;
    if (c < chunks) {
      vals[k].raw = __ldg(xs + c);
      ids[k] = load_idx<V>(is, c);
    }
  }
#pragma unroll
  for (int k = 0; k < kChunksAhead; ++k) {
    const int c = threadIdx.x + k * blockDim.x;
    if (c < chunks) staged[c] = vals[k].raw;
  }
  for (int c = threadIdx.x + kChunksAhead * blockDim.x; c < chunks;
       c += blockDim.x)
    staged[c] = __ldg(xs + c);  // rows wider than the block's chunks
  __syncthreads();
  auto gather = [&](int c, const IdxChunk& id) {
    const E* row = rowsm + (c * V / cols) * cols;
    Chunk<E, V> o;
#pragma unroll
    for (int i = 0; i < V; ++i) o.e[i] = row[clamp_index(id.i[i], cols)];
    os[c] = o.raw;
  };
#pragma unroll
  for (int k = 0; k < kChunksAhead; ++k) {
    const int c = threadIdx.x + k * blockDim.x;
    if (c < chunks) gather(c, ids[k]);
  }
  for (int c = threadIdx.x + kChunksAhead * blockDim.x; c < chunks;
       c += blockDim.x)
    gather(c, load_idx<V>(is, c));
}

// The lane gather of one (rows, cols) tile, bf16 or f32 (tiles = 1).
template <typename E, int V>
__global__ void probe_gather_lane_kernel(const E* __restrict__ x,
                                         const int* __restrict__ idx,
                                         E* __restrict__ out, int rows,
                                         int cols, int group, int groups) {
  gather_lane_group<E, V>(x, idx, out, rows, cols, group, groups);
}

// out[b][r][j] = x[b][r][idx[b][r][j]]: the lane gather on a batch of f32
// tiles (axis 2 of a 3-D array), `groups` blocks a batch entry, so the
// batch and its rows spread over the SMs and each gather still stays inside
// one block's shared memory.
template <int V>
__global__ void probe_gather_3d_kernel(const unsigned* __restrict__ x,
                                       const int* __restrict__ idx,
                                       unsigned* __restrict__ out, int rows,
                                       int cols, int group, int groups) {
  gather_lane_group<unsigned, V>(x, idx, out, rows, cols, group, groups);
}

// The same lane gather from registers, by warp shuffles: a warp owns a row
// of 128 columns as 4 segments of 32 lanes, lane l holding columns l, 32 + l,
// 64 + l and 96 + l in 4 registers. For output column j with source column
// i, the value sits in lane i % 32, register i / 32: four shuffles (one per
// register, every lane naming its source lane) and a select. bf16 values
// travel as their 16 bits.
__global__ void probe_gather_lane_shfl_kernel(
    const __nv_bfloat16* __restrict__ x, const int* __restrict__ idx,
    __nv_bfloat16* __restrict__ out, int rows) {
  constexpr int kCols = 128, kSeg = kCols / 32;
  const int lane = threadIdx.x & 31;
  const int warps = (gridDim.x * blockDim.x) >> 5;
  for (int r = (blockIdx.x * blockDim.x + threadIdx.x) >> 5; r < rows;
       r += warps) {
    unsigned reg[kSeg];
#pragma unroll
    for (int k = 0; k < kSeg; ++k)
      reg[k] = __bfloat16_as_ushort(x[r * kCols + k * 32 + lane]);
#pragma unroll
    for (int s = 0; s < kSeg; ++s) {
      const int i = clamp_index(idx[r * kCols + s * 32 + lane], kCols);
      unsigned got = 0;
#pragma unroll
      for (int k = 0; k < kSeg; ++k) {
        const unsigned v = __shfl_sync(0xffffffffu, reg[k], i & 31);
        if (k == (i >> 5)) got = v;
      }
      out[r * kCols + s * 32 + lane] =
          __ushort_as_bfloat16((unsigned short)got);
    }
  }
}

// out[i][j] = x[idx[i][j]][j]: a gather across rows (axis 0), the access a
// row-stacked DCN would make. Output column j reads only column j, so the
// tile is cut into strips of 32 columns, one block each (4 blocks of 8 KB
// at (64, 128) f32): the staging spreads over as many SMs, and each strip
// sits in its block's shared memory as rows of 32 words. Lane l of a warp
// owns column l of the strip and warp w rows w, w + warps, ...; before the
// staging barrier each thread issues the loads of its first kRowsAhead rows
// of the tile and of idx together, into registers, so the two trips to
// memory are one (a single block that read idx only after staging the
// whole 32 KB tile made two dependent trips). The gather then reads word idx * 32 + l
// of the staged strip, in bank l whatever row it asks for: a warp's 32
// reads never conflict (with fewer than 32 columns a strip row is cols
// words). PERF.md: 2.05-2.31 us against the single block's 4.26-4.33 in
// turns on an H100 80GB HBM3 at 700 W, device-side; nvcc 12.9: 32
// registers, no spills.
constexpr int kStripCols = 32;
constexpr int kRowsAhead = 8;

__global__ void probe_gather_rows_kernel(const float* __restrict__ x,
                                         const int* __restrict__ idx,
                                         float* __restrict__ out, int rows,
                                         int cols) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* strip = reinterpret_cast<float*>(smem);
  const int stride = cols < kStripCols ? cols : kStripCols;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int col = blockIdx.x * kStripCols + lane;
  const bool mine = lane < stride && col < cols;
  int ahead[kRowsAhead];
  float vals[kRowsAhead];
#pragma unroll
  for (int k = 0; k < kRowsAhead; ++k) {
    const int r = warp + k * warps;
    const bool in = mine && r < rows;
    ahead[k] = in ? __ldg(idx + (size_t)r * cols + col) : 0;
    vals[k] = in ? __ldg(x + (size_t)r * cols + col) : 0.f;
  }
#pragma unroll
  for (int k = 0; k < kRowsAhead; ++k) {
    const int r = warp + k * warps;
    if (mine && r < rows) strip[r * stride + lane] = vals[k];
  }
  if (mine)
    for (int r = warp + kRowsAhead * warps; r < rows; r += warps)
      strip[r * stride + lane] = __ldg(x + (size_t)r * cols + col);
  __syncthreads();
  if (!mine) return;
#pragma unroll
  for (int k = 0; k < kRowsAhead; ++k) {
    const int r = warp + k * warps;
    if (r < rows)
      out[(size_t)r * cols + col] =
          strip[clamp_index(ahead[k], rows) * stride + lane];
  }
  for (int r = warp + kRowsAhead * warps; r < rows; r += warps)
    out[(size_t)r * cols + col] =
        strip[clamp_index(__ldg(idx + (size_t)r * cols + col), rows) * stride +
              lane];
}

// out[r][j] = x[r][(j - s) mod cols]: a rotation along the lane axis by an
// amount the kernel reads from device memory (any integer, negative too).
// The shift's load is issued before the tile's, so that the two trips to
// memory overlap (reading it after the staging barrier made them two
// dependent trips, where torch.roll, with a host shift, makes one).
// Neighbouring threads read neighbouring words of the staged row: no bank
// conflicts. The general path, for any (rows, cols) tile.
__global__ void probe_dynamic_roll_kernel(const float* __restrict__ x,
                                          const int* __restrict__ shift,
                                          float* __restrict__ out, int rows,
                                          int cols) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* tile = reinterpret_cast<float*>(smem);
  const int shift_raw = __ldg(shift);
  const int count = rows * cols;
  stage(tile, x, count);
  int s = shift_raw % cols;
  if (s < 0) s += cols;
  for (int e = threadIdx.x; e < count; e += blockDim.x) {
    const int r = e / cols;
    int j = e - r * cols - s;
    if (j < 0) j += cols;
    out[e] = tile[r * cols + j];
  }
}

// The same rotation from registers, for rows of 128 columns (16-byte
// aligned): a warp holds one row, lane l its columns 4l .. 4l + 3 as one
// float4, loaded while the shift's load is in flight. With s mod 128 = 4q +
// r, output column 4l + i comes from lane l - q (component i - r) when
// i >= r, else from lane l - q - 1 (component i - r + 4): eight shuffles
// and a warp-uniform choice of four components, then one 16-byte store. No
// shared memory and no barrier.
__global__ void probe_dynamic_roll_shfl_kernel(const float4* __restrict__ x,
                                               const int* __restrict__ shift,
                                               float4* __restrict__ out,
                                               int rows) {
  const int shift_raw = __ldg(shift);
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (row >= rows) return;  // whole warps: blockDim is a multiple of 32
  const int lane = threadIdx.x & 31;
  const float4 v = __ldg(x + row * 32 + lane);
  int s = shift_raw % 128;
  if (s < 0) s += 128;
  const int q = s >> 2;
  const int la = (lane - q) & 31, lb = (lane - q - 1) & 31;
  const unsigned all = 0xffffffffu;
  const float a0 = __shfl_sync(all, v.x, la), a1 = __shfl_sync(all, v.y, la);
  const float a2 = __shfl_sync(all, v.z, la), a3 = __shfl_sync(all, v.w, la);
  const float b1 = __shfl_sync(all, v.y, lb), b2 = __shfl_sync(all, v.z, lb);
  const float b3 = __shfl_sync(all, v.w, lb);
  float4 o;
  switch (s & 3) {
    case 0: o = make_float4(a0, a1, a2, a3); break;
    case 1: o = make_float4(b3, a0, a1, a2); break;
    case 2: o = make_float4(b2, b3, a0, a1); break;
    default: o = make_float4(b1, b2, b3, a0); break;
  }
  out[row * 32 + lane] = o;
}

// Does nothing: the least time a launch of one block occupies the card
// (chip_smoke.py times it as a node of a replayed CUDA graph, the floor
// under every probe).
__global__ void empty_kernel() {}

bool tile_fits(long long bytes) {
  return bytes > 0 && bytes <= kMaxStaticTileBytes;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The vector path needs rows of whole chunks of 4 and 16-byte aligned x,
// idx and out; any other tile takes the scalar path.
bool lane_vector(const void* x, const void* idx, const void* out, int cols) {
  return cols % 4 == 0 && aligned16(x) && aligned16(idx) && aligned16(out);
}

// Launches a lane gather over `tiles` (rows, cols) tiles: a row group of
// about kChunksPerBlock chunks a block (2 rows of 128 columns),
// one chunk a thread where the group allows it, at most kLaneMaxThreads
// threads; the group's rows are the block's shared memory.
template <typename E, int V>
int launch_lane(void (*kernel)(const E*, const int*, E*, int, int, int, int),
                const void* x, const int* idx, void* out, int tiles, int rows,
                int cols, cudaStream_t s) {
  const int per_row = cols / V;
  int group = kChunksPerBlock / per_row;
  group = group < 1 ? 1 : (group > rows ? rows : group);
  const int groups = (rows + group - 1) / group;
  const long long blocks = (long long)tiles * groups;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const int want = (group * per_row + 31) / 32 * 32;
  const int threads = want < kLaneMaxThreads ? want : kLaneMaxThreads;
  kernel<<<(unsigned)blocks, threads, (size_t)group * cols * sizeof(E), s>>>(
      static_cast<const E*>(x), idx, static_cast<E*>(out), rows, cols, group,
      groups);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and out, (rows, cols)); idx is int32
// of the same shape. Variant 0 gathers from shared memory, variant 1 by warp
// shuffles from registers (bfloat16, cols == 128 only).
extern "C" int fami_probe_gather_lane(const void* x, const void* idx,
                                      void* out, int dtype, int rows,
                                      int cols, int variant, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ix = static_cast<const int*>(idx);
  if (rows <= 0 || cols <= 0) return (int)cudaErrorInvalidValue;
  if (variant == 1) {
    if (dtype != 1 || cols != 128) return (int)cudaErrorInvalidValue;
    const int warps_per_block = kThreads / 32;
    const int blocks = (rows + warps_per_block - 1) / warps_per_block;
    probe_gather_lane_shfl_kernel<<<blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), ix,
        static_cast<__nv_bfloat16*>(out), rows);
    return (int)cudaGetLastError();
  }
  if (variant != 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (!tile_fits((long long)rows * cols * (dtype == 0 ? 4 : 2)))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return lane_vector(x, idx, out, cols)
               ? launch_lane<unsigned, 4>(probe_gather_lane_kernel<unsigned, 4>,
                                          x, ix, out, 1, rows, cols, s)
               : launch_lane<unsigned, 1>(probe_gather_lane_kernel<unsigned, 1>,
                                          x, ix, out, 1, rows, cols, s);
  using u16 = unsigned short;
  return lane_vector(x, idx, out, cols)
             ? launch_lane<u16, 4>(probe_gather_lane_kernel<u16, 4>, x, ix,
                                   out, 1, rows, cols, s)
             : launch_lane<u16, 1>(probe_gather_lane_kernel<u16, 1>, x, ix,
                                   out, 1, rows, cols, s);
}

// x, out: (batch, rows, cols) float32; idx: int32 of the same shape.
extern "C" int fami_probe_gather_3d(const void* x, const void* idx, void* out,
                                    int batch, int rows, int cols,
                                    void* stream) {
  const long long bytes = (long long)rows * cols * 4;
  if (batch <= 0 || rows <= 0 || cols <= 0 || !tile_fits(bytes))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ix = static_cast<const int*>(idx);
  return lane_vector(x, idx, out, cols)
             ? launch_lane<unsigned, 4>(probe_gather_3d_kernel<4>, x, ix, out,
                                        batch, rows, cols, s)
             : launch_lane<unsigned, 1>(probe_gather_3d_kernel<1>, x, ix, out,
                                        batch, rows, cols, s);
}

// x, out: (rows, cols) float32; idx: (rows, cols) int32 row numbers.
extern "C" int fami_probe_gather_rows(const void* x, const void* idx,
                                      void* out, int rows, int cols,
                                      void* stream) {
  const long long bytes = (long long)rows * cols * 4;
  if (rows <= 0 || cols <= 0 || !tile_fits(bytes))
    return (int)cudaErrorInvalidValue;
  // one block a strip of 32 columns, one warp per kRowsAhead rows (at most
  // 32 warps); the strip's shared memory is no larger than the tile's
  const int blocks = (cols + kStripCols - 1) / kStripCols;
  const int want = (rows + kRowsAhead - 1) / kRowsAhead;
  const int warps = want < 32 ? want : 32;
  const int stride = cols < kStripCols ? cols : kStripCols;
  probe_gather_rows_kernel<<<blocks, warps * 32,
                             (size_t)rows * stride * sizeof(float),
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(idx),
      static_cast<float*>(out), rows, cols);
  return (int)cudaGetLastError();
}

// x, out: (rows, cols) float32; shift: one int32 in device memory. Rows of
// 128 columns with 16-byte aligned x and out take the register kernel, one
// warp a row; any other tile the shared-memory kernel.
extern "C" int fami_probe_dynamic_roll(const void* x, const void* shift,
                                       void* out, int rows, int cols,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long bytes = (long long)rows * cols * 4;
  if (rows <= 0 || cols <= 0 || !tile_fits(bytes))
    return (int)cudaErrorInvalidValue;
  if (cols == 128 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(out) % 16 == 0) {
    const int threads = rows * 32 < 512 ? rows * 32 : 512;
    const int blocks = (rows * 32 + threads - 1) / threads;
    probe_dynamic_roll_shfl_kernel<<<blocks, threads, 0, s>>>(
        static_cast<const float4*>(x), static_cast<const int*>(shift),
        static_cast<float4*>(out), rows);
    return (int)cudaGetLastError();
  }
  probe_dynamic_roll_kernel<<<1, kThreads, bytes, s>>>(
      static_cast<const float*>(x), static_cast<const int*>(shift),
      static_cast<float*>(out), rows, cols);
  return (int)cudaGetLastError();
}

// One launch of the empty kernel (one block of 32 threads) on `stream`.
extern "C" int fami_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
