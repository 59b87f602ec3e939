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
// memory (or, in the shuffle variant, into registers), the block
// synchronises, and the gather or rotation reads the staged copy, never
// device memory. A launch that builds, runs and returns the input's values
// bit for bit says that a Hopper kernel can rely on the mechanism.
//
// What bounds them on an H100: nothing but the launch. Each moves 4-32 KB in
// and as much out (a few nanoseconds at 3.35 TB/s) and does no arithmetic,
// so the time is the ~2-3 us a kernel launch occupies the card. They are
// probes, not hot-path kernels; one block (one per batch entry for the 3-D
// probe) keeps the whole tile in one SM's shared memory, which is the point.
//
// Indices must lie inside the gathered axis, as for torch.gather; the kernels
// clamp them so that no thread ever reads outside the staged tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

// out[r][j] = x[r][idx[r][j]]: a gather along the last (lane) axis of one
// (rows, cols) tile held in one block's shared memory. Thread j of a warp
// reads word idx of row r: random columns of one row, so up to 32 threads
// can meet in one bank (a gather's own pattern; a broadcast where they ask
// for the same word). Two bf16 values share a 32-bit bank word.
template <typename T>
__global__ void probe_gather_lane_kernel(const T* __restrict__ x,
                                         const int* __restrict__ idx,
                                         T* __restrict__ out, int rows,
                                         int cols) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* tile = reinterpret_cast<T*>(smem);
  const int count = rows * cols;
  stage(tile, x, count);
  for (int e = threadIdx.x; e < count; e += blockDim.x) {
    const int r = e / cols;
    out[e] = tile[r * cols + clamp_index(idx[e], cols)];
  }
}

// out[b][r][j] = x[b][r][idx[b][r][j]]: the lane gather on a batch of f32
// tiles (axis 2 of a 3-D array). One block per leading index b stages its
// own (rows, cols) tile, so the batch spreads over the SMs and each gather
// still stays inside one block's shared memory.
__global__ void probe_gather_3d_kernel(const float* __restrict__ x,
                                       const int* __restrict__ idx,
                                       float* __restrict__ out, int rows,
                                       int cols) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* tile = reinterpret_cast<float*>(smem);
  const int count = rows * cols;
  const size_t base = (size_t)blockIdx.x * count;
  stage(tile, x + base, count);
  for (int e = threadIdx.x; e < count; e += blockDim.x) {
    const int r = e / cols;
    out[base + e] = tile[r * cols + clamp_index(idx[base + e], cols)];
  }
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
// row-stacked DCN would make. The whole (rows, cols) tile sits in one
// block's shared memory (32 KB at (64, 128) f32). Thread j of a warp reads
// word idx * cols + j: with cols a multiple of 32 its bank is j % 32 whatever
// row it asks for, so a warp's 32 reads never conflict.
__global__ void probe_gather_rows_kernel(const float* __restrict__ x,
                                         const int* __restrict__ idx,
                                         float* __restrict__ out, int rows,
                                         int cols) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* tile = reinterpret_cast<float*>(smem);
  const int count = rows * cols;
  stage(tile, x, count);
  for (int e = threadIdx.x; e < count; e += blockDim.x) {
    const int j = e % cols;
    out[e] = tile[clamp_index(idx[e], rows) * cols + j];
  }
}

// out[r][j] = x[r][(j - s) mod cols]: a rotation along the lane axis by an
// amount the kernel reads from device memory (any integer, negative too).
// Neighbouring threads read neighbouring words of the staged row: no bank
// conflicts.
__global__ void probe_dynamic_roll_kernel(const float* __restrict__ x,
                                          const int* __restrict__ shift,
                                          float* __restrict__ out, int rows,
                                          int cols) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* tile = reinterpret_cast<float*>(smem);
  const int count = rows * cols;
  stage(tile, x, count);
  int s = shift[0] % cols;
  if (s < 0) s += cols;
  for (int e = threadIdx.x; e < count; e += blockDim.x) {
    const int r = e / cols;
    int j = e - r * cols - s;
    if (j < 0) j += cols;
    out[e] = tile[r * cols + j];
  }
}

bool tile_fits(long long bytes) {
  return bytes > 0 && bytes <= kMaxStaticTileBytes;
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
  if (variant != 0) return (int)cudaErrorInvalidValue;
  const long long elems = (long long)rows * cols;
  if (dtype == 0) {
    if (!tile_fits(elems * 4)) return (int)cudaErrorInvalidValue;
    probe_gather_lane_kernel<float><<<1, kThreads, elems * 4, s>>>(
        static_cast<const float*>(x), ix, static_cast<float*>(out), rows,
        cols);
  } else if (dtype == 1) {
    if (!tile_fits(elems * 2)) return (int)cudaErrorInvalidValue;
    probe_gather_lane_kernel<__nv_bfloat16><<<1, kThreads, elems * 2, s>>>(
        static_cast<const __nv_bfloat16*>(x), ix,
        static_cast<__nv_bfloat16*>(out), rows, cols);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// x, out: (batch, rows, cols) float32; idx: int32 of the same shape.
extern "C" int fami_probe_gather_3d(const void* x, const void* idx, void* out,
                                    int batch, int rows, int cols,
                                    void* stream) {
  const long long bytes = (long long)rows * cols * 4;
  if (batch <= 0 || rows <= 0 || cols <= 0 || !tile_fits(bytes))
    return (int)cudaErrorInvalidValue;
  probe_gather_3d_kernel<<<batch, kThreads, bytes,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(idx),
      static_cast<float*>(out), rows, cols);
  return (int)cudaGetLastError();
}

// x, out: (rows, cols) float32; idx: (rows, cols) int32 row numbers.
extern "C" int fami_probe_gather_rows(const void* x, const void* idx,
                                      void* out, int rows, int cols,
                                      void* stream) {
  const long long bytes = (long long)rows * cols * 4;
  if (rows <= 0 || cols <= 0 || !tile_fits(bytes))
    return (int)cudaErrorInvalidValue;
  probe_gather_rows_kernel<<<1, kThreads, bytes,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(idx),
      static_cast<float*>(out), rows, cols);
  return (int)cudaGetLastError();
}

// x, out: (rows, cols) float32; shift: one int32 in device memory.
extern "C" int fami_probe_dynamic_roll(const void* x, const void* shift,
                                       void* out, int rows, int cols,
                                       void* stream) {
  const long long bytes = (long long)rows * cols * 4;
  if (rows <= 0 || cols <= 0 || !tile_fits(bytes))
    return (int)cudaErrorInvalidValue;
  probe_dynamic_roll_kernel<<<1, kThreads, bytes,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(shift),
      static_cast<float*>(out), rows, cols);
  return (int)cudaGetLastError();
}
