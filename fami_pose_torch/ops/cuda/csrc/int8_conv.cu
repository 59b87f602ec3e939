// The two hand-written halves of the int8 convolution of the serving path
// (TPU.INT8_EVAL): the quantize-and-gather pass in front of the s8 x s8 -> s32
// product and the dequant epilogue behind it (ops/int8_conv.py::int8_conv2d;
// the product itself is torch._int_mm, cuBLASLt).
//
// Replaces no Pallas kernel: the JAX package's int8 convolution is XLA's s8
// conv_general_dilated with preferred_element_type=int32
// (fami_pose_tpu/models/quant.py:102-111, QuantConv in mode "int8"); XLA
// fuses the quantize into the convolution's input and the dequant into its
// epilogue. Both kernels follow QuantConv's arithmetic bit for bit:
//
//   fami_int8_quant_im2col - xq = clip(rint(x_f32 * (1 / act_scale)), -127,
//     127) as int8, written as the im2col matrix A (M = B*Ho*Wo rows, Kp
//     columns; column k = (cin * kh + ky) * kw + kx, the order of an OIHW
//     weight flattened per output channel). Taps outside the image and the
//     columns K..Kp-1 that pad K to a multiple of 8 (cuBLASLt's int8 rule)
//     are 0: JAX pads after quantizing, and a zero quantizes to 0. A 1x1
//     stride-1 convolution is the same kernel with one tap: a quantizing
//     transpose from NCHW to (pixels, channels).
//   fami_int8_dequant - y = float(acc) * (w_scale[n] * act_scale), the
//     product of the two scales formed first, then + bias[n] in f32, then
//     rounded once to the output type, written in NCHW. A 32-bit integer
//     above 2^24 rounds on its way to f32 exactly as XLA's convert does.
//
// Every multiply and add is an explicit _rn intrinsic, so nvcc fuses nothing
// into an FMA (its default --fmad=true would), and the reciprocal is
// __frcp_rn, the IEEE quotient 1 / s that XLA and torch compute. act_scale is
// read from device memory, so a forward has no host synchronisation and can
// be captured in a CUDA graph.
//
// What bounds them on an H100: neither does arithmetic worth counting; A
// reads x once and writes M * Kp bytes (9x the input's elements for a 3x3,
// at one byte each), B reads M * N int32 and writes M * N outputs, so both
// are bound by bytes at 3.35 TB/s. Design: each block transposes one tile
// through shared memory so that both its reads and its writes are coalesced,
// and decodes its rows and columns once, into shared tables, so that no
// element pays an integer division (a first version that decoded every
// element ran A at 9% of its bound):
//   A - a 64-row x 64-column tile of the matrix; a table of the 64 rows
//       (image offset, top-left input pixel) and of the 64 columns (channel
//       plane, tap displacement); a warp reads 32 consecutive output pixels
//       of one tap (consecutive input columns at the stride; the column's
//       entry a shared-memory broadcast) and packs four taps into a 32-bit
//       word in shared memory; then each thread writes 8 bytes of a row,
//       eight threads a row's 64 bytes;
//   B - a 64-row x 32-channel tile; a table of the rows' NCHW offsets and
//       the channels' scales; a warp reads 32 channels of one row (128
//       bytes), dequantizes into f32 shared memory, and writes 32
//       consecutive pixels of one channel.
// The im2col matrix itself is the cost of this route (its bytes are 9x the
// input's for a 3x3): an implicit-GEMM s8 kernel that gathers the taps into
// shared memory and feeds wgmma without writing A is the later design.
//
// Measured (chip_smoke.py phase int8, H100 80GB HBM3, 700 W): over the 307
// int8 convs of a B=8 W48 forward, A 33.1 ms (bound 6.5) and B 9.3-9.5 ms
// (bound 4.2), beside torch._int_mm's 13.0-13.2 and cuDNN's bf16 convs'
// 21.5-21.6 on the same shapes; at 48 -> 48 channels, 3x3, 40 frames of
// 96x72: A 0.280 ms (bound 0.044), B 0.062 (bound 0.024). Build (nvcc 12.9,
// -Xptxas -v, sm_90a): A 32 registers, B 29 (bf16) / 32 (f32), no spills.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsA = 64;   // matrix rows (output pixels) a block of A
constexpr int kColsA = 64;   // matrix columns (taps x channels) a block of A
constexpr int kPadA = 8;     // shared row stride 72 bytes: 8-byte reads
constexpr int kRowsB = 64;   // matrix rows a block of B
constexpr int kColsB = 32;   // output channels a block of B

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
  return __float2bfloat16_rn(v);
}

// QuantConv's activation quantization of one value, as a byte
__device__ __forceinline__ uint32_t quant8(float v, float inv) {
  float q = rintf(__fmul_rn(v, inv));  // round half to even
  q = fminf(fmaxf(q, -127.f), 127.f);
  return (uint32_t)(uint8_t)(int8_t)(int)q;
}

struct Geometry {
  int C, H, W, kh, kw, sh, sw, ph, pw, dh, dw, Ho, Wo, K, Kp;
  long long M;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    quant_im2col_kernel(const T* __restrict__ x,
                        const float* __restrict__ act_scale,
                        int8_t* __restrict__ out, Geometry g) {
  __shared__ __align__(16) uint8_t tile[kRowsA][kColsA + kPadA];
  // the tile's rows: image offset (-1 past M) and top-left input pixel;
  // its columns: channel-plane offset (-1 past K) and tap displacement
  __shared__ long long row_base[kRowsA];
  __shared__ int row_iy[kRowsA], row_ix[kRowsA];
  __shared__ int col_off[kColsA], col_dy[kColsA], col_dx[kColsA];
  const float inv = __frcp_rn(*act_scale);
  const long long m0 = (long long)blockIdx.x * kRowsA;
  const int k0 = blockIdx.y * kColsA;
  const int t = threadIdx.x;
  if (t < kRowsA) {
    const long long m = m0 + t;
    row_base[t] = -1;
    if (m < g.M) {
      const int mi = (int)m;  // M < 2^31 (the entry point checks)
      const int wo = mi % g.Wo;
      const int ho = (mi / g.Wo) % g.Ho;
      const int b = mi / (g.Wo * g.Ho);
      row_base[t] = (long long)b * g.C * g.H * g.W;
      row_iy[t] = ho * g.sh - g.ph;
      row_ix[t] = wo * g.sw - g.pw;
    }
  } else if (t < kRowsA + kColsA) {
    const int j = t - kRowsA;
    const int k = k0 + j;
    col_off[j] = -1;
    if (k < g.K) {
      const int taps = g.kh * g.kw;
      const int c = k / taps;
      const int ky = (k - c * taps) / g.kw;
      const int kx = k - c * taps - ky * g.kw;
      col_off[j] = c * g.H * g.W;
      col_dy[j] = ky * g.dh;
      col_dx[j] = kx * g.dw;
    }
  }
  __syncthreads();

  // gather: thread (r, q) fills row r at the column quads q, q + 4, ...; a
  // warp reads one tap of 32 consecutive output pixels (the column's entry
  // is a shared-memory broadcast)
  const int r = t % kRowsA;
  const int q = t / kRowsA;
  const long long base = row_base[r];
  const int iy0 = row_iy[r], ix0 = row_ix[r];
#pragma unroll
  for (int j = 0; j < kColsA / 4 / (kThreads / kRowsA); ++j) {
    const int quad = q + j * (kThreads / kRowsA);
    uint32_t word = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = quad * 4 + i;
      const int off = col_off[col];
      const int iy = iy0 + col_dy[col];
      const int ix = ix0 + col_dx[col];
      if (base >= 0 && off >= 0 && (unsigned)iy < (unsigned)g.H &&
          (unsigned)ix < (unsigned)g.W)
        word |= quant8(to_f(x[base + off + (long long)iy * g.W + ix]), inv)
                << (8 * i);
    }
    *reinterpret_cast<uint32_t*>(&tile[r][quad * 4]) = word;
  }
  __syncthreads();

  // store: eight threads a row, 8 bytes each (Kp is a multiple of 8, so a
  // chunk lies wholly inside or outside the matrix)
  for (int idx = t; idx < kRowsA * kColsA / 8; idx += kThreads) {
    const int row = idx / (kColsA / 8);
    const int chunk = idx % (kColsA / 8);
    const long long mm = m0 + row;
    const int k = k0 + chunk * 8;
    if (mm < g.M && k < g.Kp)
      *reinterpret_cast<uint2*>(out + mm * g.Kp + k) =
          *reinterpret_cast<const uint2*>(&tile[row][chunk * 8]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dequant_kernel(const int32_t* __restrict__ acc,
                   const float* __restrict__ w_scale,
                   const float* __restrict__ act_scale,
                   const float* __restrict__ bias, T* __restrict__ out,
                   long long M, int N, int P) {
  __shared__ float tile[kColsB][kRowsB + 1];
  __shared__ long long row_out[kRowsB];  // b * N * P + p, or -1 past M
  __shared__ float col_scale[kColsB], col_bias[kColsB];
  const long long m0 = (long long)blockIdx.x * kRowsB;
  const int n0 = blockIdx.y * kColsB;
  const int t = threadIdx.x;
  if (t < kRowsB) {
    const long long m = m0 + t;
    row_out[t] = -1;
    if (m < M) {
      const int mi = (int)m;  // M < 2^31 (the entry point checks)
      const int b = mi / P;
      row_out[t] = (long long)b * N * P + (mi - b * P);
    }
  } else if (t < kRowsB + kColsB) {
    const int j = t - kRowsB;
    const int n = n0 + j;
    if (n < N) {
      // the two scales' product first, as QuantConv forms it
      col_scale[j] = __fmul_rn(w_scale[n], *act_scale);
      col_bias[j] = bias != nullptr ? bias[n] : 0.f;
    }
  }
  __syncthreads();

  // load: a warp reads 32 channels of one row
  for (int idx = t; idx < kRowsB * kColsB; idx += kThreads) {
    const int row = idx / kColsB;
    const int col = idx % kColsB;
    const int n = n0 + col;
    if (row_out[row] >= 0 && n < N) {
      float y = __fmul_rn(__int2float_rn(acc[(m0 + row) * N + n]),
                          col_scale[col]);
      if (bias != nullptr) y = __fadd_rn(y, col_bias[col]);
      tile[col][row] = y;
    }
  }
  __syncthreads();

  // store: a warp writes 32 consecutive pixels of one channel
  for (int idx = t; idx < kRowsB * kColsB; idx += kThreads) {
    const int col = idx / kRowsB;
    const int row = idx % kRowsB;
    const int n = n0 + col;
    if (row_out[row] >= 0 && n < N)
      out[row_out[row] + (long long)n * P] = from_f<T>(tile[col][row]);
  }
}

template <typename T>
cudaError_t launch_im2col(const void* x, const float* act_scale, int8_t* out,
                          const Geometry& g, cudaStream_t s) {
  const dim3 grid((unsigned)((g.M + kRowsA - 1) / kRowsA),
                  (unsigned)((g.Kp + kColsA - 1) / kColsA));
  quant_im2col_kernel<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), act_scale, out, g);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dequant(const int32_t* acc, const float* w_scale,
                           const float* act_scale, const float* bias,
                           void* out, long long M, int N, int P,
                           cudaStream_t s) {
  const dim3 grid((unsigned)((M + kRowsB - 1) / kRowsB),
                  (unsigned)((N + kColsB - 1) / kColsB));
  dequant_kernel<T><<<grid, kThreads, 0, s>>>(
      acc, w_scale, act_scale, bias, static_cast<T*>(out), M, N, P);
  return cudaGetLastError();
}

}  // namespace

// x (B, C, H, W) f32 or bf16 (dtype 0 / 1), act_scale one f32 on the card,
// out (B * Ho * Wo, Kp) int8
extern "C" int fami_int8_quant_im2col(
    const void* x, const void* act_scale, void* out, int dtype, int B, int C,
    int H, int W, int kh, int kw, int sh, int sw, int ph, int pw, int dh,
    int dw, int Ho, int Wo, int Kp, void* stream) {
  const Geometry g{C, H, W, kh, kw, sh, sw, ph, pw, dh, dw, Ho, Wo,
                   C * kh * kw, Kp, (long long)B * Ho * Wo};
  if (g.M <= 0 || g.M > 0x7fffffffLL || Kp % 8 != 0 || Kp < g.K ||
      (long long)C * H * W > 0x7fffffffLL || Kp / kColsA >= 65535)
    return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* sc = static_cast<const float*>(act_scale);
  auto* o = static_cast<int8_t*>(out);
  if (dtype == 0) return (int)launch_im2col<float>(x, sc, o, g, s);
  if (dtype == 1) return (int)launch_im2col<__nv_bfloat16>(x, sc, o, g, s);
  return (int)cudaErrorInvalidValue;
}

// acc (B * P, N) int32, w_scale (N,) f32, act_scale one f32, bias (N,) f32
// or null, out (B, N, P) f32 or bf16 (dtype 0 / 1)
extern "C" int fami_int8_dequant(const void* acc, const void* w_scale,
                                 const void* act_scale, const void* bias,
                                 void* out, int dtype, int B, int N, int P,
                                 void* stream) {
  const long long M = (long long)B * P;
  if (M <= 0 || M > 0x7fffffffLL || N <= 0 || N / kColsB >= 65535)
    return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* a = static_cast<const int32_t*>(acc);
  const auto* ws = static_cast<const float*>(w_scale);
  const auto* sc = static_cast<const float*>(act_scale);
  const auto* bs = static_cast<const float*>(bias);
  if (dtype == 0)
    return (int)launch_dequant<float>(a, ws, sc, bs, out, M, N, P, s);
  if (dtype == 1)
    return (int)launch_dequant<__nv_bfloat16>(a, ws, sc, bs, out, M, N, P, s);
  return (int)cudaErrorInvalidValue;
}
