// Decode GEMV for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `_gemv_kernel` / `gemv_pallas` of the JAX
// package (src/repro/kernels/gemv/gemv.py:28,55).
//
// What it computes (the same function as the TPU kernel):
//   out[b, n] = (sum_k x[b, k] * w[k, n]) * scale[n] + bias[n]
// with the sum in f32, the optional per-column scale of an int8 weight
// applied to the f32 sum before the optional bias, cast to x's type.
//
// Bound on this card: memory.  At decode batch B the kernel reads the
// (K, N) weight once and does 2*B flops per weight element, far below
// the H100's ridge (~20 flop/byte in f32, ~295 in bf16), so what counts
// is how fast the weight streams: every byte of w is loaded once per
// block of rows, coalesced, and nothing is written back but the output.
//
// Design (a first design that is right, not yet fast):
//   * a block of 4 warps owns a tile of 128 output columns and 4 rows of
//     x; each lane owns 4 adjacent columns (one 16/8/4-byte vector load
//     per weight row for f32/bf16-f16/int8) and keeps 4 x 4 f32 partials
//     in registers;
//   * the K loop is cut into chunks of 16 rows, dealt round-robin to the
//     4 warps of each of `ksplit` blocks along grid.z (split-K), so that
//     a narrow N (576 at smollm-135m) still puts enough blocks on the
//     132 SMs.  A warp's lanes load the chunk's 16 activations of each
//     row once and broadcast them with shuffles;
//   * the warps' partials are summed in smem in warp order; with split-K
//     each block writes its sum to an f32 workspace, and the last block
//     of a tile to arrive (an integer ticket, no float atomics) adds the
//     ksplit partials in split order and applies scale and bias.  The
//     order of every sum depends only on (K, N, ksplit), and ksplit only
//     on (K, N): a run is deterministic, and row b's result does not
//     depend on how many rows the call has.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 4;             // adjacent columns per lane
constexpr int kTileN = 32 * kVec;   // columns per block
constexpr int kChunk = 16;          // weight rows per warp chunk
constexpr int kRows = 4;            // rows of x per block

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(int8_t v) { return (float)v; }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half_rn(v);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// four adjacent weights as one vector load (p aligned to 4 elements)
__device__ __forceinline__ void load4(const float* p, float (&o)[kVec]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                      float (&o)[kVec]) {
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&v.y));
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}
__device__ __forceinline__ void load4(const __half* p, float (&o)[kVec]) {
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&v.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&v.y));
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}
__device__ __forceinline__ void load4(const int8_t* p, float (&o)[kVec]) {
  const char4 v = __ldg(reinterpret_cast<const char4*>(p));
  o[0] = (float)v.x; o[1] = (float)v.y; o[2] = (float)v.z;
  o[3] = (float)v.w;
}

// the bias in its own type (0 = f32, 1 = bf16, 2 = f16)
__device__ __forceinline__ float bias_at(const void* bias, int dtype,
                                         int n) {
  switch (dtype) {
    case 0: return static_cast<const float*>(bias)[n];
    case 1: return to_f(static_cast<const __nv_bfloat16*>(bias)[n]);
    default: return to_f(static_cast<const __half*>(bias)[n]);
  }
}

template <typename XT, typename WT>
__global__ void __launch_bounds__(kThreads)
    gemv_kernel(const XT* __restrict__ x, const WT* __restrict__ w,
                const void* __restrict__ bias, int bias_dtype,
                const float* __restrict__ scale, XT* __restrict__ out,
                float* __restrict__ ws, int* __restrict__ counters, int B,
                int K, int N, int ksplit, int vec_ok) {
  __shared__ float red[kWarps][kRows][kTileN];
  __shared__ int last;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n_base = blockIdx.x * kTileN;
  const int n0 = n_base + lane * kVec;
  const int b0 = blockIdx.y * kRows;
  const int z = blockIdx.z;
  const int n_chunks = (K + kChunk - 1) / kChunk;
  const int n_units = ksplit * kWarps;

  float acc[kRows][kVec];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int v = 0; v < kVec; ++v) acc[r][v] = 0.f;

  for (int c = z * kWarps + warp; c < n_chunks; c += n_units) {
    const int k0 = c * kChunk;
    const int kn = min(kChunk, K - k0);
    // lane j < kn holds x[b0 + r, k0 + j]
    float xr[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int b = b0 + r;
      xr[r] = (lane < kn && b < B) ? to_f(x[(size_t)b * K + k0 + lane])
                                   : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      if (j < kn) {  // uniform across the warp
        float wv[kVec] = {0.f, 0.f, 0.f, 0.f};
        const WT* wp = w + (size_t)(k0 + j) * N + n0;
        if (n0 < N) {
          if (vec_ok) {
            load4(wp, wv);
          } else {
#pragma unroll
            for (int v = 0; v < kVec; ++v)
              if (n0 + v < N) wv[v] = to_f(wp[v]);
          }
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float xv = __shfl_sync(0xffffffffu, xr[r], j);
#pragma unroll
          for (int v = 0; v < kVec; ++v) acc[r][v] = fmaf(xv, wv[v], acc[r][v]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int v = 0; v < kVec; ++v) red[warp][r][lane * kVec + v] = acc[r][v];
  __syncthreads();

  for (int i = threadIdx.x; i < kRows * kTileN; i += kThreads) {
    const int r = i / kTileN;
    const int col = i % kTileN;
    const int b = b0 + r;
    const int n = n_base + col;
    if (b >= B || n >= N) continue;
    float s = red[0][r][col];
#pragma unroll
    for (int wi = 1; wi < kWarps; ++wi) s += red[wi][r][col];
    if (ksplit == 1) {
      if (scale != nullptr) s *= scale[n];
      if (bias != nullptr) s += bias_at(bias, bias_dtype, n);
      out[(size_t)b * N + n] = from_f<XT>(s);
    } else {
      ws[((size_t)z * B + b) * N + n] = s;
    }
  }
  if (ksplit == 1) return;

  // split-K: the last block of this tile to arrive adds the partials
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    int* cnt = counters + blockIdx.y * gridDim.x + blockIdx.x;
    const int ticket = atomicAdd(cnt, 1);
    last = ticket == ksplit - 1;
    if (last) *cnt = 0;  // every block of the tile has arrived: reset
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = threadIdx.x; i < kRows * kTileN; i += kThreads) {
    const int r = i / kTileN;
    const int col = i % kTileN;
    const int b = b0 + r;
    const int n = n_base + col;
    if (b >= B || n >= N) continue;
    float s = 0.f;
    for (int zz = 0; zz < ksplit; ++zz)
      s += __ldcg(&ws[((size_t)zz * B + b) * N + n]);
    if (scale != nullptr) s *= scale[n];
    if (bias != nullptr) s += bias_at(bias, bias_dtype, n);
    out[(size_t)b * N + n] = from_f<XT>(s);
  }
}

template <typename XT, typename WT>
cudaError_t launch_t(const void* x, const void* w, const void* bias,
                     int bias_dtype, const float* scale, void* out,
                     float* ws, int* counters, int B, int K, int N,
                     int ksplit, int vec_ok, cudaStream_t stream) {
  const dim3 grid((N + kTileN - 1) / kTileN, (B + kRows - 1) / kRows,
                  ksplit);
  gemv_kernel<XT, WT><<<grid, kThreads, 0, stream>>>(
      static_cast<const XT*>(x), static_cast<const WT*>(w), bias,
      bias_dtype, scale, static_cast<XT*>(out), ws, counters, B, K, N,
      ksplit, vec_ok);
  return cudaGetLastError();
}

template <typename XT>
cudaError_t dispatch_w(int w_dtype, const void* x, const void* w,
                       const void* bias, int bias_dtype, const float* scale,
                       void* out, float* ws, int* counters, int B, int K,
                       int N, int ksplit, int vec_ok, cudaStream_t s) {
  switch (w_dtype) {
    case 0:
      return launch_t<XT, float>(x, w, bias, bias_dtype, scale, out, ws,
                                 counters, B, K, N, ksplit, vec_ok, s);
    case 1:
      return launch_t<XT, __nv_bfloat16>(x, w, bias, bias_dtype, scale, out,
                                         ws, counters, B, K, N, ksplit,
                                         vec_ok, s);
    case 2:
      return launch_t<XT, __half>(x, w, bias, bias_dtype, scale, out, ws,
                                  counters, B, K, N, ksplit, vec_ok, s);
    case 3:
      return launch_t<XT, int8_t>(x, w, bias, bias_dtype, scale, out, ws,
                                  counters, B, K, N, ksplit, vec_ok, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = float16, 3 = int8 (w only).
// bias and scale may be null; ws holds ksplit*B*N floats and counters
// ceil(N/128)*ceil(B/4) ints that are zero on entry (and on exit) when
// ksplit > 1.  Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int gemv(const void* x, const void* w, const void* bias,
                    const float* scale, void* out, float* ws, int* counters,
                    int B, int K, int N, int ksplit, int x_dtype,
                    int w_dtype, int bias_dtype, int vec_ok, void* stream) {
  if (B <= 0 || K <= 0 || N <= 0 || ksplit <= 0 ||
      (ksplit > 1 && (ws == nullptr || counters == nullptr)) ||
      (bias != nullptr && (bias_dtype < 0 || bias_dtype > 2)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case 0:
      return (int)dispatch_w<float>(w_dtype, x, w, bias, bias_dtype, scale,
                                    out, ws, counters, B, K, N, ksplit,
                                    vec_ok, s);
    case 1:
      return (int)dispatch_w<__nv_bfloat16>(w_dtype, x, w, bias, bias_dtype,
                                            scale, out, ws, counters, B, K,
                                            N, ksplit, vec_ok, s);
    case 2:
      return (int)dispatch_w<__half>(w_dtype, x, w, bias, bias_dtype, scale,
                                     out, ws, counters, B, K, N, ksplit,
                                     vec_ok, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
