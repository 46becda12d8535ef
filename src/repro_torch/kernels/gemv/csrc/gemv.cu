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
// Bound on this card: bytes.  At decode batch B the kernel reads the
// (K, N) weight once and does 2*B flops per weight element, far below
// the H100's ridge (~20 flop/byte in f32, ~295 in bf16), so what counts
// is how fast the weight streams.  At the C1 chain's shapes the weight is
// 1.3-7.1 MB, under a microsecond or two at the HBM rate: the kernel has
// to put loads in flight on every SM at once and keep dependent trips
// through device memory off its path.
//
// Design:
//   * the plan (the wrapper's `gemv_plan`, a function of (K, N) only)
//     cuts N into tiles of 32 columns and K into `ksplit` <= 8 splits,
//     aiming at ~384 blocks (about three per SM) so that every SM has
//     weight tiles in flight; grid (ksplit, N tiles, row groups of 4),
//     one cluster of ksplit blocks per (column tile, row group).  At the
//     chain's four shapes: (576, 960) 30 tiles x 8 = 240 blocks,
//     (576, 576) 18 x 8 = 144, (576, 3072) 96 x 4 = 384, (1536, 576)
//     18 x 8 = 144;
//   * a block stages its slice of x (4 rows x its K range, up to 1024
//     columns at a time) in shared memory as f32 once, and streams its
//     (K range x 32) slice of the weight through a ring of 4 stages of
//     32 rows with 16-byte cp.async (plain loads when N's rows are not
//     16-byte aligned), so up to 128 weight rows per block are in flight;
//   * thread t owns 4 adjacent columns and every 16th weight row of a
//     stage, with 4 x 4 f32 partials in registers; the 16 row lanes are
//     added in shared memory in lane order;
//   * the ksplit partials meet through distributed shared memory: each
//     rank stores its partial into rank 0's shared memory, and after one
//     cluster barrier rank 0 adds them in rank order, applies the column
//     scale and then the bias, and writes the output.  No workspace, no
//     ticket, no remote load, one launch.
//     The order of every sum depends on (K, N) only: a run is
//     deterministic, and row b's result does not depend on how many rows
//     the call has.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 128;
constexpr int kVec = 4;                     // adjacent columns per thread
constexpr int kTileN = 32;                  // columns per block
constexpr int kColGroups = kTileN / kVec;   // 8
constexpr int kLanesK = kThreads / kColGroups;  // 16 row lanes
constexpr int kRows = 4;                    // rows of x per block
constexpr int kStageK = 32;                 // weight rows per stage
constexpr int kStages = 4;                  // stages in the ring
constexpr int kChunkX = 1024;               // x columns staged at a time
constexpr int kMaxCluster = 8;

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

// four adjacent weights from shared memory (p aligned to 4 elements)
__device__ __forceinline__ void load4(const float* p, float (&o)[kVec]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                      float (&o)[kVec]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&v.y));
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}
__device__ __forceinline__ void load4(const __half* p, float (&o)[kVec]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&v.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&v.y));
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}
__device__ __forceinline__ void load4(const int8_t* p, float (&o)[kVec]) {
  const char4 v = *reinterpret_cast<const char4*>(p);
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d =
      static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
}

// Shared memory: the weight ring (kStages x kStageK x kTileN WT), x_s
// (kRows x min(kc, kChunkX) f32), red (kLanesK x kRows x kTileN f32, the
// row lanes' partials), part (kMaxCluster x kRows x kTileN f32: in rank
// 0, every rank's partial, written there by that rank).
template <typename WT>
__host__ __device__ constexpr size_t ring_bytes() {
  return sizeof(WT) * kStages * kStageK * kTileN;
}
__host__ __device__ inline int x_cols(int kc) {
  return kc < kChunkX ? kc : kChunkX;
}
template <typename WT>
__host__ __device__ inline size_t smem_bytes(int kc) {
  return ring_bytes<WT>() +
         sizeof(float) * ((size_t)kRows * x_cols(kc) +
                          (size_t)(kLanesK + kMaxCluster) * kRows * kTileN);
}

template <typename XT, typename WT>
__global__ void __launch_bounds__(kThreads)
    gemv_kernel(const XT* __restrict__ x, const WT* __restrict__ w,
                const void* __restrict__ bias, int bias_dtype,
                const float* __restrict__ scale, XT* __restrict__ out, int B,
                int K, int N, int kc, int vec16) {
  extern __shared__ __align__(16) char smem[];
  WT* ring = reinterpret_cast<WT*>(smem);
  float* x_s = reinterpret_cast<float*>(smem + ring_bytes<WT>());
  const int xw = x_cols(kc);
  float* red = x_s + kRows * xw;
  float* part = red + kLanesK * kRows * kTileN;

  cg::cluster_group cluster = cg::this_cluster();
  const int z = (int)cluster.block_rank();  // the K split, == blockIdx.x
  const int n_base = blockIdx.y * kTileN;
  const int b0 = blockIdx.z * kRows;
  const int cgrp = threadIdx.x % kColGroups;
  const int lane_k = threadIdx.x / kColGroups;
  const int k_lo = min(K, z * kc);
  const int k_hi = min(K, k_lo + kc);
  // first half of a cluster barrier: its wait, before the partials are
  // written to rank 0, ensures every block of the cluster has started
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  float acc[kRows][kVec];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int v = 0; v < kVec; ++v) acc[r][v] = 0.f;

  // copy weight rows [k0, k0 + n) of the tile into ring slot `slot`
  auto stage = [&](int k0, int n, int slot) {
    WT* dst = ring + (size_t)slot * kStageK * kTileN;
    if (vec16) {
      constexpr int per_row = kTileN * sizeof(WT) / 16;
      constexpr int cols16 = 16 / sizeof(WT);
      for (int i = threadIdx.x; i < n * per_row; i += kThreads) {
        const int r = i / per_row;
        const int c = (i % per_row) * cols16;
        if (n_base + c < N)  // N is a multiple of cols16 here
          cp_async16(dst + r * kTileN + c,
                     w + (size_t)(k0 + r) * N + n_base + c);
      }
    } else {
      for (int i = threadIdx.x; i < n * kTileN; i += kThreads) {
        const int r = i / kTileN;
        const int c = i % kTileN;
        if (n_base + c < N) dst[i] = w[(size_t)(k0 + r) * N + n_base + c];
      }
    }
  };

  for (int xc = k_lo; xc < k_hi; xc += kChunkX) {
    const int xn = min(kChunkX, k_hi - xc);
    const int n_st = (xn + kStageK - 1) / kStageK;
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < n_st) stage(xc + s * kStageK, min(kStageK, xn - s * kStageK), s);
      cp_async_commit();
    }
#pragma unroll 4
    for (int i = threadIdx.x; i < kRows * xn; i += kThreads) {
      const int r = i / xn;
      const int j = i % xn;
      const int b = b0 + r;
      x_s[r * xw + j] = b < B ? to_f(x[(size_t)b * K + xc + j]) : 0.f;
    }
    for (int s = 0; s < n_st; ++s) {
      const int ahead = s + kStages - 1;
      if (ahead < n_st)
        stage(xc + ahead * kStageK, min(kStageK, xn - ahead * kStageK),
              ahead % kStages);
      cp_async_commit();
      cp_async_wait_ring();
      __syncthreads();
      const WT* ws = ring + (size_t)(s % kStages) * kStageK * kTileN;
      const int rows = min(kStageK, xn - s * kStageK);
      for (int r = lane_k; r < rows; r += kLanesK) {
        float wv[kVec];
        load4(ws + r * kTileN + cgrp * kVec, wv);
        const int j = s * kStageK + r;
#pragma unroll
        for (int b = 0; b < kRows; ++b) {
          const float xv = x_s[b * xw + j];
#pragma unroll
          for (int v = 0; v < kVec; ++v)
            acc[b][v] = fmaf(xv, wv[v], acc[b][v]);
        }
      }
      __syncthreads();  // the slot is refilled, x_s rewritten
    }
  }

  // the row lanes' partials, added in lane order
#pragma unroll
  for (int b = 0; b < kRows; ++b)
#pragma unroll
    for (int v = 0; v < kVec; ++v)
      red[(lane_k * kRows + b) * kTileN + cgrp * kVec + v] = acc[b][v];
  __syncthreads();
  {
    const int b = threadIdx.x / kTileN;
    const int c = threadIdx.x % kTileN;
    float s = 0.f;
#pragma unroll
    for (int l = 0; l < kLanesK; ++l) s += red[(l * kRows + b) * kTileN + c];
    // the block's partial into rank 0's slot z (a store to distributed
    // shared memory: no round trip waits on it)
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    cluster.map_shared_rank(part, 0)[z * kThreads + threadIdx.x] = s;
  }

  // the K splits' partials, added in rank order by rank 0
  cluster.sync();
  if (z == 0) {
    const int b = b0 + threadIdx.x / kTileN;
    const int n = n_base + threadIdx.x % kTileN;
    if (b < B && n < N) {
      float s = 0.f;
      for (int p = 0; p < (int)gridDim.x; ++p)  // the cluster's ranks
        s += part[p * kThreads + threadIdx.x];
      if (scale != nullptr) s *= scale[n];
      if (bias != nullptr) s += bias_at(bias, bias_dtype, n);
      out[(size_t)b * N + n] = from_f<XT>(s);
    }
  }
}

static_assert(kRows * kTileN == kThreads, "one output per thread of rank 0");

template <typename XT, typename WT>
cudaError_t launch_t(const void* x, const void* w, const void* bias,
                     int bias_dtype, const float* scale, void* out, int B,
                     int K, int N, int ksplit, cudaStream_t stream) {
  const int kc = (K + ksplit - 1) / ksplit;
  const size_t smem = smem_bytes<WT>(kc);
  auto kern = gemv_kernel<XT, WT>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  // 16-byte copies: rows of N weights 16-byte aligned, and so the base
  const int vec16 = (N * (int)sizeof(WT)) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(w) % 16 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ksplit, (N + kTileN - 1) / kTileN,
                     (B + kRows - 1) / kRows);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ksplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const XT*>(x), static_cast<const WT*>(w),
      bias, bias_dtype, scale, static_cast<XT*>(out), B, K, N, kc, vec16);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename XT>
cudaError_t dispatch_w(int w_dtype, const void* x, const void* w,
                       const void* bias, int bias_dtype, const float* scale,
                       void* out, int B, int K, int N, int ksplit,
                       cudaStream_t s) {
  switch (w_dtype) {
    case 0:
      return launch_t<XT, float>(x, w, bias, bias_dtype, scale, out, B, K,
                                 N, ksplit, s);
    case 1:
      return launch_t<XT, __nv_bfloat16>(x, w, bias, bias_dtype, scale, out,
                                         B, K, N, ksplit, s);
    case 2:
      return launch_t<XT, __half>(x, w, bias, bias_dtype, scale, out, B, K,
                                  N, ksplit, s);
    case 3:
      return launch_t<XT, int8_t>(x, w, bias, bias_dtype, scale, out, B, K,
                                  N, ksplit, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = float16, 3 = int8 (w only).
// bias and scale may be null; ksplit (1..8) is the plan's K split, one
// cluster of ksplit blocks per column tile and row group.  Returns the
// launch's error (0 = launched).
extern "C" int gemv(const void* x, const void* w, const void* bias,
                    const float* scale, void* out, int B, int K, int N,
                    int ksplit, int x_dtype, int w_dtype, int bias_dtype,
                    void* stream) {
  if (B <= 0 || K <= 0 || N <= 0 || ksplit <= 0 || ksplit > kMaxCluster ||
      (bias != nullptr && (bias_dtype < 0 || bias_dtype > 2)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case 0:
      return (int)dispatch_w<float>(w_dtype, x, w, bias, bias_dtype, scale,
                                    out, B, K, N, ksplit, s);
    case 1:
      return (int)dispatch_w<__nv_bfloat16>(w_dtype, x, w, bias, bias_dtype,
                                            scale, out, B, K, N, ksplit, s);
    case 2:
      return (int)dispatch_w<__half>(w_dtype, x, w, bias, bias_dtype, scale,
                                     out, B, K, N, ksplit, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
