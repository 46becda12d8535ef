// WKV recurrence of RWKV6 for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `_wkv_kernel` / `rwkv_scan_pallas` of the JAX
// package (src/repro/kernels/rwkv_scan/rwkv_scan.py:22,50).
//
// What it computes (the same function as the TPU kernel): for every
// (b, h), starting from the f32 state s = s0[b, h] (dh x dh), for
// t = 0 .. S-1
//   y[b, t, h, j] = sum_i r[i] * (s[i, j] + u[h, i] * k[i] * v[j])
//   s[i, j]      <- w[i] * s[i, j] + k[i] * v[j]
// with r, k, v, w the (b, t, h) rows; then the final s is written out.
//
// Bound on this card: at decode (S = 1) memory.  The state is read once
// and written once (dh * dh * 4 bytes per (b, h), 16 KB at dh = 64) for
// about 5 flops per state element, far below the H100's ridge.  At a
// prefill length with few (b, h) the S steps of a block depend on each
// other, so latency, not bytes, sets the time.
//
// Why this design: a block of dh threads with thread j walking all dh
// rows of column j spent, at the decode shape (4, 1, 64, 64), about 2 us
// on launch, 3.7 us on its own chain (704 instructions with one warp per
// scheduler) and 3.5 us each on the state's load and its store, one
// after the other around that chain (tools/rwkv_scan_probe, PERF.md).
// So this design shortens the chain and overlaps the store:
//   * columns are independent (column j of the state and y[j] need only
//     r, k, w, u, v[j] and that column), so each (b, h) is split over
//     blocks of kCols = 32 columns: grid (B*H, ceil(dh / 32)), 512
//     blocks at the decode shape;
//   * a block's 128 threads are 4 warps of 32 columns; warp g takes a
//     contiguous quarter of the dh rows of every column, so a thread
//     keeps at most 32 state values in registers and does a quarter of
//     the per-step products;
//   * the block copies its dh x 32 slab of s0 into shared memory with
//     16-byte cp.async (4-byte copies when dh is not a multiple of 4),
//     all in flight before one wait, with the first step's r, k, w, v
//     and u loads issued before that wait.  A slab row is 32 floats, one
//     per bank, and a warp reads one row across its 32 columns, so no
//     padding is needed for conflict-free reads;
//   * each step, every thread writes its rows' terms r[i] * (s + u k v)
//     to shared memory and updates its state values; after a barrier
//     warp 0 sums the dh terms of its column left to right and writes
//     y.  At the last step the new state goes to the slab before that
//     barrier, so the other warps store it to s_out (16-byte stores)
//     while warp 0 sums;
//   * the next step's row is loaded into registers while a step
//     computes;
//   * every product and sum is rounded on its own (__fmul_rn /
//     __fadd_rn, never contracted into a fused multiply-add) and the sum
//     over i runs left to right, i = 0 .. dh-1: the plain version
//     (ref.py) repeats this arithmetic, so the two agree bit for bit,
//     and a run is deterministic.  dh is a
//     runtime value up to 128; the register rows have the size of the
//     next template width (32, 64 or 128, a quarter each) and rows past
//     dh are skipped.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kCols = 32;                  // state columns per block
constexpr int kGroups = 4;                 // row groups (warps) per block
constexpr int kThreads = kCols * kGroups;  // >= dh: one vector element each

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <int MAXD>
__global__ void __launch_bounds__(kThreads)
    wkv_kernel(const float* __restrict__ r, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ w,
               const float* __restrict__ u, const float* __restrict__ s0,
               float* __restrict__ y, float* __restrict__ s_out, int S,
               int H, int dh, int vec) {
  constexpr int MAXR = MAXD / kGroups;  // rows of a column per thread
  __shared__ __align__(16) float slab[MAXD * kCols];   // [i][c]
  __shared__ float term_s[MAXD * kCols];               // [i][c]
  __shared__ float r_s[MAXD];
  __shared__ float k_s[MAXD];
  __shared__ float w_s[MAXD];
  __shared__ float u_s[MAXD];
  const int bh = blockIdx.x;  // b * H + h
  const int b = bh / H;
  const int h = bh - b * H;
  const int c0 = blockIdx.y * kCols;
  const int nc = min(kCols, dh - c0);    // this block's columns
  const int j = threadIdx.x % kCols;     // my column, c0 + j
  const int grp = threadIdx.x / kCols;   // my row group (my warp)
  const bool col = j < nc;
  const int rows = (dh + kGroups - 1) / kGroups;
  const int i0 = grp * rows;             // my rows: i0 .. i0 + rows - 1
  const int e = threadIdx.x;             // the vector element I stage

  // the slab s0[b, h, :, c0:c0+nc], every copy in flight at once
  const size_t state = (size_t)bh * dh * dh + c0;
  if (vec) {
    const int per_row = nc / 4;
    for (int q = threadIdx.x; q < dh * per_row; q += kThreads) {
      const int i = q / per_row;
      const int c = 4 * (q - i * per_row);
      cp_async16(&slab[i * kCols + c], s0 + state + (size_t)i * dh + c);
    }
  } else {
    for (int q = threadIdx.x; q < dh * nc; q += kThreads) {
      const int i = q / nc;
      const int c = q - i * nc;
      cp_async4(&slab[i * kCols + c], s0 + state + (size_t)i * dh + c);
    }
  }
  // the first step's row and u, in flight with the slab
  const size_t t_stride = (size_t)H * dh;
  size_t off = ((size_t)b * S * H + h) * dh;  // (b, t = 0, h, 0)
  float r_n = 0.f, k_n = 0.f, w_n = 0.f;
  if (e < dh) {
    r_n = r[off + e];
    k_n = k[off + e];
    w_n = w[off + e];
    u_s[e] = u[(size_t)h * dh + e];
  }
  float v_n = col ? v[off + c0 + j] : 0.f;
  cp_async_commit_wait_all();
  __syncthreads();

  float s[MAXR];
#pragma unroll
  for (int m = 0; m < MAXR; ++m)
    s[m] = (m < rows && i0 + m < dh) ? slab[(i0 + m) * kCols + j] : 0.f;

  for (int t = 0; t < S; ++t, off += t_stride) {
    if (e < dh) {
      r_s[e] = r_n;
      k_s[e] = k_n;
      w_s[e] = w_n;
    }
    const float vj = v_n;
    __syncthreads();  // the row is staged; warp 0 has read the last terms
    if (t + 1 < S) {  // the next step's row, in flight during this one
      if (e < dh) {
        r_n = r[off + t_stride + e];
        k_n = k[off + t_stride + e];
        w_n = w[off + t_stride + e];
      }
      if (col) v_n = v[off + t_stride + c0 + j];
    }
    if (col) {
#pragma unroll
      for (int m = 0; m < MAXR; ++m) {
        const int i = i0 + m;
        if (m < rows && i < dh) {
          const float kv = __fmul_rn(k_s[i], vj);
          term_s[i * kCols + j] = __fmul_rn(
              r_s[i], __fadd_rn(__fmul_rn(u_s[i], kv), s[m]));
          s[m] = __fadd_rn(__fmul_rn(w_s[i], s[m]), kv);
          if (t + 1 == S) slab[i * kCols + j] = s[m];
        }
      }
    }
    __syncthreads();  // the terms (and at the end the state) are staged
    if (grp == 0 && col) {
      float acc = term_s[j];
#pragma unroll 8
      for (int i = 1; i < dh; ++i) acc = __fadd_rn(acc, term_s[i * kCols + j]);
      y[off + c0 + j] = acc;
    }
  }

  // the final slab back to s_out, 16 bytes a store where rows allow
  float* dst = s_out + state;
  if (vec) {
    const int per_row = nc / 4;
    for (int q = threadIdx.x; q < dh * per_row; q += kThreads) {
      const int i = q / per_row;
      const int c = 4 * (q - i * per_row);
      *reinterpret_cast<float4*>(dst + (size_t)i * dh + c) =
          *reinterpret_cast<const float4*>(&slab[i * kCols + c]);
    }
  } else {
    for (int q = threadIdx.x; q < dh * nc; q += kThreads) {
      const int i = q / nc;
      const int c = q - i * nc;
      dst[(size_t)i * dh + c] = slab[i * kCols + c];
    }
  }
}

template <int MAXD>
cudaError_t launch(const float* r, const float* k, const float* v,
                   const float* w, const float* u, const float* s0, float* y,
                   float* s_out, int B, int S, int H, int dh,
                   cudaStream_t stream) {
  // 16-byte copies need rows of a multiple of 4 floats and aligned bases
  const int vec = dh % 4 == 0 &&
                  (reinterpret_cast<uintptr_t>(s0) |
                   reinterpret_cast<uintptr_t>(s_out)) % 16 == 0;
  const dim3 grid(B * H, (dh + kCols - 1) / kCols);
  wkv_kernel<MAXD><<<grid, kThreads, 0, stream>>>(r, k, v, w, u, s0, y,
                                                  s_out, S, H, dh, vec);
  return cudaGetLastError();
}

}  // namespace

// r, k, v, w, y: (B, S, H, dh); u: (H, dh); s0, s_out: (B, H, dh, dh);
// all float32 and contiguous, s_out distinct from s0.  1 <= dh <= 128.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int rwkv_scan(const float* r, const float* k, const float* v,
                         const float* w, const float* u, const float* s0,
                         float* y, float* s_out, int B, int S, int H, int dh,
                         void* stream_ptr) {
  if (B <= 0 || S <= 0 || H <= 0 || dh <= 0 || dh > 128 ||
      (long long)B * H > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (dh <= 32)
    return (int)launch<32>(r, k, v, w, u, s0, y, s_out, B, S, H, dh, stream);
  if (dh <= 64)
    return (int)launch<64>(r, k, v, w, u, s0, y, s_out, B, S, H, dh, stream);
  return (int)launch<128>(r, k, v, w, u, s0, y, s_out, B, S, H, dh, stream);
}
