// Selective scan (Mamba S6) for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `_scan_kernel` / `mamba_scan_pallas` of the JAX
// package (src/repro/kernels/mamba_scan/mamba_scan.py:27,52).
//
// What it computes (the same function as the TPU kernel): for every
// channel (b, c), starting from the f32 state h = h0[b, c, :] (N values),
// for t = 0 .. S-1
//   h[n]        <- da[b, t, c, n] * h[n] + bx[b, t, c, n]
//   y[b, t, c]   = sum_n h[n] * cc[b, t, n]
// then the final h is written out.
//
// Bound on this card: memory.  Each (b, t, c, n) element of da and bx is
// read once for 4 flops (the update and the output's product and sum),
// far below the H100's ridge; at the decode shape (4, 1, 8192, 16) the
// state is read and written once as well (8.5 MB in all, 2.5 us at
// 3.35 TB/s), at the prefill shape (1, 64, 8192, 16) da and bx dominate
// (70 MB, 21 us).
//
// Design (a first design that is right, not yet fast):
//   * one thread per channel (b, c), holding its N states in registers
//     for the whole sequence, so the state touches device memory only at
//     the start and at the end (the TPU kernel keeps a (C tile, N) state
//     in VMEM scratch across its sequence tiles); blocks of 128 channels,
//     grid (C / 128, B): the TPU grid's sequential sequence axis becomes
//     the loop inside each thread;
//   * each thread reads its N contiguous floats of da and bx per step
//     (float4 loads when N % 4 == 0 and the pointers are 16-byte
//     aligned), so a warp's loads cover 32 * N contiguous floats; the
//     next step's rows are loaded into registers before the current step
//     is computed, so the loads overlap the arithmetic (for N <= 32);
//   * cc, which every thread of a block reads, is staged in shared
//     memory CHUNK steps at a time (two barriers per chunk);
//   * y[b, t, c] is summed inside the thread: no cross-thread reduction;
//   * every product and sum is rounded on its own (__fmul_rn / __fadd_rn,
//     never contracted into a fused multiply-add) and the sum over n runs
//     left to right, n = 0 .. N-1: the plain version (ref.py) repeats
//     exactly this arithmetic, so the two agree bit for bit and a run is
//     deterministic.  N is a runtime value up to 64; the register arrays
//     have the size of the next template width (8, 16, 32 or 64) and
//     states past N are skipped.  Any S >= 1 and any C run: the TPU
//     wrapper's S % 8 / C % 8 rule has no counterpart.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;  // channels per block
constexpr int CHUNK = 32;     // steps of cc staged per shared-memory fill

template <int MAXN>
__device__ __forceinline__ void load_row(float (&r)[MAXN],
                                         const float* __restrict__ p, int N,
                                         bool vec) {
  if (vec) {
#pragma unroll
    for (int n = 0; n < MAXN; n += 4) {
      if (n < N) {
        const float4 v = *reinterpret_cast<const float4*>(p + n);
        r[n] = v.x;
        r[n + 1] = v.y;
        r[n + 2] = v.z;
        r[n + 3] = v.w;
      } else {
        r[n] = r[n + 1] = r[n + 2] = r[n + 3] = 0.f;
      }
    }
  } else {
#pragma unroll
    for (int n = 0; n < MAXN; ++n) r[n] = n < N ? p[n] : 0.f;
  }
}

template <int MAXN, bool PREFETCH>
__global__ void __launch_bounds__(THREADS)
    scan_kernel(const float* __restrict__ da, const float* __restrict__ bx,
                const float* __restrict__ cc, const float* __restrict__ h0,
                float* __restrict__ y, float* __restrict__ h_out, int S,
                int C, int N, bool vec) {
  __shared__ float c_s[CHUNK * MAXN];
  const int b = blockIdx.y;
  const int ch = blockIdx.x * THREADS + threadIdx.x;
  const bool live = ch < C;  // threads past C only help stage cc

  float h[MAXN];
  const size_t state = ((size_t)b * C + ch) * N;
  if (live)
    load_row<MAXN>(h, h0 + state, N, vec);

  const size_t t_stride = (size_t)C * N;
  size_t off = ((size_t)b * S * C + ch) * N;  // (b, t = 0, ch, 0)
  float a_n[MAXN], b_n[MAXN];
  if (PREFETCH && live) {
    load_row<MAXN>(a_n, da + off, N, vec);
    load_row<MAXN>(b_n, bx + off, N, vec);
  }
  const float* c_b = cc + (size_t)b * S * N;
  float* y_b = y + (size_t)b * S * C + ch;

  for (int t0 = 0; t0 < S; t0 += CHUNK) {
    const int steps = min(CHUNK, S - t0);
    __syncthreads();  // every thread is done with the previous chunk
    for (int i = threadIdx.x; i < steps * N; i += THREADS)
      c_s[(i / N) * MAXN + i % N] = c_b[(size_t)t0 * N + i];
    __syncthreads();
    if (!live) continue;
    for (int i = 0; i < steps; ++i, off += t_stride) {
      float a_c[MAXN], b_c[MAXN];
      if (PREFETCH) {
#pragma unroll
        for (int n = 0; n < MAXN; ++n) {
          a_c[n] = a_n[n];
          b_c[n] = b_n[n];
        }
        if (t0 + i + 1 < S) {  // the next step's rows, in flight now
          load_row<MAXN>(a_n, da + off + t_stride, N, vec);
          load_row<MAXN>(b_n, bx + off + t_stride, N, vec);
        }
      } else {
        load_row<MAXN>(a_c, da + off, N, vec);
        load_row<MAXN>(b_c, bx + off, N, vec);
      }
      const float* c_t = c_s + i * MAXN;
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < MAXN; ++n) {
        if (n < N) {
          h[n] = __fadd_rn(__fmul_rn(a_c[n], h[n]), b_c[n]);
          const float term = __fmul_rn(h[n], c_t[n]);
          acc = n == 0 ? term : __fadd_rn(acc, term);
        }
      }
      y_b[(size_t)(t0 + i) * C] = acc;
    }
  }

  if (live) {
#pragma unroll
    for (int n = 0; n < MAXN; ++n)
      if (n < N) h_out[state + n] = h[n];
  }
}

template <int MAXN, bool PREFETCH>
cudaError_t launch(const float* da, const float* bx, const float* cc,
                   const float* h0, float* y, float* h_out, int B, int S,
                   int C, int N, bool vec, cudaStream_t stream) {
  const dim3 grid((C + THREADS - 1) / THREADS, B);
  scan_kernel<MAXN, PREFETCH><<<grid, THREADS, 0, stream>>>(
      da, bx, cc, h0, y, h_out, S, C, N, vec);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// da, bx: (B, S, C, N); cc: (B, S, N); h0, h_out: (B, C, N); y: (B, S, C);
// all float32 and contiguous, h_out distinct from h0.  1 <= N <= 64,
// B <= 65535.  Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int mamba_scan(const float* da, const float* bx, const float* cc,
                          const float* h0, float* y, float* h_out, int B,
                          int S, int C, int N, void* stream_ptr) {
  if (B <= 0 || S <= 0 || C <= 0 || N <= 0 || N > 64 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bool vec = (N % 4 == 0) && aligned16(da) && aligned16(bx) &&
                   aligned16(h0) && aligned16(h_out);
  if (N <= 8)
    return (int)launch<8, true>(da, bx, cc, h0, y, h_out, B, S, C, N, vec,
                                stream);
  if (N <= 16)
    return (int)launch<16, true>(da, bx, cc, h0, y, h_out, B, S, C, N, vec,
                                 stream);
  if (N <= 32)
    return (int)launch<32, true>(da, bx, cc, h0, y, h_out, B, S, C, N, vec,
                                 stream);
  return (int)launch<64, false>(da, bx, cc, h0, y, h_out, B, S, C, N, vec,
                                stream);
}
