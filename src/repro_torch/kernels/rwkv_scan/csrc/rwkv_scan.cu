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
// Design (a first design that is right, not yet fast):
//   * one block per (b, h) with dh threads; thread j keeps column j of
//     the state, s[:, j], in registers for the whole sequence, so the
//     state touches device memory only at the start and at the end (the
//     TPU kernel keeps it in VMEM scratch across its sequence tiles);
//   * each step, thread j stages r[j], k[j], w[j] in shared memory and
//     reads v[j] into a register; the staging is double-buffered, so one
//     barrier per step keeps a fast thread from overwriting a row that a
//     slow one still reads;
//   * each thread loads the next step's r, k, w, v into registers
//     before it computes the current one, so the global loads overlap
//     the arithmetic of a step;
//   * every product and sum is rounded on its own (__fmul_rn /
//     __fadd_rn, never contracted into a fused multiply-add) and the sum
//     over i runs left to right, i = 0 .. dh-1: the plain version
//     (ref.py) repeats exactly this arithmetic, so the two agree bit for
//     bit, and a run is deterministic.  dh is a runtime value up to 128;
//     the register column has the size of the next template width (32,
//     64 or 128) and rows past dh are skipped.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

template <int MAXD>
__global__ void __launch_bounds__(MAXD)
    wkv_kernel(const float* __restrict__ r, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ w,
               const float* __restrict__ u, const float* __restrict__ s0,
               float* __restrict__ y, float* __restrict__ s_out, int S,
               int H, int dh) {
  __shared__ float r_s[2][MAXD];
  __shared__ float k_s[2][MAXD];
  __shared__ float w_s[2][MAXD];
  __shared__ float u_s[MAXD];
  const int bh = blockIdx.x;  // b * H + h
  const int b = bh / H;
  const int h = bh - b * H;
  const int j = threadIdx.x;  // < dh

  const size_t state = (size_t)bh * dh * dh + j;
  float s[MAXD];
#pragma unroll
  for (int i = 0; i < MAXD; ++i)
    s[i] = i < dh ? s0[state + (size_t)i * dh] : 0.f;
  u_s[j] = u[(size_t)h * dh + j];  // visible after the first barrier

  const size_t t_stride = (size_t)H * dh;
  size_t off = ((size_t)b * S * H + h) * dh + j;  // (b, t = 0, h, j)
  float r_n = r[off], k_n = k[off], w_n = w[off], v_n = v[off];
  for (int t = 0; t < S; ++t, off += t_stride) {
    const int buf = t & 1;
    r_s[buf][j] = r_n;
    k_s[buf][j] = k_n;
    w_s[buf][j] = w_n;
    const float vj = v_n;
    __syncthreads();
    if (t + 1 < S) {  // the next step's row, in flight during this one
      r_n = r[off + t_stride];
      k_n = k[off + t_stride];
      w_n = w[off + t_stride];
      v_n = v[off + t_stride];
    }
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < MAXD; ++i) {
      if (i < dh) {
        const float kv = __fmul_rn(k_s[buf][i], vj);
        const float term = __fmul_rn(
            r_s[buf][i], __fadd_rn(__fmul_rn(u_s[i], kv), s[i]));
        acc = i == 0 ? term : __fadd_rn(acc, term);
        s[i] = __fadd_rn(__fmul_rn(w_s[buf][i], s[i]), kv);
      }
    }
    y[off] = acc;
  }

#pragma unroll
  for (int i = 0; i < MAXD; ++i)
    if (i < dh) s_out[state + (size_t)i * dh] = s[i];
}

template <int MAXD>
cudaError_t launch(const float* r, const float* k, const float* v,
                   const float* w, const float* u, const float* s0, float* y,
                   float* s_out, int B, int S, int H, int dh,
                   cudaStream_t stream) {
  wkv_kernel<MAXD><<<B * H, dh, 0, stream>>>(r, k, v, w, u, s0, y, s_out, S,
                                              H, dh);
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
