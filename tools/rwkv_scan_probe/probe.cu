// Variants of the first design of the rwkv_scan kernel (one block of dh
// threads per (b, h), thread j walking all dh rows of state column j in
// registers), kept to locate where that design's time went:
// MODE 0 as it was, 1 state load only (no s_out store), 2 state store
// only (s0 not read), 3 no state traffic, 4 empty body.  dh = 64 only.
// Built and timed by probe.py beside it.
#include <cuda_runtime.h>
#include <stddef.h>

template <int MAXD, int MODE>
__global__ void __launch_bounds__(MAXD)
    wkv_kernel(const float* __restrict__ r, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ w,
               const float* __restrict__ u, const float* __restrict__ s0,
               float* __restrict__ y, float* __restrict__ s_out, int S,
               int H, int dh) {
  if (MODE == 4) return;
  __shared__ float r_s[2][MAXD];
  __shared__ float k_s[2][MAXD];
  __shared__ float w_s[2][MAXD];
  __shared__ float u_s[MAXD];
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int j = threadIdx.x;
  const size_t state = (size_t)bh * dh * dh + j;
  float s[MAXD];
#pragma unroll
  for (int i = 0; i < MAXD; ++i)
    s[i] = (i < dh && (MODE == 0 || MODE == 1)) ? s0[state + (size_t)i * dh]
                                                 : 0.f;
  u_s[j] = u[(size_t)h * dh + j];
  const size_t t_stride = (size_t)H * dh;
  size_t off = ((size_t)b * S * H + h) * dh + j;
  float r_n = r[off], k_n = k[off], w_n = w[off], v_n = v[off];
  for (int t = 0; t < S; ++t, off += t_stride) {
    const int buf = t & 1;
    r_s[buf][j] = r_n;
    k_s[buf][j] = k_n;
    w_s[buf][j] = w_n;
    const float vj = v_n;
    __syncthreads();
    if (t + 1 < S) {
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
  if (MODE == 0 || MODE == 2) {
#pragma unroll
    for (int i = 0; i < MAXD; ++i)
      if (i < dh) s_out[state + (size_t)i * dh] = s[i];
  }
}

template <int MODE>
cudaError_t go(const float* r, const float* k, const float* v, const float* w,
               const float* u, const float* s0, float* y, float* s_out, int B,
               int S, int H, int dh, cudaStream_t st) {
  wkv_kernel<64, MODE><<<B * H, dh, 0, st>>>(r, k, v, w, u, s0, y, s_out, S,
                                             H, dh);
  return cudaGetLastError();
}

extern "C" int probe(const float* r, const float* k, const float* v,
                     const float* w, const float* u, const float* s0,
                     float* y, float* s_out, int B, int S, int H, int dh,
                     int mode, void* sp) {
  if (dh != 64) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(sp);
  switch (mode) {
    case 0: return (int)go<0>(r, k, v, w, u, s0, y, s_out, B, S, H, dh, st);
    case 1: return (int)go<1>(r, k, v, w, u, s0, y, s_out, B, S, H, dh, st);
    case 2: return (int)go<2>(r, k, v, w, u, s0, y, s_out, B, S, H, dh, st);
    case 3: return (int)go<3>(r, k, v, w, u, s0, y, s_out, B, S, H, dh, st);
    default: return (int)go<4>(r, k, v, w, u, s0, y, s_out, B, S, H, dh, st);
  }
}
