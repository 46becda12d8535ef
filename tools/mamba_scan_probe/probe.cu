// Variants of the first design of the mamba_scan kernel (one thread per
// channel walking its N states over the sequence in registers, blocks of
// 128 channels, grid (C / 128, B), the next step's da/bx rows prefetched
// into registers, cc staged in shared memory 32 steps at a time), kept
// to locate where that design's time went:
// MODE 0 as it was, 1 no state traffic (h0 not read, h_out not written),
// 2 no da/bx loads (constants in their place), 3 no cc staging (a
// constant cc, no barriers), 4 empty body.  N = 16 only.
// probe_expf applies the CUDA math library's expf (no fast-math, as
// kernels/build.py compiles) elementwise, to hold it against torch.exp.
// Built and timed by probe.py beside it.
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int THREADS = 128;
constexpr int CHUNK = 32;
constexpr int N = 16;

template <int MODE>
__global__ void __launch_bounds__(THREADS)
    scan_kernel(const float* __restrict__ da, const float* __restrict__ bx,
                const float* __restrict__ cc, const float* __restrict__ h0,
                float* __restrict__ y, float* __restrict__ h_out, int S,
                int C) {
  if (MODE == 4) return;
  __shared__ float c_s[CHUNK * N];
  const int b = blockIdx.y;
  const int ch = blockIdx.x * THREADS + threadIdx.x;
  const bool live = ch < C;

  float h[N];
  const size_t state = ((size_t)b * C + ch) * N;
#pragma unroll
  for (int n = 0; n < N; n += 4) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (MODE != 1 && live)
      v = *reinterpret_cast<const float4*>(h0 + state + n);
    h[n] = v.x; h[n + 1] = v.y; h[n + 2] = v.z; h[n + 3] = v.w;
  }
  const size_t t_stride = (size_t)C * N;
  size_t off = ((size_t)b * S * C + ch) * N;
  float a_n[N], b_n[N];
#pragma unroll
  for (int n = 0; n < N; n += 4) {
    float4 va = make_float4(0.9f, 0.9f, 0.9f, 0.9f);
    float4 vb = make_float4(0.1f, 0.1f, 0.1f, 0.1f);
    if (MODE != 2 && live) {
      va = *reinterpret_cast<const float4*>(da + off + n);
      vb = *reinterpret_cast<const float4*>(bx + off + n);
    }
    a_n[n] = va.x; a_n[n + 1] = va.y; a_n[n + 2] = va.z; a_n[n + 3] = va.w;
    b_n[n] = vb.x; b_n[n + 1] = vb.y; b_n[n + 2] = vb.z; b_n[n + 3] = vb.w;
  }
  const float* c_b = cc + (size_t)b * S * N;
  float* y_b = y + (size_t)b * S * C + ch;

  for (int t0 = 0; t0 < S; t0 += CHUNK) {
    const int steps = min(CHUNK, S - t0);
    if (MODE != 3) {
      __syncthreads();
      for (int i = threadIdx.x; i < steps * N; i += THREADS)
        c_s[i] = c_b[(size_t)t0 * N + i];
      __syncthreads();
    }
    if (!live) continue;
    for (int i = 0; i < steps; ++i, off += t_stride) {
      float a_c[N], b_c[N];
#pragma unroll
      for (int n = 0; n < N; ++n) {
        a_c[n] = a_n[n];
        b_c[n] = b_n[n];
      }
      if (MODE != 2 && t0 + i + 1 < S) {
#pragma unroll
        for (int n = 0; n < N; n += 4) {
          const float4 va =
              *reinterpret_cast<const float4*>(da + off + t_stride + n);
          const float4 vb =
              *reinterpret_cast<const float4*>(bx + off + t_stride + n);
          a_n[n] = va.x; a_n[n + 1] = va.y; a_n[n + 2] = va.z;
          a_n[n + 3] = va.w;
          b_n[n] = vb.x; b_n[n + 1] = vb.y; b_n[n + 2] = vb.z;
          b_n[n + 3] = vb.w;
        }
      }
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        h[n] = __fadd_rn(__fmul_rn(a_c[n], h[n]), b_c[n]);
        const float cv = MODE == 3 ? 0.5f : c_s[i * N + n];
        const float term = __fmul_rn(h[n], cv);
        acc = n == 0 ? term : __fadd_rn(acc, term);
      }
      y_b[(size_t)(t0 + i) * C] = acc;
    }
  }
  if (MODE != 1 && live) {
#pragma unroll
    for (int n = 0; n < N; n += 4)
      *reinterpret_cast<float4*>(h_out + state + n) =
          make_float4(h[n], h[n + 1], h[n + 2], h[n + 3]);
  }
}

template <int MODE>
cudaError_t go(const float* da, const float* bx, const float* cc,
               const float* h0, float* y, float* h_out, int B, int S, int C,
               cudaStream_t st) {
  const dim3 grid((C + THREADS - 1) / THREADS, B);
  scan_kernel<MODE><<<grid, THREADS, 0, st>>>(da, bx, cc, h0, y, h_out, S,
                                               C);
  return cudaGetLastError();
}

__global__ void expf_kernel(const float* __restrict__ x, float* __restrict__ y,
                            long n) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = expf(x[i]);
}

}  // namespace

extern "C" int probe(const float* da, const float* bx, const float* cc,
                     const float* h0, float* y, float* h_out, int B, int S,
                     int C, int n, int mode, void* sp) {
  if (n != N || C % 4) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(sp);
  switch (mode) {
    case 0: return (int)go<0>(da, bx, cc, h0, y, h_out, B, S, C, st);
    case 1: return (int)go<1>(da, bx, cc, h0, y, h_out, B, S, C, st);
    case 2: return (int)go<2>(da, bx, cc, h0, y, h_out, B, S, C, st);
    case 3: return (int)go<3>(da, bx, cc, h0, y, h_out, B, S, C, st);
    default: return (int)go<4>(da, bx, cc, h0, y, h_out, B, S, C, st);
  }
}

extern "C" int probe_expf(const float* x, float* y, long n, void* sp) {
  cudaStream_t st = static_cast<cudaStream_t>(sp);
  expf_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(x, y, n);
  return (int)cudaGetLastError();
}
