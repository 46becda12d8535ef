// Pieces shared by the paged and the dense decode-attention kernels
// (paged_decode_attention.cu, decode_attention.cu): type conversions,
// warp reductions, the online-softmax update over one tile of KV rows,
// and the flush of a block's result.
//
// A block of 4 warps serves one (sequence b, kv head g) and all gs query
// heads of the group, so each K/V row is read once per group.  At
// smollm-135m's gs=3, dh=64 there are fewer than the 16 rows an MMA
// needs, so the dots are plain f32 FMAs: a warp takes one KV row at a
// time (its lanes read the row's dh contiguous values, coalesced) and
// reduces the gs dot products with shuffles.  Partial P.V sums live in
// registers per warp and are reduced across the warps in a fixed order,
// so a run is deterministic.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace decode {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGs = 8;     // query heads per kv head the kernels take
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }
__device__ __forceinline__ float to_f(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}

template <typename T>
struct is_quantized {
  static constexpr bool value = false;
};
template <>
struct is_quantized<int8_t> {
  static constexpr bool value = true;
};
template <>
struct is_quantized<__nv_fp8_e4m3> {
  static constexpr bool value = true;
};

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Shared memory of one block: q_s gs*dh (scaled q), p_s gs*tile (scores,
// then probabilities), acc_s gs*dh, and m, l, correction and the folded
// token's weight, kMaxGs each.
struct Smem {
  float* q_s;
  float* p_s;
  float* acc_s;
  float* m_s;
  float* l_s;
  float* c_s;
  float* self_s;
  int tile;
};

__host__ __device__ inline size_t smem_bytes(int gs, int dh, int tile) {
  return sizeof(float) * ((size_t)2 * gs * dh + (size_t)gs * tile +
                          4 * kMaxGs);
}

__device__ __forceinline__ Smem carve(float* base, int gs, int dh,
                                      int tile) {
  Smem s;
  s.q_s = base;
  s.p_s = s.q_s + gs * dh;
  s.acc_s = s.p_s + gs * tile;
  s.m_s = s.acc_s + gs * dh;
  s.l_s = s.m_s + kMaxGs;
  s.c_s = s.l_s + kMaxGs;
  s.self_s = s.c_s + kMaxGs;
  s.tile = tile;
  return s;
}

// Load the group's gs query heads, scaled by 1/sqrt(dh), into q_s and the
// lanes' registers; reset m, l and the register accumulators.
template <typename QT, int DPL>
__device__ __forceinline__ void load_q(const QT* q, const Smem& sm, int gs,
                                       int dh, float scale,
                                       float (&qr)[kMaxGs][DPL],
                                       float (&acc)[kMaxGs][DPL]) {
  const int lane = threadIdx.x % 32;
  for (int i = threadIdx.x; i < gs * dh; i += kThreads)
    sm.q_s[i] = to_f(q[i]) * scale;
  if (threadIdx.x < kMaxGs) {
    sm.m_s[threadIdx.x] = kNeg;
    sm.l_s[threadIdx.x] = 0.f;
  }
  __syncthreads();
#pragma unroll
  for (int h = 0; h < kMaxGs; ++h) {
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int d = lane + 32 * j;
      qr[h][j] = (h < gs && d < dh) ? sm.q_s[h * dh + d] : 0.f;
      acc[h][j] = 0.f;
    }
  }
}

// Online-softmax update over n KV rows (n <= sm.tile), all attended: row
// r's K at kb + r*stride, V at vb + r*stride; for an int8/fp8 cache its
// scales at ks[r*sstride], vs[r*sstride], applied right after the load.
// `uniform`: every score is the same (a row with nothing to attend), so
// the result is the mean of the V rows, as in the reference.
template <typename KT, int DPL>
__device__ __forceinline__ void attend_rows(
    const KT* __restrict__ kb, const KT* __restrict__ vb,
    const __half* __restrict__ ks, const __half* __restrict__ vs,
    size_t stride, size_t sstride, int n, bool uniform, int gs, int dh,
    const Smem& sm, const float (&qr)[kMaxGs][DPL],
    float (&acc)[kMaxGs][DPL]) {
  constexpr bool kQuant = is_quantized<KT>::value;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* p_s = sm.p_s;
  const int ld = sm.tile;

  // scores: one warp per row, lanes across dh
  for (int r = warp; r < n; r += kWarps) {
    if (uniform) {
      if (lane < gs) p_s[lane * ld + r] = 0.f;
      continue;
    }
    const float sc = kQuant ? __half2float(ks[r * sstride]) : 1.f;
    float kr[DPL];
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int d = lane + 32 * j;
      kr[j] = 0.f;
      if (d < dh) {
        kr[j] = to_f(kb[r * stride + d]);
        if (kQuant) kr[j] *= sc;
      }
    }
#pragma unroll
    for (int h = 0; h < kMaxGs; ++h) {
      if (h < gs) {
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < DPL; ++j) s += qr[h][j] * kr[j];
        s = warp_sum(s);
        if (lane == 0) p_s[h * ld + r] = s;
      }
    }
  }
  __syncthreads();

  // online-softmax update per head: one warp per head
  for (int h = warp; h < gs; h += kWarps) {
    float mx = kNeg;
    for (int r = lane; r < n; r += 32) mx = fmaxf(mx, p_s[h * ld + r]);
    mx = warp_max(mx);
    const float m_old = sm.m_s[h];
    const float m_new = fmaxf(m_old, mx);
    float sum = 0.f;
    for (int r = lane; r < n; r += 32) {
      const float p = expf(p_s[h * ld + r] - m_new);
      p_s[h * ld + r] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      const float corr = expf(m_old - m_new);
      sm.c_s[h] = corr;
      sm.l_s[h] = sm.l_s[h] * corr + sum;
      sm.m_s[h] = m_new;
    }
  }
  __syncthreads();

  // P.V: partial sums per warp in registers
#pragma unroll
  for (int h = 0; h < kMaxGs; ++h) {
    if (h < gs) {
      const float corr = sm.c_s[h];
#pragma unroll
      for (int j = 0; j < DPL; ++j) acc[h][j] *= corr;
    }
  }
  for (int r = warp; r < n; r += kWarps) {
    const float sc = kQuant ? __half2float(vs[r * sstride]) : 1.f;
    float vr[DPL];
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int d = lane + 32 * j;
      vr[j] = 0.f;
      if (d < dh) {
        vr[j] = to_f(vb[r * stride + d]);
        if (kQuant) vr[j] *= sc;
      }
    }
#pragma unroll
    for (int h = 0; h < kMaxGs; ++h) {
      if (h < gs) {
        const float p = p_s[h * ld + r];
#pragma unroll
        for (int j = 0; j < DPL; ++j) acc[h][j] += p * vr[j];
      }
    }
  }
  __syncthreads();  // p_s is rewritten by the next tile
}

// Reduce the warps' accumulators in a fixed order, fold the new token
// (kn/vn, may be null) in after the last tile, and write
// out = acc / max(l, 1e-30) in QT.
template <typename QT, int DPL>
__device__ __forceinline__ void finish(const Smem& sm, int gs, int dh,
                                       float (&acc)[kMaxGs][DPL],
                                       const QT* kn, const QT* vn, QT* out) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int h = 0; h < kMaxGs; ++h) {
        if (h < gs) {
#pragma unroll
          for (int j = 0; j < DPL; ++j) {
            const int d = lane + 32 * j;
            if (d < dh)
              sm.acc_s[h * dh + d] =
                  (w == 0) ? acc[h][j] : sm.acc_s[h * dh + d] + acc[h][j];
          }
        }
      }
    }
    __syncthreads();
  }
  if (kn != nullptr) {
    for (int h = warp; h < gs; h += kWarps) {
      float s = 0.f;
      for (int d = lane; d < dh; d += 32) s += sm.q_s[h * dh + d] * to_f(kn[d]);
      s = warp_sum(s);
      if (lane == 0) {
        const float m_f = fmaxf(sm.m_s[h], s);
        const float p_self = expf(s - m_f);
        const float c = expf(sm.m_s[h] - m_f);
        sm.l_s[h] = sm.l_s[h] * c + p_self;
        sm.c_s[h] = c;
        sm.self_s[h] = p_self;
        sm.m_s[h] = m_f;
      }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < gs * dh; i += kThreads) {
    const int h = i / dh;
    const int d = i % dh;
    float a = sm.acc_s[i];
    if (kn != nullptr) a = a * sm.c_s[h] + sm.self_s[h] * to_f(vn[d]);
    out[i] = from_f<QT>(a / fmaxf(sm.l_s[h], 1e-30f));
  }
}

}  // namespace decode
