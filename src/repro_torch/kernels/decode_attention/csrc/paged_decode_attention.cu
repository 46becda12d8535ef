// Paged decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `_paged_decode_kernel` /
// `paged_decode_attention_pallas` of the JAX package
// (src/repro/kernels/decode_attention/decode_attention.py:63,142).
//
// What it computes (the same function as the TPU kernel): for each
// sequence b and query head h = g*gs + i of kv group g, an online softmax
// over the paged KV pool through the block table, in f32:
//   q is scaled by 1/sqrt(dh); scores at positions >= lengths[b] are -1e30;
//   (m, l, acc) are carried in f32; the optional new token (k_new, v_new)
//   is folded in after the last pool tile; out = acc / max(l, 1e-30),
//   cast to q's type.
//
// Bound on this card: memory.  Per (b, g) it streams ~2*len*dh*itemsize
// bytes of K and V (at most 2*T*bs*dh*itemsize) and does ~4*gs*len*dh
// flops, far below the H100's ~20 flop/byte ridge, so the only lever is
// how fast the tiles stream.
//
// Design (a first design that is right, not yet fast):
//   * one thread block of 4 warps per (b, kv head g), computing all gs
//     query heads of the group, so each K/V row is read once per group.
//     At smollm-135m's gs=3, dh=64 there are fewer than the 16 rows an
//     MMA needs, so the dots are plain f32 FMAs: a warp takes one pool row
//     at a time (its lanes read the row's dh contiguous values, coalesced)
//     and reduces the gs dot products with shuffles;
//   * the block reads its own block-table entries and loops over the
//     tiles t < ceil(lengths[b]/bs) only.  A fully masked tile would add
//     p = 0 with corr = 1, so skipping it changes nothing, and the null
//     block 0 that idle slots and table tails point at is never read: it
//     is inert for any finite fill by construction.  A row with length 0
//     returns the folded token alone, or zeros without a fold (never NaN);
//   * partial P.V sums live in registers per warp and are reduced across
//     the 4 warps in a fixed order, so a run is deterministic.
//   At slots=4 and G=3 only 12 blocks are in flight on 132 SMs: splitting
//   the T tiles across blocks (a split-K pass with a second reduction) is
//   the obvious next step for speed.
//
// The int8/fp8 pool (per-row scales) is not in this kernel yet: the
// wrapper raises for it on the card.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGs = 8;     // query heads per kv head the kernel takes
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

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

// DPL: head-dim values per lane (dh <= 32 * DPL).
template <typename QT, typename KT, int DPL>
__global__ void __launch_bounds__(kThreads)
    paged_decode_kernel(const QT* __restrict__ q, const KT* __restrict__ kp,
                        const KT* __restrict__ vp,
                        const int* __restrict__ tables,
                        const int* __restrict__ lengths,
                        const QT* __restrict__ kn, const QT* __restrict__ vn,
                        QT* __restrict__ out, int H, int G, int dh, int bs,
                        int T, float scale) {
  extern __shared__ float smem[];
  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int gs = H / G;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  float* q_s = smem;              // gs*dh   scaled q
  float* p_s = q_s + gs * dh;     // gs*bs   tile scores, then probabilities
  float* acc_s = p_s + gs * bs;   // gs*dh   accumulator after the tiles
  float* m_s = acc_s + gs * dh;   // kMaxGs  running max
  float* l_s = m_s + kMaxGs;      // kMaxGs  running sum
  float* c_s = l_s + kMaxGs;      // kMaxGs  correction of the last update
  float* self_s = c_s + kMaxGs;   // kMaxGs  weight of the folded token

  const size_t q_base = ((size_t)b * H + (size_t)g * gs) * dh;
  for (int i = threadIdx.x; i < gs * dh; i += kThreads)
    q_s[i] = to_f(q[q_base + i]) * scale;
  if (threadIdx.x < kMaxGs) {
    m_s[threadIdx.x] = kNeg;
    l_s[threadIdx.x] = 0.f;
  }
  __syncthreads();

  float qr[kMaxGs][DPL];
  float acc[kMaxGs][DPL];
#pragma unroll
  for (int h = 0; h < kMaxGs; ++h) {
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int d = lane + 32 * j;
      qr[h][j] = (h < gs && d < dh) ? q_s[h * dh + d] : 0.f;
      acc[h][j] = 0.f;
    }
  }

  const int len = lengths[b];
  const int n_tiles = min((len + bs - 1) / bs, T);
  const size_t row_stride = (size_t)G * dh;  // between rows of one block
  for (int t = 0; t < n_tiles; ++t) {
    const size_t blk = (size_t)tables[(size_t)b * T + t];
    const KT* kb = kp + (blk * bs * G + g) * dh;
    const KT* vb = vp + (blk * bs * G + g) * dh;

    // scores: one warp per pool row, lanes across dh
    for (int r = warp; r < bs; r += kWarps) {
      float kr[DPL];
#pragma unroll
      for (int j = 0; j < DPL; ++j) {
        const int d = lane + 32 * j;
        kr[j] = d < dh ? to_f(kb[r * row_stride + d]) : 0.f;
      }
      const bool valid = t * bs + r < len;
#pragma unroll
      for (int h = 0; h < kMaxGs; ++h) {
        if (h < gs) {
          float s = 0.f;
#pragma unroll
          for (int j = 0; j < DPL; ++j) s += qr[h][j] * kr[j];
          s = warp_sum(s);
          if (lane == 0) p_s[h * bs + r] = valid ? s : kNeg;
        }
      }
    }
    __syncthreads();

    // online-softmax update per head: one warp per head
    for (int h = warp; h < gs; h += kWarps) {
      float mx = kNeg;
      for (int r = lane; r < bs; r += 32) mx = fmaxf(mx, p_s[h * bs + r]);
      mx = warp_max(mx);
      const float m_old = m_s[h];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int r = lane; r < bs; r += 32) {
        const float p = expf(p_s[h * bs + r] - m_new);
        p_s[h * bs + r] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        c_s[h] = corr;
        l_s[h] = l_s[h] * corr + sum;
        m_s[h] = m_new;
      }
    }
    __syncthreads();

    // P.V: partial sums per warp in registers
#pragma unroll
    for (int h = 0; h < kMaxGs; ++h) {
      if (h < gs) {
        const float corr = c_s[h];
#pragma unroll
        for (int j = 0; j < DPL; ++j) acc[h][j] *= corr;
      }
    }
    for (int r = warp; r < bs; r += kWarps) {
      float vr[DPL];
#pragma unroll
      for (int j = 0; j < DPL; ++j) {
        const int d = lane + 32 * j;
        vr[j] = d < dh ? to_f(vb[r * row_stride + d]) : 0.f;
      }
#pragma unroll
      for (int h = 0; h < kMaxGs; ++h) {
        if (h < gs) {
          const float p = p_s[h * bs + r];
#pragma unroll
          for (int j = 0; j < DPL; ++j) acc[h][j] += p * vr[j];
        }
      }
    }
    __syncthreads();  // p_s is rewritten by the next tile
  }

  // reduce the warps' partial accumulators in a fixed order
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int h = 0; h < kMaxGs; ++h) {
        if (h < gs) {
#pragma unroll
          for (int j = 0; j < DPL; ++j) {
            const int d = lane + 32 * j;
            if (d < dh)
              acc_s[h * dh + d] =
                  (w == 0) ? acc[h][j] : acc_s[h * dh + d] + acc[h][j];
          }
        }
      }
    }
    __syncthreads();
  }

  const size_t kv_base = ((size_t)b * G + g) * dh;
  if (kn != nullptr) {
    // fold the new token in after the last pool tile
    for (int h = warp; h < gs; h += kWarps) {
      float s = 0.f;
      for (int d = lane; d < dh; d += 32) s += q_s[h * dh + d] * to_f(kn[kv_base + d]);
      s = warp_sum(s);
      if (lane == 0) {
        const float m_f = fmaxf(m_s[h], s);
        const float p_self = expf(s - m_f);
        const float c = expf(m_s[h] - m_f);
        l_s[h] = l_s[h] * c + p_self;
        c_s[h] = c;
        self_s[h] = p_self;
        m_s[h] = m_f;
      }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < gs * dh; i += kThreads) {
    const int h = i / dh;
    const int d = i % dh;
    float a = acc_s[i];
    if (kn != nullptr) a = a * c_s[h] + self_s[h] * to_f(vn[kv_base + d]);
    out[q_base + i] = from_f<QT>(a / fmaxf(l_s[h], 1e-30f));
  }
}

template <typename QT, typename KT, int DPL>
cudaError_t launch_t(const void* q, const void* kp, const void* vp,
                     const int* tables, const int* lengths, const void* kn,
                     const void* vn, void* out, int B, int H, int G, int dh,
                     int bs, int T, cudaStream_t stream) {
  const int gs = H / G;
  const size_t smem =
      sizeof(float) * ((size_t)2 * gs * dh + (size_t)gs * bs + 4 * kMaxGs);
  auto kern = paged_decode_kernel<QT, KT, DPL>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(G, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(kp),
      static_cast<const KT*>(vp), tables, lengths,
      static_cast<const QT*>(kn), static_cast<const QT*>(vn),
      static_cast<QT*>(out), H, G, dh, bs, T, 1.0f / sqrtf((float)dh));
  return cudaGetLastError();
}

template <typename QT, typename KT>
cudaError_t dispatch_dpl(const void* q, const void* kp, const void* vp,
                         const int* tables, const int* lengths,
                         const void* kn, const void* vn, void* out, int B,
                         int H, int G, int dh, int bs, int T,
                         cudaStream_t stream) {
  if (dh <= 32)
    return launch_t<QT, KT, 1>(q, kp, vp, tables, lengths, kn, vn, out, B,
                               H, G, dh, bs, T, stream);
  if (dh <= 64)
    return launch_t<QT, KT, 2>(q, kp, vp, tables, lengths, kn, vn, out, B,
                               H, G, dh, bs, T, stream);
  if (dh <= 128)
    return launch_t<QT, KT, 4>(q, kp, vp, tables, lengths, kn, vn, out, B,
                               H, G, dh, bs, T, stream);
  return launch_t<QT, KT, 8>(q, kp, vp, tables, lengths, kn, vn, out, B, H,
                             G, dh, bs, T, stream);
}

template <typename QT>
cudaError_t dispatch_kv(int kv_dtype, const void* q, const void* kp,
                        const void* vp, const int* tables,
                        const int* lengths, const void* kn, const void* vn,
                        void* out, int B, int H, int G, int dh, int bs, int T,
                        cudaStream_t stream) {
  switch (kv_dtype) {
    case 0:
      return dispatch_dpl<QT, float>(q, kp, vp, tables, lengths, kn, vn,
                                     out, B, H, G, dh, bs, T, stream);
    case 1:
      return dispatch_dpl<QT, __nv_bfloat16>(q, kp, vp, tables, lengths, kn,
                                             vn, out, B, H, G, dh, bs, T,
                                             stream);
    case 2:
      return dispatch_dpl<QT, __half>(q, kp, vp, tables, lengths, kn, vn,
                                      out, B, H, G, dh, bs, T, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = float16.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const int* block_tables, const int* lengths, const void* k_new,
    const void* v_new, void* out, int B, int H, int G, int dh, int bs, int T,
    int q_dtype, int kv_dtype, void* stream) {
  if (B <= 0 || G <= 0 || H % G != 0 || H / G > kMaxGs || dh <= 0 ||
      dh > 256 || bs <= 0 || T <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (q_dtype) {
    case 0:
      e = dispatch_kv<float>(kv_dtype, q, k_pages, v_pages, block_tables,
                             lengths, k_new, v_new, out, B, H, G, dh, bs, T,
                             s);
      break;
    case 1:
      e = dispatch_kv<__nv_bfloat16>(kv_dtype, q, k_pages, v_pages,
                                     block_tables, lengths, k_new, v_new, out,
                                     B, H, G, dh, bs, T, s);
      break;
    case 2:
      e = dispatch_kv<__half>(kv_dtype, q, k_pages, v_pages, block_tables,
                              lengths, k_new, v_new, out, B, H, G, dh, bs, T,
                              s);
      break;
    default:
      e = cudaErrorInvalidValue;
  }
  return (int)e;
}
