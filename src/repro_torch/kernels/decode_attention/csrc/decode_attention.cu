// Dense decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `_decode_kernel` / `decode_attention_pallas` of
// the JAX package (src/repro/kernels/decode_attention/decode_attention.py
// :27,218).
//
// What it computes (the same function as the TPU kernel): for each
// sequence b and query head h = g*gs + i of kv group g, an online softmax
// over the dense cache k, v (B, S, G, dh) in f32: q is scaled by
// 1/sqrt(dh), positions < lengths[b] are attended, out = acc / max(l,
// 1e-30) cast to q's type.  No fold: the caller has written the new token
// into the cache before the call.
//
// Bound on this card: memory (as the paged kernel: ~1 flop per byte).
//
// Design (the paged kernel's, with dense addressing; the tile update is in
// decode_common.cuh):
//   * one thread block of 4 warps per (b, kv head g), looping over S in
//     tiles of 128 rows and reading only the tiles and rows below the
//     row's length.  The TPU kernel's tile comes from a VMEM budget
//     (`plan_block_s`); here the tile is the shared-memory score buffer,
//     gs*128 floats;
//   * a row with length 0 averages all S rows, as the reference does (its
//     masked scores all take one fill value, so the softmax is uniform);
//   * the batch stride is a parameter, so a cache broadcast over the
//     batch (stride 0: the chunked prefill's one request seen by C
//     queries) is read in place.

#include "decode_common.cuh"

namespace {

using namespace decode;

constexpr int kTile = 128;

template <typename QT, typename KT, int DPL>
__global__ void __launch_bounds__(kThreads)
    dense_decode_kernel(const QT* __restrict__ q, const KT* __restrict__ k,
                        const KT* __restrict__ v,
                        const int* __restrict__ lengths,
                        QT* __restrict__ out, int H, int G, int dh, int S,
                        long long k_bstride, long long v_bstride,
                        float scale) {
  extern __shared__ float smem[];
  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int gs = H / G;
  const Smem sm = carve(smem, gs, dh, kTile);
  const size_t q_base = ((size_t)b * H + (size_t)g * gs) * dh;
  float qr[kMaxGs][DPL];
  float acc[kMaxGs][DPL];
  load_q<QT, DPL>(q + q_base, sm, gs, dh, scale, qr, acc);

  const int len = min(lengths[b], S);
  const bool uniform = len <= 0;
  const int cover = uniform ? S : len;
  const size_t row_stride = (size_t)G * dh;
  const KT* kb = k + (size_t)b * k_bstride + (size_t)g * dh;
  const KT* vb = v + (size_t)b * v_bstride + (size_t)g * dh;
  for (int r0 = 0; r0 < cover; r0 += kTile) {
    const int n = min(kTile, cover - r0);
    attend_rows<KT, DPL>(kb + r0 * row_stride, vb + r0 * row_stride,
                         nullptr, nullptr, row_stride, 0, n, uniform, gs,
                         dh, sm, qr, acc);
  }
  finish<QT, DPL>(sm, gs, dh, acc, static_cast<const QT*>(nullptr),
                  static_cast<const QT*>(nullptr), out + q_base);
}

template <typename QT, typename KT, int DPL>
cudaError_t launch_t(const void* q, const void* k, const void* v,
                     const int* lengths, void* out, int B, int H, int G,
                     int dh, int S, long long k_bstride, long long v_bstride,
                     cudaStream_t stream) {
  const size_t smem = smem_bytes(H / G, dh, kTile);
  auto kern = dense_decode_kernel<QT, KT, DPL>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(G, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), lengths, static_cast<QT*>(out), H, G, dh,
      S, k_bstride, v_bstride, 1.0f / sqrtf((float)dh));
  return cudaGetLastError();
}

#define DENSE_ARGS q, k, v, lengths, out, B, H, G, dh, S, k_bstride, \
                   v_bstride, stream

template <typename QT, typename KT>
cudaError_t dispatch_dpl(const void* q, const void* k, const void* v,
                         const int* lengths, void* out, int B, int H, int G,
                         int dh, int S, long long k_bstride,
                         long long v_bstride, cudaStream_t stream) {
  if (dh <= 32) return launch_t<QT, KT, 1>(DENSE_ARGS);
  if (dh <= 64) return launch_t<QT, KT, 2>(DENSE_ARGS);
  if (dh <= 128) return launch_t<QT, KT, 4>(DENSE_ARGS);
  return launch_t<QT, KT, 8>(DENSE_ARGS);
}

template <typename QT>
cudaError_t dispatch_kv(int kv_dtype, const void* q, const void* k,
                        const void* v, const int* lengths, void* out, int B,
                        int H, int G, int dh, int S, long long k_bstride,
                        long long v_bstride, cudaStream_t stream) {
  switch (kv_dtype) {
    case 0: return dispatch_dpl<QT, float>(DENSE_ARGS);
    case 1: return dispatch_dpl<QT, __nv_bfloat16>(DENSE_ARGS);
    case 2: return dispatch_dpl<QT, __half>(DENSE_ARGS);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = float16.  k, v: (B,S,G,dh)
// with rows contiguous and k_bstride / v_bstride elements between
// batches (0 for a cache broadcast over the batch).
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const int* lengths, void* out, int B, int H,
                                int G, int dh, int S, long long k_bstride,
                                long long v_bstride, int q_dtype,
                                int kv_dtype, void* stream_ptr) {
  if (B <= 0 || G <= 0 || H % G != 0 || H / G > kMaxGs || dh <= 0 ||
      dh > 256 || S <= 0 || k_bstride < 0 || v_bstride < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  switch (q_dtype) {
    case 0: return (int)dispatch_kv<float>(kv_dtype, DENSE_ARGS);
    case 1: return (int)dispatch_kv<__nv_bfloat16>(kv_dtype, DENSE_ARGS);
    case 2: return (int)dispatch_kv<__half>(kv_dtype, DENSE_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
}
