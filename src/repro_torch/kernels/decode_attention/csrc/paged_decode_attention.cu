// Paged decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `_paged_decode_kernel` /
// `paged_decode_attention_pallas` of the JAX package
// (src/repro/kernels/decode_attention/decode_attention.py:63,142).
//
// What it computes (the same function as the TPU kernel): for each
// sequence b and query head h = g*gs + i of kv group g, an online softmax
// over the paged KV pool through the block table, in f32:
//   q is scaled by 1/sqrt(dh); positions < lengths[b] are attended;
//   (m, l, acc) are carried in f32; the optional new token (k_new, v_new)
//   is folded in after the last pool tile; out = acc / max(l, 1e-30),
//   cast to q's type.  An int8 or fp8 (e4m3) pool carries one f16 scale
//   per (row, kv head); each K/V row is dequantized by it right after the
//   load, inside the tile loop, as the TPU kernel does.  The folded token
//   stays at full precision.
//
// Bound on this card: memory.  Per (b, g) it streams ~2*len*dh*itemsize
// bytes of K and V and does ~4*gs*len*dh flops, far below the H100's
// ~20 flop/byte ridge, so the only lever is how fast the tiles stream.
//
// Design (a first design that is right, not yet fast; the tile update is
// in decode_common.cuh):
//   * one thread block of 4 warps per (b, kv head g);
//   * the block reads its own block-table entries and loops over the
//     tiles t < ceil(lengths[b]/bs) only, and within the last tile over
//     the rows below the length.  The null block 0 that idle slots and
//     table tails point at is never read, so it is inert for any finite
//     fill.  A row with length 0 and the fold returns the folded token;
//     with length 0 and no fold every score is the same, and the block
//     averages the V rows of all T tiles of the row's table, as the
//     reference does (its masked scores all take one fill value);
//   * at slots=4 and G=3 only 12 blocks are in flight on 132 SMs:
//     splitting the T tiles across blocks (a second reduction pass) is
//     the obvious next step for speed.

#include "decode_common.cuh"

namespace {

using namespace decode;

// DPL: head-dim values per lane (dh <= 32 * DPL).
template <typename QT, typename KT, int DPL>
__global__ void __launch_bounds__(kThreads)
    paged_decode_kernel(const QT* __restrict__ q, const KT* __restrict__ kp,
                        const KT* __restrict__ vp,
                        const __half* __restrict__ ksc,
                        const __half* __restrict__ vsc,
                        const int* __restrict__ tables,
                        const int* __restrict__ lengths,
                        const QT* __restrict__ kn, const QT* __restrict__ vn,
                        QT* __restrict__ out, int H, int G, int dh, int bs,
                        int T, float scale) {
  extern __shared__ float smem[];
  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int gs = H / G;
  const Smem sm = carve(smem, gs, dh, bs);
  const size_t q_base = ((size_t)b * H + (size_t)g * gs) * dh;
  float qr[kMaxGs][DPL];
  float acc[kMaxGs][DPL];
  load_q<QT, DPL>(q + q_base, sm, gs, dh, scale, qr, acc);

  const bool fold = kn != nullptr;
  const int len = lengths[b];
  const bool uniform = len <= 0 && !fold;
  const int n_tiles = uniform ? T : min((max(len, 0) + bs - 1) / bs, T);
  const size_t row_stride = (size_t)G * dh;  // between rows of one block
  for (int t = 0; t < n_tiles; ++t) {
    const size_t blk = (size_t)tables[(size_t)b * T + t];
    const size_t row0 = blk * bs * G + g;    // (blk, row 0, g)
    const int n = uniform ? bs : min(bs, len - t * bs);
    attend_rows<KT, DPL>(kp + row0 * dh, vp + row0 * dh,
                         ksc != nullptr ? ksc + row0 : nullptr,
                         vsc != nullptr ? vsc + row0 : nullptr, row_stride,
                         (size_t)G, n, uniform, gs, dh, sm, qr, acc);
  }
  const size_t kv_base = ((size_t)b * G + g) * dh;
  finish<QT, DPL>(sm, gs, dh, acc, fold ? kn + kv_base : nullptr,
                  fold ? vn + kv_base : nullptr, out + q_base);
}

template <typename QT, typename KT, int DPL>
cudaError_t launch_t(const void* q, const void* kp, const void* vp,
                     const void* ksc, const void* vsc, const int* tables,
                     const int* lengths, const void* kn, const void* vn,
                     void* out, int B, int H, int G, int dh, int bs, int T,
                     cudaStream_t stream) {
  const size_t smem = smem_bytes(H / G, dh, bs);
  auto kern = paged_decode_kernel<QT, KT, DPL>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(G, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(kp),
      static_cast<const KT*>(vp), static_cast<const __half*>(ksc),
      static_cast<const __half*>(vsc), tables, lengths,
      static_cast<const QT*>(kn), static_cast<const QT*>(vn),
      static_cast<QT*>(out), H, G, dh, bs, T, 1.0f / sqrtf((float)dh));
  return cudaGetLastError();
}

#define PAGED_ARGS q, kp, vp, ksc, vsc, tables, lengths, kn, vn, out, B, H, \
                   G, dh, bs, T, stream

template <typename QT, typename KT>
cudaError_t dispatch_dpl(const void* q, const void* kp, const void* vp,
                         const void* ksc, const void* vsc, const int* tables,
                         const int* lengths, const void* kn, const void* vn,
                         void* out, int B, int H, int G, int dh, int bs,
                         int T, cudaStream_t stream) {
  if (dh <= 32) return launch_t<QT, KT, 1>(PAGED_ARGS);
  if (dh <= 64) return launch_t<QT, KT, 2>(PAGED_ARGS);
  if (dh <= 128) return launch_t<QT, KT, 4>(PAGED_ARGS);
  return launch_t<QT, KT, 8>(PAGED_ARGS);
}

template <typename QT>
cudaError_t dispatch_kv(int kv_dtype, const void* q, const void* kp,
                        const void* vp, const void* ksc, const void* vsc,
                        const int* tables, const int* lengths,
                        const void* kn, const void* vn, void* out, int B,
                        int H, int G, int dh, int bs, int T,
                        cudaStream_t stream) {
  switch (kv_dtype) {
    case 0: return dispatch_dpl<QT, float>(PAGED_ARGS);
    case 1: return dispatch_dpl<QT, __nv_bfloat16>(PAGED_ARGS);
    case 2: return dispatch_dpl<QT, __half>(PAGED_ARGS);
    case 3: return dispatch_dpl<QT, int8_t>(PAGED_ARGS);
    case 4: return dispatch_dpl<QT, __nv_fp8_e4m3>(PAGED_ARGS);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = float16 (q and pool),
// 3 = int8, 4 = float8_e4m3fn (pool only; k_scale/v_scale (N,bs,G) f16
// must then be given, and are ignored otherwise).
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int paged_decode_attention(
    const void* q, const void* kp, const void* vp, const void* ksc,
    const void* vsc, const int* tables, const int* lengths, const void* kn,
    const void* vn, void* out, int B, int H, int G, int dh, int bs, int T,
    int q_dtype, int kv_dtype, void* stream_ptr) {
  if (B <= 0 || G <= 0 || H % G != 0 || H / G > kMaxGs || dh <= 0 ||
      dh > 256 || bs <= 0 || bs > 256 || T <= 0 ||
      (kv_dtype >= 3 && (ksc == nullptr || vsc == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (kv_dtype < 3) ksc = vsc = nullptr;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  switch (q_dtype) {
    case 0: return (int)dispatch_kv<float>(kv_dtype, PAGED_ARGS);
    case 1: return (int)dispatch_kv<__nv_bfloat16>(kv_dtype, PAGED_ARGS);
    case 2: return (int)dispatch_kv<__half>(kv_dtype, PAGED_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
}
