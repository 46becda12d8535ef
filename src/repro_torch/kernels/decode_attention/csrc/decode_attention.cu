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
// Bound on this card: bytes.  Each attended K/V row is read once and
// used for about one flop per byte, so the least time is the attended
// rows' bytes over the HBM rate; at decode shapes that is well under a
// microsecond, and what a kernel can lose is latency: blocks that wait on
// one row at a time, or SMs left idle.
//
// Design (the split and merge are in decode_split.cuh):
//   * grid (kSplit, G, B), cluster (kSplit, 1, 1): the kSplit = 16
//     blocks of a cluster share one (b, g).  Block p takes the p-th
//     contiguous share, ceil(n / 16) rows, of the row's n attended
//     positions (all S rows for a length-0 row), so every (b, g) gets 16
//     blocks whatever its length: 192 blocks at the C1 chain's (B 4, G 3)
//     instead of 12, more than the card's 132 SMs;
//   * a block copies its share into shared memory one tile of L rows at
//     a time with 16-byte cp.async (K and V rows are dh contiguous
//     values, G*dh apart), all of a tile's loads in flight at once and
//     one wait, then computes the gs x L scores, the tile's max and sum
//     and P.V from shared memory.  L (at most 64 rows, 16 KB per K or V
//     tile) and the number of stages (2, double-buffered, only when a
//     share can exceed one tile) come from the wrapper's plan, a function
//     of S and the row's bytes only.  At the chain's S = 512, L = 32:
//     every block reads at most one tile of 8 KB of K and 8 KB of V;
//   * no MMA: gs <= 8 query heads per kv head is fewer than the 16 rows
//     an MMA tile needs, and the kernel is bound by bytes;
//   * the 16 partials (m, l, acc[gs][dh]) meet through distributed shared
//     memory: each rank stores its partial into rank 0's shared memory,
//     and after one cluster barrier rank 0 adds them in rank order and
//     writes the output.  No workspace, no ticket, no remote load, one
//     launch; the order of every sum depends on
//     (S, dh, the row's length) only, so row b is bit-equal alone or in a
//     batch;
//   * a row with length 0 averages all S rows, as the reference does (its
//     masked scores all take one fill value, so the softmax is uniform);
//   * the batch stride is a parameter, so a cache broadcast over the
//     batch (stride 0: the chunked prefill's one request seen by C
//     queries) is read in place.

#include "decode_split.cuh"

namespace {

using namespace decode;
using namespace decode_split;

template <typename QT, typename KT, int J>
__global__ void __launch_bounds__(kThreads)
    dense_decode_kernel(const QT* __restrict__ q, const KT* __restrict__ k,
                        const KT* __restrict__ v,
                        const int* __restrict__ lengths,
                        QT* __restrict__ out, int H, int G, int dh, int S,
                        long long k_bstride, long long v_bstride, int L,
                        int stages, int vec, float scale) {
  extern __shared__ __align__(16) char smem[];
  const int rank = blockIdx.x;  // == the block's rank in its cluster
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int gs = H / G;
  const Layout sl = carve(smem, gs, dh, (int)sizeof(KT), L, stages);
  cluster_arrive_relaxed();

  const int len = min(lengths[b], S);
  const bool uniform = len <= 0;
  int lo, count;
  share_of(uniform ? S : len, rank, lo, count);
  const size_t row_stride = (size_t)G * dh;
  const KT* kb = k + (size_t)b * k_bstride + (size_t)g * dh + lo * row_stride;
  const KT* vb = v + (size_t)b * v_bstride + (size_t)g * dh + lo * row_stride;
  const int n_tiles = (count + L - 1) / L;

  auto stage_tile = [&](int t) {
    const int r0 = t * L;
    const int n = min(L, count - r0);
    const int st = t % stages;
    if (!uniform)
      stage_rows<KT>(k_tile(sl, st),
                     [&](int r) { return kb + (r0 + r) * row_stride; }, n,
                     dh, sl.pitch, vec);
    stage_rows<KT>(v_tile(sl, st),
                   [&](int r) { return vb + (r0 + r) * row_stride; }, n, dh,
                   sl.pitch, vec);
    cp_async_commit();
  };

  if (n_tiles > 0) stage_tile(0);
  const size_t q_base = ((size_t)b * H + (size_t)g * gs) * dh;
  load_q<QT>(q + q_base, sl, gs, dh, scale);
  float acc[J];
#pragma unroll
  for (int j = 0; j < J; ++j) acc[j] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {  // only with 2 stages (the plan's rule)
      stage_tile(t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    attend_tile<KT, J>(sl, t % stages, min(L, count - t * L), uniform, gs,
                       dh, acc);
  }
  cluster_merge<QT, J>(sl, gs, dh, acc, out + q_base, false);
}

template <typename QT, typename KT, int J>
cudaError_t launch_t(const void* q, const void* k, const void* v,
                     const int* lengths, void* out, int B, int H, int G,
                     int dh, int S, long long k_bstride, long long v_bstride,
                     int L, int stages, cudaStream_t stream) {
  const int item = (int)sizeof(KT);
  const size_t smem = smem_bytes(H / G, dh, item, L, stages);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  auto kern = dense_decode_kernel<QT, KT, J>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  // 16-byte copies need 16-byte rows, row starts and batch strides
  const int vec = (dh * item) % 16 == 0 &&
                  (reinterpret_cast<uintptr_t>(k) |
                   reinterpret_cast<uintptr_t>(v)) % 16 == 0 &&
                  (k_bstride * item) % 16 == 0 && (v_bstride * item) % 16 == 0;
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (opt_in != cudaSuccess) return opt_in;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kSplit, G, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kSplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kern, static_cast<const QT*>(q),
                                     static_cast<const KT*>(k),
                                     static_cast<const KT*>(v), lengths,
                                     static_cast<QT*>(out), H, G, dh, S,
                                     k_bstride, v_bstride, L, stages, vec,
                                     1.0f / sqrtf((float)dh));
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

#define DENSE_ARGS q, k, v, lengths, out, B, H, G, dh, S, k_bstride, \
                   v_bstride, L, stages, stream

// J: outputs per thread, ceil(gs * dh / kThreads) for gs <= kMaxGs
template <typename QT, typename KT>
cudaError_t dispatch_j(const void* q, const void* k, const void* v,
                       const int* lengths, void* out, int B, int H, int G,
                       int dh, int S, long long k_bstride,
                       long long v_bstride, int L, int stages,
                       cudaStream_t stream) {
  if (dh <= 32) return launch_t<QT, KT, 2>(DENSE_ARGS);
  if (dh <= 64) return launch_t<QT, KT, 4>(DENSE_ARGS);
  if (dh <= 128) return launch_t<QT, KT, 8>(DENSE_ARGS);
  return launch_t<QT, KT, 16>(DENSE_ARGS);
}

template <typename QT>
cudaError_t dispatch_kv(int kv_dtype, const void* q, const void* k,
                        const void* v, const int* lengths, void* out, int B,
                        int H, int G, int dh, int S, long long k_bstride,
                        long long v_bstride, int L, int stages,
                        cudaStream_t stream) {
  switch (kv_dtype) {
    case 0: return dispatch_j<QT, float>(DENSE_ARGS);
    case 1: return dispatch_j<QT, __nv_bfloat16>(DENSE_ARGS);
    case 2: return dispatch_j<QT, __half>(DENSE_ARGS);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = float16.  k, v: (B,S,G,dh)
// with rows contiguous and k_bstride / v_bstride elements between
// batches (0 for a cache broadcast over the batch).  tile_rows (L) and
// stages (1 or 2, and 2 whenever ceil(S / 16) > L) are the wrapper's
// plan.  Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const int* lengths, void* out, int B, int H,
                                int G, int dh, int S, long long k_bstride,
                                long long v_bstride, int L, int stages,
                                int q_dtype, int kv_dtype,
                                void* stream_ptr) {
  if (B <= 0 || G <= 0 || H % G != 0 || H / G > kMaxGs || dh <= 0 ||
      dh > 256 || S <= 0 || k_bstride < 0 || v_bstride < 0 || L <= 0 ||
      stages < 1 || stages > 2 ||
      (stages == 1 && (S + kSplit - 1) / kSplit > L))
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  switch (q_dtype) {
    case 0: return (int)dispatch_kv<float>(kv_dtype, DENSE_ARGS);
    case 1: return (int)dispatch_kv<__nv_bfloat16>(kv_dtype, DENSE_ARGS);
    case 2: return (int)dispatch_kv<__half>(kv_dtype, DENSE_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
}
