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
//   is folded in after the pool's positions; out = acc / max(l, 1e-30),
//   cast to q's type.  An int8 or fp8 (e4m3) pool carries one f16 scale
//   per (row, kv head); each K/V row is dequantized by it right after the
//   load, before the dot and before P.V, as the TPU kernel does.  The
//   folded token stays at full precision.
//
// Bound on this card: bytes.  Per (b, g) it streams ~2*len*dh*itemsize
// bytes of K and V and does ~4*gs*len*dh flops, far below the H100's
// ~20 flop/byte ridge; at decode shapes the bytes take well under a
// microsecond, and what a kernel can lose is latency: blocks that wait
// on one row at a time, or SMs left idle.
//
// Design (kernel 2's split and cluster merge, decode_split.cuh, with the
// block table as the row address):
//   * grid (kSplit, G, B), cluster (kSplit, 1, 1): the kSplit = 16
//     blocks of a cluster share one (b, g).  Block p takes the p-th
//     contiguous share, ceil(n / 16) positions, of the row's n attended
//     positions (all T*bs positions for a length-0 row without the
//     fold), so every (b, g) gets 16 blocks whatever its length: 192
//     blocks at slots 4 and G 3, more than the card's 132 SMs;
//   * position p of row b lives in pool block tables[b*T + p/bs] at row
//     p % bs, so a share may cross pool blocks: the staging looks each
//     row up through the table.  Only positions below n are looked up,
//     so no table entry at or past ceil(n / bs) is read and the null
//     block 0 that idle slots and table tails point at stays inert for
//     any finite fill;
//   * a block copies its share into shared memory one tile of L rows at
//     a time with 16-byte cp.async when a row is a multiple of 16 bytes
//     (plain loads otherwise), all of a tile's loads in flight at once
//     and one wait, then computes the gs x L scores, the tile's max and
//     sum and P.V from shared memory.  L and the number of stages come
//     from `tile_plan`, a function of S = T*bs and the row's bytes only
//     (the wrapper's `dense_plan` gives the same): at the main path's
//     S = 512, L = 32 and one stage;
//   * an int8 / fp8 pool's f16 row scales are staged beside the tile
//     and applied to each value as it is read from shared memory;
//   * the 16 partials (m, l, acc[gs][dh]) meet in rank 0's shared memory
//     through distributed shared memory; the new token is one more
//     partial (m = q.k_new, l = 1, acc = v_new), added after ranks
//     0..15 in that fixed place.  A length-0 row with the fold then
//     returns v_new: every share is empty and weighs exp(-1e30 - m) = 0;
//     a length-0 row without the fold averages the V rows of its whole
//     table, as the reference does (its masked scores all take one fill
//     value, so the softmax is uniform);
//   * the order of every sum depends on (T*bs, dh, the item size, the
//     row's length) only, so row b is bit-equal alone or in a batch;
//   * shared memory: rank 0's merge slots (17 partials) dominate.  At
//     gs 8 and dh 256 with two stages a block takes 217,568 bytes in f32
//     (L 16), 219,360 in bf16/f16 (L 32) and, the worst case the wrapper
//     admits, 222,944 with an int8 / fp8 pool (L 64), of the 232,448 a
//     block may use.  At the main path's shape (gs 3, dh 64, f32) it
//     takes 33,888.

#include "decode_split.cuh"

namespace {

using namespace decode;
using namespace decode_split;

template <typename QT, typename KT, int J>
__global__ void __launch_bounds__(kThreads)
    paged_decode_kernel(const QT* __restrict__ q, const KT* __restrict__ kp,
                        const KT* __restrict__ vp,
                        const __half* __restrict__ ksc,
                        const __half* __restrict__ vsc,
                        const int* __restrict__ tables,
                        const int* __restrict__ lengths,
                        const QT* __restrict__ kn, const QT* __restrict__ vn,
                        QT* __restrict__ out, int H, int G, int dh, int bs,
                        int T, int L, int stages, int vec, float scale) {
  constexpr bool kQuant = is_quantized<KT>::value;
  extern __shared__ __align__(16) char smem[];
  const int rank = blockIdx.x;  // == the block's rank in its cluster
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int gs = H / G;
  const Layout sl = carve(smem, gs, dh, (int)sizeof(KT), L, stages);
  cluster_arrive_relaxed();

  const bool fold = kn != nullptr;
  const int S = T * bs;
  const int len = lengths[b];
  const bool uniform = len <= 0 && !fold;
  int lo, count;
  share_of(uniform ? S : min(max(len, 0), S), rank, lo, count);
  const int* tb = tables + (size_t)b * T;
  // (pool row, kv head) index of the row's position p
  auto at = [&](int p) -> size_t {
    return ((size_t)tb[p / bs] * bs + p % bs) * G + g;
  };
  const int n_tiles = (count + L - 1) / L;

  auto stage_tile = [&](int t) {
    const int p0 = lo + t * L;
    const int n = min(L, count - t * L);
    const int st = t % stages;
    if (!uniform)
      stage_rows<KT>(k_tile(sl, st),
                     [&](int r) { return kp + at(p0 + r) * dh; }, n, dh,
                     sl.pitch, vec);
    stage_rows<KT>(v_tile(sl, st),
                   [&](int r) { return vp + at(p0 + r) * dh; }, n, dh,
                   sl.pitch, vec);
    cp_async_commit();
    if (kQuant) {
      float* ks = k_scales(sl, st);
      float* vs = v_scales(sl, st);
      for (int r = threadIdx.x; r < n; r += kThreads) {
        const size_t i = at(p0 + r);
        if (!uniform) ks[r] = __half2float(ksc[i]);
        vs[r] = __half2float(vsc[i]);
      }
    }
  };

  if (n_tiles > 0) stage_tile(0);
  const size_t q_base = ((size_t)b * H + (size_t)g * gs) * dh;
  load_q<QT>(q + q_base, sl, gs, dh, scale);
  const size_t kv_base = ((size_t)b * G + g) * dh;
  if (fold && rank == 0)
    fold_load<QT>(sl, gs, dh, kn + kv_base, vn + kv_base);
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
  if (fold && rank == 0) {
    __syncthreads();  // q_s and kn_s, also when the share was empty
    fold_score(sl, gs, dh);
  }
  cluster_merge<QT, J>(sl, gs, dh, acc, out + q_base, fold);
}

template <typename QT, typename KT, int J>
cudaError_t launch_t(const void* q, const void* kp, const void* vp,
                     const void* ksc, const void* vsc, const int* tables,
                     const int* lengths, const void* kn, const void* vn,
                     void* out, int B, int H, int G, int dh, int bs, int T,
                     cudaStream_t stream) {
  const int item = (int)sizeof(KT);
  int L, stages;
  tile_plan(T * bs, dh, item, L, stages);
  const size_t smem = smem_bytes(H / G, dh, item, L, stages);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  auto kern = paged_decode_kernel<QT, KT, J>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  // 16-byte copies need 16-byte rows and pool bases (a row's offset is a
  // multiple of its bytes)
  const int vec = (dh * item) % 16 == 0 &&
                  (reinterpret_cast<uintptr_t>(kp) |
                   reinterpret_cast<uintptr_t>(vp)) % 16 == 0;
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
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const QT*>(q), static_cast<const KT*>(kp),
      static_cast<const KT*>(vp), static_cast<const __half*>(ksc),
      static_cast<const __half*>(vsc), tables, lengths,
      static_cast<const QT*>(kn), static_cast<const QT*>(vn),
      static_cast<QT*>(out), H, G, dh, bs, T, L, stages, vec,
      1.0f / sqrtf((float)dh));
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

#define PAGED_ARGS q, kp, vp, ksc, vsc, tables, lengths, kn, vn, out, B, H, \
                   G, dh, bs, T, stream

// J: outputs per thread, ceil(gs * dh / kThreads) for gs <= kMaxGs
template <typename QT, typename KT>
cudaError_t dispatch_j(const void* q, const void* kp, const void* vp,
                       const void* ksc, const void* vsc, const int* tables,
                       const int* lengths, const void* kn, const void* vn,
                       void* out, int B, int H, int G, int dh, int bs, int T,
                       cudaStream_t stream) {
  if (dh <= 32) return launch_t<QT, KT, 2>(PAGED_ARGS);
  if (dh <= 64) return launch_t<QT, KT, 4>(PAGED_ARGS);
  if (dh <= 128) return launch_t<QT, KT, 8>(PAGED_ARGS);
  return launch_t<QT, KT, 16>(PAGED_ARGS);
}

template <typename QT>
cudaError_t dispatch_kv(int kv_dtype, const void* q, const void* kp,
                        const void* vp, const void* ksc, const void* vsc,
                        const int* tables, const int* lengths,
                        const void* kn, const void* vn, void* out, int B,
                        int H, int G, int dh, int bs, int T,
                        cudaStream_t stream) {
  switch (kv_dtype) {
    case 0: return dispatch_j<QT, float>(PAGED_ARGS);
    case 1: return dispatch_j<QT, __nv_bfloat16>(PAGED_ARGS);
    case 2: return dispatch_j<QT, __half>(PAGED_ARGS);
    case 3: return dispatch_j<QT, int8_t>(PAGED_ARGS);
    case 4: return dispatch_j<QT, __nv_fp8_e4m3>(PAGED_ARGS);
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
