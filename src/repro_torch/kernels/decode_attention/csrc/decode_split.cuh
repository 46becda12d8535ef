// Split-S decode attention with a cluster merge, for Hopper (sm_90a).
//
// The pieces of a decode-attention kernel that splits each (sequence b,
// kv head g) over a thread-block cluster of kSplit blocks along the
// cache axis: the plan's shared-memory layout, the 16-byte cp.async
// staging of a tile of K/V rows, the online-softmax update of a tile
// read from shared memory, and the merge of the blocks' partials
// (m, l, acc) through distributed shared memory in rank order, with an
// optional extra partial for a folded token.  The dense kernel
// (decode_attention.cu) uses them with dense addressing, the paged
// kernel (paged_decode_attention.cu) with the block table as the row
// address (`RowPtr`), an int8 / fp8 pool's row scales staged beside its
// tiles, and the new token folded in as that extra partial.
//
// Why: at decode the kernel is bound by bytes (about one flop per byte
// read), and one block per (b, g) leaves most SMs idle and each block
// paying one DRAM round trip per row.  Here every (b, g) gets kSplit
// blocks whatever its length, each block issues a whole tile of K and V
// rows at once (cp.async, one wait), and the partials meet in rank 0's
// shared memory: no global workspace, no remote load, no second launch.
//
// The plan (tile rows L and stages; `tile_plan` below, the wrapper's
// `dense_plan`) depends on S and the row's bytes only, and block p's
// share of a row's attended positions on that row's length only, so a
// row's result is bit-equal whether it is computed alone or inside a
// batch.

#pragma once

#include <cooperative_groups.h>

#include "decode_common.cuh"

namespace decode_split {

using namespace decode;
namespace cg = cooperative_groups;

// blocks per cluster along S: 16, a non-portable cluster size that
// Hopper allows (the launch opts in), so that a decode batch of a few
// sequences still puts more blocks than SMs on the card
constexpr int kSplit = 16;
// a tile holds at most kMaxTileRows rows and kTileBytes bytes of K (and
// as many of V)
constexpr int kMaxTileRows = 64;
constexpr int kTileBytes = 16384;

// The plan for a cache of S rows of dh values of `item` bytes (the
// wrapper's `dense_plan` computes the same): L covers one block's share
// of S in one tile where the tile's bytes allow, and a second stage
// double-buffers the tiles only when a share can exceed one.
__host__ inline void tile_plan(int S, int dh, int item, int& L,
                               int& stages) {
  const int per = (S + kSplit - 1) / kSplit;
  L = per < kMaxTileRows ? per : kMaxTileRows;
  if (L > kTileBytes / (dh * item)) L = kTileBytes / (dh * item);
  if (L < 1) L = 1;
  stages = per <= L ? 1 : 2;
}

// bytes between two K (or V) rows of a tile in shared memory: the row
// rounded up to 16 bytes plus 16, so lanes reading 16 bytes of
// consecutive rows fall in different banks
__host__ __device__ inline int row_pitch(int dh, int item) {
  return (dh * item + 15) / 16 * 16 + 16;
}

// Shared memory of one block: `stages` x (K tile, V tile) of L rows,
// then floats: q_s gs*dh (scaled q), p_s gs*L (scores, probabilities),
// m_s, l_s, c_s kMaxGs each, w_s (kSplit+1)*kMaxGs and lt_s kMaxGs (rank
// 0's merge weights and sums), kn_s dh (the folded token's k), sc_s
// stages*2*L (an int8 / fp8 pool's K and V row scales of each stage),
// and mrg (kSplit+1)*(2*kMaxGs + gs*dh): in rank 0, every rank's
// (m, l, acc), written there by that rank, and in slot kSplit the folded
// token's.
struct Layout {
  char* tiles;
  float* q_s;
  float* p_s;
  float* m_s;
  float* l_s;
  float* c_s;
  float* w_s;
  float* lt_s;
  float* kn_s;
  float* sc_s;
  float* mrg;
  int pitch;
  int L;
};

constexpr int kParts = kSplit + 1;  // merge slots: the ranks, the fold

__host__ __device__ inline size_t smem_bytes(int gs, int dh, int item,
                                             int L, int stages) {
  return (size_t)stages * 2 * L * row_pitch(dh, item) +
         sizeof(float) * ((size_t)gs * dh + (size_t)gs * L +
                          (4 + kParts) * kMaxGs + dh + (size_t)stages * 2 * L +
                          (size_t)kParts * (2 * kMaxGs + gs * dh));
}

__device__ __forceinline__ Layout carve(char* base, int gs, int dh,
                                        int item, int L, int stages) {
  Layout s;
  s.pitch = row_pitch(dh, item);
  s.L = L;
  s.tiles = base;
  s.q_s = reinterpret_cast<float*>(base + (size_t)stages * 2 * L * s.pitch);
  s.p_s = s.q_s + gs * dh;
  s.m_s = s.p_s + gs * L;
  s.l_s = s.m_s + kMaxGs;
  s.c_s = s.l_s + kMaxGs;
  s.w_s = s.c_s + kMaxGs;
  s.lt_s = s.w_s + kParts * kMaxGs;
  s.kn_s = s.lt_s + kMaxGs;
  s.sc_s = s.kn_s + dh;
  s.mrg = s.sc_s + stages * 2 * L;
  return s;
}

__device__ __forceinline__ char* k_tile(const Layout& s, int stage) {
  return s.tiles + (size_t)(2 * stage) * s.L * s.pitch;
}
__device__ __forceinline__ char* v_tile(const Layout& s, int stage) {
  return s.tiles + (size_t)(2 * stage + 1) * s.L * s.pitch;
}
// the row scales of a stage's K and V tiles (int8 / fp8 pools)
__device__ __forceinline__ float* k_scales(const Layout& s, int stage) {
  return s.sc_s + (size_t)(2 * stage) * s.L;
}
__device__ __forceinline__ float* v_scales(const Layout& s, int stage) {
  return s.sc_s + (size_t)(2 * stage + 1) * s.L;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d =
      static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage n rows (row r at row(r)) of dh KT values into dst, pitch bytes
// apart: 16-byte cp.async when `vec` (rows and pointers 16-byte
// aligned), else plain loads and stores.  The caller commits and waits.
template <typename KT, typename RowPtr>
__device__ __forceinline__ void stage_rows(char* dst, RowPtr row, int n,
                                           int dh, int pitch, bool vec) {
  if (vec) {
    const int per_row = dh * (int)sizeof(KT) / 16;
    for (int i = threadIdx.x; i < n * per_row; i += kThreads) {
      const int r = i / per_row;
      const int c = i % per_row;
      cp_async16(dst + (size_t)r * pitch + 16 * c,
                 reinterpret_cast<const char*>(row(r)) + 16 * c);
    }
  } else {
    for (int i = threadIdx.x; i < n * dh; i += kThreads) {
      const int r = i / dh;
      const int d = i % dh;
      reinterpret_cast<KT*>(dst + (size_t)r * pitch)[d] = row(r)[d];
    }
  }
}

// q . k over dh from shared memory (q in f32, k a staged row)
template <typename KT>
__device__ __forceinline__ float dot_row(const float* q, const KT* k,
                                         int dh) {
  float s = 0.f;
  for (int d = 0; d < dh; ++d) s = fmaf(q[d], to_f(k[d]), s);
  return s;
}
template <>
__device__ __forceinline__ float dot_row<float>(const float* q,
                                                const float* k, int dh) {
  float s = 0.f;
  if (dh % 4 == 0) {
    for (int d = 0; d < dh; d += 4) {
      const float4 a = *reinterpret_cast<const float4*>(q + d);
      const float4 b = *reinterpret_cast<const float4*>(k + d);
      s = fmaf(a.x, b.x, s);
      s = fmaf(a.y, b.y, s);
      s = fmaf(a.z, b.z, s);
      s = fmaf(a.w, b.w, s);
    }
  } else {
    for (int d = 0; d < dh; ++d) s = fmaf(q[d], k[d], s);
  }
  return s;
}

// q . k over dh from shared memory for a quantized row: each value
// dequantized by the row's scale before the product, as the TPU kernel
// and the plain version dequantize the tile before the dot
template <typename KT>
__device__ __forceinline__ float dot_row_scaled(const float* q, const KT* k,
                                                float sc, int dh) {
  float s = 0.f;
  for (int d = 0; d < dh; ++d) s = fmaf(q[d], to_f(k[d]) * sc, s);
  return s;
}

// Reset the block's softmax state and load the group's gs query heads,
// scaled by 1/sqrt(dh), into q_s.  No barrier: the first tile's wait has
// one.
template <typename QT>
__device__ __forceinline__ void load_q(const QT* q, const Layout& s, int gs,
                                       int dh, float scale) {
  for (int i = threadIdx.x; i < gs * dh; i += kThreads)
    s.q_s[i] = to_f(q[i]) * scale;
  if (threadIdx.x < kMaxGs) {
    s.m_s[threadIdx.x] = kNeg;
    s.l_s[threadIdx.x] = 0.f;
  }
}

// Online-softmax update over the n rows staged in `stage` (all attended;
// `uniform`: every score is 0, a row with nothing to attend averages its
// V rows).  An int8 / fp8 row is dequantized by its staged scale right
// after it is read.  Thread t keeps the partial P.V of outputs
// t + kThreads*j of the gs*dh in acc[j].  Ends on a barrier: the stage
// may be refilled.
template <typename KT, int J>
__device__ __forceinline__ void attend_tile(const Layout& s, int stage,
                                            int n, bool uniform, int gs,
                                            int dh, float (&acc)[J]) {
  constexpr bool kQuant = is_quantized<KT>::value;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int L = s.L;
  const int pitch_e = s.pitch / (int)sizeof(KT);
  const KT* kt = reinterpret_cast<const KT*>(k_tile(s, stage));
  const KT* vt = reinterpret_cast<const KT*>(v_tile(s, stage));
  const float* ksc = k_scales(s, stage);
  const float* vsc = v_scales(s, stage);

  // scores: one (head, row) per thread, consecutive rows across lanes
  for (int i = threadIdx.x; i < gs * n; i += kThreads) {
    const int h = i / n;
    const int r = i % n;
    const float* qh = s.q_s + h * dh;
    s.p_s[h * L + r] =
        uniform ? 0.f
        : kQuant ? dot_row_scaled<KT>(qh, kt + r * pitch_e, ksc[r], dh)
                 : dot_row<KT>(qh, kt + r * pitch_e, dh);
  }
  __syncthreads();

  // softmax update: one warp per head
  for (int h = warp; h < gs; h += kWarps) {
    float mx = kNeg;
    for (int r = lane; r < n; r += 32) mx = fmaxf(mx, s.p_s[h * L + r]);
    mx = warp_max(mx);
    const float m_old = s.m_s[h];
    const float m_new = fmaxf(m_old, mx);
    float sum = 0.f;
    for (int r = lane; r < n; r += 32) {
      const float p = expf(s.p_s[h * L + r] - m_new);
      s.p_s[h * L + r] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      const float corr = expf(m_old - m_new);
      s.c_s[h] = corr;
      s.l_s[h] = s.l_s[h] * corr + sum;
      s.m_s[h] = m_new;
    }
  }
  __syncthreads();

  // P.V: consecutive outputs (head-major, then d) across threads
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int o = threadIdx.x + kThreads * j;
    if (o < gs * dh) {
      const int h = o / dh;
      const int d = o % dh;
      const float* p = s.p_s + h * L;
      float a = acc[j] * s.c_s[h];
      for (int r = 0; r < n; ++r) {
        const float x = to_f(vt[r * pitch_e + d]);
        a = fmaf(p[r], kQuant ? x * vsc[r] : x, a);
      }
      acc[j] = a;
    }
  }
  __syncthreads();
}

// First half of the cluster barrier that cluster_merge waits on: every
// thread calls it once at the kernel's start, so that by the time a
// block writes into rank 0's shared memory, every block of the cluster
// has started.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

// The folded token (paged decode: the pool is read before the caller
// writes the new token into it) as one more partial of rank 0's merge,
// in slot kSplit: m = q.k_new (q already scaled), l = 1, acc = v_new for
// each of the gs heads.  fold_load (rank 0, every thread, before the
// tiles) brings k_new into kn_s and v_new into the slot; fold_score
// (after a barrier that makes q_s and kn_s visible) writes m and l.
template <typename QT>
__device__ __forceinline__ void fold_load(const Layout& s, int gs, int dh,
                                          const QT* kn, const QT* vn) {
  float* slot = s.mrg + (size_t)kSplit * (2 * kMaxGs + gs * dh);
  for (int d = threadIdx.x; d < dh; d += kThreads) s.kn_s[d] = to_f(kn[d]);
  for (int o = threadIdx.x; o < gs * dh; o += kThreads)
    slot[2 * kMaxGs + o] = to_f(vn[o % dh]);
}

__device__ __forceinline__ void fold_score(const Layout& s, int gs,
                                           int dh) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* slot = s.mrg + (size_t)kSplit * (2 * kMaxGs + gs * dh);
  for (int h = warp; h < gs; h += kWarps) {
    float x = 0.f;
    for (int d = lane; d < dh; d += 32) x += s.q_s[h * dh + d] * s.kn_s[d];
    x = warp_sum(x);
    if (lane == 0) {
      slot[h] = x;
      slot[kMaxGs + h] = 1.f;
    }
  }
}

// Merge the cluster's partials: every rank stores its (m, l, acc) into
// its slot of rank 0's mrg (stores to distributed shared memory: no
// round trip waits on them); after one cluster barrier rank 0 weighs
// part p by exp(m_p - max m), adds the parts in rank order 0..kSplit-1
// and then, with `fold`, the folded token's (slot kSplit, filled by
// fold_load / fold_score), and writes out = acc / max(l, 1e-30) in QT.
// Every thread of every block of the cluster must call it, after
// cluster_arrive_relaxed.
template <typename QT, int J>
__device__ __forceinline__ void cluster_merge(const Layout& s, int gs,
                                              int dh, const float (&acc)[J],
                                              QT* out, bool fold) {
  cg::cluster_group cluster = cg::this_cluster();
  const int slot = 2 * kMaxGs + gs * dh;
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  float* dst = cluster.map_shared_rank(s.mrg, 0) +
               (size_t)cluster.block_rank() * slot;
  if (threadIdx.x < gs) {
    dst[threadIdx.x] = s.m_s[threadIdx.x];
    dst[kMaxGs + threadIdx.x] = s.l_s[threadIdx.x];
  }
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int o = threadIdx.x + kThreads * j;
    if (o < gs * dh) dst[2 * kMaxGs + o] = acc[j];
  }
  cluster.sync();
  if (cluster.block_rank() != 0) return;
  const float* fs = s.mrg + (size_t)kSplit * slot;  // the fold's slot
  if (threadIdx.x < gs) {
    const int h = threadIdx.x;
    float m = kNeg;
#pragma unroll
    for (int p = 0; p < kSplit; ++p) m = fmaxf(m, s.mrg[p * slot + h]);
    if (fold) m = fmaxf(m, fs[h]);
    float l = 0.f;
#pragma unroll
    for (int p = 0; p < kSplit; ++p) {
      const float w = expf(s.mrg[p * slot + h] - m);
      s.w_s[p * kMaxGs + h] = w;
      l += s.mrg[p * slot + kMaxGs + h] * w;
    }
    if (fold) {
      const float w = expf(fs[h] - m);
      s.w_s[kSplit * kMaxGs + h] = w;
      l += fs[kMaxGs + h] * w;
    }
    s.lt_s[h] = fmaxf(l, 1e-30f);
  }
  __syncthreads();
  for (int o = threadIdx.x; o < gs * dh; o += kThreads) {
    const int h = o / dh;
    float a = 0.f;
#pragma unroll
    for (int p = 0; p < kSplit; ++p)
      a += s.mrg[p * slot + 2 * kMaxGs + o] * s.w_s[p * kMaxGs + h];
    if (fold) a += fs[2 * kMaxGs + o] * s.w_s[kSplit * kMaxGs + h];
    out[o] = from_f<QT>(a / s.lt_s[h]);
  }
}

// Block `rank`'s share of a row's n attended positions: contiguous,
// ceil(n / kSplit) rows each; [lo, lo + count).
__device__ __forceinline__ void share_of(int n, int rank, int& lo,
                                         int& count) {
  const int share = (n + kSplit - 1) / kSplit;
  lo = min(n, rank * share);
  count = min(n, lo + share) - lo;
}

}  // namespace decode_split
