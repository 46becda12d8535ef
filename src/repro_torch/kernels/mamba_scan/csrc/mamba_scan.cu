// Selective scan (Mamba S6) for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `_scan_kernel` / `mamba_scan_pallas` of the JAX
// package (src/repro/kernels/mamba_scan/mamba_scan.py:27,52).
//
// What it computes (the same function as the TPU kernel): for every
// channel (b, c), starting from the f32 state h = h0[b, c, :] (N values),
// for t = 0 .. S-1
//   h[n]        <- da[b, t, c, n] * h[n] + bx[b, t, c, n]
//   y[b, t, c]   = sum_n h[n] * cc[b, t, n]
// then the final h is written out.  Two entries share one design:
//   mamba_scan        (a) takes da and bx as (B, S, C, N) tensors, as the
//                     TPU kernel does;
//   mamba_scan_fused  (b) takes dt, x (B, S, C), a (C, N) and bm (B, S, N)
//                     and forms every element in registers, rounded as
//                     the model's PyTorch producers round them:
//                       da = expf(dt * a[c, n]),  bx = (dt * x) * bm[n];
//                     the (B, S, C, N) tensors are never written.
//
// Bound on this card: memory for (a) (da and bx are read once: 8.5 MB at
// the decode shape (4, 1, 8192, 16), 2.5 us at 3.35 TB/s); for (b) the
// state, `a` and the (B, S, C) rows (~5 MB at decode, ~52 MB at
// (1, 512, 8192, 16)), and at long S just as much the expf on the SFUs
// (16 a clock per SM: 67 M of them at S = 512).
//
// Design:
//   * a channel's N states are split over L lanes (L = 1, 2, 4, 8: four
//     states a lane, eight when N > 32), so a block of 128 threads holds
//     128 / L channels of one batch row, grid (C / (128 / L), B): 256
//     blocks at (1, S, 8192, 16), 1024 at decode, and a warp's 16-byte
//     state loads are contiguous;
//   * the sequence's rows (dt and x of the block's channels and b, c for
//     (b); the da/bx rows and c for (a)) are staged CHUNK steps at a time
//     by cp.async into a ring of up to 4 stages in shared memory, each
//     stage's arrival counted on an mbarrier (every thread's copies
//     arrive with cp.async.mbarrier.arrive.noinc) and its release on a
//     second one, so two chunks are in flight while one is computed and
//     the recurrence waits on arithmetic, not on memory; the state and
//     `a` are loaded into registers while the first stages land;
//   * every product and sum is rounded on its own (__fmul_rn / __fadd_rn,
//     never contracted into a fused multiply-add) and the output's sum
//     over n runs left to right, n = 0 .. N-1: each lane adds its own
//     states to the partial sum it receives from the lane on its left by
//     a shuffle, a chain off the recurrence's critical path; the chains
//     of 8 steps (2 for (a)) are interleaved so their latencies overlap.
//     At (1, 512, 8192, 16) the block count leaves 8 warps an SM, and
//     the kernel waits on the latency of this instruction mix (the exact
//     expf, 8 instructions each, and the chain), not on memory
//     (PERF.md).  The plain
//     versions (ref.py) repeat exactly this arithmetic, so the two agree
//     bit for bit (expf is the CUDA math library's, which torch.exp also
//     runs on the card) and a run is deterministic;
//   * any S >= 1, any C (a ragged last block), 1 <= N <= 64 (a ragged
//     last lane group); ops.mamba_plan repeats the plan below.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;       // threads per block
constexpr int kMaxChunk = 32;       // sequence steps per stage, at most
// a stage's floats, unless one step needs more: (b)'s, and (a)'s, whose
// rows are (C, N)
constexpr int kStageFloats = 4096;
constexpr int kRowStageFloats = 6400;
constexpr int kStages = 4;          // stages in the ring, at most
constexpr int kBarrierBytes = 64;   // full[kStages], empty[kStages]

struct Plan {
  int lanes, npl, cb, np, per_step, chunk, stages, nchunks, smem;
};

Plan make_plan(bool fused, int S, int N) {
  Plan p;
  const int quads = (N + 3) / 4;
  p.lanes = 1;
  while (p.lanes < quads && p.lanes < 8) p.lanes *= 2;
  p.npl = N > 32 ? 8 : 4;
  p.cb = kThreads / p.lanes;
  p.np = p.lanes * p.npl;
  p.per_step = fused ? 2 * p.cb + 2 * p.np : 2 * p.cb * p.np + p.np;
  int chunk = (fused ? kStageFloats : kRowStageFloats) / p.per_step;
  chunk = chunk < 1 ? 1 : (chunk > kMaxChunk ? kMaxChunk : chunk);
  p.chunk = chunk < S ? chunk : S;
  p.nchunks = (S + p.chunk - 1) / p.chunk;
  p.stages = p.nchunks < kStages ? p.nchunks : kStages;
  p.smem = kBarrierBytes + p.stages * p.chunk * p.per_step * 4;
  return p;
}

struct Args {
  const float* da;  // (a): (B, S, C, N)
  const float* bx;
  const float* dt;  // (b): (B, S, C), softplus applied
  const float* x;   // (b): (B, S, C)
  const float* a;   // (b): (C, N)
  const float* bm;  // (b): (B, S, N)
  const float* cc;  // (B, S, N)
  const float* h0;  // (B, C, N)
  float* y;         // (B, S, C)
  float* h_out;     // (B, C, N)
  int S, C, N, chunk, stages, nchunks;
  bool vec_rows;    // (a): 16-byte copies of the da/bx rows
  bool vec_state;   // float4 loads of h0 and a, stores of h_out
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// arrives on `bar` once every cp.async this thread issued has landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n .reg .b64 st;\n mbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::
          "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Stage chunk k's rows into ring slot k % stages; every thread then
// arrives on that slot's full barrier when its own copies have landed.
template <bool FUSED, int L, int NPL>
__device__ __forceinline__ void issue_chunk(const Args& p, float* stage,
                                            uint64_t* full, int b, int c0,
                                            int k) {
  constexpr int CB = kThreads / L;
  constexpr int NP = L * NPL;
  const int t0 = k * p.chunk;
  const int steps = min(p.chunk, p.S - t0);
  const size_t row0 = (size_t)b * p.S + t0;  // (b, t0) in (B, S, ...)
  const int N = p.N;
  float* rest;
  if (FUSED) {
    float* dx = stage;  // [chunk][CB] (dt, x) pairs
    for (int i = threadIdx.x; i < steps * CB; i += kThreads) {
      const int t = i / CB, cl = i % CB;
      if (c0 + cl < p.C) {
        const size_t src = (row0 + t) * p.C + c0 + cl;
        cp_async4(dx + 2 * i, p.dt + src);
        cp_async4(dx + 2 * i + 1, p.x + src);
      }
    }
    rest = stage + 2 * p.chunk * CB;  // [chunk][2][NP]: b row, c row
    for (int i = threadIdx.x; i < steps * N; i += kThreads) {
      const int t = i / N, n = i - t * N;
      cp_async4(rest + t * 2 * NP + n, p.bm + row0 * N + i);
      cp_async4(rest + t * 2 * NP + NP + n, p.cc + row0 * N + i);
    }
  } else {
    float* rda = stage;  // [chunk][CB][NP]
    float* rbx = stage + p.chunk * CB * NP;
    const int cbv = min(CB, p.C - c0);
    const int row = cbv * N;  // contiguous floats of a step's rows
    if (p.vec_rows) {
      const int quads = row / 4;
      for (int i = threadIdx.x; i < steps * quads; i += kThreads) {
        const int t = i / quads, e = (i - t * quads) * 4;
        const int cl = e / N, n = e - cl * N;
        const size_t src = ((row0 + t) * p.C + c0) * N + e;
        const int dst = (t * CB + cl) * NP + n;
        cp_async16(rda + dst, p.da + src);
        cp_async16(rbx + dst, p.bx + src);
      }
    } else {
      for (int i = threadIdx.x; i < steps * row; i += kThreads) {
        const int t = i / row, e = i - t * row;
        const int cl = e / N, n = e - cl * N;
        const size_t src = ((row0 + t) * p.C + c0) * N + e;
        const int dst = (t * CB + cl) * NP + n;
        cp_async4(rda + dst, p.da + src);
        cp_async4(rbx + dst, p.bx + src);
      }
    }
    rest = stage + 2 * p.chunk * CB * NP;  // [chunk][NP]: c row
    for (int i = threadIdx.x; i < steps * N; i += kThreads) {
      const int t = i / N, n = i - t * N;
      cp_async4(rest + t * NP + n, p.cc + row0 * N + i);
    }
  }
  cp_async_arrive(full + k % p.stages);
}

// y's sum over n for U steps, left to right: lane g adds its states
// n = g*NPL .. to the partial sum of lanes 0 .. g-1, passed along by
// shuffles; the whole sum ends in lane L-1.  The U steps' chains are
// independent and interleaved, so their latencies overlap.
template <int L, int NPL, int U>
__device__ __forceinline__ void sum_left_to_right(
    const float (&term)[U][NPL], int g, int nvalid, float (&acc)[U]) {
#pragma unroll
  for (int u = 0; u < U; ++u) acc[u] = 0.f;
#pragma unroll
  for (int r = 0; r < L; ++r) {
    float s[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      s[u] = r == 0 ? term[u][0]
                    : __shfl_up_sync(0xffffffffu, acc[u], 1, L);
#pragma unroll
    for (int j = r == 0 ? 1 : 0; j < NPL; ++j)
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (j < nvalid) s[u] = __fadd_rn(s[u], term[u][j]);
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (g == r) acc[u] = s[u];
  }
}

// Steps t .. t+U-1 of the chunk staged at `st`: each lane's states
// updated step after step, then the U outputs summed and stored.
template <bool FUSED, int L, int NPL, int U>
__device__ __forceinline__ void run_steps(const Args& p, const float* st,
                                          int t, int cl, int g, int nvalid,
                                          bool store, float (&h)[NPL],
                                          const float (&a_r)[NPL],
                                          float* y_t) {
  constexpr int CB = kThreads / L;
  constexpr int NP = L * NPL;
  const int n0 = g * NPL;
  float term[U][NPL];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (FUSED) {
      const float2 dx = reinterpret_cast<const float2*>(st)[(t + u) * CB + cl];
      const float dtx = __fmul_rn(dx.x, dx.y);
      const float* bt = st + 2 * p.chunk * CB + (t + u) * 2 * NP + n0;
#pragma unroll
      for (int j = 0; j < NPL; j += 4) {
        const float4 bv = *reinterpret_cast<const float4*>(bt + j);
        const float4 cv = *reinterpret_cast<const float4*>(bt + NP + j);
        const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
        const float ccv[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float dav = expf(__fmul_rn(dx.x, a_r[j + q]));
          const float bxv = __fmul_rn(dtx, bb[q]);
          h[j + q] = __fadd_rn(__fmul_rn(dav, h[j + q]), bxv);
          term[u][j + q] = __fmul_rn(h[j + q], ccv[q]);
        }
      }
    } else {
      const float* dat = st + ((t + u) * CB + cl) * NP + n0;
      const float* bxt = dat + p.chunk * CB * NP;
      const float* ct = st + 2 * p.chunk * CB * NP + (t + u) * NP + n0;
#pragma unroll
      for (int j = 0; j < NPL; j += 4) {
        const float4 av = *reinterpret_cast<const float4*>(dat + j);
        const float4 bv = *reinterpret_cast<const float4*>(bxt + j);
        const float4 cv = *reinterpret_cast<const float4*>(ct + j);
        const float aa[4] = {av.x, av.y, av.z, av.w};
        const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
        const float ccv[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          h[j + q] = __fadd_rn(__fmul_rn(aa[q], h[j + q]), bb[q]);
          term[u][j + q] = __fmul_rn(h[j + q], ccv[q]);
        }
      }
    }
  }
  float acc[U];
  sum_left_to_right<L, NPL, U>(term, g, nvalid, acc);
  if (store) {
#pragma unroll
    for (int u = 0; u < U; ++u) y_t[(size_t)(t + u) * p.C] = acc[u];
  }
}

// ONE_STEP (S == 1, a decode step) drops the interleaved steps, so the
// registers allow 8 blocks an SM: 1056 on the card, one wave for the
// 1024 blocks of the decode shape.
template <bool FUSED, int L, int NPL, bool ONE_STEP>
__global__ void __launch_bounds__(kThreads, ONE_STEP ? 8 : 1)
    scan_kernel(const Args p) {
  constexpr int CB = kThreads / L;
  constexpr int NP = L * NPL;
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kStages;
  float* ring = reinterpret_cast<float*>(smem + kBarrierBytes);
  const int stage_floats =
      p.chunk * (FUSED ? 2 * CB + 2 * NP : 2 * CB * NP + NP);

  const int b = blockIdx.y;
  const int c0 = blockIdx.x * CB;
  const int cl = threadIdx.x / L, g = threadIdx.x % L;
  const int c = c0 + cl;
  const bool live = c < p.C;  // lanes past C only help stage and shuffle
  const int N = p.N;
  const int n0 = g * NPL;
  const int nvalid = max(0, min(NPL, N - n0));

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full + s, kThreads);
      mbar_init(empty + s, kThreads);
    }
  }
  __syncthreads();
  for (int k = 0; k < p.stages; ++k)
    issue_chunk<FUSED, L, NPL>(p, ring + k * stage_floats, full, b, c0, k);

  // the state (and a) into registers while the first stages land
  float h[NPL], a_r[NPL];
#pragma unroll
  for (int j = 0; j < NPL; ++j) h[j] = a_r[j] = 0.f;
  const size_t srow = ((size_t)b * p.C + c) * N + n0;
  if (live) {
#pragma unroll
    for (int j = 0; j < NPL; j += 4) {
      if (p.vec_state) {
        if (j < nvalid) {
          const float4 v = *reinterpret_cast<const float4*>(p.h0 + srow + j);
          h[j] = v.x; h[j + 1] = v.y; h[j + 2] = v.z; h[j + 3] = v.w;
          if (FUSED) {
            const float4 w = *reinterpret_cast<const float4*>(
                p.a + (size_t)c * N + n0 + j);
            a_r[j] = w.x; a_r[j + 1] = w.y; a_r[j + 2] = w.z;
            a_r[j + 3] = w.w;
          }
        }
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (j + q < nvalid) {
            h[j + q] = p.h0[srow + j + q];
            if (FUSED) a_r[j + q] = p.a[(size_t)c * N + n0 + j + q];
          }
        }
      }
    }
  }

  for (int k = 0; k < p.nchunks; ++k) {
    const int slot = k % p.stages;
    mbar_wait(full + slot, (k / p.stages) & 1);
    const float* st = ring + slot * stage_floats;
    const int t0 = k * p.chunk;
    const int steps = min(p.chunk, p.S - t0);
    float* y_t = p.y + ((size_t)b * p.S + t0) * p.C + c;
    const bool store = live && g == L - 1;
    constexpr int U = FUSED ? 8 : 2;  // steps whose sums interleave
    int t = 0;
    if constexpr (!ONE_STEP) {
      for (; t + U <= steps; t += U)
        run_steps<FUSED, L, NPL, U>(p, st, t, cl, g, nvalid, store, h, a_r,
                                    y_t);
    }
    for (; t < steps; ++t)
      run_steps<FUSED, L, NPL, 1>(p, st, t, cl, g, nvalid, store, h, a_r,
                                  y_t);
    mbar_arrive(empty + slot);
    // refill the slot chunk k-1 used, once every thread is done with it
    const int next = k - 1 + p.stages;
    if (k >= 1 && next < p.nchunks) {
      const int prev = (k - 1) % p.stages;
      mbar_wait(empty + prev, ((k - 1) / p.stages) & 1);
      issue_chunk<FUSED, L, NPL>(p, ring + prev * stage_floats, full, b, c0,
                                 next);
    }
  }

  if (live) {
#pragma unroll
    for (int j = 0; j < NPL; j += 4) {
      if (p.vec_state) {
        if (j < nvalid)
          *reinterpret_cast<float4*>(p.h_out + srow + j) =
              make_float4(h[j], h[j + 1], h[j + 2], h[j + 3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (j + q < nvalid) p.h_out[srow + j + q] = h[j + q];
      }
    }
  }
}

template <bool FUSED, int L, int NPL, bool ONE_STEP>
cudaError_t launch_kernel(const Args& args, const Plan& plan, int B,
                          cudaStream_t stream) {
  static int smem_set = 48 * 1024;  // the default limit
  if (plan.smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        scan_kernel<FUSED, L, NPL, ONE_STEP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, plan.smem);
    if (e != cudaSuccess) return e;
    smem_set = plan.smem;
  }
  const dim3 grid((args.C + plan.cb - 1) / plan.cb, B);
  scan_kernel<FUSED, L, NPL, ONE_STEP>
      <<<grid, kThreads, plan.smem, stream>>>(args);
  return cudaGetLastError();
}

template <bool FUSED, int L, int NPL>
cudaError_t launch(const Args& args, const Plan& plan, int B,
                   cudaStream_t stream) {
  return args.S == 1
             ? launch_kernel<FUSED, L, NPL, true>(args, plan, B, stream)
             : launch_kernel<FUSED, L, NPL, false>(args, plan, B, stream);
}

template <bool FUSED>
int run(Args args, int B, cudaStream_t stream) {
  const Plan plan = make_plan(FUSED, args.S, args.N);
  args.chunk = plan.chunk;
  args.stages = plan.stages;
  args.nchunks = plan.nchunks;
  switch (plan.lanes * 10 + plan.npl) {
    case 14: return (int)launch<FUSED, 1, 4>(args, plan, B, stream);
    case 24: return (int)launch<FUSED, 2, 4>(args, plan, B, stream);
    case 44: return (int)launch<FUSED, 4, 4>(args, plan, B, stream);
    case 84: return (int)launch<FUSED, 8, 4>(args, plan, B, stream);
    default: return (int)launch<FUSED, 8, 8>(args, plan, B, stream);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

bool bad_sizes(int B, int S, int C, int N) {
  return B <= 0 || S <= 0 || C <= 0 || N <= 0 || N > 64 || B > 65535;
}

}  // namespace

// da, bx: (B, S, C, N); cc: (B, S, N); h0, h_out: (B, C, N); y: (B, S, C);
// all float32 and contiguous, h_out distinct from h0.  1 <= N <= 64,
// B <= 65535.  Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int mamba_scan(const float* da, const float* bx, const float* cc,
                          const float* h0, float* y, float* h_out, int B,
                          int S, int C, int N, void* stream_ptr) {
  if (bad_sizes(B, S, C, N)) return (int)cudaErrorInvalidValue;
  Args a = {};
  a.da = da; a.bx = bx; a.cc = cc; a.h0 = h0; a.y = y; a.h_out = h_out;
  a.S = S; a.C = C; a.N = N;
  a.vec_rows = N % 4 == 0 && aligned16(da) && aligned16(bx);
  a.vec_state = N % 4 == 0 && aligned16(h0) && aligned16(h_out);
  return run<false>(a, B, static_cast<cudaStream_t>(stream_ptr));
}

// dt, x: (B, S, C) (dt after softplus); a: (C, N); bm, cc: (B, S, N);
// h0, h_out: (B, C, N); y: (B, S, C); all float32 and contiguous, h_out
// distinct from h0.  1 <= N <= 64, B <= 65535.  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int mamba_scan_fused(const float* dt, const float* x,
                                const float* a, const float* bm,
                                const float* cc, const float* h0, float* y,
                                float* h_out, int B, int S, int C, int N,
                                void* stream_ptr) {
  if (bad_sizes(B, S, C, N)) return (int)cudaErrorInvalidValue;
  Args p = {};
  p.dt = dt; p.x = x; p.a = a; p.bm = bm; p.cc = cc; p.h0 = h0; p.y = y;
  p.h_out = h_out;
  p.S = S; p.C = C; p.N = N;
  p.vec_state = N % 4 == 0 && aligned16(h0) && aligned16(h_out) &&
                aligned16(a);
  return run<true>(p, B, static_cast<cudaStream_t>(stream_ptr));
}
