// Shared device helpers of docodo_tpu_torch's kernels (sm_90a): scans
// over lanes owned by the threads of a row, binary searches, and the
// six-field full-result output of a query row.
//
// Lane layout: a row group of T threads (a whole block, BlockRow, or a
// warp-aligned group of a block that holds several rows, GroupRow) holds
// a row (or a chunk of one) of at most T * L lanes; its thread t owns the
// ipt <= L consecutive lanes t * ipt .. t * ipt + ipt - 1, kept in
// register arrays of L.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace docodo {

constexpr int kInf = 0x7fffffff;

struct Sum {
  __device__ int operator()(int a, int b) const { return a + b; }
};
struct Max {
  __device__ int operator()(int a, int b) const { return a > b ? a : b; }
};

// The threads that hold one row: rank() of kThreads, the row's index,
// and a barrier over exactly those threads.
template <int T>
struct BlockRow {  // the whole block, one row a block
  static constexpr int kThreads = T;
  __device__ int rank() const { return threadIdx.x; }
  __device__ size_t row() const { return blockIdx.x; }
  __device__ void sync() const { __syncthreads(); }
};

// G threads (whole warps), blockDim.x / G rows a block; groups of more
// than one warp use named barriers 1 .. 15, so at most 15 such a block.
template <int G>
struct GroupRow {
  static_assert(G % 32 == 0, "whole warps");
  static constexpr int kThreads = G;
  __device__ int group() const { return threadIdx.x / G; }
  __device__ int rank() const { return threadIdx.x % G; }
  __device__ size_t row() const {
    return (size_t)blockIdx.x * (blockDim.x / G) + group();
  }
  // a warp's own barrier, or named barrier 1 + group over the group's
  // warps (barrier 0 is __syncthreads')
  __device__ void sync() const {
    if (G == 32)
      __syncwarp();
    else
      asm volatile("bar.sync %0, %1;" ::"r"(group() + 1), "r"(G)
                   : "memory");
  }
};

// Exclusive scan of one value per thread of the row group g; *total
// receives the reduction over the group. Every thread of the group must
// call it; s_warp holds at least kThreads / 32 ints. A one-warp group
// scans in registers; every form ends with a barrier of the group.
template <class Grp, class Op>
__device__ int group_exclusive(const Grp& g, int v, int identity, Op op,
                               int* s_warp, int* total) {
  constexpr int kWarps = Grp::kThreads / 32;
  static_assert(kWarps >= 1 && kWarps <= 32, "1..1024 threads");
  const int lane = g.rank() & 31;
  const int warp = g.rank() >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x = op(x, y);
  }
  int in_warp = __shfl_up_sync(0xffffffffu, x, 1);
  if (lane == 0) in_warp = identity;
  if (kWarps == 1) {
    *total = __shfl_sync(0xffffffffu, x, 31);
    g.sync();
    return in_warp;
  }
  if (lane == 31) s_warp[warp] = x;
  g.sync();
  if (warp == 0) {
    int t = lane < kWarps ? s_warp[lane] : identity;
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, t, d);
      if (lane >= d) t = op(t, y);
    }
    if (lane < kWarps) s_warp[lane] = t;
  }
  g.sync();
  const int before_warp = warp > 0 ? s_warp[warp - 1] : identity;
  *total = s_warp[kWarps - 1];
  g.sync();
  return op(before_warp, in_warp);
}

// Scan over the lanes this thread owns (x[k] belongs to lane
// g.rank() * ipt + k), in place: the exclusive prefix, or the inclusive
// one. Lanes past the row must hold the identity. Returns the group total.
template <class Grp, int L, class Op>
__device__ int scan_lanes(const Grp& g, int (&x)[L], int ipt, int identity,
                          Op op, bool inclusive, int* s_warp) {
  int agg = identity;
#pragma unroll
  for (int k = 0; k < L; ++k)
    if (k < ipt) agg = op(agg, x[k]);
  int total;
  int run = group_exclusive(g, agg, identity, op, s_warp, &total);
#pragma unroll
  for (int k = 0; k < L; ++k) {
    if (k < ipt) {
      const int v = x[k];
      if (inclusive) {
        run = op(run, v);
        x[k] = run;
      } else {
        x[k] = run;
        run = op(run, v);
      }
    }
  }
  return total;
}

// A null pointer, or one a 16-byte load or store may use.
__host__ __device__ inline bool aligned16(const void* p) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__device__ inline int clamp_len(int v, int cap) {
  return v < 0 ? 0 : (v > cap ? cap : v);
}

// #{j < m: s[j] < v}
__device__ inline int lower_bound(const int* s, int m, int v) {
  int lo = 0, hi = m;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// #{j < m: s[j] <= v}
__device__ inline int upper_bound(const int* s, int m, int v) {
  int lo = 0, hi = m;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s[mid] <= v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Page run rank: (1 + bonus) + ln(max(count, 1)) in f32, bonus and count
// exact integer sums.
__device__ inline float run_rank(int bonus, int count) {
  return (1.0f + (float)bonus) + logf(fmaxf((float)count, 1.0f));
}

struct Outputs {
  int* pg_c;     // [rows, kpad] run pages, -1 past n_pages
  float* rk_c;   // [rows, kpad] run ranks, 0 past n_pages
  float* ct_c;   // [rows, kpad] run counts, 0 past n_pages
  int* n_pages;  // [rows]
  int* n_hits;   // [rows]
  int* hits;     // [rows, hpad] kept values, INF32 past n_hits
};

inline Outputs outputs(int* pg_c, float* rk_c, float* ct_c, int* n_pages,
                       int* n_hits, int* hits) {
  Outputs o;
  o.pg_c = pg_c;
  o.rk_c = rk_c;
  o.ct_c = ct_c;
  o.n_pages = n_pages;
  o.n_hits = n_hits;
  o.hits = hits;
  return o;
}

}  // namespace docodo
