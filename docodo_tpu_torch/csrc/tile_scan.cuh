// Scans for kernels that give one row many blocks (sm_90a): a block-wide
// exclusive scan of one summary per thread, and the carry between the
// tiles of a row by single-pass decoupled look-back (Merrill & Garland,
// "Single-pass Parallel Prefix Scan with Decoupled Look-back", NVIDIA
// 2016).
//
// A summary S is a struct of ints with an associative, not necessarily
// commutative, combine, in which l summarises the lanes before r's:
//
//   __device__ static S identity();
//   __device__ static S combine(const S& l, const S& r);
//
// Each tile of a row publishes its aggregate and then its inclusive
// prefix in a scratch array, behind a status word per tile: 0 nothing
// yet, 1 the aggregate, 2 the inclusive prefix. The status words must be
// zero before the launch. A tile takes its index from an atomic ticket
// per row (row_ticket), so it only waits on tiles that have started
// before it and the look-back cannot deadlock. Status and summaries are
// read through L2 (volatile and ld.global.cg), never a stale L1 line.

#pragma once

#include "common.cuh"

namespace docodo {

constexpr unsigned kFullMask = 0xffffffffu;

template <class S>
__host__ __device__ constexpr int words() {
  static_assert(sizeof(S) % sizeof(int) == 0, "a summary is a struct of ints");
  return (int)(sizeof(S) / sizeof(int));
}

template <class S>
__device__ inline S shfl_up(const S& s, int d) {
  S r;
  const int* a = reinterpret_cast<const int*>(&s);
  int* b = reinterpret_cast<int*>(&r);
#pragma unroll
  for (int i = 0; i < words<S>(); ++i) b[i] = __shfl_up_sync(kFullMask, a[i], d);
  return r;
}

template <class S>
__device__ inline S shfl_down(const S& s, int d) {
  S r;
  const int* a = reinterpret_cast<const int*>(&s);
  int* b = reinterpret_cast<int*>(&r);
#pragma unroll
  for (int i = 0; i < words<S>(); ++i)
    b[i] = __shfl_down_sync(kFullMask, a[i], d);
  return r;
}

template <class S>
__device__ inline S shfl_idx(const S& s, int src) {
  S r;
  const int* a = reinterpret_cast<const int*>(&s);
  int* b = reinterpret_cast<int*>(&r);
#pragma unroll
  for (int i = 0; i < words<S>(); ++i) b[i] = __shfl_sync(kFullMask, a[i], src);
  return r;
}

template <class S>
__device__ inline void store_l2(S* p, const S& s) {
  const int* a = reinterpret_cast<const int*>(&s);
  int* b = reinterpret_cast<int*>(p);
#pragma unroll
  for (int i = 0; i < words<S>(); ++i) __stcg(b + i, a[i]);
}

template <class S>
__device__ inline S load_l2(const S* p) {
  S r;
  const int* a = reinterpret_cast<const int*>(p);
  int* b = reinterpret_cast<int*>(&r);
#pragma unroll
  for (int i = 0; i < words<S>(); ++i) b[i] = __ldcg(a + i);
  return r;
}

// Exclusive scan of one summary per thread over a block of T threads;
// *total receives the combine of all T. s_warp holds T / 32 summaries.
// Every thread of the block must call it.
template <int T, class S>
__device__ S block_scan(const S& x, S* s_warp, S* total) {
  constexpr int kWarps = T / 32;
  static_assert(kWarps >= 1 && kWarps <= 32, "1..1024 threads");
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  S inc = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const S y = shfl_up(inc, d);
    if (lane >= d) inc = S::combine(y, inc);
  }
  S excl = shfl_up(inc, 1);
  if (lane == 0) excl = S::identity();
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  S before = S::identity();
  S all = S::identity();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w == warp) before = all;
    all = S::combine(all, s_warp[w]);
  }
  __syncthreads();  // s_warp is free again when this returns
  *total = all;
  return S::combine(before, excl);
}

// This block's tile index in its row: the row's next ticket, or 0 for a
// row of one tile. Every thread of the block must call it.
__device__ inline int row_ticket(int* ticket, int tiles, int* s_tile) {
  if (tiles == 1) return 0;
  if (threadIdx.x == 0) *s_tile = atomicAdd(ticket, 1);
  __syncthreads();
  return *s_tile;
}

// The exclusive prefix of tile `tile` of a row, from its aggregate `agg`:
// called by the 32 lanes of one warp, returns the prefix in every lane.
// Publishes the aggregate first, then walks back over windows of 32
// predecessors, adding aggregates until the nearest inclusive prefix,
// and publishes this tile's inclusive prefix.
template <class S>
__device__ S tile_exclusive(const S& agg, int tile, int* flag, S* aggs,
                            S* incls) {
  const int lane = threadIdx.x & 31;
  volatile int* vflag = flag;
  if (lane == 0) {
    store_l2(tile == 0 ? &incls[0] : &aggs[tile], agg);
    __threadfence();
    vflag[tile] = tile == 0 ? 2 : 1;
  }
  if (tile == 0) return S::identity();
  S excl = S::identity();
  for (int top = tile - 1;; top -= 32) {
    const int p = top - lane;  // lane i reads the (i + 1)-th predecessor
    int f;
    do {
      f = p >= 0 ? vflag[p] : 2;
    } while (__any_sync(kFullMask, f == 0));
    __threadfence();
    S x = S::identity();
    if (p >= 0) x = f == 2 ? load_l2(&incls[p]) : load_l2(&aggs[p]);
    const unsigned inc = __ballot_sync(kFullMask, f == 2);
    const int stop = inc ? __ffs(inc) - 1 : 31;
    if (lane > stop) x = S::identity();
    // lane 0 <- x[stop] + ... + x[0], the farthest predecessor first
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const S y = shfl_down(x, d);
      if (lane + d < 32) x = S::combine(y, x);
    }
    excl = S::combine(x, excl);  // right in lane 0
    if (inc) break;
  }
  excl = shfl_idx(excl, 0);
  if (lane == 0) {
    store_l2(&incls[tile], S::combine(excl, agg));
    __threadfence();
    vflag[tile] = 2;
  }
  return excl;
}

}  // namespace docodo
