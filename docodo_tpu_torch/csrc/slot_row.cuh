// The row-per-block pieces shared by the slot kernels of locate_full.cu and
// variants.cu (sm_90a): a query row held in shared memory, the AND's
// segmentation over it, and the locate tail that writes the row's
// full-result outputs.

#pragma once

#include "common.cuh"

namespace docodo {

template <int N>
struct RowSmem {
  int val[N];
  int page[N];
  int tmp[N];
  int run_bonus[N];
  int run_count[N];
  int run_page[N];
  int warp[32];
};

// The AND's segmentation over a merged row held in s.val: seg holds each
// lane's gap cut (a gap wider than |R|, and lane 0); with `ordered` (both
// windows negative; uniform over the block) each gap segment's first
// word-A mark also opens a segment unless it starts one already. A
// segment keeps its eligible lanes (eff) only if it holds a word-A mark
// (isa) and a word-B mark (isb). s.tmp is scratch. Called by every thread.
template <int T, int L, int N>
__device__ void segment_keep(RowSmem<N>& s, const bool (&isa)[L],
                             const bool (&isb)[L], const bool (&eff)[L],
                             bool (&seg)[L], bool ordered, int n, int ipt,
                             bool (&keep)[L]) {
  const int base = threadIdx.x * ipt;
  if (ordered) {
    int before[L], start[L];
#pragma unroll
    for (int k = 0; k < L; ++k) {
      const int l = base + k;
      before[k] = isa[k] ? 1 : 0;
      start[k] = (k < ipt && l < n && seg[k]) ? l : -1;
    }
    scan_lanes<T>(before, ipt, 0, Sum(), false, s.warp);
    scan_lanes<T>(start, ipt, -1, Max(), true, s.warp);
#pragma unroll
    for (int k = 0; k < L; ++k) {
      const int l = base + k;
      if (k < ipt && l < n) s.tmp[l] = before[k];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < L; ++k) {
      const int l = base + k;
      if (k < ipt && l < n && isa[k] && l != start[k] &&
          before[k] == s.tmp[start[k]])
        seg[k] = true;
    }
    __syncthreads();
  }
  int sid[L];
#pragma unroll
  for (int k = 0; k < L; ++k) sid[k] = seg[k] ? 1 : 0;
  scan_lanes<T>(sid, ipt, 0, Sum(), true, s.warp);
  for (int l = threadIdx.x; l < n; l += T) s.tmp[l] = 0;
  __syncthreads();
#pragma unroll
  for (int k = 0; k < L; ++k)
    if (isa[k] || isb[k])
      atomicOr(&s.tmp[sid[k] - 1], (isa[k] ? 1 : 0) | (isb[k] ? 2 : 0));
  __syncthreads();
#pragma unroll
  for (int k = 0; k < L; ++k) keep[k] = eff[k] && s.tmp[sid[k] - 1] == 3;
}

// Locate, rank and both compactions over the row held in s.val / s.page,
// given the keep mask of this thread's lanes. Called by every thread.
template <int T, int L, int N>
__device__ void locate_tail(RowSmem<N>& s, const bool (&keep)[L], int n,
                            int ipt, int kpad, int hpad, const Outputs& out) {
  const int tid = threadIdx.x;
  const int base = tid * ipt;
  const size_t row = blockIdx.x;
  for (int r = tid; r < kpad; r += T) {
    s.run_bonus[r] = 0;
    s.run_count[r] = 0;
  }
  // the previous kept lane of every lane: an exclusive max-scan
  int prev[L];
#pragma unroll
  for (int k = 0; k < L; ++k) {
    const int l = base + k;
    prev[k] = (k < ipt && l < n && keep[k]) ? l : -1;
  }
  scan_lanes<T>(prev, ipt, -1, Max(), false, s.warp);

  int rid[L], slot[L], bonus[L];
  bool first[L];
#pragma unroll
  for (int k = 0; k < L; ++k) {
    const int l = base + k;
    first[k] = false;
    bonus[k] = 0;
    const bool kept = k < ipt && l < n && keep[k];
    if (kept) {
      const int p = prev[k];
      const int prev_page = p >= 0 ? s.page[p] : -1;
      first[k] = s.page[l] != prev_page;
      if (!first[k]) {
        const int gap = s.val[l] - s.val[p];
        bonus[k] = 30 / (gap > 5 ? gap : 5);
      }
    }
    rid[k] = first[k] ? 1 : 0;
    slot[k] = kept ? 1 : 0;
  }
  // run ordinal + 1 of every kept lane, and each kept lane's hit slot
  const int total_pages = scan_lanes<T>(rid, ipt, 0, Sum(), true, s.warp);
  const int total_hits = scan_lanes<T>(slot, ipt, 0, Sum(), false, s.warp);

  int* hits = out.hits + row * hpad;
#pragma unroll
  for (int k = 0; k < L; ++k) {
    const int l = base + k;
    if (k < ipt && l < n && keep[k]) {
      const int r = rid[k] - 1;
      if (r < kpad) {
        atomicAdd(&s.run_count[r], 1);
        if (bonus[k]) atomicAdd(&s.run_bonus[r], bonus[k]);
        if (first[k]) s.run_page[r] = s.page[l];
      }
      if (slot[k] < hpad) hits[slot[k]] = s.val[l];
    }
  }
  __syncthreads();
  for (int r = tid; r < kpad; r += T) {
    const size_t o = row * kpad + r;
    if (r < total_pages) {
      const int c = s.run_count[r];
      out.pg_c[o] = s.run_page[r];
      out.rk_c[o] = run_rank(s.run_bonus[r], c);
      out.ct_c[o] = (float)c;
    } else {
      out.pg_c[o] = -1;
      out.rk_c[o] = 0.0f;
      out.ct_c[o] = 0.0f;
    }
  }
  for (int r = total_hits + tid; r < hpad; r += T) hits[r] = kInf;
  if (tid == 0) {
    out.n_pages[row] = total_pages;
    out.n_hits[row] = total_hits;
  }
}

}  // namespace docodo
