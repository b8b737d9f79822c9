// The row pieces shared by the slot kernels of locate_full.cu,
// variants.cu, w1_kernel.cuh and probes.cu (sm_90a), each run by the row
// group that holds the row (a block, or a few warps of one; common.cuh): a
// query row held in shared memory, the W = 2 merge and the AND's
// segmentation over it (tagged_keep, also over a row merged already), the
// locate tail that writes the row's full-result outputs (its first
// kpad runs), the page-level tail that ranks every run and writes the
// row's top k, and the full-result tail that ends a row with that top k
// inside the kernel; the three ways a row ends (SlotsTail, TopkTail,
// PageTopkTail), each also for a row whose kept lanes are a prefix of it
// (kPrefix: no scans to find them); the launch shape of a slot kernel
// chosen by its rows (launch_by_rows); and the one-time raise of a
// kernel's dynamic shared memory limit (size_smem).

#pragma once

#include <atomic>

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
// windows negative; uniform over the row) each gap segment's first
// word-A mark also opens a segment unless it starts one already. A
// segment keeps its eligible lanes (eff) only if it holds a word-A mark
// (isa) and a word-B mark (isb). s.tmp is scratch. Called by every thread
// of the row group g.
template <class Grp, int L, int N>
__device__ void segment_keep(const Grp& g, RowSmem<N>& s,
                             const bool (&isa)[L], const bool (&isb)[L],
                             const bool (&eff)[L], bool (&seg)[L],
                             bool ordered, int n, int ipt, bool (&keep)[L]) {
  const int base = g.rank() * ipt;
  if (ordered) {
    int before[L], start[L];
#pragma unroll
    for (int k = 0; k < L; ++k) {
      const int l = base + k;
      before[k] = isa[k] ? 1 : 0;
      start[k] = (k < ipt && l < n && seg[k]) ? l : -1;
    }
    scan_lanes(g, before, ipt, 0, Sum(), false, s.warp);
    scan_lanes(g, start, ipt, -1, Max(), true, s.warp);
#pragma unroll
    for (int k = 0; k < L; ++k) {
      const int l = base + k;
      if (k < ipt && l < n) s.tmp[l] = before[k];
    }
    g.sync();
#pragma unroll
    for (int k = 0; k < L; ++k) {
      const int l = base + k;
      if (k < ipt && l < n && isa[k] && l != start[k] &&
          before[k] == s.tmp[start[k]])
        seg[k] = true;
    }
    g.sync();
  }
  int sid[L];
#pragma unroll
  for (int k = 0; k < L; ++k) sid[k] = seg[k] ? 1 : 0;
  scan_lanes(g, sid, ipt, 0, Sum(), true, s.warp);
  for (int l = g.rank(); l < n; l += Grp::kThreads) s.tmp[l] = 0;
  g.sync();
#pragma unroll
  for (int k = 0; k < L; ++k)
    if (isa[k] || isb[k])
      atomicOr(&s.tmp[sid[k] - 1], (isa[k] ? 1 : 0) | (isb[k] ? 2 : 0));
  g.sync();
#pragma unroll
  for (int k = 0; k < L; ++k) keep[k] = eff[k] && s.tmp[sid[k] - 1] == 3;
}

// Page of a coordinate: #bounds <= v, clamped to the last page.
__device__ inline int page_of_coord(const int* __restrict__ bounds, int p,
                                    int v) {
  const int pg = upper_bound(bounds, p, v);
  return pg < p - 1 ? pg : p - 1;
}

// Shared memory of the W = 2 kernels: the row and the tags. The two
// operands are staged in the row's run arrays (run_bonus, run_count),
// which the tail needs only after the merge.
template <int N>
struct AndSmem {
  RowSmem<N> row;
  unsigned char tag[N];
};

// Threads of a block of the slot kernels that pack several rows a block,
// and the widest row they take (MAX_STREAM_WIDTH, pallas_query.py:780).
constexpr int kSlotThreads = 256;
constexpr int kSlotLanes = 1024;

// The launch shape of a slot kernel at stream width N (a row of at most N
// lanes) whose row keeps its state in Smem: a row group of G threads (N /
// 4 unless given: 4 lanes a thread), kSlotThreads / G rows a block (8, 4,
// 2 and 1 at N = 128, 256, 512, 1024 with 4 lanes a thread), or one row
// a block of G threads past kSlotThreads; each row in its own Smem of the
// block's dynamic shared memory.
template <int N, class Smem, int G = N / 4>
struct SlotShape {
  static_assert(G % 32 == 0 && N % G == 0, "whole warps, whole lanes");
  static constexpr int kGroup = G;
  static constexpr int kRows = G >= kSlotThreads ? 1 : kSlotThreads / G;
  static constexpr int kThreads = kRows * G;
  static constexpr int kIpt = N / G;
  static constexpr size_t kSmem = kRows * sizeof(Smem);
  static_assert(kSmem <= 48 * 1024, "needs no shared memory attribute");
  static unsigned blocks(int rows) { return (rows + kRows - 1) / kRows; }
};

template <int N>
struct Width {
  static constexpr int value = N;
};

// launch(Width<N>{}) at the narrowest stream width N of 128, 256, 512 and
// 1024 that holds n lanes (n <= kSlotLanes).
template <class Launch>
int with_width(int n, const Launch& launch) {
  if (n <= 128) return launch(Width<128>{});
  if (n <= 256) return launch(Width<256>{});
  if (n <= 512) return launch(Width<512>{});
  return launch(Width<1024>{});
}

// Rows that one wave of `kernel` holds on the current device (its SMs x
// the blocks of shape S resident on one SM x S's rows a block), asked once
// per device: `cache` holds it for devices 0-31. 0 if it cannot be asked.
// Threads that launch at once may each ask and store the same number.
template <class S, class K>
int wave_rows(K kernel, std::atomic<int> (&cache)[32]) {
  int dev = 0, sms = 0, blocks = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < 32) {
    const int known = cache[dev].load(std::memory_order_relaxed);
    if (known > 0) return known;
  }
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, kernel, S::kThreads, S::kSmem) != cudaSuccess)
    return 0;
  const int rows = sms * blocks * S::kRows;
  if (dev < 32) cache[dev].store(rows, std::memory_order_relaxed);
  return rows;
}

// Raises a kernel's dynamic shared memory limit, once per kernel and
// device: the limit is the current device's, and another card starts
// from the 48 KB default. `sized` holds a bit per device (devices past
// 31 set it at every launch), set after the attribute is; threads that
// launch at once may each set the attribute, which is idempotent.
template <class K>
cudaError_t size_smem(K kernel, size_t bytes, std::atomic<unsigned>* sized) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (sized->load(std::memory_order_acquire) & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
  if (e == cudaSuccess) sized->fetch_or(bit, std::memory_order_release);
  return e;
}

// The launch shape of a slot kernel by its rows, at the narrowest stream
// width N that holds n lanes. A launch of at most one wave takes one row's
// latency, so it gives each lane of a row a thread (G = N) when all its
// rows fit in one wave of that shape; a larger one packs 4 lanes a thread
// (G = N / 4: 8 / 4 / 2 / 1 rows a block of 256 threads, 4x the rows an SM
// holds). On an H100 one lane a thread cut a 128-row launch at N = 1024 by
// a quarter and took 40% longer at 512 rows (4 waves) (PERF.md).
// Launch<Tail, N, G> has its Shape (a SlotShape), kernel() and
// run(rows, args...), which launches it.
template <template <class, int, int> class Launch, class Tail,
          class... Args>
int launch_by_rows(int n, int rows, Args... args) {
  return with_width(n, [&](auto w) {
    constexpr int N = decltype(w)::value;
    using One = Launch<Tail, N, N>;
    static std::atomic<int> wave[32];  // zero: static storage
    if (rows <= wave_rows<typename One::Shape>(One::kernel(), wave))
      return One::run(rows, args...);
    return Launch<Tail, N, N / 4>::run(rows, args...);
  });
}

// Four consecutive ints of a row from i on, of which those at i + j < len
// are read: one 16-byte load where `vec` (the row 16-byte aligned, its
// width a multiple of 4, so the load stays inside it).
__device__ inline void load4(const int* __restrict__ src, int i, int len,
                             bool vec, int (&x)[4]) {
  if (vec) {
    const int4 q = *reinterpret_cast<const int4*>(src + i);
    x[0] = q.x;
    x[1] = q.y;
    x[2] = q.z;
    x[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) x[j] = i + j < len ? src[i + j] : kInf;
  }
}

// Four ints to a 16-byte aligned address in one store: a warp's quads at
// consecutive addresses meet no bank conflict in shared memory, where four
// scalar stores a thread would meet four-way ones.
__device__ inline void store4(int* dst, const int (&x)[4]) {
  *reinterpret_cast<int4*>(dst) = make_int4(x[0], x[1], x[2], x[3]);
}

// #{j in [lo, m): s[j] < v} + lo, or with `upper` s[j] <= v; s ascends.
__device__ inline int rank_from(const int* s, int lo, int m, int v,
                                bool upper) {
  int hi = m;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s[mid] < v || (upper && s[mid] == v)) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// The AND over a merged row of n lanes held in sm.row.val and sm.tag (tag 0
// word A, 1 word B, 2 padding; ascending values, INF32 padding last), with
// the words' windows r1 / r2 (pallas_query._sorted_and_keep): cross-operand
// duplicates fold onto their first lane, and segment_keep keeps the
// segments that hold both words. Fills this thread's keep flags; called by
// every thread of the row group g after the row is written and synced.
template <class Grp, int L, int N>
__device__ void tagged_keep(const Grp& g, AndSmem<N>& sm, int r1, int r2,
                            int n, bool (&keep)[L]) {
  RowSmem<N>& s = sm.row;
  const unsigned char* s_tag = sm.tag;
  const int ipt = (n + Grp::kThreads - 1) / Grp::kThreads;
  const int base = g.rank() * ipt;
  const int abs_r = max(abs(r1), abs(r2));
  const bool ordered = r1 < 0 && r2 < 0;
  bool isa[L], isb[L], ghost[L], valid[L], seg[L];
#pragma unroll
  for (int k = 0; k < L; ++k) {
    const int l = base + k;
    isa[k] = isb[k] = ghost[k] = valid[k] = seg[k] = false;
    if (k < ipt && l < n) {
      const int v = s.val[l];
      const bool val = v < kInf;
      const int pv = l > 0 ? s.val[l - 1] : -1;
      const int nv = l < n - 1 ? s.val[l + 1] : kInf;
      const bool dup_prev = val && v == pv;
      const bool dup_next = val && v == nv;
      const bool a_next = l < n - 1 && nv < kInf && s_tag[l + 1] == 0;
      const bool b_next = l < n - 1 && nv < kInf && s_tag[l + 1] == 1;
      isa[k] = ((val && s_tag[l] == 0) || (dup_next && a_next)) && !dup_prev;
      isb[k] = ((val && s_tag[l] == 1) || (dup_next && b_next)) && !dup_prev;
      ghost[k] = dup_prev;
      valid[k] = val;
      const int gap = v - (l == 0 ? 0 : pv);
      seg[k] = l == 0 || (abs_r != 0 && gap > abs_r && val);
    }
  }
  bool eff[L];
#pragma unroll
  for (int k = 0; k < L; ++k) eff[k] = valid[k] && !ghost[k];
  segment_keep(g, s, isa, isb, eff, seg, ordered, n, ipt, keep);
}

// W = 2 proximity/phrase AND (pallas_query._sorted_and_keep) of one row's
// two posting blocks, into sm.row.val / sm.row.page and this thread's keep
// flags: the blocks merge by rank into (coord, tag) order (word A first on
// equal coords, padding last), cross-operand duplicates fold onto their
// first slot, gaps wider than |R| cut segments, both R < 0 adds the ordered
// cut at each segment's first word-A slot, and a segment keeps its slots
// only if it holds both words. Pages come from the blocks' page streams
// a_pg / b_pg, or with a_pg null from `bounds` [p]. Each thread takes a
// quad of four consecutive elements: one 16-byte load of values and one
// of pages where the row allows it, both before the barrier, and each
// element's rank in the other operand searched from the previous one's.
// Called by every thread of the row group g (at least N / 4 threads).
template <class Grp, int L, int N>
__device__ void merge_and_keep(
    const Grp& g, AndSmem<N>& sm, const int* __restrict__ a,
    const int* __restrict__ a_pg, const int* __restrict__ na_,
    const int* __restrict__ ra_, const int* __restrict__ b,
    const int* __restrict__ b_pg, const int* __restrict__ nb_,
    const int* __restrict__ rb_, const int* __restrict__ bounds,
    int p_bounds, int cap, bool (&keep)[L]) {
  constexpr int T = Grp::kThreads;
  static_assert(4 * T >= N, "a quad of the row a thread at most");
  RowSmem<N>& s = sm.row;
  int* s_a = s.run_bonus;
  int* s_b = s.run_count;
  unsigned char* s_tag = sm.tag;
  const int tid = g.rank();
  const size_t row = g.row();
  const int n = 2 * cap;
  const int na = clamp_len(na_[row], cap);
  const int nb = clamp_len(nb_[row], cap);
  const int* arow = a + row * cap;
  const int* brow = b + row * cap;
  const int* apg = a_pg ? a_pg + row * cap : nullptr;
  const int* bpg = b_pg ? b_pg + row * cap : nullptr;
  const bool vec = cap % 4 == 0 && aligned16(arow) && aligned16(brow) &&
                   aligned16(apg) && aligned16(bpg);
  // one quad a thread (4 T >= N >= 2 cap): its values and pages are
  // loaded together and stay in registers across the barrier
  const int quads = (cap + 3) / 4;
  const bool in_a = tid < quads;
  const int i = 4 * (in_a ? tid : tid - quads);
  const int len = in_a ? na : nb;
  const bool mine = tid < 2 * quads && i < len;
  const int* pgs = in_a ? apg : bpg;
  int x[4], pq[4];
  if (mine) {
    load4(in_a ? arow : brow, i, len, vec, x);
    if (pgs) load4(pgs, i, len, vec, pq);
    int* dst = in_a ? s_a : s_b;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (i + j < len) dst[i + j] = x[j];
  }
  g.sync();
  if (mine) {
    const int* other = in_a ? s_b : s_a;
    const int m = in_a ? nb : na;
    int r = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (i + j >= len) break;
      const int v = x[j];
      // word A's lanes go before equal word-B lanes, B's after equal A's
      r = rank_from(other, r, m, v, !in_a);
      const int p = i + j + r;
      s.val[p] = v;
      s.page[p] = pgs ? pq[j] : page_of_coord(bounds, p_bounds, v);
      s_tag[p] = in_a ? 0 : 1;
    }
  }
  for (int p = na + nb + tid; p < n; p += T) {
    s.val[p] = kInf;
    s.page[p] = 0;
    s_tag[p] = 2;
  }
  g.sync();
  tagged_keep(g, sm, ra_[row], rb_[row], n, keep);
}

// The page runs of the row held in s.val / s.page, given the keep mask of
// this thread's lanes: a run starts at a kept lane whose page differs from
// the previous kept lane's, and each later lane of the run adds
// 30 / max(5, gap). For every run of ordinal < limit, s.run_page,
// s.run_count and s.run_bonus (exact integer sums) are filled, and with
// run_lane (a shared array of `limit` ints; s.tmp is free for it) the run's
// first lane. With kPrefix (the kept lanes are the row's first ones) a
// kept lane's previous kept lane is the lane before it, and a barrier
// takes the place of the scan that finds it. Returns the row's number of
// runs. Called by every thread of the row group g; ends synchronised.
template <bool kPrefix = false, class Grp, int L, int N>
__device__ int sum_runs(const Grp& g, RowSmem<N>& s, const bool (&keep)[L],
                        int n, int ipt, int limit, int* run_lane = nullptr) {
  const int tid = g.rank();
  const int base = tid * ipt;
  for (int r = tid; r < limit; r += Grp::kThreads) {
    s.run_bonus[r] = 0;
    s.run_count[r] = 0;
  }
  // the previous kept lane of every lane: an exclusive max-scan
  int prev[L];
#pragma unroll
  for (int k = 0; k < L; ++k) {
    const int l = base + k;
    prev[k] = kPrefix ? l - 1 : (k < ipt && l < n && keep[k]) ? l : -1;
  }
  if constexpr (kPrefix)
    g.sync();  // the lanes before this thread's are written
  else
    scan_lanes(g, prev, ipt, -1, Max(), false, s.warp);

  int rid[L], bonus[L];
  bool first[L];
#pragma unroll
  for (int k = 0; k < L; ++k) {
    const int l = base + k;
    first[k] = false;
    bonus[k] = 0;
    if (k < ipt && l < n && keep[k]) {
      const int p = prev[k];
      const int prev_page = p >= 0 ? s.page[p] : -1;
      first[k] = s.page[l] != prev_page;
      if (!first[k]) {
        const int gap = s.val[l] - s.val[p];
        bonus[k] = 30 / (gap > 5 ? gap : 5);
      }
    }
    rid[k] = first[k] ? 1 : 0;
  }
  // run ordinal + 1 of every kept lane
  const int runs = scan_lanes(g, rid, ipt, 0, Sum(), true, s.warp);
#pragma unroll
  for (int k = 0; k < L; ++k) {
    const int l = base + k;
    const int r = rid[k] - 1;
    if (k < ipt && l < n && keep[k] && r < limit) {
      atomicAdd(&s.run_count[r], 1);
      if (bonus[k]) atomicAdd(&s.run_bonus[r], bonus[k]);
      if (first[k]) {
        s.run_page[r] = s.page[l];
        if (run_lane) run_lane[r] = l;
      }
    }
  }
  g.sync();
  return runs;
}

// The row's first hpad (<= N) kept values, in lane order, into hits[0 ..
// hpad), and INF32 after them: gathered in s.tmp, then written with
// consecutive threads on consecutive slots. Returns the row's number of
// kept values. Called by every thread of the row group g.
template <class Grp, int L, int N>
__device__ int compact_hits(const Grp& g, RowSmem<N>& s,
                            const bool (&keep)[L], int n, int ipt, int hpad,
                            int* __restrict__ hits) {
  const int tid = g.rank();
  const int base = tid * ipt;
  int slot[L];
#pragma unroll
  for (int k = 0; k < L; ++k)
    slot[k] = (k < ipt && base + k < n && keep[k]) ? 1 : 0;
  const int total = scan_lanes(g, slot, ipt, 0, Sum(), false, s.warp);
#pragma unroll
  for (int k = 0; k < L; ++k) {
    const int l = base + k;
    if (k < ipt && l < n && keep[k] && slot[k] < hpad)
      s.tmp[slot[k]] = s.val[l];
  }
  g.sync();
  for (int r = tid; r < hpad; r += Grp::kThreads)
    hits[r] = r < total ? s.tmp[r] : kInf;
  return total;
}

// compact_hits of a row whose kept lanes are its first `kept`: s.val[0 ..
// min(kept, hpad)), INF32 after them, consecutive threads on consecutive
// slots, with no scan and no barrier. The row group must have synchronised
// since s.val was written. Returns `kept`.
template <class Grp, int N>
__device__ int prefix_hits(const Grp& g, const RowSmem<N>& s, int kept,
                           int hpad, int* __restrict__ hits) {
  for (int r = g.rank(); r < hpad; r += Grp::kThreads)
    hits[r] = r < kept ? s.val[r] : kInf;
  return kept;
}

// Locate, rank and both compactions over the row held in s.val / s.page,
// given the keep mask of this thread's lanes: the row's first kpad runs in
// slot order and its first hpad kept values; with kPrefix the kept lanes
// are the row's first `kept`. Called by every thread of the row group g.
template <bool kPrefix = false, class Grp, int L, int N>
__device__ void locate_tail(const Grp& g, RowSmem<N>& s,
                            const bool (&keep)[L], int n, int ipt, int kpad,
                            int hpad, const Outputs& out, int kept = 0) {
  const int tid = g.rank();
  const size_t row = g.row();
  const int total_pages = sum_runs<kPrefix>(g, s, keep, n, ipt, kpad);
  int* hits = out.hits + row * hpad;
  const int total_hits =
      kPrefix ? prefix_hits(g, s, kept, hpad, hits)
              : compact_hits(g, s, keep, n, ipt, hpad, hits);
  for (int r = tid; r < kpad; r += Grp::kThreads) {
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
  if (tid == 0) {
    out.n_pages[row] = total_pages;
    out.n_hits[row] = total_hits;
  }
}

struct TopkOutputs {
  int* pages;    // [rows, topk] run pages by rank, -1 past the row's runs
  float* ranks;  // [rows, topk] run ranks descending, 0 past the runs
  int* counts;   // [rows, topk] run counts, 0 past the runs
};

inline TopkOutputs topk_outputs(int* pages, float* ranks, int* counts) {
  TopkOutputs o;
  o.pages = pages;
  o.ranks = ranks;
  o.counts = counts;
  return o;
}

// The page-level tail (pallas_query._locate_rank_topk): locate and rank
// EVERY page run of the row held in s.val / s.page, given the keep mask of
// this thread's lanes, and write the row's top `topk` runs by (rank
// descending, run ordinal ascending). Runs are in lane order, so the lowest
// ordinal among equal ranks is the lowest lane. Each run's rank is computed
// once, into s.tmp, and the selection compares those stored bits (a
// positive f32 orders as its bit pattern): a run's output slot is the number
// of runs that precede it in that order, counted against every run of the
// row. Slots past the row's run count get -1 / 0 / 0. Returns the row's
// number of runs. kPrefix as sum_runs'. Called by every thread of the row
// group g; N lanes hold at most N runs.
template <bool kPrefix = false, class Grp, int L, int N>
__device__ int locate_topk_tail(const Grp& g, RowSmem<N>& s,
                                const bool (&keep)[L], int n, int ipt,
                                int topk, const TopkOutputs& out) {
  constexpr int T = Grp::kThreads;
  const int tid = g.rank();
  const size_t row = g.row();
  const int runs = sum_runs<kPrefix>(g, s, keep, n, ipt, n);
  for (int r = tid; r < runs; r += T)
    s.tmp[r] = __float_as_int(run_rank(s.run_bonus[r], s.run_count[r]));
  g.sync();
  for (int r = tid; r < runs; r += T) {
    const int mine = s.tmp[r];
    int before = 0;
    for (int j = 0; j < runs; ++j) {
      const int other = s.tmp[j];
      before += (other > mine || (other == mine && j < r)) ? 1 : 0;
    }
    if (before < topk) {
      const size_t o = row * topk + before;
      out.pages[o] = s.run_page[r];
      out.ranks[o] = __int_as_float(mine);
      out.counts[o] = s.run_count[r];
    }
  }
  for (int k = runs + tid; k < topk; k += T) {
    const size_t o = row * topk + k;
    out.pages[o] = -1;
    out.ranks[o] = 0.0f;
    out.counts[o] = 0;
  }
  return runs;
}

struct FullTopkOutputs {
  TopkOutputs top;  // the row's top k runs, each [rows, topk]
  int* n_pages;     // [rows] every run of the row
  int* n_hits;      // [rows] every kept value of the row
  int* hits;        // [rows, hpad] kept values, INF32 past n_hits
};

// The full-result tail that ends a row inside the kernel
// (pallas_query._full_stream_call with _locate_rank_topk): the row's first
// hpad kept values, the top `topk` of ALL its page runs (locate_topk_tail)
// and the exact totals; with kPrefix the kept lanes are the row's first
// `kept`, and the hits are written after the runs, from s.val (which the
// top k leaves as it is; compact_hits' scratch is the top k's). Called by
// every thread of the row group g.
template <bool kPrefix = false, class Grp, int L, int N>
__device__ void locate_full_topk_tail(const Grp& g, RowSmem<N>& s,
                                      const bool (&keep)[L], int n, int ipt,
                                      int topk, int hpad,
                                      const FullTopkOutputs& out,
                                      int kept = 0) {
  const size_t row = g.row();
  int* hits = out.hits + row * hpad;
  int total_hits = 0;
  if constexpr (!kPrefix)
    total_hits = compact_hits(g, s, keep, n, ipt, hpad, hits);
  const int runs =
      locate_topk_tail<kPrefix>(g, s, keep, n, ipt, topk, out.top);
  if constexpr (kPrefix) total_hits = prefix_hits(g, s, kept, hpad, hits);
  if (g.rank() == 0) {
    out.n_pages[row] = runs;
    out.n_hits[row] = total_hits;
  }
}

// How a slot kernel ends a row whose keep mask it has computed: with the
// row's first kpad runs in slot order (the caller finishes the top k),
// with the top k of every run picked here, or, on the page level, with
// that top k alone (no hits, no totals). run<true> takes a row whose kept
// lanes are its first `kept` (the W = 1 kernel's plain word; the page-level
// tail writes no hits and needs only the flag).
struct SlotsTail {
  int kpad, hpad;
  Outputs out;
  template <bool kPrefix = false, class Grp, int L, int N>
  __device__ void run(const Grp& g, RowSmem<N>& s, const bool (&keep)[L],
                      int n, int ipt, int kept = 0) const {
    locate_tail<kPrefix>(g, s, keep, n, ipt, kpad, hpad, out, kept);
  }
};

struct TopkTail {
  int topk, hpad;
  FullTopkOutputs out;
  template <bool kPrefix = false, class Grp, int L, int N>
  __device__ void run(const Grp& g, RowSmem<N>& s, const bool (&keep)[L],
                      int n, int ipt, int kept = 0) const {
    locate_full_topk_tail<kPrefix>(g, s, keep, n, ipt, topk, hpad, out,
                                   kept);
  }
};

struct PageTopkTail {
  int topk;
  TopkOutputs out;
  template <bool kPrefix = false, class Grp, int L, int N>
  __device__ void run(const Grp& g, RowSmem<N>& s, const bool (&keep)[L],
                      int n, int ipt, int kept = 0) const {
    locate_topk_tail<kPrefix>(g, s, keep, n, ipt, topk, out);
  }
};

inline SlotsTail slots_tail(int kpad, int hpad, int* pg_c, float* rk_c,
                            float* ct_c, int* n_pages, int* n_hits,
                            int* hits) {
  SlotsTail t;
  t.kpad = kpad;
  t.hpad = hpad;
  t.out = outputs(pg_c, rk_c, ct_c, n_pages, n_hits, hits);
  return t;
}

inline TopkTail topk_tail(int topk, int hpad, int* pages, float* ranks,
                          int* counts, int* n_pages, int* n_hits, int* hits) {
  TopkTail t;
  t.topk = topk;
  t.hpad = hpad;
  t.out.top = topk_outputs(pages, ranks, counts);
  t.out.n_pages = n_pages;
  t.out.n_hits = n_hits;
  t.out.hits = hits;
  return t;
}

inline PageTopkTail page_topk_tail(int topk, int* pages, float* ranks,
                                   int* counts) {
  PageTopkTail t;
  t.topk = topk;
  t.out = topk_outputs(pages, ranks, counts);
  return t;
}

}  // namespace docodo
