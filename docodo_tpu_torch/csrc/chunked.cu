// The chunked full-result kernels of docodo_tpu_torch, for Hopper (sm_90a):
// streams of any width, past what one block holds in shared memory. They
// replace these Pallas TPU kernels of docodo_tpu/ops/pallas_query.py:
//
//   docodo_merge_tagged  <- _bitonic_merge_kernel (pallas_query.py:2290),
//                           and the lax.sort of word-tagged variant blocks
//                           and of a W >= 3 fold step outside any kernel
//                           (device_index.py:1237, :1288)
//   docodo_and_keep      <- _chunked_and_fwd_kernel (:1935) +
//                           _chunked_and_bwd_kernel (:2227), and
//                           _fused_and_kernel (:2389) for n <= 4096; it
//                           also writes a fold step's compacted stream
//   docodo_variants_keep <- _chunked_variants_fwd_kernel (:2071) +
//                           _chunked_and_bwd_kernel, and
//                           _fused_variants_and_kernel (:2411) for
//                           n <= 4096
//   docodo_locate_runs   <- _chunked_locate_kernel (:1480) and
//                           _resident_locate_kernel (:1676), with the
//                           first-topk-runs compaction compact_streams_topk
//                           (:1731) and the hits compaction of
//                           device_index._locate_full_chunked (:1050)
//
// What bounds them on this card. Each reads its input streams once and
// writes its outputs once with a few integer operations a lane, so their
// floor is bytes. But a wide bucket has few rows (8 or fewer at n =
// 524288), and a kernel that gives a row one block leaves most of the
// 132 SMs idle while that block walks its row's chunks one after the
// other: such a launch is bound by the latency of one block sweeping a
// long row, not by bytes.
//
// So and_keep, variants_keep and locate_runs cut a row into tiles of
// kTile = 4096 lanes, one block each (tiles on grid x, rows on y): 256
// threads of 16 consecutive lanes, read as 16-byte loads. The per-row
// state that the TPU route carries between the steps of its sequential
// grid becomes an associative summary of a stretch of lanes (RunSum,
// SegSum, CountSum). A block scans its threads' summaries, takes its
// tile's exclusive prefix from the tiles before it by decoupled
// look-back (tile_scan.cuh: status words and summaries polled in L2,
// tiles ordered by a ticket), and each thread then walks its 16 lanes
// with the exact state a sweep of the whole row would have there. A
// launch costs about one tile's latency plus the look-back chain; a row
// of one tile (n <= 4096: the many-row buckets) finds no predecessor.
//
// The keep kernels are two launches from one entry point: pass 1 writes
// each lane's segment code and each segment's operand counts, pass 2
// resolves each lane from its segment's two entries, the second of which
// pass 1 may write in any later tile; the stream order between the
// launches is the grid-wide barrier. locate_runs ends a row in the block
// that finishes it last (a per-row counter behind __threadfence, as in
// CUDA's threadFenceReduction sample): that epilogue reads at most
// kpad + 1 run entries and pads the hits, less work than a second
// launch would cost in launch latency. It looks pages up in a window of
// bounds that the tile stages in shared memory: the tile's kept values
// lie between its first and last, so their pages lie in the bounds
// between the two, found by a 32-way warp search (3 rounds for 22k
// pages).
//
// The TPU's bitonic merge network and its sorts of already sorted blocks
// become a merge by binary-search rank (each element's slot is its index
// plus its rank in every other block), and the compare-all compactions
// become scatters at prefix-sum slots.
//
// Every entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError(). The tiled ones take two scratch
// arrays from the caller, sized by docodo_keep_scratch /
// docodo_locate_runs_scratch: `zeroed` (status words and tickets, zero
// before the launch when a row has more than one tile; a row of one tile
// reads none of them) and `work` (summaries, uninitialised).

#include <stdint.h>

#include "common.cuh"
#include "tile_scan.cuh"

namespace {

using namespace docodo;

constexpr int kThreads = 256;
constexpr int kLanes = 16;                // consecutive lanes a thread owns
constexpr int kTile = kThreads * kLanes;  // lanes a block owns
constexpr int kWindow = 2048;             // page bounds a tile can stage
constexpr int kMergeThreads = 256;

// merge_tagged: the row's va blocks of word A (tag 0) and vb blocks of word
// B (tag 1), block k of word A at a[row, k, :cap_a] with its length in
// na_[row, k] (word B likewise), merge into one (coord, tag) stream. An
// element of block k lands at its index plus its rank in every other block,
// counting equal coords of earlier blocks (word A's before word B's) as
// before it and those of later blocks as after: a bijection onto the first
// sum(len) slots. Padding lanes (INF32, tag 2, page 0) follow in block
// order. pg / a_pg / b_pg may all be null (no page payload).
__global__ void __launch_bounds__(kMergeThreads) merge_tagged_kernel(
    const int* __restrict__ a, const int* __restrict__ a_pg,
    const int* __restrict__ na_, const int* __restrict__ b,
    const int* __restrict__ b_pg, const int* __restrict__ nb_, int va,
    int cap_a, int vb, int cap_b, int* __restrict__ vals,
    int* __restrict__ tag, int* __restrict__ pg) {
  const size_t row = blockIdx.x;
  const int k = blockIdx.z;
  const int i = blockIdx.y * kMergeThreads + threadIdx.x;
  const bool in_a = k < va;
  const int cap = in_a ? cap_a : cap_b;
  if (i >= cap) return;
  const int nblk = va + vb;
  const size_t out = row * ((size_t)va * cap_a + (size_t)vb * cap_b);
  auto block = [&](int j) -> const int* {
    return j < va ? a + (row * va + j) * cap_a
                  : b + (row * vb + j - va) * cap_b;
  };
  auto length = [&](int j) -> int {
    return j < va ? clamp_len(na_[row * va + j], cap_a)
                  : clamp_len(nb_[row * vb + j - va], cap_b);
  };
  const int len = length(k);
  if (i < len) {
    const int v = block(k)[i];
    size_t p = i;
    for (int j = 0; j < nblk; ++j) {
      if (j < k) p += upper_bound(block(j), length(j), v);
      else if (j > k) p += lower_bound(block(j), length(j), v);
    }
    vals[out + p] = v;
    tag[out + p] = in_a ? 0 : 1;
    if (pg) pg[out + p] = in_a ? a_pg[(row * va + k) * cap_a + i]
                               : b_pg[(row * vb + k - va) * cap_b + i];
  } else {
    size_t p = i - len;
    for (int j = 0; j < nblk; ++j) {
      const int lj = length(j);
      p += lj;
      if (j < k) p += (j < va ? cap_a : cap_b) - lj;
    }
    vals[out + p] = kInf;
    tag[out + p] = 2;
    if (pg) pg[out + p] = 0;
  }
}

int tiles_of(int n) { return (n + kTile - 1) / kTile; }

bool aligned16(const void* p) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Lanes base .. base + kLanes - 1 of a row of n lanes, `fill` past n; as
// 16-byte loads where `vec` (the row starts 16-byte aligned, n % 4 == 0).
__device__ inline void load_lanes(const int* row, int base, int n, bool vec,
                                  int fill, int (&x)[kLanes]) {
#pragma unroll
  for (int g = 0; g < kLanes; g += 4) {
    const int l = base + g;
    if (vec && l + 3 < n) {
      const int4 q = *reinterpret_cast<const int4*>(row + l);
      x[g] = q.x;
      x[g + 1] = q.y;
      x[g + 2] = q.z;
      x[g + 3] = q.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) x[g + j] = l + j < n ? row[l + j] : fill;
    }
  }
}

__device__ inline void store_lanes(int* row, int base, int n, bool vec,
                                   const int (&x)[kLanes]) {
#pragma unroll
  for (int g = 0; g < kLanes; g += 4) {
    const int l = base + g;
    if (vec && l + 3 < n) {
      *reinterpret_cast<int4*>(row + l) =
          make_int4(x[g], x[g + 1], x[g + 2], x[g + 3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (l + j < n) row[l + j] = x[g + j];
    }
  }
}

// ---------------------------------------------------------------------------
// and_keep / variants_keep
// ---------------------------------------------------------------------------

// The AND's keep decision over a merged (coord, tag) stream (tag 0 word A,
// 1 word B, 2 padding), written as the kept stream hv: the value at kept
// lanes, INF32 elsewhere. Gaps wider than |R| cut segments, both R < 0
// adds the ordered cut at each gap segment's first word-A mark, and a
// segment keeps its eligible lanes only if it holds a mark of each word.
// The marks:
//
//   and_keep (kVariants false; pallas_query._sorted_and_keep): each word
//   has at most one lane per coordinate, so a cross-word duplicate is two
//   lanes; it folds onto its first lane, which is eligible and carries both
//   words' marks, and the second lane is dropped.
//
//   variants_keep (kVariants true; pallas_query._variants_and_keep): a run
//   of equal coordinates may be up to Va + Vb lanes long and cross tiles.
//   Tags ascend within a run, so its first lane (the eligible one) holds
//   word A's mark when its tag is 0, and its last lane holds word B's mark
//   when its tag is 1; both read only the neighbouring lanes, so a tile
//   reads one lane on either side of it. A run never crosses a segment
//   cut (equal coords have gap 0, and the ordered cut falls on word-A
//   marks, which are run starts), so the marks count per segment as if
//   they sat on the run's first lane. Rows with bpad keep every run start
//   (word B is query padding: word A's union).

// The segment state of a stretch of lanes. The ordered cut is the part
// that is not a plain sum: a lane before the stretch's first gap start
// is cut if the segment open before the stretch has no word-A mark yet,
// so the stretch records whether it holds such a mark (kPre) and leaves
// that one cut to the combine.
struct SegSum {
  static constexpr int kGap = 1;   // holds a gap start
  static constexpr int kPre = 2;   // an ordered row's word-A mark before
                                   // its first gap start (anywhere when
                                   // it holds none)
  static constexpr int kSeen = 4;  // the segment open at its end holds a
                                   // word-A mark (ordered rows; equal to
                                   // kPre when it holds no gap start)
  int a, b;    // word-A and word-B marks
  int starts;  // gap starts and the ordered cuts the stretch fixes itself
  int bits;

  __device__ static SegSum identity() { return SegSum{0, 0, 0, 0}; }
  __device__ static SegSum lane(bool isa, bool isb, bool gap_start,
                                bool ordered) {
    const bool a_mark = ordered && isa;
    if (gap_start)
      return SegSum{isa, isb, 1, kGap | (a_mark ? kSeen : 0)};
    return SegSum{isa, isb, 0, a_mark ? kPre | kSeen : 0};
  }
  __device__ static SegSum combine(const SegSum& l, const SegSum& r) {
    const bool cut = (l.bits & kGap) && !(l.bits & kSeen) && (r.bits & kPre);
    const int pre = (l.bits & kGap) ? (l.bits & kPre)
                                    : ((l.bits | r.bits) & kPre);
    const int seen = (r.bits & kGap)
                         ? (r.bits & kSeen)
                         : ((l.bits & kSeen) | ((r.bits & kPre) ? kSeen : 0));
    return SegSum{l.a + r.a, l.b + r.b, l.starts + r.starts + (cut ? 1 : 0),
                  ((l.bits | r.bits) & kGap) | pre | seen};
  }
};

struct CountSum {
  int c;
  __device__ static CountSum identity() { return CountSum{0}; }
  __device__ static CountSum combine(const CountSum& l, const CountSum& r) {
    return CountSum{l.c + r.c};
  }
};

// The keep kernels' scratch: pass 1's and pass 2's status words and
// tickets (zeroed), then their tile summaries.
struct KeepScratch {
  int* flag1;  // [rows, tiles]
  int* flag2;
  int* ticket1;  // [rows]
  int* ticket2;
  SegSum* aggs1;  // [rows, tiles]
  SegSum* incls1;
  CountSum* aggs2;
  CountSum* incls2;
};

// Lays KeepScratch out over zeroed / work (when both are set) and gives
// the int32 sizes of both.
KeepScratch keep_scratch(int rows, int tiles, int* zeroed, int* work,
                         size_t* n_zeroed, size_t* n_work) {
  const size_t rt = (size_t)rows * tiles;
  *n_zeroed = 2 * rt + 2 * (size_t)rows;
  *n_work = 2 * rt * (words<SegSum>() + words<CountSum>());
  KeepScratch s{};
  if (zeroed && work) {
    s.flag1 = zeroed;
    s.flag2 = zeroed + rt;
    s.ticket1 = zeroed + 2 * rt;
    s.ticket2 = s.ticket1 + rows;
    s.aggs1 = reinterpret_cast<SegSum*>(work);
    s.incls1 = s.aggs1 + rt;
    s.aggs2 = reinterpret_cast<CountSum*>(s.incls1 + rt);
    s.incls2 = s.aggs2 + rt;
  }
  return s;
}

// Pass 1: each lane's (segment ordinal << 1 | eligible) to hv, and each
// segment's operand counts before its first lane to seg[row, s] (one
// int2 per segment; the row's last tile writes the totals at
// seg[row, nseg]).
template <bool kVariants>
__global__ void __launch_bounds__(kThreads) keep_marks_kernel(
    const int* __restrict__ vals, const int* __restrict__ tag,
    const int* __restrict__ ra_, const int* __restrict__ rb_, int n,
    int tiles, bool vec, int* __restrict__ hv, int2* __restrict__ seg,
    KeepScratch scr) {
  __shared__ SegSum s_warp[kThreads / 32];
  __shared__ SegSum s_pre;
  __shared__ int s_tile;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const size_t row = blockIdx.y;
  const int tile = row_ticket(scr.ticket1 + row, tiles, &s_tile);
  const int base = tile * kTile + tid * kLanes;
  const int* v_row = vals + row * n;
  const int* t_row = tag + row * n;
  const int r1 = ra_[row];
  const int r2 = rb_[row];
  const int abs_r = max(abs(r1), abs(r2));
  const bool ordered = r1 < 0 && r2 < 0;

  unsigned m_a = 0, m_b = 0, m_eff = 0, m_gap = 0;
  {
    int v[kLanes], t[kLanes];
    load_lanes(v_row, base, n, vec, kInf, v);
    load_lanes(t_row, base, n, vec, 2, t);
    // the lanes on either side of this thread's
    const int pv0 = base > 0 && base - 1 < n ? v_row[base - 1] : 0;
    const int nv_end = base + kLanes < n ? v_row[base + kLanes] : kInf;
    const int nt_end = base + kLanes < n ? t_row[base + kLanes] : 2;
#pragma unroll
    for (int k = 0; k < kLanes; ++k) {
      const int l = base + k;
      const int pv = k > 0 ? v[k - 1] : pv0;
      const int nv = k + 1 < kLanes ? v[k + 1] : nv_end;
      const bool valid = v[k] < kInf;
      const bool dup_prev = valid && l > 0 && v[k] == pv;
      bool isa, isb;
      if (kVariants) {
        isa = valid && !dup_prev && t[k] == 0;
        isb = valid && t[k] == 1 && v[k] != nv;
      } else {
        const int nt = k + 1 < kLanes ? t[k + 1] : nt_end;
        const bool dup_next = valid && v[k] == nv;
        const bool a_next = nv < kInf && nt == 0;
        const bool b_next = nv < kInf && nt == 1;
        isa = ((valid && t[k] == 0) || (dup_next && a_next)) && !dup_prev;
        isb = ((valid && t[k] == 1) || (dup_next && b_next)) && !dup_prev;
      }
      const int gap = v[k] - (l == 0 ? 0 : pv);
      const bool gap_start =
          l < n && (l == 0 || (abs_r != 0 && gap > abs_r && valid));
      m_a |= (unsigned)isa << k;
      m_b |= (unsigned)isb << k;
      m_eff |= (unsigned)(valid && !dup_prev) << k;
      m_gap |= (unsigned)gap_start << k;
    }
  }
  SegSum mine = SegSum::identity();
#pragma unroll
  for (int k = 0; k < kLanes; ++k)
    mine = SegSum::combine(mine, SegSum::lane(m_a >> k & 1, m_b >> k & 1,
                                              m_gap >> k & 1, ordered));
  SegSum total;
  const SegSum before = block_scan<kThreads>(mine, s_warp, &total);
  int2* s_row = seg + row * (size_t)(n + 1);
  if (tid < 32) {
    const size_t at = row * tiles;
    const SegSum pre = tile_exclusive(total, tile, scr.flag1 + at,
                                      scr.aggs1 + at, scr.incls1 + at);
    if (lane == 0) {
      s_pre = pre;
      if (tile == tiles - 1) {
        const SegSum all = SegSum::combine(pre, total);
        s_row[all.starts] = make_int2(all.a, all.b);
      }
    }
  }
  __syncthreads();

  // this thread's lanes, from the state of the row before them (which
  // holds lane 0's gap start unless it is empty)
  const SegSum e = SegSum::combine(s_pre, before);
  int c_a = e.a, c_b = e.b, c_s = e.starts;
  bool seen = e.bits & SegSum::kSeen;
  int code[kLanes];
#pragma unroll
  for (int k = 0; k < kLanes; ++k) {
    const bool isa = m_a >> k & 1;
    bool start = m_gap >> k & 1;
    if (ordered) {
      if (start) {
        seen = isa;
      } else if (isa && !seen) {  // the gap segment's first word-A mark
        start = true;
        seen = true;
      }
    }
    if (start && base + k < n) s_row[c_s++] = make_int2(c_a, c_b);
    c_a += isa;
    c_b += m_b >> k & 1;
    code[k] = (c_s << 1) | (int)(m_eff >> k & 1);
  }
  store_lanes(hv + row * n, base, n, vec, code);
}

// Pass 2: every lane resolved from its segment's two entries. Writes the
// values to hv or, when cvals is set, the kept values (and their pages
// from pg, when cpg is set) compacted to the front of cvals / cpg, INF32
// after them, and their count to ccount. A tile's kept lanes fill the
// slots from its kept prefix on, and its dropped lanes' INF32 the slots
// n - 1 - their dropped ordinals, so the tail needs no total; both are
// runs of consecutive slots, written out of shared memory.
template <bool kVariants>
__global__ void __launch_bounds__(kThreads) keep_resolve_kernel(
    const int* __restrict__ vals, const int* __restrict__ bpad_,
    const int* __restrict__ pg, int n, int tiles, bool vec, int* hv,
    const int2* __restrict__ seg, int* __restrict__ cvals,
    int* __restrict__ cpg, int* __restrict__ ccount, KeepScratch scr) {
  __shared__ CountSum s_warp[kThreads / 32];
  __shared__ CountSum s_pre;
  __shared__ int s_tile;
  __shared__ int s_val[kTile], s_pg[kTile];  // the tile's kept lanes
  const int tid = threadIdx.x;
  const size_t row = blockIdx.y;
  const bool compact = cvals != nullptr;
  // only the compaction carries anything between tiles
  const int tile =
      compact ? row_ticket(scr.ticket2 + row, tiles, &s_tile) : blockIdx.x;
  const int base = tile * kTile + tid * kLanes;
  const bool bpad = kVariants && bpad_[row] != 0;
  int* h_row = hv + row * n;
  const int* v_row = vals + row * n;
  const int2* s_row = seg + row * (size_t)(n + 1);

  int x[kLanes];
  load_lanes(h_row, base, n, vec, 0, x);
  unsigned keep = 0;
#pragma unroll
  for (int k = 0; k < kLanes; ++k) {
    if (base + k >= n) continue;
    const int s = x[k] >> 1;
    const int2 lo = s_row[s - 1];
    const int2 hi = s_row[s];
    if ((x[k] & 1) && (bpad || (hi.x > lo.x && hi.y > lo.y)))
      keep |= 1u << k;
  }
  if (!compact) {
#pragma unroll
    for (int k = 0; k < kLanes; ++k)
      x[k] = keep >> k & 1 ? v_row[base + k] : kInf;
    store_lanes(h_row, base, n, vec, x);
    return;
  }
  CountSum total;
  const CountSum before = block_scan<kThreads>(
      CountSum{__popc(keep)}, s_warp, &total);
  if (tid < 32) {
    const size_t at = row * tiles;
    const CountSum pre = tile_exclusive(total, tile, scr.flag2 + at,
                                        scr.aggs2 + at, scr.incls2 + at);
    if (tid == 0) {
      s_pre = pre;
      if (tile == tiles - 1) ccount[row] = pre.c + total.c;
    }
  }
  const int* p_row = pg ? pg + row * n : nullptr;
  int slot = before.c;
#pragma unroll
  for (int k = 0; k < kLanes; ++k) {
    if (keep >> k & 1) {
      s_val[slot] = v_row[base + k];
      if (cpg) s_pg[slot] = p_row[base + k];
      ++slot;
    }
  }
  __syncthreads();
  const int kept = total.c;
  const int dropped = min(kTile, n - tile * kTile) - kept;
  int* cv_row = cvals + row * n + s_pre.c;
  int* tail = cvals + row * n + n - (tile * kTile - s_pre.c) - dropped;
  for (int j = tid; j < kept; j += kThreads) cv_row[j] = s_val[j];
  for (int j = tid; j < dropped; j += kThreads) tail[j] = kInf;
  if (cpg) {
    int* cp_row = cpg + row * n + s_pre.c;
    int* cp_tail = cpg + row * n + n - (tile * kTile - s_pre.c) - dropped;
    for (int j = tid; j < kept; j += kThreads) cp_row[j] = s_pg[j];
    for (int j = tid; j < dropped; j += kThreads) cp_tail[j] = kInf;
  }
}

// ---------------------------------------------------------------------------
// locate_runs
// ---------------------------------------------------------------------------

// locate_runs: page runs of a kept stream hv (INF32 at dropped lanes, kept
// values ascending) of any width. Pages come from pg (carried) or, when pg
// is null, from bounds (#bounds <= value, clamped to the last page).
// Writes the first kpad runs in slot order, the first hpad kept values,
// and the exact run and hit totals.
//
// A run's count and bonus are differences of two exclusive prefix sums:
// at its first lane and at the next run's first lane (the row totals for
// the last run). The tile that holds a run's first lane records those
// sums for run ordinals <= kpad in a [rows, kpad + 1] table, and the
// row's last block to finish turns them into runs; no full-width stream
// is written. Run sums are exact integers, so the f32 rank does not
// depend on the order of the tiles.

__device__ inline int gap_bonus(int gap) { return 30 / (gap > 5 ? gap : 5); }

// The page runs of a stretch of lanes of a kept stream.
struct RunSum {
  int hits;    // kept lanes
  int runs;    // run starts after the first kept lane
  int bonus;   // bonus after the first kept lane
  int fv, fp;  // the first kept lane's value and page
  int lv, lp;  // the last kept lane's

  __device__ static RunSum identity() { return RunSum{0, 0, 0, 0, -1, 0, -1}; }
  __device__ static RunSum lane(int v, int p) {
    return RunSum{1, 0, 0, v, p, v, p};
  }
  __device__ static RunSum combine(const RunSum& l, const RunSum& r) {
    if (r.hits == 0) return l;
    if (l.hits == 0) return r;
    const bool same = r.fp == l.lp;  // r's first lane continues l's run
    return RunSum{l.hits + r.hits, l.runs + r.runs + (same ? 0 : 1),
                  l.bonus + r.bonus + (same ? gap_bonus(r.fv - l.lv) : 0),
                  l.fv, l.fp, r.lv, r.lp};
  }
};

// locate_runs' scratch: the run table, then the status words, tickets and
// finished-tile counters (zeroed) and the tile summaries.
struct RunScratch {
  int4* runs;     // [rows, kpad + 1]: hits and bonus before run r, its page
  int* flag;      // [rows, tiles]
  int* ticket;    // [rows]
  int* finished;  // [rows]
  RunSum* aggs;   // [rows, tiles]
  RunSum* incls;
};

RunScratch run_scratch(int rows, int tiles, int kpad, int* zeroed, int* work,
                       size_t* n_zeroed, size_t* n_work) {
  const size_t rt = (size_t)rows * tiles;
  const size_t table = 4 * (size_t)rows * (kpad + 1);
  *n_zeroed = rt + 2 * (size_t)rows;
  *n_work = table + 2 * rt * words<RunSum>();
  RunScratch s{};
  if (zeroed && work) {
    s.runs = reinterpret_cast<int4*>(work);
    s.flag = zeroed;
    s.ticket = zeroed + rt;
    s.finished = s.ticket + rows;
    s.aggs = reinterpret_cast<RunSum*>(work + table);
    s.incls = s.aggs + rt;
  }
  return s;
}

// #{j < m: s[j] <= v}, by one warp: each round cuts [lo, hi] into 32
// pieces and keeps the one that holds the answer (3 rounds for 32k
// bounds). Every lane returns it.
__device__ inline int warp_upper_bound(const int* s, int m, int v) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = m;
  while (lo < hi) {
    const int len = hi - lo;
    const int step = (len + 31) / 32;
    const int probe = lo + min(len, (lane + 1) * step) - 1;
    const int c = __popc(__ballot_sync(kFullMask, s[probe] <= v));
    if (c == 32) return hi;
    hi = lo + min(len, (c + 1) * step) - 1;  // s[hi] > v
    lo += c * step;
  }
  return lo;
}

// Four blocks an SM (at most 64 registers, a few spilled): on an H100
// the wide and the many-row launches take a fifth to a third less time
// than at 95 registers and two blocks (tools/tile_kernel_times.py). The
// keep kernels gain nothing from it.
__global__ void __launch_bounds__(kThreads, 4) locate_runs_kernel(
    const int* __restrict__ hv, const int* __restrict__ pg,
    const int* __restrict__ bounds, int n_bounds, int n, int tiles, int kpad,
    int hpad, bool vec, Outputs out, RunScratch scr) {
  __shared__ RunSum s_warp[kThreads / 32];
  __shared__ RunSum s_pre;
  __shared__ int s_win[kWindow];
  __shared__ int s_min[kThreads / 32], s_max[kThreads / 32];
  __shared__ int s_lo, s_hi, s_tile, s_last;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t row = blockIdx.y;
  const int tile = row_ticket(scr.ticket + row, tiles, &s_tile);
  const int base = tile * kTile + tid * kLanes;

  int v[kLanes], page[kLanes];
  load_lanes(hv + row * n, base, n, vec, kInf, v);
  if (pg) {
    const int* p_row = pg + row * n;
#pragma unroll
    for (int g = 0; g < kLanes; g += 4) {
      const int l = base + g;
      const bool any = v[g] < kInf || v[g + 1] < kInf || v[g + 2] < kInf ||
                       v[g + 3] < kInf;
      if (any && vec && l + 3 < n) {
        const int4 q = *reinterpret_cast<const int4*>(p_row + l);
        page[g] = q.x;
        page[g + 1] = q.y;
        page[g + 2] = q.z;
        page[g + 3] = q.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          page[g + j] = v[g + j] < kInf ? p_row[l + j] : -1;
      }
    }
  } else {
    // the tile's kept values lie between its first and last, their pages
    // in bounds[lo .. hi): staged in shared memory when they fit
    int first = kInf, last = -1;
#pragma unroll
    for (int k = 0; k < kLanes; ++k) {
      if (v[k] < kInf) {
        first = min(first, v[k]);
        last = max(last, v[k]);
      }
    }
    first = __reduce_min_sync(kFullMask, first);
    last = __reduce_max_sync(kFullMask, last);
    if (lane == 0) {
      s_min[warp] = first;
      s_max[warp] = last;
    }
    __syncthreads();
    if (warp < 2) {
      int lo_v = kInf, hi_v = -1;
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w) {
        lo_v = min(lo_v, s_min[w]);
        hi_v = max(hi_v, s_max[w]);
      }
      const int b = lo_v == kInf ? 0
                    : warp_upper_bound(bounds, n_bounds,
                                       warp == 0 ? lo_v : hi_v);
      if (lane == 0) (warp == 0 ? s_lo : s_hi) = b;
    }
    __syncthreads();
    const int lo = s_lo;
    const int w = s_hi - s_lo;
    const bool staged = w <= kWindow;
    if (staged) {
      for (int j = tid; j < w; j += kThreads) s_win[j] = bounds[lo + j];
      __syncthreads();
    }
#pragma unroll
    for (int k = 0; k < kLanes; ++k) {
      page[k] = -1;
      if (v[k] < kInf) {
        const int p = lo + (staged ? upper_bound(s_win, w, v[k])
                                   : upper_bound(bounds + lo, w, v[k]));
        page[k] = p < n_bounds ? p : n_bounds - 1;
      }
    }
  }

  RunSum mine = RunSum::identity();
#pragma unroll
  for (int k = 0; k < kLanes; ++k)
    if (v[k] < kInf) mine = RunSum::combine(mine, RunSum::lane(v[k], page[k]));
  RunSum total;
  const RunSum before = block_scan<kThreads>(mine, s_warp, &total);
  const size_t at = row * tiles;
  if (warp == 0) {
    const RunSum pre = tile_exclusive(total, tile, scr.flag + at,
                                      scr.aggs + at, scr.incls + at);
    if (lane == 0) s_pre = pre;
  }
  __syncthreads();

  // this thread's lanes, from the state of the row before them
  const RunSum e = RunSum::combine(s_pre, before);
  int c_hits = e.hits, c_bon = e.bonus;
  int c_runs = e.hits ? e.runs + 1 : 0;
  int c_pv = e.hits ? e.lv : -1, c_pp = e.hits ? e.lp : -1;
  int* hits = out.hits + row * hpad;
  int4* runs = scr.runs + row * (kpad + 1);
#pragma unroll
  for (int k = 0; k < kLanes; ++k) {
    if (v[k] == kInf) continue;
    if (c_hits < hpad) hits[c_hits] = v[k];
    if (page[k] != c_pp) {  // a run starts
      if (c_runs <= kpad)
        __stcg(&runs[c_runs], make_int4(c_hits, c_bon, page[k], 0));
      ++c_runs;
    } else {
      c_bon += gap_bonus(v[k] - c_pv);
    }
    ++c_hits;
    c_pv = v[k];
    c_pp = page[k];
  }

  // the row's last block to finish writes its runs and totals
  __threadfence();
  __syncthreads();
  if (tid == 0)
    s_last = tiles == 1 || atomicAdd(scr.finished + row, 1) == tiles - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const RunSum all = tiles == 1 ? total : load_l2(&scr.incls[at + tiles - 1]);
  const int n_runs = all.hits ? all.runs + 1 : 0;
  for (int r = tid; r < kpad; r += kThreads) {
    const size_t o = row * kpad + r;
    if (r < n_runs) {
      const int4 a = __ldcg(&runs[r]);
      const int4 b = r + 1 < n_runs ? __ldcg(&runs[r + 1])
                                    : make_int4(all.hits, all.bonus, 0, 0);
      const int cnt = b.x - a.x;
      out.pg_c[o] = a.z;
      out.rk_c[o] = run_rank(b.y - a.y, cnt);
      out.ct_c[o] = (float)cnt;
    } else {
      out.pg_c[o] = -1;
      out.rk_c[o] = 0.0f;
      out.ct_c[o] = 0.0f;
    }
  }
  for (int h = all.hits + tid; h < hpad; h += kThreads) hits[h] = kInf;
  if (tid == 0) {
    out.n_pages[row] = n_runs;
    out.n_hits[row] = all.hits;
  }
}

template <bool kVariants>
int launch_keep(const int* vals, const int* tag, const int* ra,
                const int* rb, const int* bpad, const int* pg, int rows,
                int n, int* hv, int* seg, int* cvals, int* cpg, int* ccount,
                int* zeroed, int* work, void* stream) {
  if (rows > 65535) return (int)cudaErrorInvalidValue;
  if (rows > 0 && n > 0) {
    const int tiles = tiles_of(n);
    size_t nz, nw;
    const KeepScratch scr = keep_scratch(rows, tiles, zeroed, work, &nz, &nw);
    const bool vec = n % 4 == 0 && aligned16(vals) && aligned16(tag) &&
                     aligned16(hv);
    const dim3 grid(tiles, rows);
    const cudaStream_t s = (cudaStream_t)stream;
    keep_marks_kernel<kVariants><<<grid, kThreads, 0, s>>>(
        vals, tag, ra, rb, n, tiles, vec, hv, reinterpret_cast<int2*>(seg),
        scr);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    keep_resolve_kernel<kVariants><<<grid, kThreads, 0, s>>>(
        vals, bpad, pg, n, tiles, vec, hv, reinterpret_cast<int2*>(seg),
        cvals, cpg, ccount, scr);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int docodo_merge_tagged(const int* a, const int* a_pg,
                                   const int* na, const int* b,
                                   const int* b_pg, const int* nb, int rows,
                                   int va, int cap_a, int vb, int cap_b,
                                   int* vals, int* tag, int* pg,
                                   void* stream) {
  const int ca = va > 0 ? cap_a : 0;
  const int cb = vb > 0 ? cap_b : 0;
  const int cap = ca > cb ? ca : cb;
  if (va + vb > 65535) return (int)cudaErrorInvalidValue;
  if (rows > 0 && cap > 0) {
    const dim3 grid(rows, (cap + kMergeThreads - 1) / kMergeThreads,
                    va + vb);
    merge_tagged_kernel<<<grid, kMergeThreads, 0, (cudaStream_t)stream>>>(
        a, a_pg, na, b, b_pg, nb, va, cap_a, vb, cap_b, vals, tag, pg);
  }
  return (int)cudaGetLastError();
}

extern "C" int docodo_and_keep(const int* vals, const int* tag,
                               const int* ra, const int* rb, const int* pg,
                               int rows, int n, int* hv, int* seg,
                               int* cvals, int* cpg, int* ccount,
                               int* zeroed, int* work, void* stream) {
  return launch_keep<false>(vals, tag, ra, rb, nullptr, pg, rows, n, hv, seg,
                            cvals, cpg, ccount, zeroed, work, stream);
}

extern "C" int docodo_variants_keep(const int* vals, const int* tag,
                                    const int* ra, const int* rb,
                                    const int* bpad, const int* pg, int rows,
                                    int n, int* hv, int* seg, int* cvals,
                                    int* cpg, int* ccount, int* zeroed,
                                    int* work, void* stream) {
  return launch_keep<true>(vals, tag, ra, rb, bpad, pg, rows, n, hv, seg,
                           cvals, cpg, ccount, zeroed, work, stream);
}

extern "C" int docodo_locate_runs(const int* hv, const int* pg,
                                  const int* bounds, int n_bounds, int rows,
                                  int n, int kpad, int hpad, int* pg_c,
                                  float* rk_c, float* ct_c, int* n_pages,
                                  int* n_hits, int* hits, int* zeroed,
                                  int* work, void* stream) {
  if (rows > 65535) return (int)cudaErrorInvalidValue;
  if (rows > 0 && n > 0) {
    const int tiles = tiles_of(n);
    size_t nz, nw;
    const RunScratch scr =
        run_scratch(rows, tiles, kpad, zeroed, work, &nz, &nw);
    const bool vec = n % 4 == 0 && aligned16(hv) && aligned16(pg);
    locate_runs_kernel<<<dim3(tiles, rows), kThreads, 0,
                         (cudaStream_t)stream>>>(
        hv, pg, bounds, n_bounds, n, tiles, kpad, hpad, vec,
        outputs(pg_c, rk_c, ct_c, n_pages, n_hits, hits), scr);
  }
  return (int)cudaGetLastError();
}

// Lanes a block of and_keep, variants_keep and locate_runs owns.
extern "C" int docodo_tile_lanes() { return kTile; }

// The int32 sizes of the scratch arrays the tiled entry points take.
extern "C" void docodo_keep_scratch(int rows, int n, long long* zeroed,
                                    long long* work) {
  size_t nz, nw;
  keep_scratch(rows, tiles_of(n), nullptr, nullptr, &nz, &nw);
  *zeroed = (long long)nz;
  *work = (long long)nw;
}

extern "C" void docodo_locate_runs_scratch(int rows, int n, int kpad,
                                           long long* zeroed,
                                           long long* work) {
  size_t nz, nw;
  run_scratch(rows, tiles_of(n), kpad, nullptr, nullptr, &nz, &nw);
  *zeroed = (long long)nz;
  *work = (long long)nw;
}
