// Probe kernels of docodo_tpu_torch, for Hopper (sm_90a): the counterparts
// of the TPU kernels that the JAX package keeps in its benchmarks/ folder.
//
//   docodo_probe_locate <- benchmarks/probe_locate.py, mk_kernel(page_fn)'s
//                          kern (:129-130, pallas_call :95): the W = 2 slot
//                          body over a merged (coord, tag) stream with its
//                          page locate swapped
//   docodo_row_gather   <- benchmarks/probe_dma_fetch.py fetch_kernel (:80,
//                          pallas_call :114): a row gather from a table in
//                          device memory, each row copied on its own
//
// docodo_probe_locate takes rows of n <= 1024 lanes, already merged: vals
// ascending with an INF32 tail, tags 0 (word A), 1 (word B), 2 (padding),
// the windows ra / rb [rows] and the page bounds [p]. It computes row 1's
// row body (slot_row.cuh: tagged_keep, sum_runs) and writes what the TPU
// kernel writes, each [rows, n]: every lane's page, each run's rank and
// count at the run's first lane (0 elsewhere), the kept values (INF32
// elsewhere); and npages / nhits [rows]. The page of a lane is the one
// thing it varies, a template policy:
//
//   BoundsSearch  #bounds <= v clamped to the last page, a binary search of
//                 the bounds in device memory: the port's production locate
//                 (slot_row.cuh page_of_coord), in place of the TPU's
//                 compare-all against every bound
//   Arith         min(v / page_len, p - 1): exact on pages of one length, a
//                 lower bound on the locate's cost otherwise (page_arith)
//   TwoLevel      a search of every 128th bound, staged in shared memory by
//                 the block, then a search inside the 128 bounds of the
//                 block it names: the same page as BoundsSearch, with 8 of
//                 its reads from device memory instead of log2(p) (the GPU
//                 meaning of page_mxu, whose one-hot matmul picks the block
//                 on the TPU's matrix unit)
//
// What bounds it on this card: bytes, 2 n int32 and 2 scalars read and
// 4 n + 2 values written a row. But one launch is one wave (5,952 rows of
// 128 lanes are 744 blocks), so its time is one row's chain of dependent
// steps: the load, the page search, the scans. The design keeps that chain
// short. A row of n <= 128 lanes is one warp's (8 rows a 256-thread block);
// wider rows take n / 128 warps (4, 2, 1 rows a block at 256, 512, 1024).
// A thread owns 4 consecutive lanes, loaded as one 16-byte load of values
// and one of tags straight into registers, and keeps them there: the
// neighbours come by shuffle, the keep, the run marks and the run sums by
// warp scans (forward and backward segmented scans, lane_scan below), with
// no row in shared memory and no block barrier. A row of several warps
// crosses them through one exchange of warp totals in shared memory a scan,
// behind the row's own named barrier. The page search runs once a thread:
// its four lanes' searches halve in lock step, one round of four
// independent loads at a time, so a thread waits ceil(log2 p) + 1 load
// latencies and not four times that. (Stepping through the bounds from the
// first lane's page would be cheaper only where consecutive lanes share a
// page; in both shapes the probe measures they lie pages apart.) Every
// output lane is written once, by 16-byte stores from registers; npages
// and nhits are one 4-byte store each a row. Even without a search
// (Arith) the body takes about twice its bytes' time (an H100 80GB HBM3
// at 700 W, tools/probe_ab.py), so a lane's work is kept lean: the bonus
// 30 / max(5, gap) by compares, Arith's division by a multiply and a
// shift, the kept lanes counted inside the run-sum scan.
//
// docodo_row_gather copies table rows tab[ids[b]] ([R, n] int32) into out[b]
// ([B, n], mode 0) or reduces each to 128 lanes, out[b, l] = sum_k
// tab[ids[b], 128 k + l] ([B, 128], mode 1, int32 wrapping as the TPU's sum
// does). What bounds it: bytes, the B ids and each distinct row's n 4 read
// once, B n 4 (copy) or B 512 (sum) written; rows that repeat come from L2.
// The grid is persistent: as many blocks as the SMs hold at once (the
// occupancy API), each with a contiguous share of the ids that differs from
// the others' by at most one, so no SM idles in a tail wave. A block's ring
// holds `depth` row slots of shared memory: q keeps its TPU meaning, the
// rows in flight a block, capped by the ring's 96 KB in both modes (depth =
// min(q, max(1, 96 KB / 4 n)): at n = 2048 every q of 32, 64 and 128 gives
// 12 slots, two blocks an SM); a slot takes a row of up to 96 KB. Warp 0 is
// the producer: its lanes read 32 ids at a time ahead of use, and one lane
// keeps the ring full with 1-D bulk copies (TMA, cp.async.bulk), each
// completing its slot's `full` mbarrier by its bytes; it refills a slot once
// its `empty` mbarrier says the consumer is done with it. In copy mode the
// consumer is one thread: it sends a full slot straight back out with a bulk
// store (cp.async.bulk.global.shared::cta.bulk_group), no thread touching
// the bytes, and frees the slot of the store kStoreLag stores back once
// cp.async.bulk.wait_group.read says that store has read it. In sum128 mode
// four consumer warps share the slots (slot d is warp d % 4's), each
// reducing a whole row from its lanes' registers (16-byte shared loads, 4
// columns a lane) and writing its 128 sums with one 16-byte store a lane.
// Every slot's barriers are waited on by one thread or warp in phase order,
// as parity waits need. Nothing waits at a block barrier after the mbarriers
// are set up. The TPU's [R, 8, n / 8] table layout was a workaround of its
// (8, 128) tiling and is not carried over.
//
// Every entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError().

#include <atomic>

#include "slot_row.cuh"

namespace {

using namespace docodo;

constexpr unsigned kFullMask = 0xffffffffu;

// ---------------------------------------------------------------------------
// docodo_probe_locate
// ---------------------------------------------------------------------------

constexpr int kBoundsBlock = 128;  // bounds a TwoLevel fine block
constexpr int kMaxCoarse = 1024;   // fine blocks TwoLevel stages
constexpr int kProbeThreads = 256;
constexpr int kProbeScans = 5;     // scans that cross the warps of a row

// #{j < m: s(k, j) <= v[k]} for each of a thread's four values (m >= 1),
// the four searches halving in lock step: every search takes the same
// sequence of lengths (Khuong and Morin's branchless form), so a round
// issues four independent loads.
template <class Load>
__device__ inline void upper_bound4(const Load& at, int m, const int (&v)[4],
                                    int (&c)[4]) {
  int b[4] = {0, 0, 0, 0};
  for (int len = m; len > 1;) {
    const int half = len >> 1;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (at(k, b[k] + half) <= v[k]) b[k] += half;
    len -= half;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) c[k] = b[k] + (at(k, b[k]) <= v[k] ? 1 : 0);
}

struct BoundsSearch {
  static constexpr int kStage = 1;  // nothing staged
  const int* bounds;
  int p;
  __device__ void operator()(const int (&v)[4], const int*,
                             int (&pg)[4]) const {
    const int* __restrict__ b = bounds;
    upper_bound4([&](int, int i) { return __ldg(b + i); }, p, v, pg);
#pragma unroll
    for (int k = 0; k < 4; ++k) pg[k] = pg[k] < p - 1 ? pg[k] : p - 1;
  }
};

// v / page_len for 0 <= v < 2^31 as (v * mul) >> shift, exact
// (Granlund and Montgomery: mul = ceil(2^shift / page_len), shift = 31 +
// ceil(log2 page_len)); a negative v divides as C does.
struct Arith {
  static constexpr int kStage = 1;  // nothing staged
  int page_len;
  int p;
  unsigned long long mul;
  int shift;
  static Arith of(int page_len, int p) {
    int l = 0;
    while ((1ll << l) < page_len) ++l;
    const unsigned long long two = 1ull << (31 + l);
    return Arith{page_len, p, (two + page_len - 1) / page_len, 31 + l};
  }
  __device__ void operator()(const int (&v)[4], const int*,
                             int (&pg)[4]) const {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int q = v[k] >= 0
                        ? (int)(((unsigned long long)v[k] * mul) >> shift)
                        : v[k] / page_len;
      pg[k] = q < p - 1 ? q : p - 1;
    }
  }
};

struct TwoLevel {
  static constexpr int kStage = kMaxCoarse;
  const int* bounds;
  int p;
  __device__ int blocks() const {
    return (p + kBoundsBlock - 1) / kBoundsBlock;
  }
  // coarse[c] = the last bound of fine block c; the whole block stages it
  __device__ void stage(int* coarse) const {
    const int c_n = blocks();
    for (int c = threadIdx.x; c < c_n; c += blockDim.x) {
      const int last = (c + 1) * kBoundsBlock - 1;
      coarse[c] = bounds[last < p - 1 ? last : p - 1];
    }
  }
  // every bound of the blocks before c is <= v, and the last of block c is
  // not: the page is c's first bound past v, found among its 128 bounds
  // (INF32 past the table, which no value of such a lane reaches)
  __device__ void operator()(const int (&v)[4], const int* coarse,
                             int (&pg)[4]) const {
    const int c_n = blocks();
    int c[4], lo[4], f[4];
    upper_bound4([&](int, int i) { return coarse[i]; }, c_n, v, c);
#pragma unroll
    for (int k = 0; k < 4; ++k) lo[k] = c[k] * kBoundsBlock;
    const int* __restrict__ b = bounds;
    const int last = p;
    upper_bound4(
        [&](int k, int i) {
          const int j = lo[k] + i;
          return j < last ? __ldg(b + j) : kInf;
        },
        kBoundsBlock, v, f);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int g = lo[k] + f[k];
      pg[k] = c[k] >= c_n || g >= p - 1 ? p - 1 : g;
    }
  }
};

__device__ inline int shfl_up(int x, int d) {
  return __shfl_up_sync(kFullMask, x, d);
}
__device__ inline int shfl_down(int x, int d) {
  return __shfl_down_sync(kFullMask, x, d);
}
__device__ inline int shfl_at(int x, int src) {
  return __shfl_sync(kFullMask, x, src);
}
__device__ inline int2 shfl_up(int2 x, int d) {
  return make_int2(shfl_up(x.x, d), shfl_up(x.y, d));
}
__device__ inline int2 shfl_down(int2 x, int d) {
  return make_int2(shfl_down(x.x, d), shfl_down(x.y, d));
}
__device__ inline int2 shfl_at(int2 x, int src) {
  return make_int2(shfl_at(x.x, src), shfl_at(x.y, src));
}

// Scan over the threads of the row group g of one value a thread (the
// aggregate of its lanes): the exclusive prefix from the row's start, or
// with kBack the exclusive suffix from its end. op(a, b) combines a
// stretch a with the stretch b right after it and has `id` as its
// identity on both sides. *total receives the whole row's. A warp scans by
// shuffles; the warps of a wider row then exchange their totals through
// xch (one entry a warp, a region of its own for each scan of the row)
// behind one barrier of the row.
template <bool kBack, class Grp, class V, class Op>
__device__ V thread_scan(const Grp& g, V x, V id, const Op& op, V* xch,
                         V* total) {
  constexpr int W = Grp::kThreads / 32;
  const int lane = g.rank() & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    if (kBack) {
      const V y = shfl_down(x, d);
      if (lane + d < 32) x = op(x, y);
    } else {
      const V y = shfl_up(x, d);
      if (lane >= d) x = op(y, x);
    }
  }
  V ex = kBack ? shfl_down(x, 1) : shfl_up(x, 1);
  if (lane == (kBack ? 31 : 0)) ex = id;
  if constexpr (W == 1) {
    *total = shfl_at(x, kBack ? 0 : 31);
    return ex;
  } else {
    const int warp = g.rank() >> 5;
    if (lane == (kBack ? 0 : 31)) xch[warp] = x;
    g.sync();
    V before = id, after = id, all = id;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const V t = xch[w];
      if (w < warp) before = op(before, t);
      if (w > warp) after = op(after, t);
      all = op(all, t);
    }
    *total = all;
    return kBack ? op(ex, after) : op(before, ex);
  }
}

// The thread's four lanes x[0..3] replaced by their prefixes over the row
// (inclusive, or exclusive), or with kBack by their inclusive suffixes.
// Returns the whole row's.
template <bool kBack, bool kIncl, class Grp, class V, class Op>
__device__ V lane_scan(const Grp& g, V (&x)[4], V id, const Op& op,
                       V* xch) {
  V total;
  if (kBack) {
    V run = thread_scan<true>(g, op(x[0], op(x[1], op(x[2], x[3]))), id, op,
                              xch, &total);
#pragma unroll
    for (int k = 3; k >= 0; --k) {
      run = op(x[k], run);
      x[k] = run;
    }
  } else {
    V run = thread_scan<false>(g, op(op(op(x[0], x[1]), x[2]), x[3]), id, op,
                               xch, &total);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const V v = x[k];
      if (kIncl) {
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

// Segmented scans packed in one int: a value in the bits under kHead,
// kHead where a lane opens a segment, kOpen (backward only) where a
// stretch holds no segment start after its first lane. kSum adds the
// values, else ORs them.
constexpr int kHead = 1 << 29;
constexpr int kOpen = 1 << 30;
constexpr int kVal = kHead - 1;
constexpr int kEmpty = -1;  // the backward identity

template <bool kSum>
__device__ inline int seg_add(int a, int b) {
  return kSum ? (a & kVal) + (b & kVal) : (a | b) & kVal;
}

// Forward: a stretch's value over its lanes from its last segment start
// (or its first lane) on. Inclusive at lane l: over [its segment's start,
// l].
template <bool kSum>
struct FwdSeg {
  __device__ int operator()(int a, int b) const {
    const int v = (b & kHead) ? (b & kVal) : seg_add<kSum>(a, b);
    return v | ((a | b) & kHead);
  }
};

// Backward: a stretch's value over its lanes from its first lane up to
// the next segment start. Inclusive from the row's end at lane l: over
// [l, the next segment start after l).
template <bool kSum>
struct BackSeg {
  __device__ int operator()(int a, int b) const {
    if (a == kEmpty) return b;
    if (b == kEmpty) return a;
    if (!(a & kOpen) || (b & kHead)) return a & ~kOpen;
    return seg_add<kSum>(a, b) | (a & kHead) | (b & kOpen);
  }
};

// The last kept lane's (value, page) before a lane (x = INF32: none).
struct LastKept {
  __device__ int2 operator()(int2 a, int2 b) const {
    return b.x != kInf ? b : a;
  }
};

// A run's lanes (bits 0-10) and bonus (bits 11-23) summed backward from
// its first lane, as a BackSeg<true>; y counts the runs (bits 0-15) and
// the kept lanes (bits 16-31).
struct RunSums {
  __device__ int2 operator()(int2 a, int2 b) const {
    return make_int2(BackSeg<true>()(a.x, b.x), a.y + b.y);
  }
};
constexpr int kCountBits = 11;  // a row's lanes, <= 1024

// 30 / max(5, gap) by compares: 6 at gaps up to 5, 5 at 6, 4 at 7, 3 at
// 8-10, 2 at 11-15, 1 at 16-30, 0 past 30.
__device__ inline int run_bonus(int gap) {
  return gap <= 5    ? 6
         : gap <= 6  ? 5
         : gap <= 7  ? 4
         : gap <= 10 ? 3
         : gap <= 15 ? 2
         : gap <= 30 ? 1
                     : 0;
}

// A row's inputs as one thread of its group holds them: its 4 lanes
// (INF32 / tag 2 past the row, which the rules below treat as the row's
// own padding), the lanes either side of a warp's (loaded only by its
// first and last lanes: the others get theirs by shuffle), the windows.
struct ProbeIn {
  int v[4], tg[4];
  int pv, nv, nt;
  int r1, r2;
};

// Issue the loads of row `row` into `in` (nothing waits for them here).
__device__ inline void probe_load(const int* __restrict__ vals,
                                  const int* __restrict__ tags,
                                  const int* __restrict__ ra,
                                  const int* __restrict__ rb, size_t row,
                                  int n, int base, int lane, bool vec,
                                  ProbeIn& in) {
  const size_t o = row * n;
  in.r1 = ra[row];
  in.r2 = rb[row];
  if (base < n) {
    load4(vals + o, base, n, vec, in.v);
    load4(tags + o, base, n, vec, in.tg);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (base + k >= n) in.tg[k] = 2;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      in.v[k] = kInf;
      in.tg[k] = 2;
    }
  }
  in.pv = in.nv = kInf;
  in.nt = 2;
  if (lane == 0 && base > 0 && base - 1 < n) in.pv = vals[o + base - 1];
  if (lane == 31 && base + 4 < n) {
    in.nv = vals[o + base + 4];
    in.nt = tags[o + base + 4];
  }
}

// One row's body: the thread's 4 lanes of row `row` from `in`, every
// output of those lanes written, npages / nhits by the group's first
// thread. Called by every thread of the row group g.
template <class Page, class Grp, int W>
__device__ void probe_row(const Grp& g, const ProbeIn& in, size_t row, int n,
                          bool vec, const Page& page, const int* staged,
                          int4 (&xch)[kProbeScans][W],
                          int* __restrict__ page_out,
                          float* __restrict__ rank_out,
                          float* __restrict__ cnt_out,
                          int* __restrict__ npages, int* __restrict__ nhits,
                          int* __restrict__ hits) {
  const int t = g.rank();
  const int lane = t & 31;
  const int base = 4 * t;
  const size_t o = row * n;
  const int(&v)[4] = in.v;
  const int(&tg)[4] = in.tg;
  int pv = shfl_up(v[3], 1);
  int nv = shfl_down(v[0], 1);
  int nt = shfl_down(tg[0], 1);
  if (lane == 0) pv = base == 0 ? -1 : in.pv;  // none, or the last warp's
  if (lane == 31) {  // the next warp's, or none
    nv = in.nv;
    nt = in.nt;
  }
  int pg[4];
  page(v, staged, pg);

  // the AND over the merged row (pallas_query._sorted_and_keep, as
  // tagged_keep): cross-operand duplicates fold onto their first lane,
  // gaps wider than |R| cut segments, and a segment keeps its lanes only
  // if it holds both words
  const int abs_r = max(abs(in.r1), abs(in.r2));
  bool isa[4], isb[4], eff[4], seg[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int l = base + k;
    const int pvk = k ? v[k - 1] : pv;
    const int nvk = k < 3 ? v[k + 1] : nv;
    const int ntk = k < 3 ? tg[k + 1] : nt;
    const bool valid = v[k] < kInf;
    const bool dup_prev = valid && v[k] == pvk;
    const bool dup_next = valid && v[k] == nvk;
    const bool a_next = nvk < kInf && ntk == 0;
    const bool b_next = nvk < kInf && ntk == 1;
    isa[k] = ((valid && tg[k] == 0) || (dup_next && a_next)) && !dup_prev;
    isb[k] = ((valid && tg[k] == 1) || (dup_next && b_next)) && !dup_prev;
    eff[k] = valid && !dup_prev;
    const int gap = v[k] - (l == 0 ? 0 : pvk);
    seg[k] = l == 0 || (abs_r != 0 && gap > abs_r && valid);
  }
  if (in.r1 < 0 && in.r2 < 0) {
    // ordered: a gap segment's first word-A mark opens a segment too,
    // unless it opens one already (no word-A mark before it in its gap
    // segment: the exclusive segmented OR of the marks)
    int before[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      before[k] = (isa[k] ? 1 : 0) | (seg[k] ? kHead : 0);
    lane_scan<false, false>(g, before, 0, FwdSeg<false>(), &xch[0][0].x);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (!seg[k] && isa[k] && !(before[k] & 1)) seg[k] = true;
  }
  // each segment's marks, OR-ed forward to a lane and backward from it
  int fwd[4], back[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    fwd[k] = (isa[k] ? 1 : 0) | (isb[k] ? 2 : 0) | (seg[k] ? kHead : 0);
    back[k] = fwd[k] | kOpen;
  }
  lane_scan<false, true>(g, fwd, 0, FwdSeg<false>(), &xch[1][0].x);
  lane_scan<true, true>(g, back, kEmpty, BackSeg<false>(), &xch[2][0].x);
  bool keep[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    keep[k] = eff[k] && ((fwd[k] | back[k]) & 3) == 3;

  // page runs (sum_runs): a run starts at a kept lane whose page differs
  // from the previous kept lane's, each later lane adds 30 / max(5, gap)
  int2 prev[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    prev[k] = keep[k] ? make_int2(v[k], pg[k]) : make_int2(kInf, 0);
  lane_scan<false, false>(g, prev, make_int2(kInf, 0), LastKept(),
                          reinterpret_cast<int2*>(&xch[3][0]));
  bool first[4];
  int2 sums[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const bool has = prev[k].x != kInf;
    first[k] = keep[k] && pg[k] != (has ? prev[k].y : -1);
    const int gap = has ? v[k] - prev[k].x : 0;
    const int bonus = keep[k] && !first[k] ? run_bonus(gap) : 0;
    sums[k] = make_int2((keep[k] ? 1 : 0) | (bonus << kCountBits) |
                            (first[k] ? kHead : 0) | kOpen,
                        (first[k] ? 1 : 0) | (keep[k] ? 1 << 16 : 0));
  }
  const int2 runs = lane_scan<true, true>(
      g, sums, make_int2(kEmpty, 0), RunSums(),
      reinterpret_cast<int2*>(&xch[4][0]));

  if (base < n) {
    float rk[4], ct[4];
    int ht[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int s = sums[k].x & kVal;
      const int c = s & ((1 << kCountBits) - 1);
      rk[k] = first[k] ? run_rank(s >> kCountBits, c) : 0.0f;
      ct[k] = first[k] ? (float)c : 0.0f;
      ht[k] = keep[k] ? v[k] : kInf;
    }
    if (vec) {
      store4(page_out + o + base, pg);
      store4(hits + o + base, ht);
      *reinterpret_cast<float4*>(rank_out + o + base) =
          make_float4(rk[0], rk[1], rk[2], rk[3]);
      *reinterpret_cast<float4*>(cnt_out + o + base) =
          make_float4(ct[0], ct[1], ct[2], ct[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (base + k < n) {
          page_out[o + base + k] = pg[k];
          hits[o + base + k] = ht[k];
          rank_out[o + base + k] = rk[k];
          cnt_out[o + base + k] = ct[k];
        }
      }
    }
  }
  if (t == 0) {
    npages[row] = runs.y & 0xffff;
    nhits[row] = runs.y >> 16;
  }
}

// One row a row group. A launch of 128-lane rows at the probe's 5,952
// rows is 744 blocks: six blocks an SM (at most 40 registers a thread)
// hold it in one wave.
template <class Page, int N>
__global__ void __launch_bounds__(kProbeThreads, N == 128 ? 6 : 1)
    probe_locate_kernel(
    const int* __restrict__ vals, const int* __restrict__ tags,
    const int* __restrict__ ra, const int* __restrict__ rb, int rows, int n,
    Page page, int* __restrict__ page_out, float* __restrict__ rank_out,
    float* __restrict__ cnt_out, int* __restrict__ npages,
    int* __restrict__ nhits, int* __restrict__ hits, bool vec) {
  constexpr int G = N / 4;  // threads a row, 4 lanes each
  constexpr int W = G / 32;
  constexpr int R = kProbeThreads / G;
  __shared__ int staged[Page::kStage];
  __shared__ int4 xch_all[W > 1 ? R : 1][kProbeScans][W];
  if constexpr (Page::kStage > 1) {
    page.stage(staged);
    __syncthreads();
  }
  const GroupRow<G> g{};
  const size_t row = g.row();
  if (row >= (size_t)rows) return;  // the last block's spare groups
  ProbeIn in;
  probe_load(vals, tags, ra, rb, row, n, 4 * g.rank(), g.rank() & 31, vec,
             in);
  probe_row(g, in, row, n, vec, page, staged,
            xch_all[W > 1 ? g.group() : 0], page_out, rank_out, cnt_out,
            npages, nhits, hits);
}

template <class Page>
int launch_probe(const int* vals, const int* tags, const int* ra,
                 const int* rb, int rows, int n, const Page& page,
                 int* page_out, float* rank_out, float* cnt_out, int* npages,
                 int* nhits, int* hits, void* stream) {
  // 16-byte loads and stores where every row starts on 16 bytes
  const bool vec = n % 4 == 0 && aligned16(vals) && aligned16(tags) &&
                   aligned16(page_out) && aligned16(rank_out) &&
                   aligned16(cnt_out) && aligned16(hits);
  return with_width(n, [&](auto w) {
    constexpr int N = decltype(w)::value;
    constexpr int R = kProbeThreads / (N / 4);
    if (rows > 0)
      probe_locate_kernel<Page, N>
          <<<(rows + R - 1) / R, kProbeThreads, 0, (cudaStream_t)stream>>>(
              vals, tags, ra, rb, rows, n, page, page_out, rank_out, cnt_out,
              npages, nhits, hits, vec);
    return (int)cudaGetLastError();
  });
}

// ---------------------------------------------------------------------------
// docodo_row_gather
// ---------------------------------------------------------------------------

constexpr int kGatherSmem = 96 * 1024;  // the ring's bytes, past one slot
constexpr int kMaxDepth = 128;          // the ring's slots at most (q)
constexpr int kSumWarps = 4;            // sum128's consumer warps
constexpr int kStoreLag = 6;            // copy: stores in flight a block

__device__ inline uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ inline void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ inline void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ inline bool mbar_try_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.b32 %0, 1, 0, P1;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the barrier's phase of this parity has completed.
__device__ inline void mbar_wait(uint64_t* bar, unsigned parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// Arrive on the slot's barrier expecting `bytes`, and copy them from
// global memory into the slot by one bulk copy that completes them.
__device__ inline void bulk_load(void* dst, const void* src, unsigned bytes,
                                 uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Copy `bytes` of shared memory to global memory by one bulk copy, in a
// bulk group of its own.
__device__ inline void bulk_store(void* dst, const void* src,
                                  unsigned bytes) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(dst), "r"(smem_addr(src)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until at most `pending` (0..N) of this thread's bulk groups have
// not yet read their shared memory.
template <int N = kStoreLag>
__device__ inline void bulk_wait_read(int pending) {
  if constexpr (N > 0) {
    if (pending < N) return bulk_wait_read<N - 1>(pending);
  }
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

template <bool kCopy>
constexpr int gather_threads() {
  return 32 * (1 + (kCopy ? 1 : kSumWarps));
}

template <bool kCopy>
__global__ void __launch_bounds__(gather_threads<kCopy>()) row_gather_kernel(
    const int* __restrict__ tab, const int* __restrict__ ids, int rows,
    int n, int depth, int* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char ring_raw[];
  __shared__ __align__(8) uint64_t full[kMaxDepth];
  __shared__ __align__(8) uint64_t empty[kMaxDepth];
  int* ring = reinterpret_cast<int*>(ring_raw);
  // this block's share of the ids: [first, first + count)
  const int per = rows / (int)gridDim.x;
  const int extra = rows % (int)gridDim.x;
  const int bid = (int)blockIdx.x;
  const int first = bid * per + (bid < extra ? bid : extra);
  const int count = per + (bid < extra ? 1 : 0);
  const unsigned bytes = (unsigned)n * 4u;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int d = 0; d < depth; ++d) {
      mbar_init(&full[d], 1);
      mbar_init(&empty[d], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == 0) {
    // the producer: the warp reads the next 32 ids while lane 0 issues
    // the current 32 rows' loads, each into a slot the consumer freed
    int next = lane < count ? ids[first + lane] : 0;
    for (int j0 = 0; j0 < count; j0 += 32) {
      const int here = next;
      if (j0 + 32 + lane < count) next = ids[first + j0 + 32 + lane];
      const int m = count - j0 < 32 ? count - j0 : 32;
      for (int k = 0; k < m; ++k) {
        const int id = shfl_at(here, k);
        if (lane == 0) {
          const int j = j0 + k;
          const int d = j % depth;
          if (j >= depth) mbar_wait(&empty[d], (unsigned)(j / depth - 1) & 1u);
          bulk_load(ring + (size_t)d * n, tab + (size_t)id * n, bytes,
                    &full[d]);
        }
      }
    }
  } else if (kCopy) {
    if (lane != 0) return;
    // the consumer: each full slot goes straight back out; the slot of
    // the store `lag` stores back is freed once that store has read it
    const int lag = depth - 1 < kStoreLag ? depth - 1 : kStoreLag;
    for (int j = 0; j < count; ++j) {
      const int d = j % depth;
      mbar_wait(&full[d], (unsigned)(j / depth) & 1u);
      bulk_store(out + (size_t)(first + j) * n, ring + (size_t)d * n, bytes);
      if (j >= lag) {
        bulk_wait_read(lag);
        mbar_arrive(&empty[(j - lag) % depth]);
      }
    }
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  } else {
    // sum128: consumer warp c owns the slots d = c, c + kSumWarps, ...
    // and reduces their rows whole, round after round of the ring, 4
    // columns a lane, freeing each slot as it finishes. One warp a slot
    // waits for the slot's phases in order, which a parity wait needs:
    // a warp two phases behind would take an older phase for its own.
    const int n4 = n / 4;
    for (int j0 = 0; j0 < count; j0 += depth) {
      for (int d = warp - 1; d < depth && j0 + d < count; d += kSumWarps) {
        const int j = j0 + d;
        mbar_wait(&full[d], (unsigned)(j / depth) & 1u);
        const int4* src =
            reinterpret_cast<const int4*>(ring + (size_t)d * n);
        unsigned a0 = 0, a1 = 0, a2 = 0, a3 = 0;
#pragma unroll 4
        for (int i = lane; i < n4; i += 32) {
          const int4 x = src[i];
          a0 += (unsigned)x.x;
          a1 += (unsigned)x.y;
          a2 += (unsigned)x.z;
          a3 += (unsigned)x.w;
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[d]);
        *reinterpret_cast<int4*>(out + (size_t)(first + j) * 128 +
                                 4 * lane) =
            make_int4((int)a0, (int)a1, (int)a2, (int)a3);
      }
    }
  }
}

// The launch of row_gather over `rows` ids of n lanes: the ring's depth
// and the grid, min(rows, the blocks resident at once by the occupancy
// API); a CUDA error code, or 0.
template <bool kCopy>
int gather_shape(int rows, int n, int q, int* depth, int* grid) {
  static std::atomic<unsigned> sized{0};
  if (n * 4 > kGatherSmem) return (int)cudaErrorInvalidValue;
  const int fit = kGatherSmem / (n * 4);
  *depth = fit < 1 ? 1 : fit < q ? fit : q;
  cudaError_t e = size_smem(row_gather_kernel<kCopy>, kGatherSmem, &sized);
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, row_gather_kernel<kCopy>, gather_threads<kCopy>(),
        (size_t)*depth * n * 4);
  if (e != cudaSuccess) return (int)e;
  if (sms * per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *grid = rows < sms * per_sm ? rows : sms * per_sm;
  return 0;
}

template <bool kCopy>
int launch_gather(const int* tab, const int* ids, int rows, int n, int q,
                  int* out, void* stream) {
  int depth = 0, grid = 0;
  const int e = gather_shape<kCopy>(rows, n, q, &depth, &grid);
  if (e) return e;
  if (rows > 0)
    row_gather_kernel<kCopy><<<grid, gather_threads<kCopy>(),
                               (size_t)depth * n * 4, (cudaStream_t)stream>>>(
        tab, ids, rows, n, depth, out);
  return (int)cudaGetLastError();
}

}  // namespace

// policy: 0 BoundsSearch, 1 Arith (page_len), 2 TwoLevel (p <= 131072).
extern "C" int docodo_probe_locate(
    const int* vals, const int* tags, const int* ra, const int* rb,
    const int* bounds, int p, int page_len, int policy, int rows, int n,
    int* page_out, float* rank_out, float* cnt_out, int* npages, int* nhits,
    int* hits, void* stream) {
  if (n <= 0 || n > kSlotLanes || p <= 0) return (int)cudaErrorInvalidValue;
  if (policy == 0) {
    BoundsSearch pg{bounds, p};
    return launch_probe(vals, tags, ra, rb, rows, n, pg, page_out, rank_out,
                        cnt_out, npages, nhits, hits, stream);
  }
  if (policy == 1) {
    if (page_len <= 0) return (int)cudaErrorInvalidValue;
    const Arith pg = Arith::of(page_len, p);
    return launch_probe(vals, tags, ra, rb, rows, n, pg, page_out, rank_out,
                        cnt_out, npages, nhits, hits, stream);
  }
  if (policy == 2) {
    if (p > kMaxCoarse * kBoundsBlock) return (int)cudaErrorInvalidValue;
    TwoLevel pg{bounds, p};
    return launch_probe(vals, tags, ra, rb, rows, n, pg, page_out, rank_out,
                        cnt_out, npages, nhits, hits, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// mode: 0 copy (out [rows, n], n % 4 == 0), 1 sum128 (out [rows, 128],
// n % 128 == 0); q: the ring's depth a block at most, 32, 64 or 128;
// n * 4 <= 96 KB. The table and out are 16-byte aligned.
extern "C" int docodo_row_gather(const int* tab, const int* ids, int n,
                                 int rows, int q, int mode, int* out,
                                 void* stream) {
  if (n <= 0 || n % 4 != 0 || (mode == 1 && n % 128 != 0) ||
      (mode != 0 && mode != 1) || !aligned16(tab) || !aligned16(out) ||
      (q != 32 && q != 64 && q != 128))
    return (int)cudaErrorInvalidValue;
  if (mode == 0) return launch_gather<true>(tab, ids, rows, n, q, out, stream);
  return launch_gather<false>(tab, ids, rows, n, q, out, stream);
}
