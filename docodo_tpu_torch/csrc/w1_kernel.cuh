// The W = 1 slot kernel of docodo_tpu_torch (sm_90a): one template on the
// keep rule, the tail and the page source, shared by locate_full.cu and
// variants.cu. It serves these rows of PERF.md's table (TPU kernels of
// docodo_tpu/ops/pallas_query.py):
//
//   row 2   docodo_single_locate_full       <- _single_word_full_slots_kernel
//                                              (:723), SingleKeep, SlotsTail
//   row 15d docodo_single_locate_full_topk  <- _single_word_full_kernel
//                                              (:218), SingleKeep, TopkTail
//   row 3   docodo_union_locate_full        <- _union_locate_full_slots_kernel
//                                              (:660) at V = 1, UnionKeep,
//                                              SlotsTail
//   row 15c docodo_union_locate_full_topk   <- _union_locate_full_kernel
//           at V = 1 (variants.cu)             (:550) at V = 1, UnionKeep,
//                                              TopkTail
//   row 14  docodo_single_locate_topk       <- _single_word_kernel (:200),
//                                              SingleKeep, PageTopkTail,
//                                              pages carried or looked up
//
// What bounds it on this card: bytes (a row read once, 8 bytes a valid
// lane, or 4 with the pages looked up; the outputs written once). A
// launch of at most one wave takes one row's latency, so the design
// keeps that short: the row in shared memory sized to the stream width,
// a thread's values and pages in one load before any barrier, the keep
// from registers, and for a plain word (a prefix of the row) no scan.

#pragma once

#include "slot_row.cuh"

namespace docodo {

// The W = 1 kernel's keep rules (in docodo, so that a profiler's kernel
// names spell them): a plain word keeps its block's first na lanes, a
// prefix of the row; a V = 1 union keeps a lane where it is valid and
// differs from the lane before it.
struct SingleKeep {
  static constexpr bool kPrefix = true;
};
struct UnionKeep {
  static constexpr bool kPrefix = false;
};

}  // namespace docodo

namespace {

using namespace docodo;

// W = 1 at stream width N (cap <= N), a row group of G threads (N: a lane
// a thread, or N / 4), each row in its own RowSmem<N>: thread t owns lanes
// t ipt .. t ipt + ipt - 1 (ipt = ceil(cap / G)). A thread loads its
// lanes' values and pages together, 16 bytes each where it owns a quad of
// a row that allows it, and finds its keep in registers: a union lane
// compares with the lane before it, which is this thread's, the previous
// thread's (a shuffle), or at a warp's first thread that lane once more
// from the block in device memory, so no barrier comes before the tail.
// With kLookup the block comes without a page stream and a lane's page is
// page_of_coord(bounds, p_bounds, v), found in registers after the value
// load (row 14 without carried pages); bounds and p_bounds come last, so
// that the forms with carried pages keep their parameters' places. Its
// lanes go to shared memory as they came (a quad in one 16-byte store;
// the tails read kept lanes only); with SingleKeep the tail knows the
// kept lanes are the row's first na (Tail::run<true>: no scan finds them,
// no compaction writes the hits).
template <class Keep, class Tail, int N, int G, bool kLookup = false>
__global__ void __launch_bounds__(SlotShape<N, RowSmem<N>, G>::kThreads)
    w1_locate_full_kernel(const int* __restrict__ a,
                          const int* __restrict__ a_pg,
                          const int* __restrict__ na_, int rows, int cap,
                          Tail tail, const int* __restrict__ bounds,
                          int p_bounds) {
  using S = SlotShape<N, RowSmem<N>, G>;
  constexpr int L = S::kIpt;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const GroupRow<G> g{};
  if (g.row() >= (size_t)rows) return;  // the last block's spare groups
  RowSmem<N>& s = reinterpret_cast<RowSmem<N>*>(smem_raw)[g.group()];
  const size_t row = g.row();
  const int na = clamp_len(na_[row], cap);
  const int* arow = a + row * cap;
  const int* prow = kLookup ? nullptr : a_pg + row * cap;
  const int ipt = (cap + G - 1) / G;
  const int base = g.rank() * ipt;
  int v[L], pg[L];
  bool vec = false;
  if constexpr (L == 4)
    vec = ipt == 4 && cap % 4 == 0 && aligned16(arow) && aligned16(prow);
  if (vec) {
    if constexpr (L == 4) {
      if (base < na) {
        load4(arow, base, 0, true, v);
        if constexpr (!kLookup) load4(prow, base, 0, true, pg);
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < L; ++k) {
      const int l = base + k;
      if (k < ipt && l < na) {
        v[k] = arow[l];
        if constexpr (!kLookup) pg[k] = prow[l];
      }
    }
  }
  if constexpr (kLookup) {
#pragma unroll
    for (int k = 0; k < L; ++k)
      pg[k] = k < ipt && base + k < na
                  ? page_of_coord(bounds, p_bounds, v[k]) : 0;
  }
  bool keep[L];
#pragma unroll
  for (int k = 0; k < L; ++k) {
    keep[k] = k < ipt && base + k < na;
    if (!keep[k]) v[k] = kInf;
  }
  if constexpr (!Keep::kPrefix) {
    int last = v[0];
#pragma unroll
    for (int k = 1; k < L; ++k)
      if (k < ipt) last = v[k];
    int before = __shfl_up_sync(0xffffffffu, last, 1);
    if ((g.rank() & 31) == 0)
      before = base > 0 && base < na ? arow[base - 1] : -1;
#pragma unroll
    for (int k = 0; k < L; ++k) {
      keep[k] = keep[k] && v[k] != before;
      before = v[k];
    }
  }
  if (vec) {
    if constexpr (L == 4) {
      if (base < na) {
        store4(s.val + base, v);
        store4(s.page + base, pg);
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < L; ++k) {
      if (keep[k]) {
        s.val[base + k] = v[k];
        s.page[base + k] = pg[k];
      }
    }
  }
  tail.template run<Keep::kPrefix>(g, s, keep, cap, ipt, na);
}

template <class Keep, bool kLookup>
struct W1Launch {
  template <class Tail, int N, int G>
  struct At {
    using Shape = SlotShape<N, RowSmem<N>, G>;
    static auto kernel() {
      return w1_locate_full_kernel<Keep, Tail, N, G, kLookup>;
    }
    static int run(int rows, const int* a, const int* a_pg, const int* na,
                   int cap, Tail tail, const int* bounds, int p_bounds,
                   void* stream) {
      if (rows > 0)
        w1_locate_full_kernel<Keep, Tail, N, G, kLookup>
            <<<Shape::blocks(rows), Shape::kThreads, Shape::kSmem,
               (cudaStream_t)stream>>>(a, a_pg, na, rows, cap, tail, bounds,
                                       p_bounds);
      return (int)cudaGetLastError();
    }
  };
};

// The W = 1 kernel at the narrowest width N that holds cap lanes, in the
// launch shape its rows take (launch_by_rows), with the pages of a_pg or,
// with kLookup, looked up in `bounds` [p_bounds].
template <class Keep, bool kLookup = false, class Tail>
int launch_w1(const int* a, const int* a_pg, const int* na, int rows,
              int cap, const Tail& tail, void* stream,
              const int* bounds = nullptr, int p_bounds = 0) {
  if (cap <= 0 || cap > kSlotLanes || (kLookup ? p_bounds <= 0 : !a_pg))
    return (int)cudaErrorInvalidValue;
  return launch_by_rows<W1Launch<Keep, kLookup>::template At, Tail>(
      cap, rows, a, a_pg, na, cap, tail, bounds, p_bounds, stream);
}

}  // namespace
