// Full-result locate/rank kernels of docodo_tpu_torch, for Hopper (sm_90a).
//
// They replace these Pallas TPU kernels of docodo_tpu/ops/pallas_query.py:
//
//   docodo_sorted_and_locate_full  <- _sorted_and_locate_full_slots_kernel
//                                     (pallas_query.py:617), W = 2, cap <= 512
//   docodo_single_locate_full      <- _single_word_full_slots_kernel
//                                     (pallas_query.py:723), W = 1, cap <= 128
//   docodo_union_locate_full       <- _union_locate_full_slots_kernel
//                                     (pallas_query.py:660), W = 1, V = 1,
//                                     cap <= 1024
//   docodo_merge_and_locate_topk   <- _merge_and_locate_topk_kernel
//                                     (pallas_query.py:2623), W = 2,
//                                     2 * cap <= 4096
//   docodo_sorted_and_locate_full_topk <- _sorted_and_locate_full_kernel
//                                     (pallas_query.py:498), W = 2, cap <= 512
//   docodo_single_locate_full_topk <- _single_word_full_kernel
//                                     (pallas_query.py:218), W = 1, cap <= 128
//   docodo_merge_and_locate        <- _merge_and_locate_kernel
//                                     (pallas_query.py:2601), W = 2,
//                                     2 * cap <= 4096
//   docodo_and_locate_topk         <- _sorted_and_locate_kernel
//                                     (pallas_query.py:477), W = 2, cap <= 512,
//                                     and _and_locate_kernel
//                                     (pallas_query.py:133), the same
//                                     function with a compare-all merge
//                                     inside and no page streams
//   docodo_single_locate_topk      <- _single_word_kernel
//                                     (pallas_query.py:200), W = 1, cap <= 128
//
// Each of the first four turns one query row into the row's first kpad page runs in
// slot order (page, rank, count), its first hpad kept hits, and the exact
// n_pages / n_hits totals. A run starts at a kept lane whose page differs
// from the previous kept lane's; each later lane of the run adds
// 30 / max(5, gap), and rank = (1 + bonus) + ln(count) in f32. The two
// _topk kernels are the same row bodies ending in the other tail
// (slot_row.cuh, TopkTail): the top k of EVERY run of the row by (rank
// descending, lane ascending), picked in the kernel by an enumeration sort,
// where the TPU kernels run topk masked-argmax passes and leave the hit
// compaction to a sort outside. merge_and_locate writes the same row body's
// streams at full width instead: the kept stream in slot order (INF32 at
// dropped lanes) and each run's page, rank and count at the run's first
// lane (-1 / 0 / 0 elsewhere); sum_runs hands it each run's first lane in
// the row's scratch array, so it needs no more shared memory than
// merge_and_locate_topk. and_locate_topk is the W = 2 slot kernel ending
// in the page-level tail (slot_row.cuh, PageTopkTail): the top k of every
// run as (page, rank, count int32) and nothing else; its pages come from
// the carried streams or, with a_pg null, from a binary search of the page
// bounds (clamped to the last page). single_locate_topk is the W = 1
// kernel (w1_kernel.cuh) ending in the same tail, its pages carried or
// looked up in the bounds likewise.
//
// What bounds them on this card: bytes, not arithmetic. Each row is read
// once (values and pages, 8 bytes a lane) and 3 * kpad + hpad + 2 values are
// written; in between, each lane costs a few dozen integer operations and
// a handful of scans. The design keeps everything between that read and
// those writes on chip: one row group per row (slot_row.cuh), each thread
// owning a few consecutive lanes, the row's values, pages and per-run sums
// in shared memory, and no intermediate in device memory. A narrow row
// cannot fill a block, and a block that waits at ~20 block-wide barriers
// for a row of 128 lanes is bound by those barriers, not by bytes: so the
// W = 2 slot kernel is compiled for stream widths N = 128, 256, 512 and
// 1024, dispatched on cap, and gives a row N / 4 threads: one warp at
// N = 128 (8 rows a block of 256 threads, warp-shuffle scans, __syncwarp),
// 2 and 4 warps at N = 256 and 512 (named barriers over the row's own
// warps) and the block at 1024, with the shared memory of N lanes a row;
// its operands and pages come in as 16-byte loads and its hits go out
// from shared memory, consecutive threads on consecutive slots. The W = 1
// kernel (w1_kernel.cuh; rows 2, 15d, 14 and 3 at V = 1: one template on
// the keep rule, the tail and the page source) is compiled for the same
// widths, each row in RowSmem<N>, and its launch shape follows its rows
// (launch_by_rows): a lane a thread when the launch fits in one wave,
// else N / 4 threads a row. The W = 2 kernels merge
// their two posting blocks by rank in shared memory, so the separate sort
// launch of the TPU route disappears. The TPU kernels' lane-roll log-step
// scans, packed scan pairs, bitonic merge network and log-shift compaction
// become one block scan (warp shuffles plus one pass over the warp totals),
// binary-search ranks and scatters at prefix-sum slots.
//
// merge_and_locate_topk and merge_and_locate are the same W = 2 body at
// up to 4096 lanes, one row a block of N / 4 threads, compiled for stream
// widths N = 2048 and 4096 and dispatched on cap, each row with AndSmem<N>
// of dynamic shared memory (51,328 and 102,528 B): a cap-1024 row takes
// half of what a cap-2048 row takes. Their launches hold 8-128 rows, fewer
// than the card's SMs, so what bounds them is not bytes but one row's
// latency in one block: two dependent reads of device memory and ~20
// barriers. A thread owns 4 lanes at both widths (1024 threads at 4096:
// fewer serial steps a thread), and the merge loads each thread's values
// and pages together, before its first barrier.
//
// Every entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError().

#include <atomic>

#include "w1_kernel.cuh"

namespace {

using namespace docodo;

// W = 2: merge_and_keep, then the row's tail (SlotsTail, TopkTail or
// PageTopkTail). Pages come from a_pg / b_pg, or with a_pg null from
// `bounds` [p_bounds].
template <class Grp, int L, int N, class Tail>
__device__ void sorted_and_body(
    const Grp& g, AndSmem<N>& sm, const int* __restrict__ a,
    const int* __restrict__ a_pg, const int* __restrict__ na_,
    const int* __restrict__ ra_, const int* __restrict__ b,
    const int* __restrict__ b_pg, const int* __restrict__ nb_,
    const int* __restrict__ rb_, const int* __restrict__ bounds,
    int p_bounds, int cap, const Tail& tail) {
  const int n = 2 * cap;
  bool keep[L];
  merge_and_keep(g, sm, a, a_pg, na_, ra_, b, b_pg, nb_, rb_, bounds,
                 p_bounds, cap, keep);
  tail.run(g, sm.row, keep, n, (n + Grp::kThreads - 1) / Grp::kThreads);
}

constexpr int kFusedLanes = 4096;  // FUSED_AND_MAX, pallas_query.py:2478

// The W = 2 slot kernel at stream width N (2 cap <= N): a row group of
// N / 4 threads, each 4 lanes, and 256 / group rows a block (8, 4, 2 and 1
// at N = 128, 256, 512, 1024), each row in its own AndSmem<N>. On an H100
// this beat one warp a row at N = 256 and two or four warps at N = 512 and
// 1024 with 8 lanes a thread (96-101 registers, 2 blocks an SM; PERF.md).
// Rows 1, 15a, 13 and 17 of PERF.md's table are this kernel with the
// slots, the top-k and the page-level tail (17: pages from bounds).
template <int N>
using W2Shape = SlotShape<N, AndSmem<N>>;

template <class Tail, int N>
__global__ void __launch_bounds__(kSlotThreads) sorted_and_locate_full_kernel(
    const int* __restrict__ a, const int* __restrict__ a_pg,
    const int* __restrict__ na_, const int* __restrict__ ra_,
    const int* __restrict__ b, const int* __restrict__ b_pg,
    const int* __restrict__ nb_, const int* __restrict__ rb_,
    const int* __restrict__ bounds, int p_bounds, int rows, int cap,
    Tail tail) {
  using S = W2Shape<N>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const GroupRow<S::kGroup> g{};
  if (g.row() >= (size_t)rows) return;  // the last block's spare groups
  auto& sm = reinterpret_cast<AndSmem<N>*>(smem_raw)[g.group()];
  sorted_and_body<GroupRow<S::kGroup>, S::kIpt>(
      g, sm, a, a_pg, na_, ra_, b, b_pg, nb_, rb_, bounds, p_bounds, cap,
      tail);
}

// The fused W = 2 kernels at stream width N = 2048 or 4096: one row a
// block of N / 4 threads, 4 lanes each, the row in AndSmem<N> of dynamic
// shared memory. Their launches hold 8-128 rows, one wave on the card, so
// a launch takes one row's time in one block; on an H100 512 and 1024
// threads beat 256 / 1024 at N = 2048 and 512 at N = 4096 (PERF.md).
template <int N>
struct FusedShape {
  static_assert(N == 2048 || N == 4096, "the fused widths");
  static constexpr int kThreads = N / 4;
  static constexpr int kIpt = 4;
  static constexpr size_t kSmem = sizeof(AndSmem<N>);
};

template <int N>
__global__ void __launch_bounds__(FusedShape<N>::kThreads)
    merge_and_locate_topk_kernel(
        const int* __restrict__ a, const int* __restrict__ a_pg,
        const int* __restrict__ na_, const int* __restrict__ ra_,
        const int* __restrict__ b, const int* __restrict__ b_pg,
        const int* __restrict__ nb_, const int* __restrict__ rb_, int cap,
        SlotsTail tail) {
  using S = FusedShape<N>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<AndSmem<N>*>(smem_raw);
  sorted_and_body<BlockRow<S::kThreads>, S::kIpt>(
      BlockRow<S::kThreads>{}, sm, a, a_pg, na_, ra_, b, b_pg, nb_, rb_,
      nullptr, 0, cap, tail);
}

// merge_and_locate_topk's row body with its streams written at full width:
// hits[l] is the value at kept lanes and INF32 elsewhere, and a run's first
// lane carries its page, rank and count.
template <int N>
__global__ void __launch_bounds__(FusedShape<N>::kThreads)
    merge_and_locate_kernel(
        const int* __restrict__ a, const int* __restrict__ a_pg,
        const int* __restrict__ na_, const int* __restrict__ ra_,
        const int* __restrict__ b, const int* __restrict__ b_pg,
        const int* __restrict__ nb_, const int* __restrict__ rb_, int cap,
        int* __restrict__ hits, int* __restrict__ page_s,
        float* __restrict__ rank_s, float* __restrict__ cnt_s) {
  using S = FusedShape<N>;
  constexpr int T = S::kThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<AndSmem<N>*>(smem_raw);
  RowSmem<N>& s = sm.row;
  const BlockRow<T> g{};
  const int tid = threadIdx.x;
  const int n = 2 * cap;
  const int ipt = (n + T - 1) / T;
  const int base = tid * ipt;
  const size_t o = (size_t)blockIdx.x * n;
  bool keep[S::kIpt];
  merge_and_keep(g, sm, a, a_pg, na_, ra_, b, b_pg, nb_, rb_, nullptr, 0,
                 cap, keep);
  // every run's sums, and its first lane in s.tmp
  const int runs = sum_runs(g, s, keep, n, ipt, n, s.tmp);
  for (int l = tid; l < n; l += T) {
    page_s[o + l] = -1;
    rank_s[o + l] = 0.0f;
    cnt_s[o + l] = 0.0f;
  }
#pragma unroll
  for (int k = 0; k < S::kIpt; ++k) {
    const int l = base + k;
    if (k < ipt && l < n) hits[o + l] = keep[k] ? s.val[l] : kInf;
  }
  // the run starts overwrite what other threads wrote above
  __syncthreads();
  for (int r = tid; r < runs; r += T) {
    const int l = s.tmp[r];
    const int c = s.run_count[r];
    page_s[o + l] = s.run_page[r];
    rank_s[o + l] = run_rank(s.run_bonus[r], c);
    cnt_s[o + l] = (float)c;
  }
}

template <int N, class Tail>
int launch_w2(const int* a, const int* a_pg, const int* na, const int* ra,
              const int* b, const int* b_pg, const int* nb, const int* rb,
              const int* bounds, int p_bounds, int rows, int cap,
              const Tail& tail, void* stream) {
  using S = W2Shape<N>;
  if (rows > 0)
    sorted_and_locate_full_kernel<Tail, N>
        <<<S::blocks(rows), S::kThreads, S::kSmem, (cudaStream_t)stream>>>(
            a, a_pg, na, ra, b, b_pg, nb, rb, bounds, p_bounds, rows, cap,
            tail);
  return (int)cudaGetLastError();
}

// The W = 2 slot kernel at the narrowest width N that holds 2 cap lanes,
// with pages from a_pg / b_pg or, with a_pg null, from `bounds`.
template <class Tail>
int launch_sorted_and(const int* a, const int* a_pg, const int* na,
                      const int* ra, const int* b, const int* b_pg,
                      const int* nb, const int* rb, const int* bounds,
                      int p_bounds, int rows, int cap, const Tail& tail,
                      void* stream) {
  const int n = 2 * cap;
  if (cap <= 0 || n > kSlotLanes || (!a_pg && p_bounds <= 0))
    return (int)cudaErrorInvalidValue;
  return with_width(n, [&](auto w) {
    return launch_w2<decltype(w)::value>(a, a_pg, na, ra, b, b_pg, nb, rb,
                                         bounds, p_bounds, rows, cap, tail,
                                         stream);
  });
}

// A fused kernel at width N, one row a block, its shared memory limit
// raised first (once per device: `sized`).
template <int N, class... Params, class... Args>
int launch_fused(void (*kernel)(Params...), std::atomic<unsigned>* sized,
                 int rows, void* stream, Args... args) {
  using S = FusedShape<N>;
  const cudaError_t e = size_smem(kernel, S::kSmem, sized);
  if (e != cudaSuccess) return (int)e;
  if (rows > 0)
    kernel<<<rows, S::kThreads, S::kSmem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int docodo_sorted_and_locate_full(
    const int* a, const int* a_pg, const int* na, const int* ra,
    const int* b, const int* b_pg, const int* nb, const int* rb, int rows,
    int cap, int kpad, int hpad, int* pg_c, float* rk_c, float* ct_c,
    int* n_pages, int* n_hits, int* hits, void* stream) {
  return launch_sorted_and(
      a, a_pg, na, ra, b, b_pg, nb, rb, nullptr, 0, rows, cap,
      slots_tail(kpad, hpad, pg_c, rk_c, ct_c, n_pages, n_hits, hits),
      stream);
}

extern "C" int docodo_sorted_and_locate_full_topk(
    const int* a, const int* a_pg, const int* na, const int* ra,
    const int* b, const int* b_pg, const int* nb, const int* rb, int rows,
    int cap, int topk, int hpad, int* pages, float* ranks, int* counts,
    int* n_pages, int* n_hits, int* hits, void* stream) {
  return launch_sorted_and(
      a, a_pg, na, ra, b, b_pg, nb, rb, nullptr, 0, rows, cap,
      topk_tail(topk, hpad, pages, ranks, counts, n_pages, n_hits, hits),
      stream);
}

extern "C" int docodo_and_locate_topk(
    const int* a, const int* a_pg, const int* na, const int* ra,
    const int* b, const int* b_pg, const int* nb, const int* rb,
    const int* bounds, int p_bounds, int rows, int cap, int topk, int* pages,
    float* ranks, int* counts, void* stream) {
  if (topk <= 0) return (int)cudaErrorInvalidValue;
  return launch_sorted_and(a, a_pg, na, ra, b, b_pg, nb, rb, bounds,
                           p_bounds, rows, cap,
                           page_topk_tail(topk, pages, ranks, counts),
                           stream);
}

extern "C" int docodo_single_locate_topk(
    const int* a, const int* a_pg, const int* na, const int* bounds,
    int p_bounds, int rows, int cap, int topk, int* pages, float* ranks,
    int* counts, void* stream) {
  if (topk <= 0) return (int)cudaErrorInvalidValue;
  const PageTopkTail tail = page_topk_tail(topk, pages, ranks, counts);
  if (a_pg) return launch_w1<SingleKeep>(a, a_pg, na, rows, cap, tail, stream);
  return launch_w1<SingleKeep, true>(a, a_pg, na, rows, cap, tail, stream,
                                     bounds, p_bounds);
}

extern "C" int docodo_merge_and_locate_topk(
    const int* a, const int* a_pg, const int* na, const int* ra,
    const int* b, const int* b_pg, const int* nb, const int* rb, int rows,
    int cap, int kpad, int hpad, int* pg_c, float* rk_c, float* ct_c,
    int* n_pages, int* n_hits, int* hits, void* stream) {
  if (cap <= 0 || 2 * cap > kFusedLanes) return (int)cudaErrorInvalidValue;
  static std::atomic<unsigned> sized[2];  // zero: static storage
  const SlotsTail tail =
      slots_tail(kpad, hpad, pg_c, rk_c, ct_c, n_pages, n_hits, hits);
  if (2 * cap <= 2048)
    return launch_fused<2048>(merge_and_locate_topk_kernel<2048>, &sized[0],
                              rows, stream, a, a_pg, na, ra, b, b_pg, nb, rb,
                              cap, tail);
  return launch_fused<4096>(merge_and_locate_topk_kernel<4096>, &sized[1],
                            rows, stream, a, a_pg, na, ra, b, b_pg, nb, rb,
                            cap, tail);
}

extern "C" int docodo_merge_and_locate(
    const int* a, const int* a_pg, const int* na, const int* ra,
    const int* b, const int* b_pg, const int* nb, const int* rb, int rows,
    int cap, int* hits, int* page_s, float* rank_s, float* cnt_s,
    void* stream) {
  if (cap <= 0 || 2 * cap > kFusedLanes) return (int)cudaErrorInvalidValue;
  static std::atomic<unsigned> sized[2];  // zero: static storage
  if (2 * cap <= 2048)
    return launch_fused<2048>(merge_and_locate_kernel<2048>, &sized[0], rows,
                              stream, a, a_pg, na, ra, b, b_pg, nb, rb, cap,
                              hits, page_s, rank_s, cnt_s);
  return launch_fused<4096>(merge_and_locate_kernel<4096>, &sized[1], rows,
                            stream, a, a_pg, na, ra, b, b_pg, nb, rb, cap,
                            hits, page_s, rank_s, cnt_s);
}

extern "C" int docodo_single_locate_full(
    const int* a, const int* a_pg, const int* na, int rows, int cap,
    int kpad, int hpad, int* pg_c, float* rk_c, float* ct_c, int* n_pages,
    int* n_hits, int* hits, void* stream) {
  return launch_w1<SingleKeep>(
      a, a_pg, na, rows, cap,
      slots_tail(kpad, hpad, pg_c, rk_c, ct_c, n_pages, n_hits, hits),
      stream);
}

extern "C" int docodo_single_locate_full_topk(
    const int* a, const int* a_pg, const int* na, int rows, int cap,
    int topk, int hpad, int* pages, float* ranks, int* counts, int* n_pages,
    int* n_hits, int* hits, void* stream) {
  return launch_w1<SingleKeep>(
      a, a_pg, na, rows, cap,
      topk_tail(topk, hpad, pages, ranks, counts, n_pages, n_hits, hits),
      stream);
}

extern "C" int docodo_union_locate_full(
    const int* a, const int* a_pg, const int* na, int rows, int cap,
    int kpad, int hpad, int* pg_c, float* rk_c, float* ct_c, int* n_pages,
    int* n_hits, int* hits, void* stream) {
  return launch_w1<UnionKeep>(
      a, a_pg, na, rows, cap,
      slots_tail(kpad, hpad, pg_c, rk_c, ct_c, n_pages, n_hits, hits),
      stream);
}

extern "C" const char* docodo_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
