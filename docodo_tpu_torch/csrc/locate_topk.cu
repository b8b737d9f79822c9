// Page-level locate/rank/top-k kernels of docodo_tpu_torch, for Hopper
// (sm_90a).
//
// They replace three Pallas TPU kernels of docodo_tpu/ops/pallas_query.py:
//
//   docodo_and_locate_topk     <- _sorted_and_locate_kernel
//                                 (pallas_query.py:477), W = 2, cap <= 512,
//                                 and _and_locate_kernel (pallas_query.py:133),
//                                 the same function with a compare-all merge
//                                 inside
//   docodo_single_locate_topk  <- _single_word_kernel (pallas_query.py:200),
//                                 W = 1, cap <= 128
//
// Each kernel turns one query row into its top k pages: every page run of
// the row's kept stream is ranked ((1 + sum of 30 / max(5, gap)) +
// ln(count) in f32, as in locate_full.cu), and the k best runs by (rank
// descending, lane ascending) are written as (page, rank, count). The
// selection happens inside the kernel (slot_row.cuh, locate_topk_tail), so
// nothing but three [rows, k] arrays leaves it.
//
// A lane's page comes from the posting fetch's page stream where the caller
// carries one, else from a binary search of the page bounds (clamped to the
// last page). The W = 2 kernel takes the raw operand blocks and merges them
// by rank in shared memory, so the TPU route's separate sort launch is
// gone, as in docodo_sorted_and_locate_full.
//
// What bounds them on this card: bytes. A row is read once (4 or 8 bytes a
// valid lane) and 12 k bytes are written. One thread block per row, 256
// threads, the row in shared memory; the selection costs runs^2 compares of
// shared-memory words per row, which stays far below the read at these
// widths (at most 1024 runs).
//
// Every entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError().

#include "slot_row.cuh"

namespace {

using namespace docodo;

constexpr int kThreads = 256;
constexpr int kLanes = 1024;  // 2 * MAX_SORTED_PALLAS_CAP
constexpr int kIpt = kLanes / kThreads;

__global__ void __launch_bounds__(kThreads) and_locate_topk_kernel(
    const int* __restrict__ a, const int* __restrict__ a_pg,
    const int* __restrict__ na_, const int* __restrict__ ra_,
    const int* __restrict__ b, const int* __restrict__ b_pg,
    const int* __restrict__ nb_, const int* __restrict__ rb_,
    const int* __restrict__ bounds, int p_bounds, int cap, int topk,
    TopkOutputs out) {
  __shared__ AndSmem<kLanes> sm;
  const int n = 2 * cap;
  bool keep[kIpt];
  const BlockRow<kThreads> g{};
  merge_and_keep(g, sm, a, a_pg, na_, ra_, b, b_pg, nb_, rb_, bounds,
                 p_bounds, cap, keep);
  locate_topk_tail(g, sm.row, keep, n, (n + kThreads - 1) / kThreads, topk,
                   out);
}

// W = 1: the posting block's first na lanes are the kept stream; one lane
// per thread (cap <= 128 <= kThreads).
__global__ void __launch_bounds__(kThreads) single_locate_topk_kernel(
    const int* __restrict__ a, const int* __restrict__ a_pg,
    const int* __restrict__ na_, const int* __restrict__ bounds,
    int p_bounds, int cap, int topk, TopkOutputs out) {
  __shared__ RowSmem<kThreads> s;
  const size_t row = blockIdx.x;
  const int na = clamp_len(na_[row], cap);
  for (int l = threadIdx.x; l < cap; l += kThreads) {
    const int v = l < na ? a[row * cap + l] : kInf;
    s.val[l] = v;
    s.page[l] = l >= na ? 0
                : a_pg  ? a_pg[row * cap + l]
                        : page_of_coord(bounds, p_bounds, v);
  }
  __syncthreads();
  const bool keep[1] = {(int)threadIdx.x < na};
  locate_topk_tail(BlockRow<kThreads>{}, s, keep, cap, 1, topk, out);
}

TopkOutputs topk_outputs(int* pages, float* ranks, int* counts) {
  TopkOutputs o;
  o.pages = pages;
  o.ranks = ranks;
  o.counts = counts;
  return o;
}

}  // namespace

extern "C" int docodo_and_locate_topk(
    const int* a, const int* a_pg, const int* na, const int* ra,
    const int* b, const int* b_pg, const int* nb, const int* rb,
    const int* bounds, int p_bounds, int rows, int cap, int topk, int* pages,
    float* ranks, int* counts, void* stream) {
  if (rows > 0)
    and_locate_topk_kernel<<<rows, kThreads, 0, (cudaStream_t)stream>>>(
        a, a_pg, na, ra, b, b_pg, nb, rb, bounds, p_bounds, cap, topk,
        topk_outputs(pages, ranks, counts));
  return (int)cudaGetLastError();
}

extern "C" int docodo_single_locate_topk(
    const int* a, const int* a_pg, const int* na, const int* bounds,
    int p_bounds, int rows, int cap, int topk, int* pages, float* ranks,
    int* counts, void* stream) {
  if (rows > 0)
    single_locate_topk_kernel<<<rows, kThreads, 0, (cudaStream_t)stream>>>(
        a, a_pg, na, bounds, p_bounds, cap, topk,
        topk_outputs(pages, ranks, counts));
  return (int)cudaGetLastError();
}
