// Page-level W = 1 locate/rank/top-k kernel of docodo_tpu_torch, for
// Hopper (sm_90a).
//
// It replaces a Pallas TPU kernel of docodo_tpu/ops/pallas_query.py:
//
//   docodo_single_locate_topk  <- _single_word_kernel (pallas_query.py:200),
//                                 W = 1, cap <= 128
//
// (The page-level W = 2 kernel, docodo_and_locate_topk, is the W = 2 slot
// template of locate_full.cu ending in the page-level tail.)
//
// It turns one query row into its top k pages: every page run of the
// row's posting block is ranked ((1 + sum of 30 / max(5, gap)) +
// ln(count) in f32, as in locate_full.cu), and the k best runs by (rank
// descending, lane ascending) are written as (page, rank, count). The
// selection happens inside the kernel (slot_row.cuh, locate_topk_tail), so
// nothing but three [rows, k] arrays leaves it. A lane's page comes from
// the posting fetch's page stream where the caller carries one, else from
// a binary search of the page bounds (clamped to the last page).
//
// What bounds it on this card: bytes. A row is read once (4 or 8 bytes a
// valid lane) and 12 k bytes are written. One thread block of 256
// threads a row, one lane a thread, the row in shared memory; the
// selection costs runs^2 compares of shared-memory words per row, which
// stays far below the read at this width (at most 128 runs).
//
// The entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError().

#include "slot_row.cuh"

namespace {

using namespace docodo;

constexpr int kThreads = 256;

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

}  // namespace

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
