// Full-result kernels of docodo_tpu_torch's variant ORs within one slot
// (a stream of at most 1024 lanes), for Hopper (sm_90a). They replace these
// Pallas TPU kernels of docodo_tpu/ops/pallas_query.py:
//
//   docodo_variants_and_locate_full <- _variants_and_locate_full_slots_kernel
//                                      (pallas_query.py:638), W = 2 words
//                                      each an OR of variants
//   docodo_union_merge_locate_full  <- _union2_merge_locate_slots_kernel
//                                      (:681, V = 2) and
//                                      _union_locate_full_slots_kernel (:660)
//                                      at V > 2, W = 1
//   docodo_variants_and_locate_full_topk <- _variants_and_locate_full_kernel
//                                      (:526)
//   docodo_union_locate_full_topk   <- _union_locate_full_kernel (:550),
//                                      W = 1, any V >= 1 (V = 1 serves a
//                                      plain word past the W = 1 kernel's
//                                      128 lanes)
//
// Each of the first two turns one query row into the row's first kpad page
// runs in slot order, its first hpad kept hits and the exact n_pages /
// n_hits totals, as the kernels of locate_full.cu do. The two _topk kernels
// are the same row bodies ending in the other tail (slot_row.cuh,
// TopkTail): the top k of every run of the row, picked in the kernel.
//
// What bounds them on this card: bytes. Each reads its variant blocks once
// (values and pages, 8 bytes a lane) and writes 3 * kpad + hpad + 2 values
// a row; the merge costs each lane one binary search of every other block
// in shared memory. The TPU route sorts the word-tagged concatenation of
// the blocks outside the kernel (a lax.sort through device memory) or, at
// V = 2, merges with a bitonic network of lane rotations, and finds each
// run's words with span queries (prefix sums and reverse running mins).
// Here one block per row loads the blocks into shared memory and places
// every element at its index plus its rank in every other block: ties go
// by block order, which is (word, variant) order, so the row is in the
// (coord, tag) order of the TPU route's stable sort. In that order tags
// ascend within a run of equal coordinates, so a run holds word A exactly
// when its first lane has tag 0 and word B exactly when its last lane has
// tag 1: both marks are lane-local and need no span query. A run never
// crosses a segment cut, so marking word B at the run's last lane instead
// of its first leaves every segment's word count as it was.
//
// Every entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError().

#include "slot_row.cuh"

namespace {

using namespace docodo;

constexpr int kThreads = 256;
constexpr int kLanes = 1024;  // MAX_STREAM_WIDTH, pallas_query.py:780
constexpr int kIpt = kLanes / kThreads;
constexpr int kMaxBlocks = 32;

struct VarSmem {
  RowSmem<kLanes> row;
  int blk[kLanes];  // block k's values at k * cap, INF32 past its length
  int len[kMaxBlocks];
  unsigned char tag[kLanes];
};

// Merges the row's va blocks of word A (tag 0) and vb blocks of word B
// (tag 1), each ascending with its length in na_ / nb_, into s.row.val /
// s.row.page / s.tag in (coord, tag, block) order, padding (INF32, tag 2)
// last. b and b_pg are read only when vb > 0.
__device__ void merge_blocks(VarSmem& s, const int* __restrict__ a,
                             const int* __restrict__ a_pg,
                             const int* __restrict__ na_, int va,
                             const int* __restrict__ b,
                             const int* __restrict__ b_pg,
                             const int* __restrict__ nb_, int vb, int cap) {
  const int tid = threadIdx.x;
  const size_t row = blockIdx.x;
  const int nblk = va + vb;
  const int n = nblk * cap;
  if (tid < nblk)
    s.len[tid] = clamp_len(tid < va ? na_[row * va + tid]
                                    : nb_[row * vb + tid - va], cap);
  __syncthreads();
  for (int l = tid; l < n; l += kThreads) {
    const int k = l / cap;
    const int i = l - k * cap;
    const int* src = k < va ? a + (row * va + k) * cap
                            : b + (row * vb + k - va) * cap;
    s.blk[l] = i < s.len[k] ? src[i] : kInf;
  }
  __syncthreads();
  int total = 0;
  for (int j = 0; j < nblk; ++j) total += s.len[j];
  for (int l = tid; l < n; l += kThreads) {
    const int k = l / cap;
    const int i = l - k * cap;
    int p;
    if (i < s.len[k]) {
      const int v = s.blk[l];
      p = i;
      for (int j = 0; j < nblk; ++j) {
        if (j < k) p += upper_bound(s.blk + j * cap, s.len[j], v);
        else if (j > k) p += lower_bound(s.blk + j * cap, s.len[j], v);
      }
      const int* pg = k < va ? a_pg + (row * va + k) * cap
                             : b_pg + (row * vb + k - va) * cap;
      s.row.val[p] = v;
      s.row.page[p] = pg[i];
      s.tag[p] = k < va ? 0 : 1;
    } else {  // padding lanes go after all values, in block order
      p = total + i - s.len[k];
      for (int j = 0; j < k; ++j) p += cap - s.len[j];
      s.row.val[p] = kInf;
      s.row.page[p] = 0;
      s.tag[p] = 2;
    }
  }
  __syncthreads();
}

// W = 2, each word an OR of variants (pallas_query._variants_and_keep):
// the run-dedupe marks, the AND's segmentation, the locate tail. With
// bpad (word B is query padding) the row keeps every run start, word A's
// union.
template <class Tail>
__global__ void __launch_bounds__(kThreads) variants_and_locate_full_kernel(
    const int* __restrict__ a, const int* __restrict__ a_pg,
    const int* __restrict__ na_, const int* __restrict__ ra_,
    const int* __restrict__ b, const int* __restrict__ b_pg,
    const int* __restrict__ nb_, const int* __restrict__ rb_,
    const int* __restrict__ bpad_, int va, int vb, int cap, Tail tail) {
  __shared__ VarSmem s;
  merge_blocks(s, a, a_pg, na_, va, b, b_pg, nb_, vb, cap);
  const size_t row = blockIdx.x;
  const int n = (va + vb) * cap;
  const int ipt = (n + kThreads - 1) / kThreads;
  const int base = threadIdx.x * ipt;
  const int r1 = ra_[row];
  const int r2 = rb_[row];
  const int abs_r = max(abs(r1), abs(r2));
  const bool ordered = r1 < 0 && r2 < 0;
  const bool bpad = bpad_[row] != 0;
  const int* val = s.row.val;
  bool isa[kIpt], isb[kIpt], start[kIpt], seg[kIpt];
#pragma unroll
  for (int k = 0; k < kIpt; ++k) {
    const int l = base + k;
    isa[k] = isb[k] = start[k] = seg[k] = false;
    if (k < ipt && l < n) {
      const int v = val[l];
      const bool valid = v < kInf;
      const int pv = l > 0 ? val[l - 1] : -1;
      const int nv = l < n - 1 ? val[l + 1] : kInf;
      start[k] = valid && v != pv;
      isa[k] = start[k] && s.tag[l] == 0;
      isb[k] = valid && s.tag[l] == 1 && v != nv;
      const int gap = v - (l == 0 ? 0 : pv);
      seg[k] = l == 0 || (abs_r != 0 && gap > abs_r && valid);
    }
  }
  bool keep[kIpt];
  segment_keep(BlockRow<kThreads>{}, s.row, isa, isb, start, seg, ordered,
               n, ipt, keep);
  if (bpad) {
#pragma unroll
    for (int k = 0; k < kIpt; ++k) keep[k] = start[k];
  }
  tail.run(BlockRow<kThreads>{}, s.row, keep, n, ipt);
}

// W = 1, one word's V variants: the merged row keeps each run's first lane.
template <class Tail>
__global__ void __launch_bounds__(kThreads) union_merge_locate_full_kernel(
    const int* __restrict__ a, const int* __restrict__ a_pg,
    const int* __restrict__ na_, int v, int cap, Tail tail) {
  __shared__ VarSmem s;
  merge_blocks(s, a, a_pg, na_, v, nullptr, nullptr, nullptr, 0, cap);
  const int n = v * cap;
  const int ipt = (n + kThreads - 1) / kThreads;
  const int base = threadIdx.x * ipt;
  bool keep[kIpt];
#pragma unroll
  for (int k = 0; k < kIpt; ++k) {
    const int l = base + k;
    keep[k] = false;
    if (k < ipt && l < n) {
      const int x = s.row.val[l];
      keep[k] = x < kInf && x != (l > 0 ? s.row.val[l - 1] : -1);
    }
  }
  tail.run(BlockRow<kThreads>{}, s.row, keep, n, ipt);
}

bool shape_ok(int nblk, int cap) {
  return nblk > 0 && nblk <= kMaxBlocks && cap > 0 && nblk * cap <= kLanes;
}

}  // namespace

extern "C" int docodo_variants_and_locate_full(
    const int* a, const int* a_pg, const int* na, const int* ra,
    const int* b, const int* b_pg, const int* nb, const int* rb,
    const int* bpad, int rows, int va, int vb, int cap, int kpad, int hpad,
    int* pg_c, float* rk_c, float* ct_c, int* n_pages, int* n_hits,
    int* hits, void* stream) {
  if (!shape_ok(va + vb, cap)) return (int)cudaErrorInvalidValue;
  if (rows > 0)
    variants_and_locate_full_kernel<<<rows, kThreads, 0,
                                      (cudaStream_t)stream>>>(
        a, a_pg, na, ra, b, b_pg, nb, rb, bpad, va, vb, cap,
        slots_tail(kpad, hpad, pg_c, rk_c, ct_c, n_pages, n_hits, hits));
  return (int)cudaGetLastError();
}

extern "C" int docodo_variants_and_locate_full_topk(
    const int* a, const int* a_pg, const int* na, const int* ra,
    const int* b, const int* b_pg, const int* nb, const int* rb,
    const int* bpad, int rows, int va, int vb, int cap, int topk, int hpad,
    int* pages, float* ranks, int* counts, int* n_pages, int* n_hits,
    int* hits, void* stream) {
  if (!shape_ok(va + vb, cap)) return (int)cudaErrorInvalidValue;
  if (rows > 0)
    variants_and_locate_full_kernel<<<rows, kThreads, 0,
                                      (cudaStream_t)stream>>>(
        a, a_pg, na, ra, b, b_pg, nb, rb, bpad, va, vb, cap,
        topk_tail(topk, hpad, pages, ranks, counts, n_pages, n_hits, hits));
  return (int)cudaGetLastError();
}

extern "C" int docodo_union_merge_locate_full(
    const int* a, const int* a_pg, const int* na, int rows, int v, int cap,
    int kpad, int hpad, int* pg_c, float* rk_c, float* ct_c, int* n_pages,
    int* n_hits, int* hits, void* stream) {
  if (!shape_ok(v, cap)) return (int)cudaErrorInvalidValue;
  if (rows > 0)
    union_merge_locate_full_kernel<<<rows, kThreads, 0,
                                     (cudaStream_t)stream>>>(
        a, a_pg, na, v, cap,
        slots_tail(kpad, hpad, pg_c, rk_c, ct_c, n_pages, n_hits, hits));
  return (int)cudaGetLastError();
}

extern "C" int docodo_union_locate_full_topk(
    const int* a, const int* a_pg, const int* na, int rows, int v, int cap,
    int topk, int hpad, int* pages, float* ranks, int* counts, int* n_pages,
    int* n_hits, int* hits, void* stream) {
  if (!shape_ok(v, cap)) return (int)cudaErrorInvalidValue;
  if (rows > 0)
    union_merge_locate_full_kernel<<<rows, kThreads, 0,
                                     (cudaStream_t)stream>>>(
        a, a_pg, na, v, cap,
        topk_tail(topk, hpad, pages, ranks, counts, n_pages, n_hits, hits));
  return (int)cudaGetLastError();
}
