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
// merge_and_locate_topk.
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
// from shared memory, consecutive threads on consecutive slots. The other
// kernels give a row a whole block. The W = 2 kernels merge
// their two posting blocks by rank in shared memory, so the separate sort
// launch of the TPU route disappears. The TPU kernels' lane-roll log-step
// scans, packed scan pairs, bitonic merge network and log-shift compaction
// become one block scan (warp shuffles plus one pass over the warp totals),
// binary-search ranks and scatters at prefix-sum slots.
//
// merge_and_locate_topk is the same W = 2 body at up to 4096 lanes: 512
// threads of 8 lanes, and about 116 KB of shared memory, which a block
// reaches only as dynamic shared memory.
//
// Every entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError().

#include "slot_row.cuh"

namespace {

using namespace docodo;

// W = 2: merge_and_keep, then the row's tail (SlotsTail or TopkTail).
template <class Grp, int L, int N, class Tail>
__device__ void sorted_and_body(
    const Grp& g, AndSmem<N>& sm, const int* __restrict__ a,
    const int* __restrict__ a_pg, const int* __restrict__ na_,
    const int* __restrict__ ra_, const int* __restrict__ b,
    const int* __restrict__ b_pg, const int* __restrict__ nb_,
    const int* __restrict__ rb_, int cap, const Tail& tail) {
  const int n = 2 * cap;
  bool keep[L];
  merge_and_keep(g, sm, a, a_pg, na_, ra_, b, b_pg, nb_, rb_, nullptr, 0,
                 cap, keep);
  tail.run(g, sm.row, keep, n, (n + Grp::kThreads - 1) / Grp::kThreads);
}

constexpr int kSlotThreads = 256;
constexpr int kSlotLanes = 1024;  // stream width of the slot kernels
constexpr int kSlotIpt = kSlotLanes / kSlotThreads;

constexpr int kFusedThreads = 512;
constexpr int kFusedLanes = 4096;  // FUSED_AND_MAX, pallas_query.py:2478
constexpr int kFusedIpt = kFusedLanes / kFusedThreads;
constexpr size_t kFusedSmem = sizeof(AndSmem<kFusedLanes>);

// The W = 2 slot kernel at stream width N (2 cap <= N): a row group of
// N / 4 threads, each 4 lanes, and 256 / group rows a block (8, 4, 2 and 1
// at N = 128, 256, 512, 1024), each row in its own AndSmem<N>. On an H100
// this beat one warp a row at N = 256 and two or four warps at N = 512 and
// 1024 with 8 lanes a thread (96-101 registers, 2 blocks an SM; PERF.md).
template <int N>
struct W2Shape {
  static constexpr int kGroup = N / 4;
  static constexpr int kRows = kSlotThreads / kGroup;
  static constexpr int kIpt = N / kGroup;
  static constexpr size_t kSmem = kRows * sizeof(AndSmem<N>);
};

template <class Tail, int N>
__global__ void __launch_bounds__(kSlotThreads) sorted_and_locate_full_kernel(
    const int* __restrict__ a, const int* __restrict__ a_pg,
    const int* __restrict__ na_, const int* __restrict__ ra_,
    const int* __restrict__ b, const int* __restrict__ b_pg,
    const int* __restrict__ nb_, const int* __restrict__ rb_, int rows,
    int cap, Tail tail) {
  using S = W2Shape<N>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const GroupRow<S::kGroup> g{};
  if (g.row() >= (size_t)rows) return;  // the last block's spare groups
  auto& sm = reinterpret_cast<AndSmem<N>*>(smem_raw)[g.group()];
  sorted_and_body<GroupRow<S::kGroup>, S::kIpt>(
      g, sm, a, a_pg, na_, ra_, b, b_pg, nb_, rb_, cap, tail);
}

__global__ void __launch_bounds__(kFusedThreads) merge_and_locate_topk_kernel(
    const int* __restrict__ a, const int* __restrict__ a_pg,
    const int* __restrict__ na_, const int* __restrict__ ra_,
    const int* __restrict__ b, const int* __restrict__ b_pg,
    const int* __restrict__ nb_, const int* __restrict__ rb_, int cap,
    SlotsTail tail) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<AndSmem<kFusedLanes>*>(smem_raw);
  sorted_and_body<BlockRow<kFusedThreads>, kFusedIpt>(
      BlockRow<kFusedThreads>{}, sm, a, a_pg, na_, ra_, b, b_pg, nb_, rb_,
      cap, tail);
}

// merge_and_locate_topk's row body with its streams written at full width:
// hits[l] is the value at kept lanes and INF32 elsewhere, and a run's first
// lane carries its page, rank and count.
__global__ void __launch_bounds__(kFusedThreads) merge_and_locate_kernel(
    const int* __restrict__ a, const int* __restrict__ a_pg,
    const int* __restrict__ na_, const int* __restrict__ ra_,
    const int* __restrict__ b, const int* __restrict__ b_pg,
    const int* __restrict__ nb_, const int* __restrict__ rb_, int cap,
    int* __restrict__ hits, int* __restrict__ page_s,
    float* __restrict__ rank_s, float* __restrict__ cnt_s) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<AndSmem<kFusedLanes>*>(smem_raw);
  RowSmem<kFusedLanes>& s = sm.row;
  const BlockRow<kFusedThreads> g{};
  const int tid = threadIdx.x;
  const int n = 2 * cap;
  const int ipt = (n + kFusedThreads - 1) / kFusedThreads;
  const int base = tid * ipt;
  const size_t o = (size_t)blockIdx.x * n;
  bool keep[kFusedIpt];
  merge_and_keep(g, sm, a, a_pg, na_, ra_, b, b_pg, nb_, rb_, nullptr, 0,
                 cap, keep);
  // every run's sums, and its first lane in s.tmp
  const int runs = sum_runs(g, s, keep, n, ipt, n, s.tmp);
  for (int l = tid; l < n; l += kFusedThreads) {
    page_s[o + l] = -1;
    rank_s[o + l] = 0.0f;
    cnt_s[o + l] = 0.0f;
  }
#pragma unroll
  for (int k = 0; k < kFusedIpt; ++k) {
    const int l = base + k;
    if (k < ipt && l < n) hits[o + l] = keep[k] ? s.val[l] : kInf;
  }
  // the run starts overwrite what other threads wrote above
  __syncthreads();
  for (int r = tid; r < runs; r += kFusedThreads) {
    const int l = s.tmp[r];
    const int c = s.run_count[r];
    page_s[o + l] = s.run_page[r];
    rank_s[o + l] = run_rank(s.run_bonus[r], c);
    cnt_s[o + l] = (float)c;
  }
}

// Loads one posting block row (INF32 past na) and its page stream.
template <int T, int N>
__device__ int load_block(RowSmem<N>& s, const int* a, const int* a_pg,
                          const int* na_, int cap) {
  const size_t row = blockIdx.x;
  const int na = clamp_len(na_[row], cap);
  for (int l = threadIdx.x; l < cap; l += T) {
    s.val[l] = l < na ? a[row * cap + l] : kInf;
    s.page[l] = a_pg[row * cap + l];
  }
  __syncthreads();
  return na;
}

// W = 1: the posting block is the kept stream.
template <class Tail>
__global__ void __launch_bounds__(kSlotThreads) single_locate_full_kernel(
    const int* __restrict__ a, const int* __restrict__ a_pg,
    const int* __restrict__ na_, int cap, Tail tail) {
  __shared__ RowSmem<kSlotLanes> s;
  const int na = load_block<kSlotThreads>(s, a, a_pg, na_, cap);
  const int ipt = (cap + kSlotThreads - 1) / kSlotThreads;
  const int base = threadIdx.x * ipt;
  bool keep[kSlotIpt];
#pragma unroll
  for (int k = 0; k < kSlotIpt; ++k) keep[k] = k < ipt && base + k < na;
  tail.run(BlockRow<kSlotThreads>{}, s, keep, cap, ipt);
}

// W = 1 union of one variant: a slot is kept where it is valid and
// differs from the previous slot.
__global__ void __launch_bounds__(kSlotThreads) union_locate_full_kernel(
    const int* __restrict__ a, const int* __restrict__ a_pg,
    const int* __restrict__ na_, int cap, SlotsTail tail) {
  __shared__ RowSmem<kSlotLanes> s;
  load_block<kSlotThreads>(s, a, a_pg, na_, cap);
  const int ipt = (cap + kSlotThreads - 1) / kSlotThreads;
  const int base = threadIdx.x * ipt;
  bool keep[kSlotIpt];
#pragma unroll
  for (int k = 0; k < kSlotIpt; ++k) {
    const int l = base + k;
    keep[k] = false;
    if (k < ipt && l < cap) {
      const int v = s.val[l];
      keep[k] = v < kInf && v != (l > 0 ? s.val[l - 1] : -1);
    }
  }
  tail.run(BlockRow<kSlotThreads>{}, s, keep, cap, ipt);
}

// Raises a kernel's dynamic shared memory limit, once per kernel and
// device: the limit is the current device's, and another card starts
// from the 48 KB default. `sized` holds a bit per device (devices past
// 31 set it at every launch).
template <class K>
cudaError_t size_smem(K kernel, size_t bytes, unsigned* sized) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (*sized & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
  if (e == cudaSuccess) *sized |= bit;
  return e;
}

template <int N, class Tail>
int launch_w2(const int* a, const int* a_pg, const int* na, const int* ra,
              const int* b, const int* b_pg, const int* nb, const int* rb,
              int rows, int cap, const Tail& tail, void* stream) {
  using S = W2Shape<N>;
  static_assert(S::kSmem <= 48 * 1024, "needs no shared memory attribute");
  if (rows > 0)
    sorted_and_locate_full_kernel<Tail, N>
        <<<(rows + S::kRows - 1) / S::kRows, kSlotThreads, S::kSmem,
           (cudaStream_t)stream>>>(a, a_pg, na, ra, b, b_pg, nb, rb, rows,
                                   cap, tail);
  return (int)cudaGetLastError();
}

// The W = 2 slot kernel at the narrowest width N that holds 2 cap lanes.
template <class Tail>
int launch_sorted_and(const int* a, const int* a_pg, const int* na,
                      const int* ra, const int* b, const int* b_pg,
                      const int* nb, const int* rb, int rows, int cap,
                      const Tail& tail, void* stream) {
  const int n = 2 * cap;
  if (cap <= 0 || n > kSlotLanes) return (int)cudaErrorInvalidValue;
  if (n <= 128)
    return launch_w2<128>(a, a_pg, na, ra, b, b_pg, nb, rb, rows, cap, tail,
                          stream);
  if (n <= 256)
    return launch_w2<256>(a, a_pg, na, ra, b, b_pg, nb, rb, rows, cap, tail,
                          stream);
  if (n <= 512)
    return launch_w2<512>(a, a_pg, na, ra, b, b_pg, nb, rb, rows, cap, tail,
                          stream);
  return launch_w2<1024>(a, a_pg, na, ra, b, b_pg, nb, rb, rows, cap, tail,
                         stream);
}

}  // namespace

extern "C" int docodo_sorted_and_locate_full(
    const int* a, const int* a_pg, const int* na, const int* ra,
    const int* b, const int* b_pg, const int* nb, const int* rb, int rows,
    int cap, int kpad, int hpad, int* pg_c, float* rk_c, float* ct_c,
    int* n_pages, int* n_hits, int* hits, void* stream) {
  return launch_sorted_and(
      a, a_pg, na, ra, b, b_pg, nb, rb, rows, cap,
      slots_tail(kpad, hpad, pg_c, rk_c, ct_c, n_pages, n_hits, hits),
      stream);
}

extern "C" int docodo_sorted_and_locate_full_topk(
    const int* a, const int* a_pg, const int* na, const int* ra,
    const int* b, const int* b_pg, const int* nb, const int* rb, int rows,
    int cap, int topk, int hpad, int* pages, float* ranks, int* counts,
    int* n_pages, int* n_hits, int* hits, void* stream) {
  return launch_sorted_and(
      a, a_pg, na, ra, b, b_pg, nb, rb, rows, cap,
      topk_tail(topk, hpad, pages, ranks, counts, n_pages, n_hits, hits),
      stream);
}

extern "C" int docodo_merge_and_locate_topk(
    const int* a, const int* a_pg, const int* na, const int* ra,
    const int* b, const int* b_pg, const int* nb, const int* rb, int rows,
    int cap, int kpad, int hpad, int* pg_c, float* rk_c, float* ct_c,
    int* n_pages, int* n_hits, int* hits, void* stream) {
  static unsigned sized = 0;
  const cudaError_t e =
      size_smem(merge_and_locate_topk_kernel, kFusedSmem, &sized);
  if (e != cudaSuccess) return (int)e;
  if (rows > 0)
    merge_and_locate_topk_kernel<<<rows, kFusedThreads, kFusedSmem,
                                   (cudaStream_t)stream>>>(
        a, a_pg, na, ra, b, b_pg, nb, rb, cap,
        slots_tail(kpad, hpad, pg_c, rk_c, ct_c, n_pages, n_hits, hits));
  return (int)cudaGetLastError();
}

extern "C" int docodo_merge_and_locate(
    const int* a, const int* a_pg, const int* na, const int* ra,
    const int* b, const int* b_pg, const int* nb, const int* rb, int rows,
    int cap, int* hits, int* page_s, float* rank_s, float* cnt_s,
    void* stream) {
  if (cap <= 0 || 2 * cap > kFusedLanes) return (int)cudaErrorInvalidValue;
  static unsigned sized = 0;
  const cudaError_t e = size_smem(merge_and_locate_kernel, kFusedSmem, &sized);
  if (e != cudaSuccess) return (int)e;
  if (rows > 0)
    merge_and_locate_kernel<<<rows, kFusedThreads, kFusedSmem,
                              (cudaStream_t)stream>>>(
        a, a_pg, na, ra, b, b_pg, nb, rb, cap, hits, page_s, rank_s, cnt_s);
  return (int)cudaGetLastError();
}

extern "C" int docodo_single_locate_full(
    const int* a, const int* a_pg, const int* na, int rows, int cap,
    int kpad, int hpad, int* pg_c, float* rk_c, float* ct_c, int* n_pages,
    int* n_hits, int* hits, void* stream) {
  if (rows > 0)
    single_locate_full_kernel<<<rows, kSlotThreads, 0,
                                (cudaStream_t)stream>>>(
        a, a_pg, na, cap,
        slots_tail(kpad, hpad, pg_c, rk_c, ct_c, n_pages, n_hits, hits));
  return (int)cudaGetLastError();
}

extern "C" int docodo_single_locate_full_topk(
    const int* a, const int* a_pg, const int* na, int rows, int cap,
    int topk, int hpad, int* pages, float* ranks, int* counts, int* n_pages,
    int* n_hits, int* hits, void* stream) {
  if (rows > 0)
    single_locate_full_kernel<<<rows, kSlotThreads, 0,
                                (cudaStream_t)stream>>>(
        a, a_pg, na, cap,
        topk_tail(topk, hpad, pages, ranks, counts, n_pages, n_hits, hits));
  return (int)cudaGetLastError();
}

extern "C" int docodo_union_locate_full(
    const int* a, const int* a_pg, const int* na, int rows, int cap,
    int kpad, int hpad, int* pg_c, float* rk_c, float* ct_c, int* n_pages,
    int* n_hits, int* hits, void* stream) {
  if (rows > 0)
    union_locate_full_kernel<<<rows, kSlotThreads, 0,
                               (cudaStream_t)stream>>>(
        a, a_pg, na, cap,
        slots_tail(kpad, hpad, pg_c, rk_c, ct_c, n_pages, n_hits, hits));
  return (int)cudaGetLastError();
}

extern "C" const char* docodo_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
