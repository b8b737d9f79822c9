// Full-result locate/rank kernels of docodo_tpu_torch, for Hopper (sm_90a).
//
// They replace four Pallas TPU kernels of docodo_tpu/ops/pallas_query.py:
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
//
// Each kernel turns one query row into the row's first kpad page runs in
// slot order (page, rank, count), its first hpad kept hits, and the exact
// n_pages / n_hits totals. A run starts at a kept lane whose page differs
// from the previous kept lane's; each later lane of the run adds
// 30 / max(5, gap), and rank = (1 + bonus) + ln(count) in f32.
//
// What bounds them on this card: bytes, not arithmetic. Each row is read
// once (values and pages, 8 bytes a lane) and 3 * kpad + hpad + 2 values are
// written; in between, each lane costs a few dozen integer operations and
// a handful of block scans. The design keeps everything between that read
// and those writes on chip: one thread block per row, each thread owning a
// few consecutive lanes, the row's values, pages and per-run sums in shared
// memory, and no intermediate in device memory. The W = 2 kernels merge
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

// W = 2: merge_and_keep, then the first-kpad-runs tail.
template <int T, int L, int N>
__device__ void sorted_and_body(
    AndSmem<N>& sm, const int* __restrict__ a, const int* __restrict__ a_pg,
    const int* __restrict__ na_, const int* __restrict__ ra_,
    const int* __restrict__ b, const int* __restrict__ b_pg,
    const int* __restrict__ nb_, const int* __restrict__ rb_, int cap,
    int kpad, int hpad, const Outputs& out) {
  const int n = 2 * cap;
  bool keep[L];
  merge_and_keep<T, L, N>(sm, a, a_pg, na_, ra_, b, b_pg, nb_, rb_, nullptr,
                          0, cap, keep);
  locate_tail<T, L, N>(sm.row, keep, n, (n + T - 1) / T, kpad, hpad, out);
}

constexpr int kSlotThreads = 256;
constexpr int kSlotLanes = 1024;  // stream width of the slot kernels
constexpr int kSlotIpt = kSlotLanes / kSlotThreads;

constexpr int kFusedThreads = 512;
constexpr int kFusedLanes = 4096;  // FUSED_AND_MAX, pallas_query.py:2478
constexpr int kFusedIpt = kFusedLanes / kFusedThreads;
constexpr size_t kFusedSmem = sizeof(AndSmem<kFusedLanes>);

__global__ void __launch_bounds__(kSlotThreads) sorted_and_locate_full_kernel(
    const int* __restrict__ a, const int* __restrict__ a_pg,
    const int* __restrict__ na_, const int* __restrict__ ra_,
    const int* __restrict__ b, const int* __restrict__ b_pg,
    const int* __restrict__ nb_, const int* __restrict__ rb_, int cap,
    int kpad, int hpad, Outputs out) {
  __shared__ AndSmem<kSlotLanes> sm;
  sorted_and_body<kSlotThreads, kSlotIpt, kSlotLanes>(
      sm, a, a_pg, na_, ra_, b, b_pg, nb_, rb_, cap, kpad, hpad, out);
}

__global__ void __launch_bounds__(kFusedThreads) merge_and_locate_topk_kernel(
    const int* __restrict__ a, const int* __restrict__ a_pg,
    const int* __restrict__ na_, const int* __restrict__ ra_,
    const int* __restrict__ b, const int* __restrict__ b_pg,
    const int* __restrict__ nb_, const int* __restrict__ rb_, int cap,
    int kpad, int hpad, Outputs out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<AndSmem<kFusedLanes>*>(smem_raw);
  sorted_and_body<kFusedThreads, kFusedIpt, kFusedLanes>(
      sm, a, a_pg, na_, ra_, b, b_pg, nb_, rb_, cap, kpad, hpad, out);
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
__global__ void __launch_bounds__(kSlotThreads) single_locate_full_kernel(
    const int* __restrict__ a, const int* __restrict__ a_pg,
    const int* __restrict__ na_, int cap, int kpad, int hpad, Outputs out) {
  __shared__ RowSmem<kSlotLanes> s;
  const int na = load_block<kSlotThreads>(s, a, a_pg, na_, cap);
  const int ipt = (cap + kSlotThreads - 1) / kSlotThreads;
  const int base = threadIdx.x * ipt;
  bool keep[kSlotIpt];
#pragma unroll
  for (int k = 0; k < kSlotIpt; ++k) keep[k] = k < ipt && base + k < na;
  locate_tail<kSlotThreads, kSlotIpt, kSlotLanes>(s, keep, cap, ipt, kpad,
                                                  hpad, out);
}

// W = 1 union of one variant: a slot is kept where it is valid and
// differs from the previous slot.
__global__ void __launch_bounds__(kSlotThreads) union_locate_full_kernel(
    const int* __restrict__ a, const int* __restrict__ a_pg,
    const int* __restrict__ na_, int cap, int kpad, int hpad, Outputs out) {
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
  locate_tail<kSlotThreads, kSlotIpt, kSlotLanes>(s, keep, cap, ipt, kpad,
                                                  hpad, out);
}

}  // namespace

extern "C" int docodo_sorted_and_locate_full(
    const int* a, const int* a_pg, const int* na, const int* ra,
    const int* b, const int* b_pg, const int* nb, const int* rb, int rows,
    int cap, int kpad, int hpad, int* pg_c, float* rk_c, float* ct_c,
    int* n_pages, int* n_hits, int* hits, void* stream) {
  if (rows > 0)
    sorted_and_locate_full_kernel<<<rows, kSlotThreads, 0,
                                    (cudaStream_t)stream>>>(
        a, a_pg, na, ra, b, b_pg, nb, rb, cap, kpad, hpad,
        outputs(pg_c, rk_c, ct_c, n_pages, n_hits, hits));
  return (int)cudaGetLastError();
}

extern "C" int docodo_merge_and_locate_topk(
    const int* a, const int* a_pg, const int* na, const int* ra,
    const int* b, const int* b_pg, const int* nb, const int* rb, int rows,
    int cap, int kpad, int hpad, int* pg_c, float* rk_c, float* ct_c,
    int* n_pages, int* n_hits, int* hits, void* stream) {
  static bool sized = false;
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        merge_and_locate_topk_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kFusedSmem);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  if (rows > 0)
    merge_and_locate_topk_kernel<<<rows, kFusedThreads, kFusedSmem,
                                   (cudaStream_t)stream>>>(
        a, a_pg, na, ra, b, b_pg, nb, rb, cap, kpad, hpad,
        outputs(pg_c, rk_c, ct_c, n_pages, n_hits, hits));
  return (int)cudaGetLastError();
}

extern "C" int docodo_single_locate_full(
    const int* a, const int* a_pg, const int* na, int rows, int cap,
    int kpad, int hpad, int* pg_c, float* rk_c, float* ct_c, int* n_pages,
    int* n_hits, int* hits, void* stream) {
  if (rows > 0)
    single_locate_full_kernel<<<rows, kSlotThreads, 0,
                                (cudaStream_t)stream>>>(
        a, a_pg, na, cap, kpad, hpad,
        outputs(pg_c, rk_c, ct_c, n_pages, n_hits, hits));
  return (int)cudaGetLastError();
}

extern "C" int docodo_union_locate_full(
    const int* a, const int* a_pg, const int* na, int rows, int cap,
    int kpad, int hpad, int* pg_c, float* rk_c, float* ct_c, int* n_pages,
    int* n_hits, int* hits, void* stream) {
  if (rows > 0)
    union_locate_full_kernel<<<rows, kSlotThreads, 0,
                               (cudaStream_t)stream>>>(
        a, a_pg, na, cap, kpad, hpad,
        outputs(pg_c, rk_c, ct_c, n_pages, n_hits, hits));
  return (int)cudaGetLastError();
}

extern "C" const char* docodo_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
