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

// Shared memory of the W = 2 kernels: the row, both operands, the tags.
template <int N>
struct AndSmem {
  RowSmem<N> row;
  int a[N / 2];
  int b[N / 2];
  unsigned char tag[N];
};

// W = 2 proximity/phrase AND (pallas_query._sorted_and_keep): the two
// posting blocks merge by rank into (coord, tag) order (word A first on
// equal coords, padding last), cross-operand duplicates fold onto their
// first slot, gaps wider than |R| cut segments, both R < 0 adds the ordered
// cut at each segment's first word-A slot, and a segment keeps its slots
// only if it holds both words.
template <int T, int L, int N>
__device__ void sorted_and_body(
    AndSmem<N>& sm, const int* __restrict__ a, const int* __restrict__ a_pg,
    const int* __restrict__ na_, const int* __restrict__ ra_,
    const int* __restrict__ b, const int* __restrict__ b_pg,
    const int* __restrict__ nb_, const int* __restrict__ rb_, int cap,
    int kpad, int hpad, const Outputs& out) {
  RowSmem<N>& s = sm.row;
  int* s_a = sm.a;
  int* s_b = sm.b;
  unsigned char* s_tag = sm.tag;
  const int tid = threadIdx.x;
  const size_t row = blockIdx.x;
  const int n = 2 * cap;
  const int ipt = (n + T - 1) / T;
  const int base = tid * ipt;
  const int na = clamp_len(na_[row], cap);
  const int nb = clamp_len(nb_[row], cap);
  const int* arow = a + row * cap;
  const int* brow = b + row * cap;
  const int* apg = a_pg + row * cap;
  const int* bpg = b_pg + row * cap;
  for (int i = tid; i < cap; i += T) {
    s_a[i] = i < na ? arow[i] : kInf;
    s_b[i] = i < nb ? brow[i] : kInf;
  }
  __syncthreads();
  for (int i = tid; i < cap; i += T) {
    if (i < na) {
      const int p = i + lower_bound(s_b, nb, s_a[i]);
      s.val[p] = s_a[i];
      s.page[p] = apg[i];
      s_tag[p] = 0;
    }
    if (i < nb) {
      const int p = i + upper_bound(s_a, na, s_b[i]);
      s.val[p] = s_b[i];
      s.page[p] = bpg[i];
      s_tag[p] = 1;
    }
  }
  for (int p = na + nb + tid; p < n; p += T) {
    s.val[p] = kInf;
    s.page[p] = 0;
    s_tag[p] = 2;
  }
  __syncthreads();

  const int r1 = ra_[row];
  const int r2 = rb_[row];
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
  bool eff[L], keep[L];
#pragma unroll
  for (int k = 0; k < L; ++k) eff[k] = valid[k] && !ghost[k];
  segment_keep<T, L, N>(s, isa, isb, eff, seg, ordered, n, ipt, keep);
  locate_tail<T, L, N>(s, keep, n, ipt, kpad, hpad, out);
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
