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
// the windows ra / rb [rows] and the page bounds [p]. It runs row 1's row
// body (slot_row.cuh: tagged_keep, sum_runs) and writes what the TPU kernel
// writes, each [rows, n]: every lane's page, each run's rank and count at
// the run's first lane (0 elsewhere), the kept values (INF32 elsewhere); and
// npages / nhits [rows]. The page of a lane is the one thing it varies, a
// template policy:
//
//   BoundsSearch  #bounds <= v clamped to the last page, a binary search of
//                 the bounds in device memory: the port's production locate
//                 (slot_row.cuh page_of_coord), in place of the TPU's
//                 compare-all against every bound
//   Arith         min(v / page_len, p - 1): exact on pages of one length, a
//                 lower bound on the locate's cost otherwise (page_arith)
//   TwoLevel      a search of every 128th bound, staged in shared memory by
//                 the block, then a search inside the 128 bounds of the
//                 block it names: the same page as BoundsSearch, with 7 of
//                 its reads from device memory instead of log2(p) (the GPU
//                 meaning of page_mxu, whose one-hot matmul picks the block
//                 on the TPU's matrix unit)
//
// What bounds it on this card: bytes. A row reads 2 n int32 and 2 scalars
// and writes 4 n + 2 values; between them each lane costs a few dozen
// integer operations, the scans of the keep and the run sums, and the page
// search. The design is row 1's: a row group of n / 4 threads a row, the
// row in shared memory, no intermediate in device memory.
//
// docodo_row_gather copies table rows tab[ids[b]] ([R, n] int32) into
// out[b] ([B, n], mode 0) or reduces each to 128 lanes, out[b, l] =
// sum_k tab[ids[b], 128 k + l] ([B, 128], mode 1, int32 wrapping as the
// TPU's sum does). A block takes Q consecutive ids (Q = 32, 64 or 128): one
// thread issues a 1-D bulk copy (TMA, cp.async.bulk) of each row into a
// ring of `depth` row slots in shared memory, each slot with its mbarrier,
// which the copy completes by its bytes; every thread waits for the slot,
// writes it out (16-byte stores) or reduces it, and the slot is refilled
// with the row `depth` ids on. This is the TPU kernel's per-row DMA into
// VMEM with a semaphore a row; the TPU's [R, 8, n / 8] table layout was a
// workaround of its (8, 128) tiling and is not carried over. What bounds
// it: bytes, B n 4 read and B n 4 (copy) or B 512 (sum) written; the ring
// keeps up to 96 KB of rows in flight a block, two blocks an SM.
//
// Every entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError().

#include <atomic>

#include "slot_row.cuh"

namespace {

using namespace docodo;

// ---------------------------------------------------------------------------
// docodo_probe_locate
// ---------------------------------------------------------------------------

constexpr int kBoundsBlock = 128;     // bounds a TwoLevel fine block
constexpr int kMaxCoarse = 1024;      // fine blocks TwoLevel stages

struct BoundsSearch {
  static constexpr int kStage = 1;
  const int* bounds;
  int p;
  __device__ void stage(int*) const {}
  __device__ int operator()(int v, const int*) const {
    return page_of_coord(bounds, p, v);
  }
};

struct Arith {
  static constexpr int kStage = 1;
  int page_len;
  int p;
  __device__ void stage(int*) const {}
  __device__ int operator()(int v, const int*) const {
    const int pg = v / page_len;
    return pg < p - 1 ? pg : p - 1;
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
  // not: the page is c's first bound past v
  __device__ int operator()(int v, const int* coarse) const {
    const int c_n = blocks();
    const int c = upper_bound(coarse, c_n, v);
    if (c >= c_n) return p - 1;
    const int lo = c * kBoundsBlock;
    const int m = p - lo < kBoundsBlock ? p - lo : kBoundsBlock;
    const int pg = lo + upper_bound(bounds + lo, m, v);
    return pg < p - 1 ? pg : p - 1;
  }
};

template <int N>
using ProbeShape = SlotShape<N, AndSmem<N>>;

template <class Page, int N>
__global__ void __launch_bounds__(kSlotThreads) probe_locate_kernel(
    const int* __restrict__ vals, const int* __restrict__ tags,
    const int* __restrict__ ra, const int* __restrict__ rb, int rows, int n,
    Page page, int* __restrict__ page_out, float* __restrict__ rank_out,
    float* __restrict__ cnt_out, int* __restrict__ npages,
    int* __restrict__ nhits, int* __restrict__ hits) {
  using S = ProbeShape<N>;
  constexpr int G = S::kGroup;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int staged[Page::kStage];
  page.stage(staged);
  __syncthreads();
  const GroupRow<G> g{};
  if (g.row() >= (size_t)rows) return;  // the last block's spare groups
  auto& sm = reinterpret_cast<AndSmem<N>*>(smem_raw)[g.group()];
  RowSmem<N>& s = sm.row;
  const size_t row = g.row();
  const size_t o = row * n;
  const int tid = g.rank();
  const int ipt = (n + G - 1) / G;
  const int base = tid * ipt;
  for (int l = tid; l < n; l += G) {
    const int v = vals[o + l];
    s.val[l] = v;
    s.page[l] = page(v, staged);
    sm.tag[l] = (unsigned char)tags[o + l];
  }
  g.sync();
  bool keep[S::kIpt];
  tagged_keep(g, sm, ra[row], rb[row], n, keep);
  int kept[S::kIpt];
#pragma unroll
  for (int k = 0; k < S::kIpt; ++k)
    kept[k] = (k < ipt && base + k < n && keep[k]) ? 1 : 0;
  const int total_hits = scan_lanes(g, kept, ipt, 0, Sum(), false, s.warp);
  // every run's sums, and its first lane in s.tmp
  const int runs = sum_runs(g, s, keep, n, ipt, n, s.tmp);
  for (int l = tid; l < n; l += G) {
    page_out[o + l] = s.page[l];
    rank_out[o + l] = 0.0f;
    cnt_out[o + l] = 0.0f;
  }
#pragma unroll
  for (int k = 0; k < S::kIpt; ++k) {
    const int l = base + k;
    if (k < ipt && l < n) hits[o + l] = keep[k] ? s.val[l] : kInf;
  }
  // the run starts overwrite what other threads of the row wrote above
  g.sync();
  for (int r = tid; r < runs; r += G) {
    const int l = s.tmp[r];
    const int c = s.run_count[r];
    rank_out[o + l] = run_rank(s.run_bonus[r], c);
    cnt_out[o + l] = (float)c;
  }
  if (tid == 0) {
    npages[row] = runs;
    nhits[row] = total_hits;
  }
}

template <class Page>
int launch_probe(const int* vals, const int* tags, const int* ra,
                 const int* rb, int rows, int n, const Page& page,
                 int* page_out, float* rank_out, float* cnt_out, int* npages,
                 int* nhits, int* hits, void* stream) {
  return with_width(n, [&](auto w) {
    constexpr int N = decltype(w)::value;
    using S = ProbeShape<N>;
    if (rows > 0)
      probe_locate_kernel<Page, N>
          <<<S::blocks(rows), S::kThreads, S::kSmem, (cudaStream_t)stream>>>(
              vals, tags, ra, rb, rows, n, page, page_out, rank_out, cnt_out,
              npages, nhits, hits);
    return (int)cudaGetLastError();
  });
}

// ---------------------------------------------------------------------------
// docodo_row_gather
// ---------------------------------------------------------------------------

constexpr int kGatherThreads = 256;
constexpr int kGatherSmem = 96 * 1024;  // the ring's bytes a block
constexpr int kMaxDepth = 128;          // the ring's slots at most (Q)

__device__ inline uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ inline void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
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

template <int Q>
__global__ void __launch_bounds__(kGatherThreads) row_gather_kernel(
    const int* __restrict__ tab, const int* __restrict__ ids, int rows,
    int n, int depth, int mode, int* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char ring_raw[];
  __shared__ __align__(8) uint64_t bar[kMaxDepth];
  __shared__ int partial[kGatherThreads];
  int* ring = reinterpret_cast<int*>(ring_raw);
  const int first = blockIdx.x * Q;
  const int count = rows - first < Q ? rows - first : Q;
  const unsigned bytes = (unsigned)n * 4u;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int d = 0; d < depth; ++d) mbar_init(&bar[d], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int j = 0; j < depth && j < count; ++j)
      bulk_load(ring + (size_t)j * n, tab + (size_t)ids[first + j] * n,
                bytes, &bar[j]);
  for (int j = 0; j < count; ++j) {
    const int d = j % depth;
    while (!mbar_try_wait(&bar[d], (unsigned)(j / depth) & 1u)) {
    }
    const int* slot = ring + (size_t)d * n;
    const size_t b = (size_t)(first + j);
    if (mode == 0) {
      const int4* src = reinterpret_cast<const int4*>(slot);
      int4* dst = reinterpret_cast<int4*>(out + b * n);
      for (int i = tid; i < n / 4; i += kGatherThreads) dst[i] = src[i];
    } else {
      // column tid % 128 over every other 128-lane chunk, two halves
      const int col = tid & 127;
      int acc = 0;
      for (int c = tid >> 7; c < n / 128; c += kGatherThreads / 128)
        acc += slot[c * 128 + col];
      partial[tid] = acc;
      __syncthreads();
      if (tid < 128) out[b * 128 + tid] = partial[tid] + partial[tid + 128];
    }
    // every thread is done with slot d before it is refilled
    __syncthreads();
    if (tid == 0 && j + depth < count) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bulk_load(ring + (size_t)d * n, tab + (size_t)ids[first + j + depth] * n,
                bytes, &bar[d]);
    }
  }
}

template <int Q>
int launch_gather(const int* tab, const int* ids, int rows, int n, int mode,
                  int* out, void* stream) {
  static std::atomic<unsigned> sized{0};
  const int fit = kGatherSmem / (n * 4);
  const int depth = fit < Q ? fit : Q;
  if (depth < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)depth * n * 4;
  const cudaError_t e = size_smem(row_gather_kernel<Q>, kGatherSmem, &sized);
  if (e != cudaSuccess) return (int)e;
  if (rows > 0)
    row_gather_kernel<Q>
        <<<(rows + Q - 1) / Q, kGatherThreads, smem, (cudaStream_t)stream>>>(
            tab, ids, rows, n, depth, mode, out);
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
    Arith pg{page_len, p};
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
// n % 128 == 0); q: ids a block, 32, 64 or 128; n * 4 <= 96 KB. The table
// and out are 16-byte aligned.
extern "C" int docodo_row_gather(const int* tab, const int* ids, int n,
                                 int rows, int q, int mode, int* out,
                                 void* stream) {
  if (n <= 0 || n % 4 != 0 || (mode == 1 && n % 128 != 0) ||
      (mode != 0 && mode != 1) || !aligned16(tab) || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  if (q == 32) return launch_gather<32>(tab, ids, rows, n, mode, out, stream);
  if (q == 64) return launch_gather<64>(tab, ids, rows, n, mode, out, stream);
  if (q == 128)
    return launch_gather<128>(tab, ids, rows, n, mode, out, stream);
  return (int)cudaErrorInvalidValue;
}
