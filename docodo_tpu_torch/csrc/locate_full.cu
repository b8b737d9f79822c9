// Full-result locate/rank kernels of docodo_tpu_torch, for Hopper (sm_90a).
//
// They replace three Pallas TPU kernels of docodo_tpu/ops/pallas_query.py:
//
//   docodo_sorted_and_locate_full  <- _sorted_and_locate_full_slots_kernel
//                                     (pallas_query.py:617), W = 2, cap <= 512
//   docodo_single_locate_full      <- _single_word_full_slots_kernel
//                                     (pallas_query.py:723), W = 1, cap <= 128
//   docodo_union_locate_full       <- _union_locate_full_slots_kernel
//                                     (pallas_query.py:660), W = 1, V = 1,
//                                     cap <= 1024
//
// Each kernel turns one query row of at most 1024 lanes into the row's
// first kpad page runs in slot order (page, rank, count), its first hpad
// kept hits, and the exact n_pages / n_hits totals. A run starts at a kept
// lane whose page differs from the previous kept lane's; each later lane of
// the run adds 30 / max(5, gap), and rank = (1 + bonus) + ln(count) in f32.
//
// What bounds them on this card: bytes, not arithmetic. Each row is read
// once (values and pages, 8 bytes a lane) and 3 * kpad + hpad + 2 values are
// written; in between, each lane costs a few dozen integer operations and
// a handful of block scans. The design keeps everything between that read
// and those writes on chip: one thread block per row, 256 threads, each
// thread owning up to 4 consecutive lanes, the row's values, pages and
// per-run sums in shared memory (about 29 KB), and no intermediate in
// device memory. The W = 2 kernel merges its two posting blocks by rank in
// shared memory, so the separate sort launch of the TPU route disappears.
// The TPU kernel's lane-roll log-step scans, packed scan pairs and
// log-shift compaction become one block scan (warp shuffles plus one pass
// over the warp totals) and scatters at prefix-sum slots.
//
// Every entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLanes = 1024;
constexpr int kLanesPerThread = kMaxLanes / kThreads;
constexpr int kInf = 0x7fffffff;

struct Sum {
  __device__ int operator()(int a, int b) const { return a + b; }
};
struct Max {
  __device__ int operator()(int a, int b) const { return a > b ? a : b; }
};

// Block-wide exclusive scan of one value per thread; *total receives the
// reduction over the whole block. Every thread of the block must call it.
template <class Op>
__device__ int block_exclusive(int v, int identity, Op op, int* s_warp,
                               int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x = op(x, y);
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int t = lane < kWarps ? s_warp[lane] : identity;
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, t, d);
      if (lane >= d) t = op(t, y);
    }
    if (lane < kWarps) s_warp[lane] = t;
  }
  __syncthreads();
  const int before_warp = warp > 0 ? s_warp[warp - 1] : identity;
  int in_warp = __shfl_up_sync(0xffffffffu, x, 1);
  if (lane == 0) in_warp = identity;
  *total = s_warp[kWarps - 1];
  __syncthreads();
  return op(before_warp, in_warp);
}

// Scan over the lanes this thread owns (x[k] belongs to lane
// threadIdx.x * ipt + k), in place: the exclusive prefix, or the inclusive
// one. Lanes past the row must hold the identity. Returns the block total.
template <class Op>
__device__ int scan_lanes(int (&x)[kLanesPerThread], int ipt, int identity,
                          Op op, bool inclusive, int* s_warp) {
  int agg = identity;
#pragma unroll
  for (int k = 0; k < kLanesPerThread; ++k)
    if (k < ipt) agg = op(agg, x[k]);
  int total;
  int run = block_exclusive(agg, identity, op, s_warp, &total);
#pragma unroll
  for (int k = 0; k < kLanesPerThread; ++k) {
    if (k < ipt) {
      const int v = x[k];
      if (inclusive) {
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

struct RowSmem {
  int val[kMaxLanes];
  int page[kMaxLanes];
  int tmp[kMaxLanes];
  int run_bonus[kMaxLanes];
  int run_count[kMaxLanes];
  int run_page[kMaxLanes];
  int warp[kWarps];
};

struct Outputs {
  int* pg_c;     // [rows, kpad] run pages, -1 past n_pages
  float* rk_c;   // [rows, kpad] run ranks, 0 past n_pages
  float* ct_c;   // [rows, kpad] run counts, 0 past n_pages
  int* n_pages;  // [rows]
  int* n_hits;   // [rows]
  int* hits;     // [rows, hpad] kept values, INF32 past n_hits
};

// Locate, rank and both compactions over the row held in s.val / s.page,
// given the keep mask of this thread's lanes. Called by every thread.
__device__ void locate_tail(RowSmem& s, const bool (&keep)[kLanesPerThread],
                            int n, int ipt, int kpad, int hpad,
                            const Outputs& out) {
  const int tid = threadIdx.x;
  const int base = tid * ipt;
  const size_t row = blockIdx.x;
  for (int r = tid; r < kpad; r += kThreads) {
    s.run_bonus[r] = 0;
    s.run_count[r] = 0;
  }
  // the previous kept lane of every lane: an exclusive max-scan
  int prev[kLanesPerThread];
#pragma unroll
  for (int k = 0; k < kLanesPerThread; ++k) {
    const int l = base + k;
    prev[k] = (k < ipt && l < n && keep[k]) ? l : -1;
  }
  scan_lanes(prev, ipt, -1, Max(), false, s.warp);

  int rid[kLanesPerThread], slot[kLanesPerThread], bonus[kLanesPerThread];
  bool first[kLanesPerThread];
#pragma unroll
  for (int k = 0; k < kLanesPerThread; ++k) {
    const int l = base + k;
    first[k] = false;
    bonus[k] = 0;
    const bool kept = k < ipt && l < n && keep[k];
    if (kept) {
      const int p = prev[k];
      const int prev_page = p >= 0 ? s.page[p] : -1;
      first[k] = s.page[l] != prev_page;
      if (!first[k]) {
        const int gap = s.val[l] - s.val[p];
        bonus[k] = 30 / (gap > 5 ? gap : 5);
      }
    }
    rid[k] = first[k] ? 1 : 0;
    slot[k] = kept ? 1 : 0;
  }
  // run ordinal + 1 of every kept lane, and each kept lane's hit slot
  const int total_pages = scan_lanes(rid, ipt, 0, Sum(), true, s.warp);
  const int total_hits = scan_lanes(slot, ipt, 0, Sum(), false, s.warp);

  int* hits = out.hits + row * hpad;
#pragma unroll
  for (int k = 0; k < kLanesPerThread; ++k) {
    const int l = base + k;
    if (k < ipt && l < n && keep[k]) {
      const int r = rid[k] - 1;
      if (r < kpad) {
        atomicAdd(&s.run_count[r], 1);
        if (bonus[k]) atomicAdd(&s.run_bonus[r], bonus[k]);
        if (first[k]) s.run_page[r] = s.page[l];
      }
      if (slot[k] < hpad) hits[slot[k]] = s.val[l];
    }
  }
  __syncthreads();
  for (int r = tid; r < kpad; r += kThreads) {
    const size_t o = row * kpad + r;
    if (r < total_pages) {
      const int c = s.run_count[r];
      out.pg_c[o] = s.run_page[r];
      out.rk_c[o] = (1.0f + (float)s.run_bonus[r]) + logf(fmaxf((float)c, 1.0f));
      out.ct_c[o] = (float)c;
    } else {
      out.pg_c[o] = -1;
      out.rk_c[o] = 0.0f;
      out.ct_c[o] = 0.0f;
    }
  }
  for (int r = total_hits + tid; r < hpad; r += kThreads) hits[r] = kInf;
  if (tid == 0) {
    out.n_pages[row] = total_pages;
    out.n_hits[row] = total_hits;
  }
}

__device__ int clamp_len(int v, int cap) {
  return v < 0 ? 0 : (v > cap ? cap : v);
}

// #{j < m: s[j] < v}
__device__ int lower_bound(const int* s, int m, int v) {
  int lo = 0, hi = m;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// #{j < m: s[j] <= v}
__device__ int upper_bound(const int* s, int m, int v) {
  int lo = 0, hi = m;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s[mid] <= v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// W = 2 proximity/phrase AND (pallas_query._sorted_and_keep): the two
// posting blocks merge by rank into (coord, tag) order (word A first on
// equal coords, padding last), cross-operand duplicates fold onto their
// first slot, gaps wider than |R| cut segments, both R < 0 adds the ordered
// cut at each segment's first word-A slot, and a segment keeps its slots
// only if it holds both words.
__global__ void __launch_bounds__(kThreads) sorted_and_locate_full_kernel(
    const int* __restrict__ a, const int* __restrict__ a_pg,
    const int* __restrict__ na_, const int* __restrict__ ra_,
    const int* __restrict__ b, const int* __restrict__ b_pg,
    const int* __restrict__ nb_, const int* __restrict__ rb_, int cap,
    int kpad, int hpad, Outputs out) {
  __shared__ RowSmem s;
  __shared__ int s_a[kMaxLanes / 2];
  __shared__ int s_b[kMaxLanes / 2];
  __shared__ unsigned char s_tag[kMaxLanes];
  const int tid = threadIdx.x;
  const size_t row = blockIdx.x;
  const int n = 2 * cap;
  const int ipt = (n + kThreads - 1) / kThreads;
  const int base = tid * ipt;
  const int na = clamp_len(na_[row], cap);
  const int nb = clamp_len(nb_[row], cap);
  const int* arow = a + row * cap;
  const int* brow = b + row * cap;
  const int* apg = a_pg + row * cap;
  const int* bpg = b_pg + row * cap;
  for (int i = tid; i < cap; i += kThreads) {
    s_a[i] = i < na ? arow[i] : kInf;
    s_b[i] = i < nb ? brow[i] : kInf;
  }
  __syncthreads();
  for (int i = tid; i < cap; i += kThreads) {
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
  for (int p = na + nb + tid; p < n; p += kThreads) {
    s.val[p] = kInf;
    s.page[p] = 0;
    s_tag[p] = 2;
  }
  __syncthreads();

  const int r1 = ra_[row];
  const int r2 = rb_[row];
  const int abs_r = max(abs(r1), abs(r2));
  const bool ordered = r1 < 0 && r2 < 0;
  bool isa[kLanesPerThread], isb[kLanesPerThread], ghost[kLanesPerThread];
  bool valid[kLanesPerThread], seg[kLanesPerThread];
#pragma unroll
  for (int k = 0; k < kLanesPerThread; ++k) {
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
  if (ordered) {  // uniform over the block, so the scans inside are safe
    int before[kLanesPerThread], start[kLanesPerThread];
#pragma unroll
    for (int k = 0; k < kLanesPerThread; ++k) {
      const int l = base + k;
      before[k] = isa[k] ? 1 : 0;
      start[k] = (k < ipt && l < n && seg[k]) ? l : -1;
    }
    scan_lanes(before, ipt, 0, Sum(), false, s.warp);
    scan_lanes(start, ipt, -1, Max(), true, s.warp);
#pragma unroll
    for (int k = 0; k < kLanesPerThread; ++k) {
      const int l = base + k;
      if (k < ipt && l < n) s.tmp[l] = before[k];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kLanesPerThread; ++k) {
      const int l = base + k;
      if (k < ipt && l < n && isa[k] && l != start[k] &&
          before[k] == s.tmp[start[k]])
        seg[k] = true;
    }
    __syncthreads();
  }
  int sid[kLanesPerThread];
#pragma unroll
  for (int k = 0; k < kLanesPerThread; ++k) sid[k] = seg[k] ? 1 : 0;
  scan_lanes(sid, ipt, 0, Sum(), true, s.warp);
  for (int l = tid; l < n; l += kThreads) s.tmp[l] = 0;
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kLanesPerThread; ++k)
    if (isa[k] || isb[k])
      atomicOr(&s.tmp[sid[k] - 1], (isa[k] ? 1 : 0) | (isb[k] ? 2 : 0));
  __syncthreads();
  bool keep[kLanesPerThread];
#pragma unroll
  for (int k = 0; k < kLanesPerThread; ++k)
    keep[k] = valid[k] && !ghost[k] && s.tmp[sid[k] - 1] == 3;
  locate_tail(s, keep, n, ipt, kpad, hpad, out);
}

// Loads one posting block row (INF32 past na) and its page stream.
__device__ int load_block(RowSmem& s, const int* a, const int* a_pg,
                          const int* na_, int cap) {
  const size_t row = blockIdx.x;
  const int na = clamp_len(na_[row], cap);
  for (int l = threadIdx.x; l < cap; l += kThreads) {
    s.val[l] = l < na ? a[row * cap + l] : kInf;
    s.page[l] = a_pg[row * cap + l];
  }
  __syncthreads();
  return na;
}

// W = 1: the posting block is the kept stream.
__global__ void __launch_bounds__(kThreads) single_locate_full_kernel(
    const int* __restrict__ a, const int* __restrict__ a_pg,
    const int* __restrict__ na_, int cap, int kpad, int hpad, Outputs out) {
  __shared__ RowSmem s;
  const int na = load_block(s, a, a_pg, na_, cap);
  const int ipt = (cap + kThreads - 1) / kThreads;
  const int base = threadIdx.x * ipt;
  bool keep[kLanesPerThread];
#pragma unroll
  for (int k = 0; k < kLanesPerThread; ++k) keep[k] = k < ipt && base + k < na;
  locate_tail(s, keep, cap, ipt, kpad, hpad, out);
}

// W = 1 union of one variant: a slot is kept where it is valid and
// differs from the previous slot.
__global__ void __launch_bounds__(kThreads) union_locate_full_kernel(
    const int* __restrict__ a, const int* __restrict__ a_pg,
    const int* __restrict__ na_, int cap, int kpad, int hpad, Outputs out) {
  __shared__ RowSmem s;
  load_block(s, a, a_pg, na_, cap);
  const int ipt = (cap + kThreads - 1) / kThreads;
  const int base = threadIdx.x * ipt;
  bool keep[kLanesPerThread];
#pragma unroll
  for (int k = 0; k < kLanesPerThread; ++k) {
    const int l = base + k;
    keep[k] = false;
    if (k < ipt && l < cap) {
      const int v = s.val[l];
      keep[k] = v < kInf && v != (l > 0 ? s.val[l - 1] : -1);
    }
  }
  locate_tail(s, keep, cap, ipt, kpad, hpad, out);
}

Outputs outputs(int* pg_c, float* rk_c, float* ct_c, int* n_pages,
                int* n_hits, int* hits) {
  Outputs o;
  o.pg_c = pg_c;
  o.rk_c = rk_c;
  o.ct_c = ct_c;
  o.n_pages = n_pages;
  o.n_hits = n_hits;
  o.hits = hits;
  return o;
}

}  // namespace

extern "C" int docodo_sorted_and_locate_full(
    const int* a, const int* a_pg, const int* na, const int* ra,
    const int* b, const int* b_pg, const int* nb, const int* rb, int rows,
    int cap, int kpad, int hpad, int* pg_c, float* rk_c, float* ct_c,
    int* n_pages, int* n_hits, int* hits, void* stream) {
  if (rows > 0)
    sorted_and_locate_full_kernel<<<rows, kThreads, 0,
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
    single_locate_full_kernel<<<rows, kThreads, 0, (cudaStream_t)stream>>>(
        a, a_pg, na, cap, kpad, hpad,
        outputs(pg_c, rk_c, ct_c, n_pages, n_hits, hits));
  return (int)cudaGetLastError();
}

extern "C" int docodo_union_locate_full(
    const int* a, const int* a_pg, const int* na, int rows, int cap,
    int kpad, int hpad, int* pg_c, float* rk_c, float* ct_c, int* n_pages,
    int* n_hits, int* hits, void* stream) {
  if (rows > 0)
    union_locate_full_kernel<<<rows, kThreads, 0, (cudaStream_t)stream>>>(
        a, a_pg, na, cap, kpad, hpad,
        outputs(pg_c, rk_c, ct_c, n_pages, n_hits, hits));
  return (int)cudaGetLastError();
}

extern "C" const char* docodo_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
