// The posting fetch of docodo_tpu_torch's kernel buckets, for Hopper (sm_90a).
//
//   docodo_fetch_postings  <- no Pallas kernel: the JAX package fetches a
//                             bucket's lists with an XLA gather outside its
//                             kernels (docodo_tpu/ops/device_index.py
//                             gather_term :397, gather_term_paged :499),
//                             which the port first wrote as a chain of torch
//                             ops (ops/device_index.py gather_term,
//                             gather_term_paged, still its plain version)
//
// What it writes. For each of rows = B * V term ids (terms [B] or [B, V],
// any strides) and a cap: vals[r] ([rows, cap] int32) the term's postings
// coords[term_offsets[t] ..] up to min(count, cap) of them, then INF32 to
// the cap; ln[r] that length, 0 for a term < 0; with page_of, pgs[r] the
// same span of page_of, INF32 padded, written in the same pass. The small
// tables' rows hold the same spans, so the kernel reads the CSR for every
// cap.
//
// What bounds it on this card: bytes. A row reads its term id and two
// offsets, 4 bytes for each posting it copies and writes 4 bytes a lane,
// doubled with pages; there is no arithmetic to speak of. The torch chain
// it replaces moved about 50 bytes a lane, most of them int64 indices (the
// start + lane index, its clamped copy, the lane mask, a select a field).
//
// The design moves each byte once. A warp owns a task of 1024 lanes of one
// row (a row has ceil(cap / 1024) tasks, eight tasks a block of 256
// threads, one flat grid over rows x tasks): a bucket of many short rows
// gives each row a warp, and one list of 2^21 lanes spreads over 2048
// warps on every SM. Lane i of the warp owns the 16-byte vectors 32 c + i
// (c < 8) of the task and stores each with one 16-byte store, the INF32
// padding included. A CSR span starts anywhere, so the warp loads the
// aligned 16-byte vectors that cover the span (the head's and the tail's
// partial vectors whole: an aligned vector that holds one element of an
// allocation lies inside it), all nine of a lane in flight at once, and
// builds each output vector from two neighbours shifted by the span's
// misalignment s (0-3 lanes): the neighbour comes from the next lane by a
// shuffle a component, lane 31's from lane 0's next vector; s = 0 needs
// none. A lane past the span loads nothing, and a task past it only
// stores. A cap that is not a multiple of 4 (an explicit cap) takes the
// same tasks with 4-byte loads and stores. No shared memory, no barrier,
// no allocation.
//
// Every entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError().

#include "common.cuh"

namespace {

using namespace docodo;

constexpr int kFetchWarps = 8;                // tasks a block
constexpr int kChunks = 8;                    // 16-byte vectors a lane a task
constexpr int kTaskLanes = 32 * 4 * kChunks;  // 1024 lanes a task
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ int4 inf4() {
  return make_int4(kInf, kInf, kInf, kInf);
}

__device__ __forceinline__ int4 shfl4(int4 v, int src) {
  return make_int4(__shfl_sync(kAll, v.x, src), __shfl_sync(kAll, v.y, src),
                   __shfl_sync(kAll, v.z, src), __shfl_sync(kAll, v.w, src));
}

// Values s .. s + 3 of the eight v || nx.
__device__ __forceinline__ int4 shifted(int4 v, int4 nx, int s) {
  switch (s) {
    case 0: return v;
    case 1: return make_int4(v.y, v.z, v.w, nx.x);
    case 2: return make_int4(v.z, v.w, nx.x, nx.y);
    default: return make_int4(v.w, nx.x, nx.y, nx.z);
  }
}

// One warp writes dst[0, lanes) = src[0, m), then INF32: m may be <= 0 or
// past lanes; lanes <= kTaskLanes is a multiple of 4 and dst 16-byte
// aligned.
__device__ __forceinline__ void copy_vectors(const int* __restrict__ src,
                                             int m, int lanes,
                                             int* __restrict__ dst,
                                             int lane) {
  const int live = m < lanes ? m : lanes;
  const int s = (int)((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
  // aligned vector j holds src[4 j - s .. 4 j - s + 3]; it is loaded when
  // one of them is live (j = 256, past the task, only for lane 31's shift)
  const int4* q = reinterpret_cast<const int4*>(src - s);
  int4 v[kChunks + 1];
#pragma unroll
  for (int c = 0; c <= kChunks; ++c) {
    const int j = 32 * c + lane;
    v[c] = inf4();
    if (4 * j - s < live) v[c] = __ldg(q + j);
  }
  int4* out = reinterpret_cast<int4*>(dst);
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    if (128 * c >= lanes) break;  // the same for the whole warp
    int4 w = v[c];
    if (s) {
      // lane i takes lane i + 1's vector, lane 31 lane 0's next one
      const int4 nx = shfl4(lane == 0 ? v[c + 1] : v[c], (lane + 1) & 31);
      w = shifted(v[c], nx, s);
    }
    const int j = 32 * c + lane;
    const int l = 4 * j;
    if (l < lanes) {
      if (l + 3 >= live) {
        w.x = l < live ? w.x : kInf;
        w.y = l + 1 < live ? w.y : kInf;
        w.z = l + 2 < live ? w.z : kInf;
        w.w = l + 3 < live ? w.w : kInf;
      }
      out[j] = w;
    }
  }
}

// copy_vectors with 4-byte loads and stores, for any lanes and dst.
__device__ __forceinline__ void copy_scalars(const int* __restrict__ src,
                                             int m, int lanes,
                                             int* __restrict__ dst,
                                             int lane) {
  for (int k = lane; k < lanes; k += 32) dst[k] = k < m ? src[k] : kInf;
}

template <bool kPages, bool kVec>
__global__ void __launch_bounds__(32 * kFetchWarps) fetch_postings_kernel(
    const int* __restrict__ coords, const int* __restrict__ page_of,
    const int* __restrict__ term_offsets, const int* __restrict__ terms,
    int rows, int v, int stride_b, int stride_v, int cap, int tasks,
    int* __restrict__ vals, int* __restrict__ pgs, int* __restrict__ ln) {
  const int lane = threadIdx.x & 31;
  const long long task =
      (long long)blockIdx.x * kFetchWarps + (threadIdx.x >> 5);
  if (task >= (long long)rows * tasks) return;  // whole warps
  const int row = (int)(task / tasks);
  const int l0 = (int)(task - (long long)row * tasks) * kTaskLanes;
  const int t = terms[(long long)(row / v) * stride_b +
                      (long long)(row % v) * stride_v];
  int start = 0, n = 0;
  if (t >= 0) {
    start = term_offsets[t];
    n = min(term_offsets[t + 1] - start, cap);
  }
  if (l0 == 0 && lane == 0) ln[row] = n;
  const int lanes = min(kTaskLanes, cap - l0);
  const size_t at = (size_t)row * cap + l0;
  const size_t from = (size_t)start + l0;
  if (kVec) {
    copy_vectors(coords + from, n - l0, lanes, vals + at, lane);
    if (kPages) copy_vectors(page_of + from, n - l0, lanes, pgs + at, lane);
  } else {
    copy_scalars(coords + from, n - l0, lanes, vals + at, lane);
    if (kPages) copy_scalars(page_of + from, n - l0, lanes, pgs + at, lane);
  }
}

template <bool kPages, bool kVec>
void launch_fetch(unsigned blocks, const int* coords, const int* page_of,
                  const int* term_offsets, const int* terms, int rows, int v,
                  int stride_b, int stride_v, int cap, int tasks, int* vals,
                  int* pgs, int* ln, cudaStream_t stream) {
  fetch_postings_kernel<kPages, kVec><<<blocks, 32 * kFetchWarps, 0,
                                        stream>>>(
      coords, page_of, term_offsets, terms, rows, v, stride_b, stride_v, cap,
      tasks, vals, pgs, ln);
}

}  // namespace

// terms: rows / v ids of v each, id (b, k) at terms[b stride_b + k
// stride_v]; page_of and pgs both null or both set; vals / pgs [rows, cap]
// and ln [rows], contiguous.
extern "C" int docodo_fetch_postings(const int* coords, const int* page_of,
                                     const int* term_offsets,
                                     const int* terms, int rows, int v,
                                     int stride_b, int stride_v, int cap,
                                     int* vals, int* pgs, int* ln,
                                     void* stream) {
  if (rows < 0 || v <= 0 || rows % v != 0 || cap <= 0)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaGetLastError();  // empty outputs: null
  if ((page_of == nullptr) != (pgs == nullptr))
    return (int)cudaErrorInvalidValue;
  const int tasks = (cap + kTaskLanes - 1) / kTaskLanes;
  const long long blocks =
      ((long long)rows * tasks + kFetchWarps - 1) / kFetchWarps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const bool vec = cap % 4 == 0 && aligned16(vals) && aligned16(pgs);
  const cudaStream_t st = (cudaStream_t)stream;
  const unsigned g = (unsigned)blocks;
  if (page_of != nullptr && vec)
    launch_fetch<true, true>(g, coords, page_of, term_offsets, terms, rows, v,
                             stride_b, stride_v, cap, tasks, vals, pgs, ln,
                             st);
  else if (page_of != nullptr)
    launch_fetch<true, false>(g, coords, page_of, term_offsets, terms, rows,
                              v, stride_b, stride_v, cap, tasks, vals, pgs,
                              ln, st);
  else if (vec)
    launch_fetch<false, true>(g, coords, page_of, term_offsets, terms, rows,
                              v, stride_b, stride_v, cap, tasks, vals, pgs,
                              ln, st);
  else
    launch_fetch<false, false>(g, coords, page_of, term_offsets, terms, rows,
                               v, stride_b, stride_v, cap, tasks, vals, pgs,
                               ln, st);
  return (int)cudaGetLastError();
}
