// The chunked full-result kernels of docodo_tpu_torch, for Hopper (sm_90a):
// streams of any width, past what one block holds in shared memory. They
// replace these Pallas TPU kernels of docodo_tpu/ops/pallas_query.py:
//
//   docodo_merge_tagged  <- _bitonic_merge_kernel (pallas_query.py:2290),
//                           and the lax.sort of word-tagged variant blocks
//                           and of a W >= 3 fold step outside any kernel
//                           (device_index.py:1237, :1288)
//   docodo_and_keep      <- _chunked_and_fwd_kernel (:1935) +
//                           _chunked_and_bwd_kernel (:2227), and
//                           _fused_and_kernel (:2389) for n <= 4096; it
//                           also writes a fold step's compacted stream
//   docodo_variants_keep <- _chunked_variants_fwd_kernel (:2071) +
//                           _chunked_and_bwd_kernel, and
//                           _fused_variants_and_kernel (:2411) for
//                           n <= 4096
//   docodo_locate_runs   <- _chunked_locate_kernel (:1480) and
//                           _resident_locate_kernel (:1676), with the
//                           first-topk-runs compaction compact_streams_topk
//                           (:1731) and the hits compaction of
//                           device_index._locate_full_chunked (:1050)
//
// What bounds them on this card. Each reads its input streams once and
// writes its outputs once with a few integer operations a lane, so their
// floor is bytes. But a wide bucket has few rows (8 or fewer at n =
// 524288), and a kernel that gives a row one block leaves most of the
// 132 SMs idle while that block walks its row's chunks one after the
// other: such a launch is bound by the latency of one block sweeping a
// long row, not by bytes.
//
// So and_keep, variants_keep and locate_runs cut a row into tiles of
// kTile = 4096 lanes, one block each (tiles on grid x, rows on y): 256
// threads of 16 consecutive lanes, read as 16-byte loads. The per-row
// state that the TPU route carries between the steps of its sequential
// grid becomes an associative summary of a stretch of lanes (RunSum,
// SegSum, CountSum). A block scans its threads' summaries, takes its
// tile's exclusive prefix from the tiles before it by decoupled
// look-back (tile_scan.cuh: status words and summaries polled in L2,
// tiles ordered by a ticket), and each thread then walks its 16 lanes
// with the exact state a sweep of the whole row would have there. A
// launch costs about one tile's latency plus the look-back chain; a row
// of one tile (n <= 4096: the many-row buckets) finds no predecessor.
//
// The keep kernels are two launches from one entry point: pass 1 writes
// each lane's segment code and each segment's operand counts, pass 2
// resolves each lane from its segment's two entries, the second of which
// pass 1 may write in any later tile; the stream order between the
// launches is the grid-wide barrier. locate_runs ends a row in the block
// that finishes it last (a per-row counter behind __threadfence, as in
// CUDA's threadFenceReduction sample): that epilogue reads at most
// kpad + 1 run entries and pads the hits, less work than a second
// launch would cost in launch latency. It looks pages up in a window of
// bounds that the tile stages in shared memory: the tile's kept values
// lie between its first and last, so their pages lie in the bounds
// between the two, found by a 32-way warp search (3 rounds for 22k
// pages).
//
// merge_tagged is bound by bytes too: each block lane is read once and
// each output lane (value, tag, page) written once, a few compares a lane.
// The TPU's bitonic merge network and its sorts of already sorted blocks
// become a merge-path merge in output tiles: a block owns kMergeTile =
// 2048 lanes of the merged row, two of its warps find where the tile's
// first and last lanes split the two input runs (a 32-way co-rank search,
// once a tile, not once an element), the tile's inputs are staged in
// shared memory with 16-byte loads, each thread merges 8 lanes there from
// its own co-rank, and the tile goes out as 16-byte stores. All padding
// lanes are equal, so the output is the merge of the real elements
// followed by a constant fill, which the tiles past the real elements
// write without searching. More than two blocks (k = va + vb) merge as a
// pairwise tree, ties to the left so that block order holds: ceil(log2 k)
// launches, each moving the row once (k = 8: three times the one-pass
// bytes). A row of at most 2048 lanes and 32 blocks runs the whole tree
// in one block's shared memory in one launch (merge_row_kernel): such
// rows are bound by launches and latency, not by bytes. A k-way co-rank
// in one pass would need, per tile, a search over the value range with a
// rank in every block at each step (about 31 x k x log2(cap) dependent
// loads), where a pass costs one stream read and write; so the tree. The compare-all compactions become scatters at
// prefix-sum slots.
//
// Every entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError(). The tiled ones take two scratch
// arrays from the caller, sized by docodo_keep_scratch /
// docodo_locate_runs_scratch: `zeroed` (status words and tickets, zero
// before the launch when a row has more than one tile; a row of one tile
// reads none of them) and `work` (summaries, uninitialised).

#include <stdint.h>

#include "common.cuh"
#include "tile_scan.cuh"

namespace {

using namespace docodo;

constexpr int kThreads = 256;
constexpr int kLanes = 16;                // consecutive lanes a thread owns
constexpr int kTile = kThreads * kLanes;  // lanes a block owns
constexpr int kWindow = 2048;             // page bounds a tile can stage
constexpr int kMergeThreads = 256;
constexpr int kMergeIpt = 8;  // output lanes a thread of merge_tagged merges
constexpr int kMergeTile = kMergeThreads * kMergeIpt;
constexpr int kRowBlocks = 32;  // blocks a row merged in one block may have
constexpr int kStageUnits = 2;  // loads in flight a thread when staging

// ---------------------------------------------------------------------------
// merge_tagged
// ---------------------------------------------------------------------------

// The row's va blocks of word A (tag 0) and vb blocks of word B (tag 1),
// block j of word A at a[row, j, :cap_a] with its length in na_[row, j]
// (word B likewise), as merge_tagged sees them: block j at offset off(j)
// of the merged row, which is the blocks' concatenation. `vec`: every
// block row and page row may be read with 16-byte loads.
struct MergeBlocks {
  const int* a;
  const int* a_pg;
  const int* na;
  const int* b;
  const int* b_pg;
  const int* nb;
  int va, cap_a, vb, cap_b, n;
  bool vec;
  __host__ __device__ int off(int j) const {
    return j < va ? j * cap_a : va * cap_a + (j - va) * cap_b;
  }
  __device__ int len(size_t row, int j) const {
    return j < va ? clamp_len(na[row * va + j], cap_a)
                  : clamp_len(nb[row * vb + j - va], cap_b);
  }
  __device__ const int* vals(size_t row, int j) const {
    return j < va ? a + (row * va + j) * cap_a
                  : b + (row * vb + j - va) * cap_b;
  }
  __device__ const int* pages(size_t row, int j) const {
    if (!a_pg) return nullptr;
    return j < va ? a_pg + (row * va + j) * cap_a
                  : b_pg + (row * vb + j - va) * cap_b;
  }
};

// One [rows, n] stream: values, tags and pages (null for none).
struct Stream {
  int* vals;
  int* tag;
  int* pg;
};

// Merge-path co-rank: how many of the first d outputs of the merge of the
// ascending runs l [la] and r [lb], ties to l, come from l. One warp
// searches together, 32 probes a round (4 rounds for 2^18 candidates).
__device__ inline int warp_corank(const int* l, int la, const int* r, int lb,
                                  int d) {
  const int lane = threadIdx.x & 31;
  int lo = max(0, d - lb), hi = min(d, la);  // the co-rank is in [lo, hi]
  while (lo < hi) {
    const int len = hi - lo;
    const int step = (len + 31) / 32;
    const int probe = lo + min(len, (lane + 1) * step) - 1;
    const int c = __popc(
        __ballot_sync(kFullMask, l[probe] <= r[d - 1 - probe]));
    if (c == 32) return hi;
    hi = lo + min(len, (c + 1) * step) - 1;  // probe c is false
    lo += c * step;
  }
  return lo;
}

// w (4 or 1) consecutive ints of src from lane q * w on: one 16-byte
// load for w = 4.
__device__ inline void load_unit(const int* __restrict__ src, int q, int w,
                                 int (&x)[4]) {
  if (w == 4) {
    const int4 v = reinterpret_cast<const int4*>(src)[q];
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  } else {
    x[0] = src[q];
  }
}

// A merge pass's two input segments into shared memory: left run lanes
// i0 .. i0 + ca - 1 to 0 .. ca - 1 and right run lanes j0 .. j0 + cb - 1
// after them, values, pages (lp / rp, or none) and tags (lt / rt, or the
// constants tl / tr) in the same round of loads. Each thread takes units
// of w lanes: quads read as 16-byte loads where `vec` (the runs' rows
// 16-byte aligned, their widths multiples of 4), single lanes otherwise.
__device__ inline void stage_pair(
    const int* lv, const int* lp, const int* lt, unsigned char tl, int i0,
    int ca, const int* rv, const int* rp, const int* rt, unsigned char tr,
    int j0, int cb, bool vec, int* s_val, int* s_pg,
    unsigned char* s_tag) {
  const int w = vec ? 4 : 1;
  const int l0 = i0 / w, nl = ca ? (i0 + ca + w - 1) / w - l0 : 0;
  const int r0 = j0 / w, nr = cb ? (j0 + cb + w - 1) / w - r0 : 0;
  // kStageUnits units a thread with all their loads in flight together
  for (int u0 = threadIdx.x; u0 < nl + nr;
       u0 += kStageUnits * kMergeThreads) {
    int v[kStageUnits][4], pg[kStageUnits][4], tg[kStageUnits][4];
#pragma unroll
    for (int k = 0; k < kStageUnits; ++k) {
      const int u = u0 + k * kMergeThreads;
      if (u < nl + nr) {
        const bool left = u < nl;
        const int q = left ? l0 + u : r0 + u - nl;
        const int* p = left ? lp : rp;
        const int* t = left ? lt : rt;
        load_unit(left ? lv : rv, q, w, v[k]);
        if (p) load_unit(p, q, w, pg[k]);
        if (t) load_unit(t, q, w, tg[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < kStageUnits; ++k) {
      const int u = u0 + k * kMergeThreads;
      if (u < nl + nr) {
        const bool left = u < nl;
        const int q = left ? l0 + u : r0 + u - nl;
        const int from = left ? i0 : j0;
        const int count = left ? ca : cb;
        const int base = left ? 0 : ca;
        const bool paged = (left ? lp : rp) != nullptr;
        const bool tagged = (left ? lt : rt) != nullptr;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = q * w + e - from;
          if (e < w && x >= 0 && x < count) {
            s_val[base + x] = v[k][e];
            if (paged) s_pg[base + x] = pg[k][e];
            s_tag[base + x] = tagged ? tg[k][e] : (left ? tl : tr);
          }
        }
      }
    }
  }
}

// dst[0 .. count) from the tile staged in shared memory, with 16-byte
// stores where `vec` (dst 16-byte aligned) and scalar ones after.
template <class S>
__device__ inline void store_tile(int* __restrict__ dst, const S* src,
                                  int count, bool vec) {
  const int quads = vec ? count >> 2 : 0;
  for (int q = threadIdx.x; q < quads; q += kMergeThreads)
    reinterpret_cast<int4*>(dst)[q] =
        make_int4(src[4 * q], src[4 * q + 1], src[4 * q + 2], src[4 * q + 3]);
  for (int x = 4 * quads + threadIdx.x; x < count; x += kMergeThreads)
    dst[x] = src[x];
}

// One pass of merge_tagged's pairwise tree. Run r of `level` holds the
// row's blocks r << level .. ((r + 1) << level) - 1, merged, at their
// offset: the blocks themselves at level 0, `src` after. Pair q (grid z)
// merges runs 2q and 2q + 1, ties to the left, into the next level's run q
// in `dst`, at the same offset; a run without a partner is copied. Equal
// coords therefore keep block order at every level. Each block (grid y)
// owns kMergeTile lanes of its pair's output: two warps find the tile's
// first and last co-ranks by warp_corank over the runs in device memory,
// the tile's two input segments are staged in shared memory, each thread
// merges kMergeIpt lanes from its own co-rank there, and the tile is
// stored from shared memory. With `last` (the pass that writes the
// output; its one pair spans the row) lanes past the real elements get
// INF32, tag 2, page 0; before it they are left as they are.
__global__ void __launch_bounds__(kMergeThreads) merge_pass_kernel(
    MergeBlocks m, int level, Stream src, Stream dst, bool last,
    bool vec_out) {
  __shared__ __align__(16) int s_val[kMergeTile];
  __shared__ __align__(16) int s_pg[kMergeTile];
  __shared__ unsigned char s_tag[kMergeTile];
  __shared__ int s_cut[2], s_len[2];
  const size_t row = blockIdx.x;
  const int tid = threadIdx.x;
  const int nblk = m.va + m.vb;
  const int f0 = (2 * blockIdx.z) << level;
  const int f1 = min(f0 + (1 << level), nblk);
  const int f2 = min(f1 + (1 << level), nblk);
  const int out = m.off(f0);
  const int width = m.off(f2) - out;
  const int d0 = blockIdx.y * kMergeTile;
  if (d0 >= width) return;
  if (tid < 32) {  // the two runs' lengths, a block a lane
    int sa = 0, sb = 0;
    for (int j = f0 + tid; j < f2; j += 32) {
      const int len = m.len(row, j);
      if (j < f1) sa += len; else sb += len;
    }
    sa = __reduce_add_sync(kFullMask, sa);
    sb = __reduce_add_sync(kFullMask, sb);
    if (tid == 0) {
      s_len[0] = sa;
      s_len[1] = sb;
    }
  }
  __syncthreads();
  const int la = s_len[0], lb = s_len[1];
  const int total = la + lb;
  if (!last && d0 >= total) return;
  const bool paged = dst.pg != nullptr;
  // the left and right runs
  const int *lv, *rv, *lp = nullptr, *rp = nullptr, *lt = nullptr,
                       *rt = nullptr;
  if (level == 0) {
    lv = m.vals(row, f0);
    rv = f1 < f2 ? m.vals(row, f1) : lv;
    lp = m.pages(row, f0);
    rp = f1 < f2 ? m.pages(row, f1) : lp;
  } else {
    const size_t at = row * m.n;
    lv = src.vals + at + out;
    rv = src.vals + at + m.off(f1);
    lt = src.tag + at + out;
    rt = src.tag + at + m.off(f1);
    if (paged) {
      lp = src.pg + at + out;
      rp = src.pg + at + m.off(f1);
    }
  }
  const bool real = d0 < total;
  const int d1 = real ? min(d0 + kMergeTile, total) : d0;
  if (real && tid < 64) {
    const int c = warp_corank(lv, la, rv, lb, tid < 32 ? d0 : d1);
    if ((tid & 31) == 0) s_cut[tid >> 5] = c;
  }
  __syncthreads();
  const int i0 = real ? s_cut[0] : 0;
  const int ca = real ? s_cut[1] - i0 : 0;  // lanes from the left run
  const int j0 = d0 - i0;
  const int cb = d1 - d0 - ca;               // and from the right run
  stage_pair(lv, lp, lt, f0 < m.va ? 0 : 1, i0, ca, rv, rp, rt,
             f1 < m.va ? 0 : 1, j0, cb, level == 0 ? m.vec : vec_out, s_val,
             s_pg, s_tag);
  __syncthreads();

  const int cnt = d1 - d0;
  const int d = tid * kMergeIpt;
  int ov[kMergeIpt], op[kMergeIpt];
  unsigned char ot[kMergeIpt];
  if (d < cnt) {
    int lo = max(0, d - cb), hi = min(d, ca);
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (s_val[mid] <= s_val[ca + d - 1 - mid]) lo = mid + 1; else hi = mid;
    }
    int i = lo, j = d - lo;
#pragma unroll
    for (int k = 0; k < kMergeIpt; ++k) {
      if (d + k < cnt) {
        const bool left =
            j >= cb || (i < ca && s_val[i] <= s_val[ca + j]);
        const int x = left ? i++ : ca + j++;
        ov[k] = s_val[x];
        op[k] = paged ? s_pg[x] : 0;
        ot[k] = s_tag[x];
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kMergeIpt; ++k) {
    if (d + k < cnt) {
      s_val[d + k] = ov[k];
      s_pg[d + k] = op[k];
      s_tag[d + k] = ot[k];
    }
  }
  const int w = last ? min(kMergeTile, width - d0) : cnt;
  for (int x = cnt + tid; x < w; x += kMergeThreads) {
    s_val[x] = kInf;
    s_pg[x] = 0;
    s_tag[x] = 2;
  }
  __syncthreads();
  const size_t at = row * m.n + out + d0;
  store_tile(dst.vals + at, s_val, w, vec_out);
  store_tile(dst.tag + at, s_tag, w, vec_out);
  if (paged) store_tile(dst.pg + at, s_pg, w, vec_out);
}

// merge_tagged of a row that fits one block: n <= kMergeTile lanes, at
// most kRowBlocks blocks, caps multiples of kMergeIpt. A row of many
// blocks that is not wide would pay a launch and a trip through device
// memory for every level of the tree, so here the
// whole tree runs in shared memory in one launch: the blocks are staged
// at their offsets, each level merges in place (a thread merges its
// kMergeIpt output lanes of its pair, ties to the left, from its own
// co-rank into registers, and the block writes them back), and the merged
// row and its fill are stored once. The thread owning lanes x .. x +
// kMergeIpt - 1 serves the pair that holds lane x at every level: pair
// widths are whole blocks.
__global__ void __launch_bounds__(kMergeThreads) merge_row_kernel(
    MergeBlocks m, Stream dst, bool vec_out) {
  constexpr int T = kMergeThreads;
  __shared__ __align__(16) int s_val[kMergeTile];
  __shared__ __align__(16) int s_pg[kMergeTile];
  __shared__ unsigned char s_tag[kMergeTile];
  __shared__ int s_pre[kRowBlocks + 1];  // the blocks' lengths, summed
  const size_t row = blockIdx.x;
  const int tid = threadIdx.x;
  const int nblk = m.va + m.vb;
  const bool paged = dst.pg != nullptr;
  if (tid < 32) {  // the lengths' prefix sums, by one warp
    int sum = tid < nblk ? m.len(row, tid) : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFullMask, sum, d);
      if (tid >= d) sum += y;
    }
    s_pre[tid + 1] = sum;
    if (tid == 0) s_pre[0] = 0;
  }
  __syncthreads();
  const int split = m.va * m.cap_a;
  auto block_of = [&](int x) {
    return x < split ? x / m.cap_a : m.va + (x - split) / m.cap_b;
  };
  // the blocks at their offsets in units of w lanes (never across blocks:
  // caps are multiples of kMergeIpt), kStageUnits units a thread with
  // their loads in flight together
  const int w = m.vec ? 4 : 1;
  for (int u0 = tid; u0 * w < m.n; u0 += kStageUnits * T) {
    int v[kStageUnits][4], pg[kStageUnits][4], blk_of[kStageUnits];
#pragma unroll
    for (int k = 0; k < kStageUnits; ++k) {
      const int x = (u0 + k * T) * w;
      blk_of[k] = x < m.n ? block_of(x) : nblk;
      const int j = blk_of[k];
      if (j < nblk && x - m.off(j) < s_pre[j + 1] - s_pre[j]) {
        load_unit(m.vals(row, j) + x - m.off(j), 0, w, v[k]);
        if (paged) load_unit(m.pages(row, j) + x - m.off(j), 0, w, pg[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < kStageUnits; ++k) {
      const int x = (u0 + k * T) * w;
      const int j = blk_of[k];
      if (j >= nblk) continue;
      const int i = x - m.off(j);
      const int len = s_pre[j + 1] - s_pre[j];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (e < w && i + e < len) {
          s_val[x + e] = v[k][e];
          if (paged) s_pg[x + e] = pg[k][e];
          s_tag[x + e] = j < m.va ? 0 : 1;
        }
      }
    }
  }
  __syncthreads();
  const int x0 = tid * kMergeIpt;
  const int blk = x0 < m.n ? block_of(x0) : nblk;
  for (int level = 0; (1 << level) < nblk; ++level) {
    int ov[kMergeIpt], op[kMergeIpt];
    unsigned char ot[kMergeIpt];
    int cnt = 0;
    if (blk < nblk) {
      const int f0 = (blk >> (level + 1)) << (level + 1);
      const int f1 = min(f0 + (1 << level), nblk);
      const int f2 = min(f1 + (1 << level), nblk);
      const int la = s_pre[f1] - s_pre[f0];
      const int lb = s_pre[f2] - s_pre[f1];
      const int* l = s_val + m.off(f0);
      const int* r = s_val + m.off(f1);
      const int d = x0 - m.off(f0);
      cnt = min(kMergeIpt, la + lb - d);
      if (cnt > 0) {
        int lo = max(0, d - lb), hi = min(d, la);
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (l[mid] <= r[d - 1 - mid]) lo = mid + 1; else hi = mid;
        }
        int i = lo, j = d - lo;
#pragma unroll
        for (int k = 0; k < kMergeIpt; ++k) {
          if (k < cnt) {
            const bool left = j >= lb || (i < la && l[i] <= r[j]);
            const int x = left ? m.off(f0) + i++ : m.off(f1) + j++;
            ov[k] = s_val[x];
            op[k] = paged ? s_pg[x] : 0;
            ot[k] = s_tag[x];
          }
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kMergeIpt; ++k) {
      if (k < cnt) {
        s_val[x0 + k] = ov[k];
        s_pg[x0 + k] = op[k];
        s_tag[x0 + k] = ot[k];
      }
    }
    __syncthreads();
  }
  for (int x = s_pre[nblk] + tid; x < m.n; x += T) {
    s_val[x] = kInf;
    s_pg[x] = 0;
    s_tag[x] = 2;
  }
  __syncthreads();
  const size_t at = row * m.n;
  store_tile(dst.vals + at, s_val, m.n, vec_out);
  store_tile(dst.tag + at, s_tag, m.n, vec_out);
  if (paged) store_tile(dst.pg + at, s_pg, m.n, vec_out);
}

int tiles_of(int n) { return (n + kTile - 1) / kTile; }

// Lanes base .. base + kLanes - 1 of a row of n lanes, `fill` past n; as
// 16-byte loads where `vec` (the row starts 16-byte aligned, n % 4 == 0).
__device__ inline void load_lanes(const int* row, int base, int n, bool vec,
                                  int fill, int (&x)[kLanes]) {
#pragma unroll
  for (int g = 0; g < kLanes; g += 4) {
    const int l = base + g;
    if (vec && l + 3 < n) {
      const int4 q = *reinterpret_cast<const int4*>(row + l);
      x[g] = q.x;
      x[g + 1] = q.y;
      x[g + 2] = q.z;
      x[g + 3] = q.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) x[g + j] = l + j < n ? row[l + j] : fill;
    }
  }
}

__device__ inline void store_lanes(int* row, int base, int n, bool vec,
                                   const int (&x)[kLanes]) {
#pragma unroll
  for (int g = 0; g < kLanes; g += 4) {
    const int l = base + g;
    if (vec && l + 3 < n) {
      *reinterpret_cast<int4*>(row + l) =
          make_int4(x[g], x[g + 1], x[g + 2], x[g + 3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (l + j < n) row[l + j] = x[g + j];
    }
  }
}

// ---------------------------------------------------------------------------
// and_keep / variants_keep
// ---------------------------------------------------------------------------

// The AND's keep decision over a merged (coord, tag) stream (tag 0 word A,
// 1 word B, 2 padding), written as the kept stream hv: the value at kept
// lanes, INF32 elsewhere. Gaps wider than |R| cut segments, both R < 0
// adds the ordered cut at each gap segment's first word-A mark, and a
// segment keeps its eligible lanes only if it holds a mark of each word.
// The marks:
//
//   and_keep (kVariants false; pallas_query._sorted_and_keep): each word
//   has at most one lane per coordinate, so a cross-word duplicate is two
//   lanes; it folds onto its first lane, which is eligible and carries both
//   words' marks, and the second lane is dropped.
//
//   variants_keep (kVariants true; pallas_query._variants_and_keep): a run
//   of equal coordinates may be up to Va + Vb lanes long and cross tiles.
//   Tags ascend within a run, so its first lane (the eligible one) holds
//   word A's mark when its tag is 0, and its last lane holds word B's mark
//   when its tag is 1; both read only the neighbouring lanes, so a tile
//   reads one lane on either side of it. A run never crosses a segment
//   cut (equal coords have gap 0, and the ordered cut falls on word-A
//   marks, which are run starts), so the marks count per segment as if
//   they sat on the run's first lane. Rows with bpad keep every run start
//   (word B is query padding: word A's union).

// The segment state of a stretch of lanes. The ordered cut is the part
// that is not a plain sum: a lane before the stretch's first gap start
// is cut if the segment open before the stretch has no word-A mark yet,
// so the stretch records whether it holds such a mark (kPre) and leaves
// that one cut to the combine.
struct SegSum {
  static constexpr int kGap = 1;   // holds a gap start
  static constexpr int kPre = 2;   // an ordered row's word-A mark before
                                   // its first gap start (anywhere when
                                   // it holds none)
  static constexpr int kSeen = 4;  // the segment open at its end holds a
                                   // word-A mark (ordered rows; equal to
                                   // kPre when it holds no gap start)
  int a, b;    // word-A and word-B marks
  int starts;  // gap starts and the ordered cuts the stretch fixes itself
  int bits;

  __device__ static SegSum identity() { return SegSum{0, 0, 0, 0}; }
  __device__ static SegSum lane(bool isa, bool isb, bool gap_start,
                                bool ordered) {
    const bool a_mark = ordered && isa;
    if (gap_start)
      return SegSum{isa, isb, 1, kGap | (a_mark ? kSeen : 0)};
    return SegSum{isa, isb, 0, a_mark ? kPre | kSeen : 0};
  }
  __device__ static SegSum combine(const SegSum& l, const SegSum& r) {
    const bool cut = (l.bits & kGap) && !(l.bits & kSeen) && (r.bits & kPre);
    const int pre = (l.bits & kGap) ? (l.bits & kPre)
                                    : ((l.bits | r.bits) & kPre);
    const int seen = (r.bits & kGap)
                         ? (r.bits & kSeen)
                         : ((l.bits & kSeen) | ((r.bits & kPre) ? kSeen : 0));
    return SegSum{l.a + r.a, l.b + r.b, l.starts + r.starts + (cut ? 1 : 0),
                  ((l.bits | r.bits) & kGap) | pre | seen};
  }
};

struct CountSum {
  int c;
  __device__ static CountSum identity() { return CountSum{0}; }
  __device__ static CountSum combine(const CountSum& l, const CountSum& r) {
    return CountSum{l.c + r.c};
  }
};

// The keep kernels' scratch: pass 1's and pass 2's status words and
// tickets (zeroed), then their tile summaries.
struct KeepScratch {
  int* flag1;  // [rows, tiles]
  int* flag2;
  int* ticket1;  // [rows]
  int* ticket2;
  SegSum* aggs1;  // [rows, tiles]
  SegSum* incls1;
  CountSum* aggs2;
  CountSum* incls2;
};

// Lays KeepScratch out over zeroed / work (when both are set) and gives
// the int32 sizes of both.
KeepScratch keep_scratch(int rows, int tiles, int* zeroed, int* work,
                         size_t* n_zeroed, size_t* n_work) {
  const size_t rt = (size_t)rows * tiles;
  *n_zeroed = 2 * rt + 2 * (size_t)rows;
  *n_work = 2 * rt * (words<SegSum>() + words<CountSum>());
  KeepScratch s{};
  if (zeroed && work) {
    s.flag1 = zeroed;
    s.flag2 = zeroed + rt;
    s.ticket1 = zeroed + 2 * rt;
    s.ticket2 = s.ticket1 + rows;
    s.aggs1 = reinterpret_cast<SegSum*>(work);
    s.incls1 = s.aggs1 + rt;
    s.aggs2 = reinterpret_cast<CountSum*>(s.incls1 + rt);
    s.incls2 = s.aggs2 + rt;
  }
  return s;
}

// Pass 1: each lane's (segment ordinal << 1 | eligible) to hv, and each
// segment's operand counts before its first lane to seg[row, s] (one
// int2 per segment; the row's last tile writes the totals at
// seg[row, nseg]).
template <bool kVariants>
__global__ void __launch_bounds__(kThreads) keep_marks_kernel(
    const int* __restrict__ vals, const int* __restrict__ tag,
    const int* __restrict__ ra_, const int* __restrict__ rb_, int n,
    int tiles, bool vec, int* __restrict__ hv, int2* __restrict__ seg,
    KeepScratch scr) {
  __shared__ SegSum s_warp[kThreads / 32];
  __shared__ SegSum s_pre;
  __shared__ int s_tile;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const size_t row = blockIdx.y;
  const int tile = row_ticket(scr.ticket1 + row, tiles, &s_tile);
  const int base = tile * kTile + tid * kLanes;
  const int* v_row = vals + row * n;
  const int* t_row = tag + row * n;
  const int r1 = ra_[row];
  const int r2 = rb_[row];
  const int abs_r = max(abs(r1), abs(r2));
  const bool ordered = r1 < 0 && r2 < 0;

  unsigned m_a = 0, m_b = 0, m_eff = 0, m_gap = 0;
  {
    int v[kLanes], t[kLanes];
    load_lanes(v_row, base, n, vec, kInf, v);
    load_lanes(t_row, base, n, vec, 2, t);
    // the lanes on either side of this thread's
    const int pv0 = base > 0 && base - 1 < n ? v_row[base - 1] : 0;
    const int nv_end = base + kLanes < n ? v_row[base + kLanes] : kInf;
    const int nt_end = base + kLanes < n ? t_row[base + kLanes] : 2;
#pragma unroll
    for (int k = 0; k < kLanes; ++k) {
      const int l = base + k;
      const int pv = k > 0 ? v[k - 1] : pv0;
      const int nv = k + 1 < kLanes ? v[k + 1] : nv_end;
      const bool valid = v[k] < kInf;
      const bool dup_prev = valid && l > 0 && v[k] == pv;
      bool isa, isb;
      if (kVariants) {
        isa = valid && !dup_prev && t[k] == 0;
        isb = valid && t[k] == 1 && v[k] != nv;
      } else {
        const int nt = k + 1 < kLanes ? t[k + 1] : nt_end;
        const bool dup_next = valid && v[k] == nv;
        const bool a_next = nv < kInf && nt == 0;
        const bool b_next = nv < kInf && nt == 1;
        isa = ((valid && t[k] == 0) || (dup_next && a_next)) && !dup_prev;
        isb = ((valid && t[k] == 1) || (dup_next && b_next)) && !dup_prev;
      }
      const int gap = v[k] - (l == 0 ? 0 : pv);
      const bool gap_start =
          l < n && (l == 0 || (abs_r != 0 && gap > abs_r && valid));
      m_a |= (unsigned)isa << k;
      m_b |= (unsigned)isb << k;
      m_eff |= (unsigned)(valid && !dup_prev) << k;
      m_gap |= (unsigned)gap_start << k;
    }
  }
  SegSum mine = SegSum::identity();
#pragma unroll
  for (int k = 0; k < kLanes; ++k)
    mine = SegSum::combine(mine, SegSum::lane(m_a >> k & 1, m_b >> k & 1,
                                              m_gap >> k & 1, ordered));
  SegSum total;
  const SegSum before = block_scan<kThreads>(mine, s_warp, &total);
  int2* s_row = seg + row * (size_t)(n + 1);
  if (tid < 32) {
    const size_t at = row * tiles;
    const SegSum pre = tile_exclusive(total, tile, scr.flag1 + at,
                                      scr.aggs1 + at, scr.incls1 + at);
    if (lane == 0) {
      s_pre = pre;
      if (tile == tiles - 1) {
        const SegSum all = SegSum::combine(pre, total);
        s_row[all.starts] = make_int2(all.a, all.b);
      }
    }
  }
  __syncthreads();

  // this thread's lanes, from the state of the row before them (which
  // holds lane 0's gap start unless it is empty)
  const SegSum e = SegSum::combine(s_pre, before);
  int c_a = e.a, c_b = e.b, c_s = e.starts;
  bool seen = e.bits & SegSum::kSeen;
  int code[kLanes];
#pragma unroll
  for (int k = 0; k < kLanes; ++k) {
    const bool isa = m_a >> k & 1;
    bool start = m_gap >> k & 1;
    if (ordered) {
      if (start) {
        seen = isa;
      } else if (isa && !seen) {  // the gap segment's first word-A mark
        start = true;
        seen = true;
      }
    }
    if (start && base + k < n) s_row[c_s++] = make_int2(c_a, c_b);
    c_a += isa;
    c_b += m_b >> k & 1;
    code[k] = (c_s << 1) | (int)(m_eff >> k & 1);
  }
  store_lanes(hv + row * n, base, n, vec, code);
}

// Pass 2: every lane resolved from its segment's two entries. Writes the
// values to hv or, when cvals is set, the kept values (and their pages
// from pg, when cpg is set) compacted to the front of cvals / cpg, INF32
// after them, and their count to ccount. A tile's kept lanes fill the
// slots from its kept prefix on, and its dropped lanes' INF32 the slots
// n - 1 - their dropped ordinals, so the tail needs no total; both are
// runs of consecutive slots, written out of shared memory.
template <bool kVariants>
__global__ void __launch_bounds__(kThreads) keep_resolve_kernel(
    const int* __restrict__ vals, const int* __restrict__ bpad_,
    const int* __restrict__ pg, int n, int tiles, bool vec, int* hv,
    const int2* __restrict__ seg, int* __restrict__ cvals,
    int* __restrict__ cpg, int* __restrict__ ccount, KeepScratch scr) {
  __shared__ CountSum s_warp[kThreads / 32];
  __shared__ CountSum s_pre;
  __shared__ int s_tile;
  __shared__ int s_val[kTile], s_pg[kTile];  // the tile's kept lanes
  const int tid = threadIdx.x;
  const size_t row = blockIdx.y;
  const bool compact = cvals != nullptr;
  // only the compaction carries anything between tiles
  const int tile =
      compact ? row_ticket(scr.ticket2 + row, tiles, &s_tile) : blockIdx.x;
  const int base = tile * kTile + tid * kLanes;
  const bool bpad = kVariants && bpad_[row] != 0;
  int* h_row = hv + row * n;
  const int* v_row = vals + row * n;
  const int2* s_row = seg + row * (size_t)(n + 1);

  int x[kLanes];
  load_lanes(h_row, base, n, vec, 0, x);
  unsigned keep = 0;
#pragma unroll
  for (int k = 0; k < kLanes; ++k) {
    if (base + k >= n) continue;
    const int s = x[k] >> 1;
    const int2 lo = s_row[s - 1];
    const int2 hi = s_row[s];
    if ((x[k] & 1) && (bpad || (hi.x > lo.x && hi.y > lo.y)))
      keep |= 1u << k;
  }
  if (!compact) {
#pragma unroll
    for (int k = 0; k < kLanes; ++k)
      x[k] = keep >> k & 1 ? v_row[base + k] : kInf;
    store_lanes(h_row, base, n, vec, x);
    return;
  }
  CountSum total;
  const CountSum before = block_scan<kThreads>(
      CountSum{__popc(keep)}, s_warp, &total);
  if (tid < 32) {
    const size_t at = row * tiles;
    const CountSum pre = tile_exclusive(total, tile, scr.flag2 + at,
                                        scr.aggs2 + at, scr.incls2 + at);
    if (tid == 0) {
      s_pre = pre;
      if (tile == tiles - 1) ccount[row] = pre.c + total.c;
    }
  }
  const int* p_row = pg ? pg + row * n : nullptr;
  int slot = before.c;
#pragma unroll
  for (int k = 0; k < kLanes; ++k) {
    if (keep >> k & 1) {
      s_val[slot] = v_row[base + k];
      if (cpg) s_pg[slot] = p_row[base + k];
      ++slot;
    }
  }
  __syncthreads();
  const int kept = total.c;
  const int dropped = min(kTile, n - tile * kTile) - kept;
  int* cv_row = cvals + row * n + s_pre.c;
  int* tail = cvals + row * n + n - (tile * kTile - s_pre.c) - dropped;
  for (int j = tid; j < kept; j += kThreads) cv_row[j] = s_val[j];
  for (int j = tid; j < dropped; j += kThreads) tail[j] = kInf;
  if (cpg) {
    int* cp_row = cpg + row * n + s_pre.c;
    int* cp_tail = cpg + row * n + n - (tile * kTile - s_pre.c) - dropped;
    for (int j = tid; j < kept; j += kThreads) cp_row[j] = s_pg[j];
    for (int j = tid; j < dropped; j += kThreads) cp_tail[j] = kInf;
  }
}

// ---------------------------------------------------------------------------
// locate_runs
// ---------------------------------------------------------------------------

// locate_runs: page runs of a kept stream hv (INF32 at dropped lanes, kept
// values ascending) of any width. Pages come from pg (carried) or, when pg
// is null, from bounds (#bounds <= value, clamped to the last page).
// Writes the first kpad runs in slot order, the first hpad kept values,
// and the exact run and hit totals. Only the kept values in [keep_lo,
// keep_hi) count (a document shard drops the postings it holds of its
// neighbours); [0, INF32) keeps every one.
//
// A run's count and bonus are differences of two exclusive prefix sums:
// at its first lane and at the next run's first lane (the row totals for
// the last run). The tile that holds a run's first lane records those
// sums for run ordinals <= kpad in a [rows, kpad + 1] table, and the
// row's last block to finish turns them into runs; no full-width stream
// is written. Run sums are exact integers, so the f32 rank does not
// depend on the order of the tiles.

__device__ inline int gap_bonus(int gap) { return 30 / (gap > 5 ? gap : 5); }

// The page runs of a stretch of lanes of a kept stream.
struct RunSum {
  int hits;    // kept lanes
  int runs;    // run starts after the first kept lane
  int bonus;   // bonus after the first kept lane
  int fv, fp;  // the first kept lane's value and page
  int lv, lp;  // the last kept lane's

  __device__ static RunSum identity() { return RunSum{0, 0, 0, 0, -1, 0, -1}; }
  __device__ static RunSum lane(int v, int p) {
    return RunSum{1, 0, 0, v, p, v, p};
  }
  __device__ static RunSum combine(const RunSum& l, const RunSum& r) {
    if (r.hits == 0) return l;
    if (l.hits == 0) return r;
    const bool same = r.fp == l.lp;  // r's first lane continues l's run
    return RunSum{l.hits + r.hits, l.runs + r.runs + (same ? 0 : 1),
                  l.bonus + r.bonus + (same ? gap_bonus(r.fv - l.lv) : 0),
                  l.fv, l.fp, r.lv, r.lp};
  }
};

// locate_runs' scratch: the run table, then the status words, tickets and
// finished-tile counters (zeroed) and the tile summaries.
struct RunScratch {
  int4* runs;     // [rows, kpad + 1]: hits and bonus before run r, its page
  int* flag;      // [rows, tiles]
  int* ticket;    // [rows]
  int* finished;  // [rows]
  RunSum* aggs;   // [rows, tiles]
  RunSum* incls;
};

RunScratch run_scratch(int rows, int tiles, int kpad, int* zeroed, int* work,
                       size_t* n_zeroed, size_t* n_work) {
  const size_t rt = (size_t)rows * tiles;
  const size_t table = 4 * (size_t)rows * (kpad + 1);
  *n_zeroed = rt + 2 * (size_t)rows;
  *n_work = table + 2 * rt * words<RunSum>();
  RunScratch s{};
  if (zeroed && work) {
    s.runs = reinterpret_cast<int4*>(work);
    s.flag = zeroed;
    s.ticket = zeroed + rt;
    s.finished = s.ticket + rows;
    s.aggs = reinterpret_cast<RunSum*>(work + table);
    s.incls = s.aggs + rt;
  }
  return s;
}

// #{j < m: s[j] <= v}, by one warp: each round cuts [lo, hi] into 32
// pieces and keeps the one that holds the answer (3 rounds for 32k
// bounds). Every lane returns it.
__device__ inline int warp_upper_bound(const int* s, int m, int v) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = m;
  while (lo < hi) {
    const int len = hi - lo;
    const int step = (len + 31) / 32;
    const int probe = lo + min(len, (lane + 1) * step) - 1;
    const int c = __popc(__ballot_sync(kFullMask, s[probe] <= v));
    if (c == 32) return hi;
    hi = lo + min(len, (c + 1) * step) - 1;  // s[hi] > v
    lo += c * step;
  }
  return lo;
}

// Four blocks an SM (at most 64 registers, a few spilled): on an H100
// the wide and the many-row launches take a fifth to a third less time
// than at 95 registers and two blocks (tools/tile_kernel_times.py). The
// keep kernels gain nothing from it.
__global__ void __launch_bounds__(kThreads, 4) locate_runs_kernel(
    const int* __restrict__ hv, const int* __restrict__ pg,
    const int* __restrict__ bounds, int n_bounds, int n, int tiles, int kpad,
    int hpad, bool vec, int keep_lo, int keep_hi, Outputs out,
    RunScratch scr) {
  __shared__ RunSum s_warp[kThreads / 32];
  __shared__ RunSum s_pre;
  __shared__ int s_win[kWindow];
  __shared__ int s_min[kThreads / 32], s_max[kThreads / 32];
  __shared__ int s_lo, s_hi, s_tile, s_last;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t row = blockIdx.y;
  const int tile = row_ticket(scr.ticket + row, tiles, &s_tile);
  const int base = tile * kTile + tid * kLanes;

  int v[kLanes], page[kLanes];
  load_lanes(hv + row * n, base, n, vec, kInf, v);
  if (keep_lo > 0 || keep_hi < kInf) {
#pragma unroll
    for (int k = 0; k < kLanes; ++k)
      if (v[k] < keep_lo || v[k] >= keep_hi) v[k] = kInf;
  }
  if (pg) {
    const int* p_row = pg + row * n;
#pragma unroll
    for (int g = 0; g < kLanes; g += 4) {
      const int l = base + g;
      const bool any = v[g] < kInf || v[g + 1] < kInf || v[g + 2] < kInf ||
                       v[g + 3] < kInf;
      if (any && vec && l + 3 < n) {
        const int4 q = *reinterpret_cast<const int4*>(p_row + l);
        page[g] = q.x;
        page[g + 1] = q.y;
        page[g + 2] = q.z;
        page[g + 3] = q.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          page[g + j] = v[g + j] < kInf ? p_row[l + j] : -1;
      }
    }
  } else {
    // the tile's kept values lie between its first and last, their pages
    // in bounds[lo .. hi): staged in shared memory when they fit
    int first = kInf, last = -1;
#pragma unroll
    for (int k = 0; k < kLanes; ++k) {
      if (v[k] < kInf) {
        first = min(first, v[k]);
        last = max(last, v[k]);
      }
    }
    first = __reduce_min_sync(kFullMask, first);
    last = __reduce_max_sync(kFullMask, last);
    if (lane == 0) {
      s_min[warp] = first;
      s_max[warp] = last;
    }
    __syncthreads();
    if (warp < 2) {
      int lo_v = kInf, hi_v = -1;
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w) {
        lo_v = min(lo_v, s_min[w]);
        hi_v = max(hi_v, s_max[w]);
      }
      const int b = lo_v == kInf ? 0
                    : warp_upper_bound(bounds, n_bounds,
                                       warp == 0 ? lo_v : hi_v);
      if (lane == 0) (warp == 0 ? s_lo : s_hi) = b;
    }
    __syncthreads();
    const int lo = s_lo;
    const int w = s_hi - s_lo;
    const bool staged = w <= kWindow;
    if (staged) {
      for (int j = tid; j < w; j += kThreads) s_win[j] = bounds[lo + j];
      __syncthreads();
    }
#pragma unroll
    for (int k = 0; k < kLanes; ++k) {
      page[k] = -1;
      if (v[k] < kInf) {
        const int p = lo + (staged ? upper_bound(s_win, w, v[k])
                                   : upper_bound(bounds + lo, w, v[k]));
        page[k] = p < n_bounds ? p : n_bounds - 1;
      }
    }
  }

  RunSum mine = RunSum::identity();
#pragma unroll
  for (int k = 0; k < kLanes; ++k)
    if (v[k] < kInf) mine = RunSum::combine(mine, RunSum::lane(v[k], page[k]));
  RunSum total;
  const RunSum before = block_scan<kThreads>(mine, s_warp, &total);
  const size_t at = row * tiles;
  if (warp == 0) {
    const RunSum pre = tile_exclusive(total, tile, scr.flag + at,
                                      scr.aggs + at, scr.incls + at);
    if (lane == 0) s_pre = pre;
  }
  __syncthreads();

  // this thread's lanes, from the state of the row before them
  const RunSum e = RunSum::combine(s_pre, before);
  int c_hits = e.hits, c_bon = e.bonus;
  int c_runs = e.hits ? e.runs + 1 : 0;
  int c_pv = e.hits ? e.lv : -1, c_pp = e.hits ? e.lp : -1;
  int* hits = out.hits + row * hpad;
  int4* runs = scr.runs + row * (kpad + 1);
#pragma unroll
  for (int k = 0; k < kLanes; ++k) {
    if (v[k] == kInf) continue;
    if (c_hits < hpad) hits[c_hits] = v[k];
    if (page[k] != c_pp) {  // a run starts
      if (c_runs <= kpad)
        __stcg(&runs[c_runs], make_int4(c_hits, c_bon, page[k], 0));
      ++c_runs;
    } else {
      c_bon += gap_bonus(v[k] - c_pv);
    }
    ++c_hits;
    c_pv = v[k];
    c_pp = page[k];
  }

  // the row's last block to finish writes its runs and totals
  __threadfence();
  __syncthreads();
  if (tid == 0)
    s_last = tiles == 1 || atomicAdd(scr.finished + row, 1) == tiles - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const RunSum all = tiles == 1 ? total : load_l2(&scr.incls[at + tiles - 1]);
  const int n_runs = all.hits ? all.runs + 1 : 0;
  for (int r = tid; r < kpad; r += kThreads) {
    const size_t o = row * kpad + r;
    if (r < n_runs) {
      const int4 a = __ldcg(&runs[r]);
      const int4 b = r + 1 < n_runs ? __ldcg(&runs[r + 1])
                                    : make_int4(all.hits, all.bonus, 0, 0);
      const int cnt = b.x - a.x;
      out.pg_c[o] = a.z;
      out.rk_c[o] = run_rank(b.y - a.y, cnt);
      out.ct_c[o] = (float)cnt;
    } else {
      out.pg_c[o] = -1;
      out.rk_c[o] = 0.0f;
      out.ct_c[o] = 0.0f;
    }
  }
  for (int h = all.hits + tid; h < hpad; h += kThreads) hits[h] = kInf;
  if (tid == 0) {
    out.n_pages[row] = n_runs;
    out.n_hits[row] = all.hits;
  }
}

template <bool kVariants>
int launch_keep(const int* vals, const int* tag, const int* ra,
                const int* rb, const int* bpad, const int* pg, int rows,
                int n, int* hv, int* seg, int* cvals, int* cpg, int* ccount,
                int* zeroed, int* work, void* stream) {
  if (rows > 65535) return (int)cudaErrorInvalidValue;
  if (rows > 0 && n > 0) {
    const int tiles = tiles_of(n);
    size_t nz, nw;
    const KeepScratch scr = keep_scratch(rows, tiles, zeroed, work, &nz, &nw);
    const bool vec = n % 4 == 0 && aligned16(vals) && aligned16(tag) &&
                     aligned16(hv);
    const dim3 grid(tiles, rows);
    const cudaStream_t s = (cudaStream_t)stream;
    keep_marks_kernel<kVariants><<<grid, kThreads, 0, s>>>(
        vals, tag, ra, rb, n, tiles, vec, hv, reinterpret_cast<int2*>(seg),
        scr);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    keep_resolve_kernel<kVariants><<<grid, kThreads, 0, s>>>(
        vals, bpad, pg, n, tiles, vec, hv, reinterpret_cast<int2*>(seg),
        cvals, cpg, ccount, scr);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Launches of docodo_merge_tagged for va blocks of cap_a and vb of cap_b:
// 0 for a row that one block merges in shared memory (merge_row_kernel:
// up to 2048 lanes), else ceil(log2(va + vb)) passes of the pairwise
// tree, at least one: rows wider than one tile merge faster in passes of
// many tiles than in one block (H100, tools/tile_kernel_times.py).
extern "C" int docodo_merge_tagged_passes(int va, int cap_a, int vb,
                                          int cap_b) {
  const int nblk = va + vb;
  const int ca = va > 0 ? cap_a : 0;
  const int cb = vb > 0 ? cap_b : 0;
  const long long n = (long long)va * ca + (long long)vb * cb;
  if (n <= kMergeTile && nblk <= kRowBlocks && ca % kMergeIpt == 0 &&
      cb % kMergeIpt == 0)
    return 0;
  int passes = 1;
  while ((1 << passes) < nblk) ++passes;
  return passes;
}

// scratch: where docodo_merge_tagged_passes gives more than one pass,
// [2 or 3, rows, n] int32 (values, tags, and pages when pg is given),
// which the tree's passes and the outputs take in turns so that the last
// pass writes the outputs; may be null otherwise.
extern "C" int docodo_merge_tagged(const int* a, const int* a_pg,
                                   const int* na, const int* b,
                                   const int* b_pg, const int* nb, int rows,
                                   int va, int cap_a, int vb, int cap_b,
                                   int* vals, int* tag, int* pg,
                                   int* scratch, void* stream) {
  MergeBlocks m;
  m.a = a;
  m.a_pg = a_pg;
  m.na = na;
  m.b = b;
  m.b_pg = b_pg;
  m.nb = nb;
  m.va = va;
  m.vb = vb;
  m.cap_a = va > 0 ? cap_a : 0;
  m.cap_b = vb > 0 ? cap_b : 0;
  const int nblk = va + vb;
  const long long n = (long long)va * m.cap_a + (long long)vb * m.cap_b;
  if (va < 0 || vb < 0 || nblk > 65535 || n > 65535LL * kMergeTile)
    return (int)cudaErrorInvalidValue;
  m.n = (int)n;
  if (rows <= 0 || n == 0) return (int)cudaGetLastError();
  const int passes = docodo_merge_tagged_passes(va, cap_a, vb, cap_b);
  if (passes > 1 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const bool caps4 = m.cap_a % 4 == 0 && m.cap_b % 4 == 0;
  m.vec = caps4 && aligned16(a) && aligned16(a_pg) && aligned16(b) &&
          aligned16(b_pg);
  const Stream out{vals, tag, pg};
  const bool vec_dst =
      caps4 && aligned16(vals) && aligned16(tag) && aligned16(pg);
  if (passes == 0) {
    merge_row_kernel<<<rows, kMergeThreads, 0, (cudaStream_t)stream>>>(
        m, out, vec_dst);
    return (int)cudaGetLastError();
  }
  const size_t plane = (size_t)rows * m.n;
  const Stream tmp =
      scratch ? Stream{scratch, scratch + plane, pg ? scratch + 2 * plane
                                                    : nullptr}
              : Stream{nullptr, nullptr, nullptr};
  const bool vec_out = vec_dst && aligned16(tmp.vals) &&
                       aligned16(tmp.tag) && aligned16(tmp.pg);
  Stream src{nullptr, nullptr, nullptr};
  for (int p = 0; p < passes; ++p) {
    const Stream dst = (passes - 1 - p) % 2 == 0 ? out : tmp;
    const int pairs = (((nblk + (1 << p) - 1) >> p) + 1) / 2;
    int widest = 0;
    for (int q = 0; q < pairs; ++q) {
      const int f0 = (2 * q) << p;
      const int f2 = f0 + (2 << p) < nblk ? f0 + (2 << p) : nblk;
      const int w = m.off(f2) - m.off(f0);
      widest = w > widest ? w : widest;
    }
    const dim3 grid(rows, (widest + kMergeTile - 1) / kMergeTile, pairs);
    merge_pass_kernel<<<grid, kMergeThreads, 0, (cudaStream_t)stream>>>(
        m, p, src, dst, p == passes - 1, vec_out);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    src = dst;
  }
  return (int)cudaGetLastError();
}

extern "C" int docodo_and_keep(const int* vals, const int* tag,
                               const int* ra, const int* rb, const int* pg,
                               int rows, int n, int* hv, int* seg,
                               int* cvals, int* cpg, int* ccount,
                               int* zeroed, int* work, void* stream) {
  return launch_keep<false>(vals, tag, ra, rb, nullptr, pg, rows, n, hv, seg,
                            cvals, cpg, ccount, zeroed, work, stream);
}

extern "C" int docodo_variants_keep(const int* vals, const int* tag,
                                    const int* ra, const int* rb,
                                    const int* bpad, const int* pg, int rows,
                                    int n, int* hv, int* seg, int* cvals,
                                    int* cpg, int* ccount, int* zeroed,
                                    int* work, void* stream) {
  return launch_keep<true>(vals, tag, ra, rb, bpad, pg, rows, n, hv, seg,
                           cvals, cpg, ccount, zeroed, work, stream);
}

extern "C" int docodo_locate_runs(const int* hv, const int* pg,
                                  const int* bounds, int n_bounds, int rows,
                                  int n, int kpad, int hpad, int keep_lo,
                                  int keep_hi, int* pg_c,
                                  float* rk_c, float* ct_c, int* n_pages,
                                  int* n_hits, int* hits, int* zeroed,
                                  int* work, void* stream) {
  if (rows > 65535) return (int)cudaErrorInvalidValue;
  if (rows > 0 && n > 0) {
    const int tiles = tiles_of(n);
    size_t nz, nw;
    const RunScratch scr =
        run_scratch(rows, tiles, kpad, zeroed, work, &nz, &nw);
    const bool vec = n % 4 == 0 && aligned16(hv) && aligned16(pg);
    locate_runs_kernel<<<dim3(tiles, rows), kThreads, 0,
                         (cudaStream_t)stream>>>(
        hv, pg, bounds, n_bounds, n, tiles, kpad, hpad, vec, keep_lo, keep_hi,
        outputs(pg_c, rk_c, ct_c, n_pages, n_hits, hits), scr);
  }
  return (int)cudaGetLastError();
}

// Lanes a block of and_keep, variants_keep and locate_runs owns.
extern "C" int docodo_tile_lanes() { return kTile; }

// The int32 sizes of the scratch arrays the tiled entry points take.
extern "C" void docodo_keep_scratch(int rows, int n, long long* zeroed,
                                    long long* work) {
  size_t nz, nw;
  keep_scratch(rows, tiles_of(n), nullptr, nullptr, &nz, &nw);
  *zeroed = (long long)nz;
  *work = (long long)nw;
}

extern "C" void docodo_locate_runs_scratch(int rows, int n, int kpad,
                                           long long* zeroed,
                                           long long* work) {
  size_t nz, nw;
  run_scratch(rows, tiles_of(n), kpad, nullptr, nullptr, &nz, &nw);
  *zeroed = (long long)nz;
  *work = (long long)nw;
}
