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
//                                      128 lanes; it takes the W = 1 body
//                                      of w1_kernel.cuh, with no merge)
//
// Each of the first two turns one query row into the row's first kpad page
// runs in slot order, its first hpad kept hits and the exact n_pages /
// n_hits totals, as the kernels of locate_full.cu do. The two _topk kernels
// are the same row bodies ending in the other tail (slot_row.cuh,
// TopkTail): the top k of every run of the row, picked in the kernel.
// At V = 1 there is nothing to merge, and union_locate_full_topk runs the
// W = 1 body with the same tail (UnionKeep: a lane is kept where it
// differs from the lane before it), as row 3's V = 1 form does.
//
// What bounds them on this card: bytes, at ~0.5 us for a launch of 128
// rows of 1024 lanes. Each reads its variant blocks once (values and
// pages, 8 bytes a lane) and writes 3 * kpad + hpad + 2 values a row. The
// serving launches hold 32-128 rows, one wave on the card, so a launch
// takes one row's latency; what sets it is the row's serial chain: the
// loads, the merge and ~20 barriers of the tails.
//
// The TPU route sorts the word-tagged concatenation of the blocks outside
// the kernel (a lax.sort through device memory) or, at V = 2, merges with
// a bitonic network of lane rotations, and finds each run's words with span
// queries (prefix sums and reverse running mins). Here a row group merges
// the blocks in shared memory as a pairwise tree: at level j the runs of
// 2^j blocks pair up, and each element's place in the merged run is its
// place in its own run plus its rank in the partner run, one binary search
// (ties go to the left run, so the row is in (coord, block) order, which
// is the (coord, tag) order of the TPU route's stable sort). An element's
// serial chain is ceil(log2 V) searches of its partner run, in place of a
// search of every other block, and a thread searches for its four lanes
// at once. A thread loads its lanes' values and pages together, 16 bytes
// each where the blocks allow, before the first barrier; the values and
// the source lane travel through the levels, and the last level looks each
// element's page up in shared memory. In the merged order tags ascend
// within a run of equal coordinates, so a run holds word A exactly when
// its first lane has tag 0 and word B exactly when its last lane has tag
// 1: both marks are lane-local and need no span query. A run never
// crosses a segment cut, so marking word B at the run's last lane instead
// of its first leaves every segment's word count as it was.
//
// Like the W = 2 slot kernel (locate_full.cu), each kernel is compiled for
// stream widths N = 128, 256, 512 and 1024 and dispatched on n = V cap (or
// (va + vb) cap), each row in its own VarSmem<N>. A launch whose rows fit
// in one wave of N threads a row (a lane a thread) takes that shape; a
// larger one gives a row N / 4 threads, 4 lanes a thread, 8 / 4 / 2 / 1
// rows a block of 256 threads (launch_by_rows, slot_row.cuh).
//
// Every entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError().

#include "w1_kernel.cuh"

namespace {

using namespace docodo;

constexpr int kMaxBlocks = 32;

// Shared memory of a variant row at stream width N: the merged row, the
// blocks' pages at their lanes, block k's first slot in the merged row
// (off[k], off[nblk] = the row's values) and the tags. The merge's two
// buffers of (value, source lane) are the row's run arrays and scratch,
// which the tail needs only after the merge.
template <int N>
struct __align__(16) VarSmem {
  RowSmem<N> row;
  int page_in[N];
  int off[kMaxBlocks + 1];
  unsigned char tag[N];
};

// A row group of G threads at stream width N: N / 4 (4 lanes a thread,
// several rows a block below N = 1024) or N (a lane a thread).
template <int N, int G>
using VarShape = SlotShape<N, VarSmem<N>, G>;

// Merges the row's va blocks of word A (tag 0) and vb blocks of word B
// (tag 1), each ascending with its length in na_ / nb_, into s.row.val /
// s.row.page / s.tag in (coord, block) order, padding (INF32, page 0,
// tag 2) last. b, b_pg and nb_ are read only when vb > 0. Thread t of the
// row group owns lanes Q t .. Q t + Q - 1 at every level. Called by every
// thread of the row group g; ends synchronised.
template <class Grp, int N>
__device__ void merge_blocks(const Grp& g, VarSmem<N>& s,
                             const int* __restrict__ a,
                             const int* __restrict__ a_pg,
                             const int* __restrict__ na_, int va,
                             const int* __restrict__ b,
                             const int* __restrict__ b_pg,
                             const int* __restrict__ nb_, int vb, int cap) {
  constexpr int Q = N / Grp::kThreads;
  static_assert(Q == 4 || Q == 1, "four lanes a thread, or one");
  const int tid = g.rank();
  const size_t row = g.row();
  const int nblk = va + vb;
  const int n = nblk * cap;
  const int wa = va * cap;  // word A's lanes
  const int* arow = a + row * wa;
  const int* apg = a_pg + row * wa;
  const int* brow = vb ? b + row * (size_t)(vb * cap) : nullptr;
  const int* bpg = vb ? b_pg + row * (size_t)(vb * cap) : nullptr;
  // the blocks' first slots: one warp scans their lengths
  if (tid < 32) {
    int x = 0;
    if (tid < nblk)
      x = clamp_len(tid < va ? na_[row * va + tid]
                             : nb_[row * vb + tid - va], cap);
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, d);
      if (tid >= d) x += y;
    }
    if (tid < nblk) s.off[tid + 1] = x;
    if (tid == 0) s.off[0] = 0;
  }
  // this thread's lanes, values and pages in one load: a quad lies in one
  // word's blocks when cap % 4 == 0
  const int l0 = Q * tid;
  int v[Q], pq[Q];
  bool vec = false;
  if constexpr (Q == 4)
    vec = cap % 4 == 0 && aligned16(arow) && aligned16(apg) &&
          aligned16(brow) && aligned16(bpg);
  if (vec) {
    if constexpr (Q == 4) {
      if (l0 < n) {
        const bool in_a = l0 < wa;
        const int i = in_a ? l0 : l0 - wa;
        load4(in_a ? arow : brow, i, 0, true, v);
        load4(in_a ? apg : bpg, i, 0, true, pq);
      }
    }
  } else {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int l = l0 + q;
      v[q] = pq[q] = 0;
      if (l < n) {
        v[q] = l < wa ? arow[l] : brow[l - wa];
        pq[q] = l < wa ? apg[l] : bpg[l - wa];
      }
    }
  }
  // the lanes' blocks, and their places in their blocks
  int blk[Q], i0[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    blk[q] = (l0 + q) / cap;
    i0[q] = l0 + q - blk[q] * cap;
  }
  int* vin = s.row.run_bonus;  // values by lane: the first level's runs
  const int* sin = nullptr;
  int* vout = s.row.run_page;
  int* sout = s.row.tmp;
  if (l0 < n) {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      vin[l0 + q] = v[q];
      s.page_in[l0 + q] = pq[q];
    }
  }
  g.sync();

  const int last = nblk > 1 ? 31 - __clz(nblk - 1) : 0;  // levels - 1
  const int total = s.off[nblk];
  int src[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) src[q] = l0 + q;
  for (int j = 0; j <= last; ++j) {
    if (j > 0) {
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        v[q] = vin[l0 + q];
        src[q] = sin[l0 + q];
      }
    }
    // each live lane's partner run [pk0, pk1) of blocks, its rank there
    // (m: the partner's values) and its place in the merged run
    int m[Q], base[Q], dst[Q], pos[Q];
    bool up[Q];
    int most = 0;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int k0 = (blk[q] >> j) << j;
      const int k1 = min(k0 + (1 << j), nblk);
      const int i = i0[q] + (blk[q] - k0) * cap;
      const bool live = l0 + q < n && i < s.off[k1] - s.off[k0];
      const bool left = ((blk[q] >> j) & 1) == 0;
      const int pk0 = left ? k1 : k0 - (1 << j);
      const int pk1 = left ? min(k1 + (1 << j), nblk) : k0;
      m[q] = live ? s.off[pk1] - s.off[pk0] : 0;
      base[q] = pk0 * cap - 1;
      up[q] = !left;
      dst[q] = live ? ((blk[q] >> (j + 1)) << (j + 1)) * cap + i : -1;
      pos[q] = 0;
      most = max(most, m[q]);
    }
    // binary searches of the partner runs, the thread's lanes side by
    // side: pos = #{partner < v}, or #{partner <= v} for a right run
    for (int step = most ? 1 << (31 - __clz(most)) : 0; step > 0;
         step >>= 1) {
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int c = pos[q] + step;
        if (c <= m[q]) {
          const int w = vin[base[q] + c];
          if (w < v[q] || (up[q] && w == v[q])) pos[q] = c;
        }
      }
    }
    if (j == last) {
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        if (dst[q] < 0) continue;
        const int p = dst[q] + pos[q];
        s.row.val[p] = v[q];
        s.row.page[p] = s.page_in[src[q]];
        s.tag[p] = src[q] < wa ? 0 : 1;
      }
      for (int p = total + tid; p < n; p += Grp::kThreads) {
        s.row.val[p] = kInf;
        s.row.page[p] = 0;
        s.tag[p] = 2;
      }
    } else {
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        if (dst[q] < 0) continue;
        vout[dst[q] + pos[q]] = v[q];
        sout[dst[q] + pos[q]] = src[q];
      }
      // the next level reads what this one wrote, and writes the buffers
      // this one read
      int* t = vin;
      vin = vout;
      vout = t;
      sin = sout;
      sout = t == s.row.run_bonus ? s.row.run_count : s.row.tmp;
    }
    g.sync();
  }
}

// W = 2, each word an OR of variants (pallas_query._variants_and_keep):
// the run-dedupe marks, the AND's segmentation, the locate tail. With
// bpad (word B is query padding) the row keeps every run start, word A's
// union.
template <class Tail, int N, int G>
__global__ void __launch_bounds__(SlotShape<N, VarSmem<N>, G>::kThreads)
    variants_and_locate_full_kernel(
        const int* __restrict__ a, const int* __restrict__ a_pg,
        const int* __restrict__ na_, const int* __restrict__ ra_,
        const int* __restrict__ b, const int* __restrict__ b_pg,
        const int* __restrict__ nb_, const int* __restrict__ rb_,
        const int* __restrict__ bpad_, int rows, int va, int vb, int cap,
        Tail tail) {
  using S = SlotShape<N, VarSmem<N>, G>;
  constexpr int L = S::kIpt;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const GroupRow<G> g{};
  if (g.row() >= (size_t)rows) return;  // the last block's spare groups
  auto& s = reinterpret_cast<VarSmem<N>*>(smem_raw)[g.group()];
  merge_blocks(g, s, a, a_pg, na_, va, b, b_pg, nb_, vb, cap);
  const size_t row = g.row();
  const int n = (va + vb) * cap;
  const int ipt = (n + G - 1) / G;
  const int base = g.rank() * ipt;
  const int r1 = ra_[row];
  const int r2 = rb_[row];
  const int abs_r = max(abs(r1), abs(r2));
  const bool ordered = r1 < 0 && r2 < 0;
  const bool bpad = bpad_[row] != 0;
  const int* val = s.row.val;
  bool isa[L], isb[L], start[L], seg[L];
#pragma unroll
  for (int k = 0; k < L; ++k) {
    const int l = base + k;
    isa[k] = isb[k] = start[k] = seg[k] = false;
    if (k < ipt && l < n) {
      const int x = val[l];
      const bool valid = x < kInf;
      const int pv = l > 0 ? val[l - 1] : -1;
      const int nv = l < n - 1 ? val[l + 1] : kInf;
      start[k] = valid && x != pv;
      isa[k] = start[k] && s.tag[l] == 0;
      isb[k] = valid && s.tag[l] == 1 && x != nv;
      const int gap = x - (l == 0 ? 0 : pv);
      seg[k] = l == 0 || (abs_r != 0 && gap > abs_r && valid);
    }
  }
  bool keep[L];
  segment_keep(g, s.row, isa, isb, start, seg, ordered, n, ipt, keep);
  if (bpad) {
#pragma unroll
    for (int k = 0; k < L; ++k) keep[k] = start[k];
  }
  tail.run(g, s.row, keep, n, ipt);
}

// W = 1, one word's V variants: the merged row keeps each run's first lane.
template <class Tail, int N, int G>
__global__ void __launch_bounds__(SlotShape<N, VarSmem<N>, G>::kThreads)
    union_merge_locate_full_kernel(const int* __restrict__ a,
                                   const int* __restrict__ a_pg,
                                   const int* __restrict__ na_, int rows,
                                   int v, int cap, Tail tail) {
  using S = SlotShape<N, VarSmem<N>, G>;
  constexpr int L = S::kIpt;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const GroupRow<G> g{};
  if (g.row() >= (size_t)rows) return;
  auto& s = reinterpret_cast<VarSmem<N>*>(smem_raw)[g.group()];
  merge_blocks(g, s, a, a_pg, na_, v, nullptr, nullptr, nullptr, 0, cap);
  const int n = v * cap;
  const int ipt = (n + G - 1) / G;
  const int base = g.rank() * ipt;
  bool keep[L];
#pragma unroll
  for (int k = 0; k < L; ++k) {
    const int l = base + k;
    keep[k] = false;
    if (k < ipt && l < n) {
      const int x = s.row.val[l];
      keep[k] = x < kInf && x != (l > 0 ? s.row.val[l - 1] : -1);
    }
  }
  tail.run(g, s.row, keep, n, ipt);
}

bool shape_ok(int nblk, int cap) {
  return nblk > 0 && nblk <= kMaxBlocks && cap > 0 &&
         nblk * cap <= kSlotLanes;
}

template <class Tail, int N, int G>
struct VariantsAndLaunch {
  using Shape = VarShape<N, G>;
  static auto kernel() { return variants_and_locate_full_kernel<Tail, N, G>; }
  static int run(int rows, const int* a, const int* a_pg, const int* na,
                 const int* ra, const int* b, const int* b_pg,
                 const int* nb, const int* rb, const int* bpad, int va,
                 int vb, int cap, Tail tail, void* stream) {
    if (rows > 0)
      variants_and_locate_full_kernel<Tail, N, G>
          <<<Shape::blocks(rows), Shape::kThreads, Shape::kSmem,
             (cudaStream_t)stream>>>(a, a_pg, na, ra, b, b_pg, nb, rb, bpad,
                                     rows, va, vb, cap, tail);
    return (int)cudaGetLastError();
  }
};

template <class Tail, int N, int G>
struct UnionMergeLaunch {
  using Shape = VarShape<N, G>;
  static auto kernel() { return union_merge_locate_full_kernel<Tail, N, G>; }
  static int run(int rows, const int* a, const int* a_pg, const int* na,
                 int v, int cap, Tail tail, void* stream) {
    if (rows > 0)
      union_merge_locate_full_kernel<Tail, N, G>
          <<<Shape::blocks(rows), Shape::kThreads, Shape::kSmem,
             (cudaStream_t)stream>>>(a, a_pg, na, rows, v, cap, tail);
    return (int)cudaGetLastError();
  }
};

template <class Tail>
int launch_variants_and(const int* a, const int* a_pg, const int* na,
                        const int* ra, const int* b, const int* b_pg,
                        const int* nb, const int* rb, const int* bpad,
                        int rows, int va, int vb, int cap, const Tail& tail,
                        void* stream) {
  if (!shape_ok(va + vb, cap)) return (int)cudaErrorInvalidValue;
  return launch_by_rows<VariantsAndLaunch, Tail>(
      (va + vb) * cap, rows, a, a_pg, na, ra, b, b_pg, nb, rb, bpad, va, vb,
      cap, tail, stream);
}

template <class Tail>
int launch_union_merge(const int* a, const int* a_pg, const int* na,
                       int rows, int v, int cap, const Tail& tail,
                       void* stream) {
  if (!shape_ok(v, cap)) return (int)cudaErrorInvalidValue;
  return launch_by_rows<UnionMergeLaunch, Tail>(v * cap, rows, a, a_pg, na,
                                                v, cap, tail, stream);
}

}  // namespace

extern "C" int docodo_variants_and_locate_full(
    const int* a, const int* a_pg, const int* na, const int* ra,
    const int* b, const int* b_pg, const int* nb, const int* rb,
    const int* bpad, int rows, int va, int vb, int cap, int kpad, int hpad,
    int* pg_c, float* rk_c, float* ct_c, int* n_pages, int* n_hits,
    int* hits, void* stream) {
  return launch_variants_and(
      a, a_pg, na, ra, b, b_pg, nb, rb, bpad, rows, va, vb, cap,
      slots_tail(kpad, hpad, pg_c, rk_c, ct_c, n_pages, n_hits, hits),
      stream);
}

extern "C" int docodo_variants_and_locate_full_topk(
    const int* a, const int* a_pg, const int* na, const int* ra,
    const int* b, const int* b_pg, const int* nb, const int* rb,
    const int* bpad, int rows, int va, int vb, int cap, int topk, int hpad,
    int* pages, float* ranks, int* counts, int* n_pages, int* n_hits,
    int* hits, void* stream) {
  return launch_variants_and(
      a, a_pg, na, ra, b, b_pg, nb, rb, bpad, rows, va, vb, cap,
      topk_tail(topk, hpad, pages, ranks, counts, n_pages, n_hits, hits),
      stream);
}

extern "C" int docodo_union_merge_locate_full(
    const int* a, const int* a_pg, const int* na, int rows, int v, int cap,
    int kpad, int hpad, int* pg_c, float* rk_c, float* ct_c, int* n_pages,
    int* n_hits, int* hits, void* stream) {
  return launch_union_merge(
      a, a_pg, na, rows, v, cap,
      slots_tail(kpad, hpad, pg_c, rk_c, ct_c, n_pages, n_hits, hits),
      stream);
}

extern "C" int docodo_union_locate_full_topk(
    const int* a, const int* a_pg, const int* na, int rows, int v, int cap,
    int topk, int hpad, int* pages, float* ranks, int* counts, int* n_pages,
    int* n_hits, int* hits, void* stream) {
  const TopkTail tail =
      topk_tail(topk, hpad, pages, ranks, counts, n_pages, n_hits, hits);
  if (v == 1) return launch_w1<UnionKeep>(a, a_pg, na, rows, cap, tail, stream);
  return launch_union_merge(a, a_pg, na, rows, v, cap, tail, stream);
}
