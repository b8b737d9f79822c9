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
// What bounds them on this card: bytes. Each reads its input streams once
// and writes its outputs once, with a few integer operations a lane. The
// TPU route runs its scans over a sequential grid of 8-row programs and
// carries per-row state in scratch between grid steps; here a block owns a
// row and sweeps it in chunks of kChunk lanes with the carried state in
// registers, so nothing between the chunks goes through device memory but
// the keep kernels' per-segment operand counts. The TPU's bitonic merge
// network and its sorts of already sorted blocks become a merge by
// binary-search rank (each element's slot is its index plus its rank in
// every other block), and the compare-all compactions become scatters at
// prefix-sum slots. One block per row leaves SMs idle
// when a wide bucket has few rows; that is left for later work.
//
// Every entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError().

#include "common.cuh"

namespace {

using namespace docodo;

constexpr int kThreads = 256;
constexpr int kIpt = 4;
constexpr int kChunk = kThreads * kIpt;  // lanes a block sweeps at once
constexpr int kMergeThreads = 256;

// merge_tagged: the row's va blocks of word A (tag 0) and vb blocks of word
// B (tag 1), block k of word A at a[row, k, :cap_a] with its length in
// na_[row, k] (word B likewise), merge into one (coord, tag) stream. An
// element of block k lands at its index plus its rank in every other block,
// counting equal coords of earlier blocks (word A's before word B's) as
// before it and those of later blocks as after: a bijection onto the first
// sum(len) slots. Padding lanes (INF32, tag 2, page 0) follow in block
// order. pg / a_pg / b_pg may all be null (no page payload).
__global__ void __launch_bounds__(kMergeThreads) merge_tagged_kernel(
    const int* __restrict__ a, const int* __restrict__ a_pg,
    const int* __restrict__ na_, const int* __restrict__ b,
    const int* __restrict__ b_pg, const int* __restrict__ nb_, int va,
    int cap_a, int vb, int cap_b, int* __restrict__ vals,
    int* __restrict__ tag, int* __restrict__ pg) {
  const size_t row = blockIdx.x;
  const int k = blockIdx.z;
  const int i = blockIdx.y * kMergeThreads + threadIdx.x;
  const bool in_a = k < va;
  const int cap = in_a ? cap_a : cap_b;
  if (i >= cap) return;
  const int nblk = va + vb;
  const size_t out = row * ((size_t)va * cap_a + (size_t)vb * cap_b);
  auto block = [&](int j) -> const int* {
    return j < va ? a + (row * va + j) * cap_a
                  : b + (row * vb + j - va) * cap_b;
  };
  auto length = [&](int j) -> int {
    return j < va ? clamp_len(na_[row * va + j], cap_a)
                  : clamp_len(nb_[row * vb + j - va], cap_b);
  };
  const int len = length(k);
  if (i < len) {
    const int v = block(k)[i];
    size_t p = i;
    for (int j = 0; j < nblk; ++j) {
      if (j < k) p += upper_bound(block(j), length(j), v);
      else if (j > k) p += lower_bound(block(j), length(j), v);
    }
    vals[out + p] = v;
    tag[out + p] = in_a ? 0 : 1;
    if (pg) pg[out + p] = in_a ? a_pg[(row * va + k) * cap_a + i]
                               : b_pg[(row * vb + k - va) * cap_b + i];
  } else {
    size_t p = i - len;
    for (int j = 0; j < nblk; ++j) {
      const int lj = length(j);
      p += lj;
      if (j < k) p += (j < va ? cap_a : cap_b) - lj;
    }
    vals[out + p] = kInf;
    tag[out + p] = 2;
    if (pg) pg[out + p] = 0;
  }
}

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
//   of equal coordinates may be up to Va + Vb lanes long and cross chunks.
//   Tags ascend within a run, so its first lane (the eligible one) holds
//   word A's mark when its tag is 0, and its last lane holds word B's mark
//   when its tag is 1; both read only the neighbouring lanes. A run never
//   crosses a segment cut (equal coords have gap 0, and the ordered cut
//   falls on word-A marks, which are run starts), so the marks count per
//   segment as if they sat on the run's first lane. Rows with bpad keep
//   every run start (word B is query padding: word A's union).
//
// Pass 1 sweeps the row in chunks, carrying the operand counts and the
// segment state, and writes each lane's (segment ordinal << 1 | eligible)
// to hv and each segment's operand counts before its first lane to
// seg[row, s] (one int2 per segment; seg[row, nseg] holds the totals).
// Pass 2 resolves every lane from its segment's two entries. It writes the
// values to hv or, when cvals is set, the kept values (and their pages
// from pg, when cpg is set) compacted to the front of cvals / cpg, INF32
// after them, and their count to ccount. Each thread revisits the lanes it
// wrote in pass 1.
template <bool kVariants>
__global__ void __launch_bounds__(kThreads) keep_kernel(
    const int* __restrict__ vals, const int* __restrict__ tag,
    const int* __restrict__ ra_, const int* __restrict__ rb_,
    const int* __restrict__ bpad_, const int* __restrict__ pg, int n,
    int* __restrict__ hv, int2* __restrict__ seg, int* __restrict__ cvals,
    int* __restrict__ cpg, int* __restrict__ ccount) {
  __shared__ int s_warp[32];
  const int tid = threadIdx.x;
  const size_t row = blockIdx.x;
  const int* v_row = vals + row * n;
  const int* t_row = tag + row * n;
  int* h_row = hv + row * n;
  int2* s_row = seg + row * (size_t)(n + 1);
  const int r1 = ra_[row];
  const int r2 = rb_[row];
  const int abs_r = max(abs(r1), abs(r2));
  const bool ordered = r1 < 0 && r2 < 0;
  const bool bpad = kVariants && bpad_[row] != 0;

  int c_a = 0, c_b = 0, c_sid = 0, c_start = -1, c_bas = -1;
  for (int c0 = 0; c0 < n; c0 += kChunk) {
    const int base = c0 + tid * kIpt;
    int isa[kIpt], isb[kIpt], seg_start[kIpt];
    bool eff[kIpt];
#pragma unroll
    for (int k = 0; k < kIpt; ++k) {
      const int l = base + k;
      isa[k] = isb[k] = seg_start[k] = 0;
      eff[k] = false;
      if (l < n) {
        const int v = v_row[l];
        const int t = t_row[l];
        const bool valid = v < kInf;
        const int pv = l > 0 ? v_row[l - 1] : 0;
        const int nv = l + 1 < n ? v_row[l + 1] : kInf;
        const bool dup_prev = valid && l > 0 && v == pv;
        if (kVariants) {
          isa[k] = valid && !dup_prev && t == 0;
          isb[k] = valid && t == 1 && v != nv;
        } else {
          const int nt = l + 1 < n ? t_row[l + 1] : 2;
          const bool dup_next = valid && v == nv;
          const bool a_next = nv < kInf && nt == 0;
          const bool b_next = nv < kInf && nt == 1;
          isa[k] = ((valid && t == 0) || (dup_next && a_next)) && !dup_prev;
          isb[k] = ((valid && t == 1) || (dup_next && b_next)) && !dup_prev;
        }
        eff[k] = valid && !dup_prev;
        const int gap = v - (l == 0 ? 0 : pv);
        seg_start[k] = l == 0 || (abs_r != 0 && gap > abs_r && valid);
      }
    }
    // operand counts through each lane (inclusive)
    int cum_a[kIpt], cum_b[kIpt];
#pragma unroll
    for (int k = 0; k < kIpt; ++k) {
      cum_a[k] = isa[k];
      cum_b[k] = isb[k];
    }
    const int tot_a = scan_lanes<kThreads>(cum_a, kIpt, 0, Sum(), true, s_warp);
    const int tot_b = scan_lanes<kThreads>(cum_b, kIpt, 0, Sum(), true, s_warp);
#pragma unroll
    for (int k = 0; k < kIpt; ++k) {
      cum_a[k] += c_a;
      cum_b[k] += c_b;
    }
    if (ordered) {  // uniform over the block, so the scans inside are safe
      // the enclosing gap segment's start lane, and the A count before it
      int start[kIpt], bas[kIpt];
#pragma unroll
      for (int k = 0; k < kIpt; ++k) {
        const int l = base + k;
        start[k] = (l < n && seg_start[k]) ? l : -1;
        bas[k] = (l < n && seg_start[k]) ? cum_a[k] - isa[k] : -1;
      }
      const int m_start =
          scan_lanes<kThreads>(start, kIpt, -1, Max(), true, s_warp);
      const int m_bas = scan_lanes<kThreads>(bas, kIpt, -1, Max(), true, s_warp);
#pragma unroll
      for (int k = 0; k < kIpt; ++k) {
        const int l = base + k;
        const int st = max(start[k], c_start);
        const int bs = max(bas[k], c_bas);
        if (l < n && isa[k] && cum_a[k] - isa[k] == bs && l != st)
          seg_start[k] = 1;
      }
      c_start = max(c_start, m_start);
      c_bas = max(c_bas, m_bas);
    }
    int sid[kIpt];
#pragma unroll
    for (int k = 0; k < kIpt; ++k) sid[k] = seg_start[k];
    const int tot_s = scan_lanes<kThreads>(sid, kIpt, 0, Sum(), true, s_warp);
#pragma unroll
    for (int k = 0; k < kIpt; ++k) {
      const int l = base + k;
      if (l < n) {
        const int s = sid[k] + c_sid;  // 1-based segment ordinal
        if (seg_start[k])
          s_row[s - 1] = make_int2(cum_a[k] - isa[k], cum_b[k] - isb[k]);
        h_row[l] = (s << 1) | (eff[k] ? 1 : 0);
      }
    }
    c_a += tot_a;
    c_b += tot_b;
    c_sid += tot_s;
  }
  if (tid == 0) s_row[c_sid] = make_int2(c_a, c_b);
  __syncthreads();  // pass 1's writes to seg are visible to the block

  int* cv_row = cvals ? cvals + row * n : nullptr;
  int* cp_row = cpg ? cpg + row * n : nullptr;
  const int* p_row = pg ? pg + row * n : nullptr;
  int c_kept = 0;
  for (int c0 = 0; c0 < n; c0 += kChunk) {
    const int base = c0 + tid * kIpt;
    int slot[kIpt];
#pragma unroll
    for (int k = 0; k < kIpt; ++k) {
      const int l = base + k;
      bool keep = false;
      if (l < n) {
        const int x = h_row[l];
        const int s = (x >> 1) - 1;
        const int2 lo = s_row[s];
        const int2 hi = s_row[s + 1];
        keep = (x & 1) && (bpad || (hi.x > lo.x && hi.y > lo.y));
        if (!cv_row) h_row[l] = keep ? v_row[l] : kInf;
      }
      slot[k] = keep ? 1 : 0;
    }
    if (cv_row) {  // uniform over the block, so the scan inside is safe
      int kept[kIpt];
#pragma unroll
      for (int k = 0; k < kIpt; ++k) kept[k] = slot[k];
      const int tot = scan_lanes<kThreads>(slot, kIpt, 0, Sum(), false,
                                           s_warp);
#pragma unroll
      for (int k = 0; k < kIpt; ++k) {
        if (!kept[k]) continue;
        const int l = base + k;
        cv_row[c_kept + slot[k]] = v_row[l];
        if (cp_row) cp_row[c_kept + slot[k]] = p_row[l];
      }
      c_kept += tot;
    }
  }
  if (cv_row) {
    for (int l = c_kept + tid; l < n; l += kThreads) {
      cv_row[l] = kInf;
      if (cp_row) cp_row[l] = kInf;
    }
    if (tid == 0) ccount[row] = c_kept;
  }
}

// locate_runs: page runs of a kept stream hv (INF32 at dropped lanes, kept
// values ascending) of any width. Pages come from pg (carried) or, when pg
// is null, from a binary search of bounds (#bounds <= value, clamped to
// the last page). Writes the first kpad runs in slot order, the first hpad
// kept values, and the exact run and hit totals.
//
// A run's count and bonus are differences of two exclusive prefix sums:
// at its first lane and at the next run's first lane (the row totals for
// the last run). The block records those sums for run ordinals <= kpad in
// shared memory and never writes a full-width stream.
__global__ void __launch_bounds__(kThreads) locate_runs_kernel(
    const int* __restrict__ hv, const int* __restrict__ pg,
    const int* __restrict__ bounds, int n_bounds, int n, int kpad, int hpad,
    Outputs out) {
  extern __shared__ int smem[];
  int* s_cnt = smem;                  // [kpad + 1] hits before run r
  int* s_bon = s_cnt + (kpad + 1);    // [kpad + 1] bonus before run r
  int* s_page = s_bon + (kpad + 1);   // [kpad] page of run r
  int* s_val = s_page + kpad;         // [kChunk] the chunk's values
  int* s_pg = s_val + kChunk;         // [kChunk] the chunk's pages
  int* s_warp = s_pg + kChunk;        // [32]
  const int tid = threadIdx.x;
  const size_t row = blockIdx.x;
  const int* h_row = hv + row * n;
  const int* p_row = pg ? pg + row * n : nullptr;
  int* hits = out.hits + row * hpad;

  int c_runs = 0, c_hits = 0, c_bon = 0, c_pv = -1, c_pp = -1;
  for (int c0 = 0; c0 < n; c0 += kChunk) {
    const int base = c0 + tid * kIpt;
    int v[kIpt], page[kIpt], prev[kIpt];
    bool keep[kIpt];
#pragma unroll
    for (int k = 0; k < kIpt; ++k) {
      const int l = base + k;
      v[k] = l < n ? h_row[l] : kInf;
      keep[k] = v[k] < kInf;
      page[k] = -1;
      if (keep[k]) {
        if (p_row) {
          page[k] = p_row[l];
        } else {
          const int p = upper_bound(bounds, n_bounds, v[k]);
          page[k] = p < n_bounds ? p : n_bounds - 1;
        }
      }
      s_val[l - c0] = v[k];
      s_pg[l - c0] = page[k];
      prev[k] = keep[k] ? l - c0 : -1;
    }
    // the previous kept lane in this chunk: an exclusive max-scan (it also
    // orders the s_val / s_pg writes before the reads below)
    const int last = scan_lanes<kThreads>(prev, kIpt, -1, Max(), false, s_warp);
    int first[kIpt], bonus[kIpt], slot[kIpt];
#pragma unroll
    for (int k = 0; k < kIpt; ++k) {
      const int p = prev[k];
      const int pv = p >= 0 ? s_val[p] : c_pv;
      const int pp = p >= 0 ? s_pg[p] : c_pp;
      first[k] = keep[k] && page[k] != pp;
      bonus[k] = 0;
      if (keep[k] && !first[k]) {
        const int gap = v[k] - pv;
        bonus[k] = 30 / (gap > 5 ? gap : 5);
      }
      slot[k] = keep[k] ? 1 : 0;
    }
    int rid[kIpt];
#pragma unroll
    for (int k = 0; k < kIpt; ++k) rid[k] = first[k];
    const int t_runs = scan_lanes<kThreads>(rid, kIpt, 0, Sum(), true, s_warp);
    const int t_hits = scan_lanes<kThreads>(slot, kIpt, 0, Sum(), false, s_warp);
    const int t_bon = scan_lanes<kThreads>(bonus, kIpt, 0, Sum(), false, s_warp);
#pragma unroll
    for (int k = 0; k < kIpt; ++k) {
      if (!keep[k]) continue;
      const int h = c_hits + slot[k];
      if (h < hpad) hits[h] = v[k];
      const int r = c_runs + rid[k] - 1;
      if (first[k] && r <= kpad) {
        s_cnt[r] = h;
        s_bon[r] = c_bon + bonus[k];
        if (r < kpad) s_page[r] = page[k];
      }
    }
    if (last >= 0) {
      c_pv = s_val[last];
      c_pp = s_pg[last];
    }
    c_runs += t_runs;
    c_hits += t_hits;
    c_bon += t_bon;
    __syncthreads();  // the chunk buffers are rewritten next
  }
  if (tid == 0 && c_runs <= kpad) {
    s_cnt[c_runs] = c_hits;
    s_bon[c_runs] = c_bon;
  }
  __syncthreads();
  for (int r = tid; r < kpad; r += kThreads) {
    const size_t o = row * kpad + r;
    if (r < c_runs) {
      const int cnt = s_cnt[r + 1] - s_cnt[r];
      out.pg_c[o] = s_page[r];
      out.rk_c[o] = run_rank(s_bon[r + 1] - s_bon[r], cnt);
      out.ct_c[o] = (float)cnt;
    } else {
      out.pg_c[o] = -1;
      out.rk_c[o] = 0.0f;
      out.ct_c[o] = 0.0f;
    }
  }
  for (int h = c_hits + tid; h < hpad; h += kThreads) hits[h] = kInf;
  if (tid == 0) {
    out.n_pages[row] = c_runs;
    out.n_hits[row] = c_hits;
  }
}

size_t locate_runs_smem(int kpad) {
  return sizeof(int) * (2 * (size_t)(kpad + 1) + kpad + 2 * kChunk + 32);
}

}  // namespace

extern "C" int docodo_merge_tagged(const int* a, const int* a_pg,
                                   const int* na, const int* b,
                                   const int* b_pg, const int* nb, int rows,
                                   int va, int cap_a, int vb, int cap_b,
                                   int* vals, int* tag, int* pg,
                                   void* stream) {
  const int ca = va > 0 ? cap_a : 0;
  const int cb = vb > 0 ? cap_b : 0;
  const int cap = ca > cb ? ca : cb;
  if (va + vb > 65535) return (int)cudaErrorInvalidValue;
  if (rows > 0 && cap > 0) {
    const dim3 grid(rows, (cap + kMergeThreads - 1) / kMergeThreads,
                    va + vb);
    merge_tagged_kernel<<<grid, kMergeThreads, 0, (cudaStream_t)stream>>>(
        a, a_pg, na, b, b_pg, nb, va, cap_a, vb, cap_b, vals, tag, pg);
  }
  return (int)cudaGetLastError();
}

extern "C" int docodo_and_keep(const int* vals, const int* tag,
                               const int* ra, const int* rb, const int* pg,
                               int rows, int n, int* hv, int* seg,
                               int* cvals, int* cpg, int* ccount,
                               void* stream) {
  if (rows > 0 && n > 0)
    keep_kernel<false><<<rows, kThreads, 0, (cudaStream_t)stream>>>(
        vals, tag, ra, rb, nullptr, pg, n, hv, reinterpret_cast<int2*>(seg),
        cvals, cpg, ccount);
  return (int)cudaGetLastError();
}

extern "C" int docodo_variants_keep(const int* vals, const int* tag,
                                    const int* ra, const int* rb,
                                    const int* bpad, const int* pg, int rows,
                                    int n, int* hv, int* seg, int* cvals,
                                    int* cpg, int* ccount, void* stream) {
  if (rows > 0 && n > 0)
    keep_kernel<true><<<rows, kThreads, 0, (cudaStream_t)stream>>>(
        vals, tag, ra, rb, bpad, pg, n, hv, reinterpret_cast<int2*>(seg),
        cvals, cpg, ccount);
  return (int)cudaGetLastError();
}

extern "C" int docodo_locate_runs(const int* hv, const int* pg,
                                  const int* bounds, int n_bounds, int rows,
                                  int n, int kpad, int hpad, int* pg_c,
                                  float* rk_c, float* ct_c, int* n_pages,
                                  int* n_hits, int* hits, void* stream) {
  const size_t smem = locate_runs_smem(kpad);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        locate_runs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (rows > 0 && n > 0)
    locate_runs_kernel<<<rows, kThreads, smem, (cudaStream_t)stream>>>(
        hv, pg, bounds, n_bounds, n, kpad, hpad,
        outputs(pg_c, rk_c, ct_c, n_pages, n_hits, hits));
  return (int)cudaGetLastError();
}
