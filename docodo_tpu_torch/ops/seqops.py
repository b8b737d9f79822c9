"""Posting algebra on batched torch tensors: the twin of
docodo_tpu/ops/seqops.py for the full-result path (AND folds of any
width, variant ORs).

Every function takes a batch of rows written out as the leading
dimension (the JAX package vmaps the same functions over one row).
Streams are int32 and padded with INF32; ranks and counts are float32.

The TPU workarounds of the reference (compare-all ranks, one-hot
placement and compaction) are not carried over: on the GPU a merge is a
scatter at searchsorted ranks and a compaction is a prefix sum plus a
scatter. The outputs and their tie-break orders are the contract.
"""

from __future__ import annotations

import numpy as np
import torch

INF32 = 2**31 - 1


def topk_nonneg(ranks: torch.Tensor, k: int):
    """Top `k` of non-negative f32 ranks per row: (values, slots).

    Ties go to the lowest slot, as `lax.top_k` does (seqops.py:31): a
    stable descending sort keeps equal ranks in slot order.
    `torch.topk` leaves the order of ties unspecified and is not used."""
    vals, slots = torch.sort(ranks, dim=1, descending=True, stable=True)
    return vals[:, :k], slots[:, :k]


def select_slots(stream: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """stream[B, n] read at slots[B, k] (seqops.py:42)."""
    return torch.gather(stream, 1, slots)


def rank_in_sorted(queries: torch.Tensor, sorted_vals: torch.Tensor,
                   strict: bool) -> torch.Tensor:
    """#{j: sorted_vals[j] < q} (strict) or <= q, per element of
    `queries` (seqops.py:100, searchsorted branch). `sorted_vals` is 1-D
    or has the rows of `queries`."""
    return torch.searchsorted(sorted_vals, queries,
                              right=not strict).to(torch.int32)


def combine_r(r1: torch.Tensor, r2: torch.Tensor) -> torch.Tensor:
    """Result window: max magnitude; ordered only if both ordered."""
    abs_r = torch.maximum(r1.abs(), r2.abs())
    return torch.where((r1 < 0) & (r2 < 0), -abs_r, abs_r)


def _shift_right(x: torch.Tensor, fill) -> torch.Tensor:
    """x[:, l - 1] at lane l, `fill` at lane 0."""
    return torch.cat([torch.full_like(x[:, :1], fill), x[:, :-1]], dim=1)


def _shift_left(x: torch.Tensor, fill) -> torch.Tensor:
    """x[:, l + 1] at lane l, `fill` at the last lane."""
    return torch.cat([x[:, 1:], torch.full_like(x[:, :1], fill)], dim=1)


def fold_dups(vals, isa, isb, valid):
    """Cross-operand duplicates merge onto their first element; the
    second becomes a ghost (seqops.py:243-252). Returns (isa, isb,
    ghost)."""
    dup_prev = (vals == _shift_right(vals, -1)) & valid
    dup_next = (vals == _shift_left(vals, INF32)) & valid
    isa2 = (isa | (dup_next & _shift_left(isa, False))) & ~dup_prev
    isb2 = (isb | (dup_next & _shift_left(isb, False))) & ~dup_prev
    return isa2, isb2, dup_prev


def merge_sorted_tagged(a, na, b, nb):
    """Merge two batches of padded ascending lists [B, p1], [B, p2]
    (seqops.py:183). Each element lands at its index plus its rank in
    the other operand (ties: a first), which is a bijection onto the
    merged slots, so one scatter places it.

    Returns (vals, isa, isb, ghost, valid), each [B, p1 + p2]."""
    bsz, p1 = a.shape
    p2 = b.shape[1]
    dev = a.device
    ia = torch.arange(p1, device=dev)[None, :] < na[:, None]
    ib = torch.arange(p2, device=dev)[None, :] < nb[:, None]
    av = torch.where(ia, a, INF32)
    bv = torch.where(ib, b, INF32)
    ra = torch.arange(p1, device=dev) + rank_in_sorted(av, bv, strict=True)
    rb = torch.arange(p2, device=dev) + rank_in_sorted(bv, av, strict=False)
    vals = torch.empty((bsz, p1 + p2), dtype=torch.int32, device=dev)
    vals.scatter_(1, ra.long(), av)
    vals.scatter_(1, rb.long(), bv)
    isa = torch.zeros((bsz, p1 + p2), dtype=torch.bool, device=dev)
    isb = torch.zeros_like(isa)
    isa.scatter_(1, ra.long(), ia)
    isb.scatter_(1, rb.long(), ib)
    valid = vals < INF32
    isa, isb, ghost = fold_dups(vals, isa, isb, valid)
    return vals, isa, isb, ghost, valid


def span_contains(marks, starts, terminals):
    """Whether each slot's enclosing [start..terminal] span holds a
    marked slot (seqops.py:271)."""
    cum = torch.cumsum(marks.to(torch.int32), dim=1)
    prev = _shift_right(cum, 0)
    before = torch.cummax(torch.where(starts, prev, -1), dim=1).values
    end = torch.flip(torch.cummin(torch.flip(
        torch.where(terminals, cum, INF32), [1]), dim=1).values, [1])
    return (end - before) > 0


def segment_and(vals, isa, isb, ghost, valid, r):
    """Gap segmentation, the ordered cut and the per-segment
    both-operands test over a merged tagged stream (seqops.py:289).
    `r` is the combined window per row. Returns the keep mask."""
    n = vals.shape[1]
    idx = torch.arange(n, device=vals.device, dtype=torch.int32)[None, :]
    abs_r = r.abs()[:, None]
    prev = _shift_right(vals, 0)
    gap_cut = (abs_r != 0) & ((vals - prev) > abs_r)
    seg_start = (idx == 0) | (gap_cut & valid)
    # ordered mode: the first A-tagged element of each gap segment
    # opens a new segment unless it already starts one
    start_idx = torch.cummax(torch.where(seg_start, idx, -1), dim=1).values
    isa_i = isa.to(torch.int32)
    before = torch.cumsum(isa_i, dim=1, dtype=torch.int32) - isa_i
    before_at_start = torch.cummax(
        torch.where(seg_start, before, -1), dim=1).values
    ordered_cut = isa & (before == before_at_start) & (idx != start_idx)
    seg_start = torch.where((r < 0)[:, None], seg_start | ordered_cut,
                            seg_start)
    terminal = _shift_left(seg_start, True)
    has_a = span_contains(isa, seg_start, terminal)
    has_b = span_contains(isb, seg_start, terminal)
    return has_a & has_b & valid & ~ghost


def and_masked(a, na, ra, b, nb, rb):
    """Proximity-AND without compaction (seqops.py:327): (vals
    [B, p1 + p2] ascending incl. dropped slots, keep, r)."""
    r = combine_r(ra, rb)
    vals, isa, isb, ghost, valid = merge_sorted_tagged(a, na, b, nb)
    return vals, segment_and(vals, isa, isb, ghost, valid, r), r


def or_masked(a, na, b, nb):
    """OR-merge without compaction (seqops.py:421): (vals ascending,
    keep), cross-operand duplicates kept once."""
    vals, _, _, ghost, valid = merge_sorted_tagged(a, na, b, nb)
    return vals, valid & ~ghost


def compact(vals, keep):
    """Kept values to the front, ascending, INF32 after them, and their
    count (seqops._compact without out_cap)."""
    out = torch.sort(torch.where(keep, vals, INF32), dim=1).values
    return out, keep.sum(dim=1, dtype=torch.int32)


def sort_tagged(vals, tag, page=None):
    """A stable sort of [B, n] lanes on the packed key coord << 2 | tag
    (tag 0 = word A, 1 = word B, 2 = padding): the (coord, tag) order
    of the JAX package's two-key lax.sort, pages riding along."""
    order = torch.sort((vals.long() << 2) | tag, dim=1, stable=True).indices
    page = None if page is None else torch.gather(page, 1, order)
    return torch.gather(vals, 1, order), torch.gather(tag, 1, order), page


def variant_blocks(a, na):
    """[B, V, cap] variant posting blocks, INF32 past their lengths
    na [B, V], flattened to [B, V cap]."""
    lane = torch.arange(a.shape[2], device=a.device)
    live = lane[None, None, :] < na[:, :, None]
    return torch.where(live, a, INF32).reshape(a.shape[0], -1)


def run_marks(vals, tag):
    """Run-dedupe of a (coord, tag)-ordered variant stream
    (seqops.py:376-386): each run of equal valid coordinates folds onto
    its first lane, which carries every word tag of the run. Returns
    (isa, isb, ghost, valid, run_start)."""
    valid = vals < INF32
    run_start = valid & (vals != _shift_right(vals, -1))
    terminal = _shift_left(run_start | ~valid, True)
    isa = run_start & span_contains((tag == 0) & valid, run_start, terminal)
    isb = run_start & span_contains((tag == 1) & valid, run_start, terminal)
    return isa, isb, valid & ~run_start, valid, run_start


def variants_keep_mask(vals, tag, ra, rb, bpad):
    """The keep mask of and_variants_sorted over an already merged
    stream (seqops.py:342): run-dedupe, then the AND's segmentation;
    rows with bpad (word B is query padding) keep word A's union, the
    run starts."""
    isa, isb, ghost, valid, run_start = run_marks(vals, tag)
    keep = segment_and(vals, isa, isb, ghost, valid, combine_r(ra, rb))
    return torch.where(bpad[:, None], run_start, keep)


def and_variants_sorted(sa, na, ra, sb, nb, rb, bpad):
    """Proximity-AND of two variant-OR words in one merge
    (seqops.py:342): sa [B, Va, cap] / sb [B, Vb, cap] variant blocks
    with lengths na / nb, windows ra / rb [B], bpad [B] bool. Returns
    (vals [B, (Va + Vb) cap] ascending, keep, r)."""
    av, bv = variant_blocks(sa, na), variant_blocks(sb, nb)
    vals = torch.cat([av, bv], dim=1)
    tag = torch.cat([torch.where(av < INF32, 0, 2),
                     torch.where(bv < INF32, 1, 2)], dim=1)
    vals, tag, _ = sort_tagged(vals, tag)
    keep = variants_keep_mask(vals, tag, ra, rb, bpad)
    return vals, keep, torch.where(bpad, ra, combine_r(ra, rb))


def or_variants_sorted(streams, ns):
    """Union of one word's V variant blocks [B, V, cap] (seqops.py:395):
    (vals [B, V cap] ascending, keep = each run's first lane)."""
    vals = torch.sort(variant_blocks(streams, ns), dim=1).values
    keep = (vals < INF32) & (vals != _shift_right(vals, -1))
    return vals, keep


def run_starts(vals, keep, page):
    """Where a masked ascending stream's page runs start, and each kept
    slot's bonus: a run starts at a kept slot whose page differs from
    the previous kept slot's; each later slot of the run adds
    30 // max(5, gap). Returns (first bool[B, n], bonus int32[B, n])."""
    lane = torch.arange(vals.shape[1], device=vals.device)[None, :]
    last = torch.cummax(torch.where(keep, lane, -1), dim=1).values
    prev_idx = _shift_right(last, -1)
    has_prev = prev_idx >= 0
    safe = prev_idx.clamp_min(0)
    prev_val = torch.gather(vals, 1, safe)
    prev_page = torch.where(has_prev, torch.gather(page, 1, safe), -1)
    first = keep & (page != prev_page)
    gap = torch.where(has_prev, vals - prev_val, 0)
    return first, torch.where(keep & ~first, 30 // gap.clamp_min(5), 0)


def page_runs(vals, keep, page, kpad: int):
    """Masked ascending stream -> its first `kpad` page runs in slot
    order; with kpad = n, every run of the row.

    A run starts at a kept slot whose page differs from the previous
    kept slot's; each later slot of the run adds 30 // max(5, gap).
    rank = (1 + bonus) + ln(count) in f32 (device_index._locate_core,
    pallas_query._locate_rank_core). Run sums are exact integers, so
    any summation order gives the same f32. Page values at dropped
    slots are never read.

    Returns (pages int32[B, kpad] (-1 pad), ranks f32[B, kpad] (0 pad),
    counts int32[B, kpad] (0 pad), n_pages int32[B])."""
    bsz = vals.shape[0]
    dev = vals.device
    first, bonus = run_starts(vals, keep, page)
    run_id = torch.cumsum(first, dim=1) - 1
    n_pages = first.sum(dim=1, dtype=torch.int32)
    # runs past kpad and dropped slots land in the spare column kpad
    rsel = torch.where(keep & (run_id < kpad), run_id, kpad)
    zeros = torch.zeros((bsz, kpad + 1), dtype=torch.int32, device=dev)
    cnt = zeros.scatter_add(1, rsel, keep.to(torch.int32))[:, :kpad]
    bon = zeros.scatter_add(1, rsel, bonus.to(torch.int32))[:, :kpad]
    psel = torch.where(first, rsel, kpad)
    pg = zeros.scatter(1, psel, page)[:, :kpad]
    rank = (1.0 + bon.to(torch.float32)) + torch.log(
        cnt.to(torch.float32).clamp_min(1.0))
    served = torch.arange(kpad, device=dev)[None, :] < n_pages[:, None]
    return (torch.where(served, pg, -1), torch.where(served, rank, 0.0),
            torch.where(served, cnt, 0), n_pages)


def compact_hits(vals, keep, hpad: int):
    """The first `hpad` kept values of a masked stream in slot order,
    INF32 after them, and the exact count: (hits int32[B, hpad],
    n_hits int32[B])."""
    slot = torch.cumsum(keep, dim=1) - 1
    hsel = torch.where(keep & (slot < hpad), slot, hpad)
    hits = torch.full((vals.shape[0], hpad + 1), INF32, dtype=torch.int32,
                      device=vals.device)
    return (hits.scatter(1, hsel, vals)[:, :hpad],
            keep.sum(dim=1, dtype=torch.int32))


def locate_compact(vals, keep, page, kpad: int, hpad: int):
    """Masked ascending stream -> the first `kpad` page runs in slot
    order (page_runs, counts as f32) and the first `hpad` kept hits,
    with exact totals.

    Returns (pg_c int32[B, kpad] (-1 pad), rk_c f32[B, kpad] (0 pad),
    ct_c f32[B, kpad] (0 pad), n_pages int32[B], n_hits int32[B],
    hits int32[B, hpad] (INF32 pad))."""
    pg_c, rk_c, cnt, n_pages = page_runs(vals, keep, page, kpad)
    hits, n_hits = compact_hits(vals, keep, hpad)
    return pg_c, rk_c, cnt.to(torch.float32), n_pages, n_hits, hits


# ---------------------------------------------------------------------------
# the set operations on their own (seqops.py:65, :149, :411-441, :445):
# the JAX package's device_and / device_or take one row and batch_and /
# batch_or vmap them; here the batch forms are the core and the one-row
# forms wrap it
# ---------------------------------------------------------------------------

def pad_to(coords, cap: int):
    """An ascending list as a padded int32 row of `cap` lanes (numpy,
    INF32 past its first cap values) and its count, np.int32."""
    coords = np.asarray(coords, dtype=np.int64)
    n = min(coords.size, cap)
    out = np.full(cap, INF32, dtype=np.int32)
    out[:n] = coords[:n]
    return out, np.int32(n)


def compact_mask(vals, mask, out_cap: int):
    """The masked values of ascending streams [..., p] in the first
    `out_cap` lanes, ascending, INF32 after them (a stable partition:
    masking and sorting keeps the order)."""
    out = torch.sort(torch.where(mask, vals, INF32), dim=-1).values
    out = out[..., :out_cap]
    if out_cap > out.shape[-1]:
        out = torch.cat([out, out.new_full(
            (*out.shape[:-1], out_cap - out.shape[-1]), INF32)], dim=-1)
    return out


def _compact_to(vals, keep, out_cap):
    """compact, cut to the out_cap lowest kept values when out_cap is
    narrower than the stream (seqops._compact)."""
    out, n = compact(vals, keep)
    if out_cap is not None and out_cap < out.shape[1]:
        out, n = out[:, :out_cap], n.clamp_max(out_cap)
    return out, n


def batch_and(a, na, ra, b, nb, rb, out_cap=None):
    """Proximity-AND with group emission (both operands' coordinates) of
    rows a [B, p1], b [B, p2] with counts na / nb and windows ra / rb
    [B]. Returns (coords int32[B, out_cap or p1 + p2] INF32-padded,
    n int32[B], r int32[B])."""
    vals, keep, r = and_masked(a, na, ra, b, nb, rb)
    out, n = _compact_to(vals, keep, out_cap)
    return out, n, r


def batch_or(a, na, ra, b, nb, rb, out_cap=None):
    """OR-merge of rows with cross-operand duplicates kept once; as
    batch_and otherwise."""
    vals, keep = or_masked(a, na, b, nb)
    out, n = _compact_to(vals, keep, out_cap)
    return out, n, combine_r(ra, rb)


def _one_row(fn, a, na, ra, b, nb, rb, out_cap):
    def col(x):
        return torch.as_tensor(x, dtype=torch.int32,
                               device=a.device).reshape(1)

    out, n, r = fn(a[None], col(na), col(ra), b[None], col(nb), col(rb),
                   out_cap)
    return out[0], n[0], r[0]


def device_and(a, na, ra, b, nb, rb, out_cap=None):
    """batch_and of one row: a [p1], b [p2], the counts and windows
    scalars. Returns (coords [out_cap or p1 + p2], n, r), n and r 0-d."""
    return _one_row(batch_and, a, na, ra, b, nb, rb, out_cap)


def device_or(a, na, ra, b, nb, rb, out_cap=None):
    """batch_or of one row; as device_and."""
    return _one_row(batch_or, a, na, ra, b, nb, rb, out_cap)


def device_locate_rank(coords, n, bounds, page_doc, max_pages: int):
    """One coordinate stream [P] of n hits -> per-hit page statistics.
    A hit's page is searchsorted(bounds, coord, 'right') (capped at the
    last page), its position the coordinate less the page's start; a
    page run's rank is 1 + sum(30 // max(5, gap)) + ln(count) over its
    hits (ref Search.cs:99-111), summed over the first max_pages runs.
    page_doc is unused, as in the JAX package.

    Returns (page int32[P], pos int32[P], first bool[P], page_rank
    f32[P]); page_rank is nonzero only at a run's first hit."""
    p = coords.shape[0]
    dev = coords.device
    valid = torch.arange(p, device=dev) < n
    page = torch.searchsorted(bounds, coords, right=True).to(torch.int32)
    page = page.clamp_max(bounds.shape[0] - 1)
    base = torch.where(page > 0, bounds[(page - 1).clamp_min(0).long()], 0)
    pos = torch.where(valid, coords - base, 0)
    first = (page != _shift_right(page[None], -1)[0]) & valid
    run_id = torch.cumsum(first.to(torch.int32), 0) - 1
    gap = coords - _shift_right(coords[None], 0)[0]
    bonus = torch.where(valid & ~first, 30 // gap.clamp_min(5), 0)
    # runs past max_pages (and the slots before the first run) add to no
    # run, as segment_sum drops them
    ok = (run_id >= 0) & (run_id < max_pages)
    rid = torch.where(ok, run_id, 0).long()
    zeros = torch.zeros(max_pages, dtype=torch.float32, device=dev)
    run_bonus = zeros.index_add(0, rid, torch.where(ok, bonus, 0).float())
    run_count = zeros.index_add(0, rid, (valid & ok).float())
    run_rank = torch.where(
        run_count > 0,
        1.0 + run_bonus + torch.log(run_count.clamp_min(1.0)), 0.0)
    page_rank = torch.where(
        first, run_rank[run_id.clamp(0, max_pages - 1).long()], 0.0)
    return page, pos, first, page_rank


# ---------------------------------------------------------------------------
# the posting fetch, plain (the JAX package's ops/device_index.py)
# ---------------------------------------------------------------------------

def fetch_tables(small, cap: int):
    """The tables that together hold every term with count <= cap, or
    None (device_index.py:455)."""
    if small is None:
        return None
    cums = [st for st in small if not st.band]
    for st in cums:
        if st.w == cap and st.tab.shape[0] > 0:
            return (st,)
    if not cums or cap <= max(st.w for st in cums):
        return None
    base = max(cums, key=lambda st: st.w)
    if base.tab.shape[0] == 0:
        return None
    tabs = [base]
    w = base.w * 2
    bands = {st.w: st for st in small if st.band}
    while w <= cap:
        st = bands.get(w)
        if st is None:
            return None
        if st.tab.shape[0] > 0:
            tabs.append(st)
        w *= 2
    return tuple(tabs)


def _term_span(term_offsets, terms, cap: int):
    safe = terms.clamp_min(0).long()
    start = term_offsets[safe]
    ln = term_offsets[safe + 1] - start
    ln = torch.where(terms >= 0, ln, 0).clamp_max(cap).to(torch.int32)
    return safe, start, ln


def _table_rows(tabs, safe, cap: int, halves: int):
    """Row-gather every term's table row(s), padded to cap: a list of
    `halves` [B, cap] tensors (coords, then pages)."""
    bsz = safe.shape[0]
    dev = safe.device
    outs = [torch.full((bsz, cap), INF32, dtype=torch.int32, device=dev)
            for _ in range(halves)]
    for st in tabs:
        row = st.row_map[safe]
        both = st.tab[row.clamp_min(0).long()]
        has = (row >= 0)[:, None]
        for h in range(halves):
            g = both[:, h * st.w: (h + 1) * st.w]
            if st.w < cap:
                g = torch.cat([g, g.new_full((bsz, cap - st.w), INF32)],
                              dim=1)
            outs[h] = torch.where(has, g, outs[h])
    return outs


def gather_term(coords, term_offsets, terms, cap: int, small=None):
    """Fetch each term's postings into [B, cap] (device_index.py:397):
    term < 0 gives an empty row, longer lists keep their first cap
    coords. `small` may be passed only when every real term has count
    <= cap. Returns (vals int32[B, cap] INF32-padded, n int32[B])."""
    safe, start, ln = _term_span(term_offsets, terms, cap)
    lane = torch.arange(cap, device=coords.device)[None, :]
    tabs = fetch_tables(small, cap)
    if tabs is not None:
        (vals,) = _table_rows(tabs, safe, cap, 1)
    else:
        idx = (start[:, None].long() + lane).clamp_max(coords.shape[0] - 1)
        vals = coords[idx]
    return torch.where(lane < ln[:, None], vals, INF32), ln


def gather_term_paged(coords, page_of, term_offsets, terms, cap: int,
                      small=None):
    """gather_term plus each posting's page (device_index.py:499): both
    halves of a combined small table come from one row gather.
    Returns (vals, pages, n); padding lanes carry INF32 in both."""
    safe, start, ln = _term_span(term_offsets, terms, cap)
    lane = torch.arange(cap, device=coords.device)[None, :]
    tabs = fetch_tables(small, cap)
    if tabs is not None and all(st.tab.shape[1] == 2 * st.w for st in tabs):
        vals, pgs = _table_rows(tabs, safe, cap, 2)
    else:
        idx = (start[:, None].long() + lane).clamp_max(coords.shape[0] - 1)
        vals, pgs = coords[idx], page_of[idx]
    live = lane < ln[:, None]
    return (torch.where(live, vals, INF32), torch.where(live, pgs, INF32),
            ln)
