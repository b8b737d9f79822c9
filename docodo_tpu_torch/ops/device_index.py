"""Device-resident index and query evaluation on torch: twin of
docodo_tpu/ops/device_index.py for the full-result path
(search_batch_full) and the page-level path (search_batch).

The index lives on the device as a structure of arrays (int32, INF32
padding):

  term_offsets : int32[T+1]  CSR offsets into `coords`
  coords       : int32[N]    posting coordinates, per-term ascending
  bounds       : int32[P]    page END coordinates (exclusive)
  page_doc     : int32[P]    doc ordinal per page
  is_header    : bool[P]     header page ("0") mask
  page_of      : int32[N]    page index of every posting
  small        : SmallTabs   padded per-term rows (coords || page_of)

Queries are AND folds of W words, each word an OR of V variants. With
the kernels, each bucket of queries goes through a slot kernel when its
shape is admitted, else through the chunked kernels (query_kernels); the
kernel buckets share one rank top-k and one doc grouping at the end, as
in the JAX package; on the per-bucket path a server takes
(search_batch_full with fused=False, batched_query_full) each bucket
ends its own. W >= 3 with variants, which no kernel takes (nor
does the JAX package's), and every bucket without the kernels take the
plain route below (query_step_full).

The page-level path returns each query's top-k pages only (pages, ranks,
counts). A bucket of W = 1 (cap <= 128) or W = 2 (cap <= 512) words goes
through a page-level kernel, which ranks every run and picks the top k
itself; every other bucket takes the torch route (query_step), and rows
of variant ORs take batched_query_step_variants.

The chained forms of both dispatchers (multi_bucket_query_full_chained,
multi_bucket_query_step_chained) take a 0-d tensor that enters the term
ids as zero and return a checksum of their outputs, so that reps chained
through it need one readback. The build's packed token stream
(pack_tokens, split_packed, pack_tokens_split) builds on the device by
build_postings_packed, a part at a time.
"""

from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass, field
from typing import Iterator, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from docodo_tpu_torch.ops import query_kernels as qk
from docodo_tpu_torch.ops.seqops import (
    INF32,
    and_masked,
    and_variants_sorted,
    combine_r,
    compact,
    compact_hits,
    fetch_tables,
    gather_term,
    gather_term_paged,
    locate_compact,
    or_masked,
    or_variants_sorted,
    page_runs,
    rank_in_sorted,
)
from docodo_tpu_torch.utils import profiling

# the JAX package's small-table widths and budget (device_index.py:76,
# 149); its DOCODO_SMALL_TAB* overrides are not read here
SMALL_TAB_WIDTHS = (64, 128)
SMALL_TAB_BYTES = 128 * 1024 * 1024
SMALL_TAB_BAND_MAX = 32768


def _bucket(n: int, lo: int = 64) -> int:
    """Power-of-two shape bucket (device_index.py:1883)."""
    c = lo
    while c < n:
        c <<= 1
    return c


def _bucket4(n: int, lo: int = 8) -> int:
    """Power-of-four bucket (device_index.py:1891): the per-bucket path's
    row counts, so that request waves of changing sizes launch few
    distinct shapes, at the cost of under 4x padding rows (empty
    queries)."""
    c = lo
    while c < n:
        c <<= 2
    return c


def _cap_rounder(cap: Optional[int], cap_ladder: Optional[Sequence[int]]):
    """need -> a bucket's posting cap (device_index.py:2224): `cap` for
    every query, else the first rung of `cap_ladder` that holds the
    longest list, else a power of two from 64."""

    def round_cap(need: int) -> int:
        if cap:
            return cap
        for c in cap_ladder or ():
            if need <= c:
                return c
        return _bucket(need)
    return round_cap


def _bucket_sort_key(kv):
    """Deterministic bucket order (device_index.py:96)."""
    qcap = kv[0][0]
    return ((qcap,) if isinstance(qcap, int) else qcap, kv[0][1:])


def build_page_of(bounds_np, coords_np):
    """page_of[i] = page index of posting coordinate i: #bounds <= coord,
    clamped to P-1 (copied from device_index.py:103)."""
    bounds_np = np.asarray(bounds_np, dtype=np.int64)
    pages = np.searchsorted(
        bounds_np, np.asarray(coords_np, dtype=np.int64), side="right"
    )
    p = max(int(bounds_np.shape[0]), 1)
    return np.minimum(pages, p - 1).astype(np.int32)


@dataclass
class SmallTab:
    """One posting table (device_index.py:119): `w` is the width it
    serves; `tab` is [rows, 2w] (coords || page_of) or [rows, w];
    `row_map[t]` is term t's row or -1. A cumulative table (band False)
    holds every term with count <= w, a banded one the terms with count
    in (w/2, w]."""

    w: int
    row_map: object
    tab: object
    band: bool = False

    def to(self, device) -> "SmallTab":
        return SmallTab(self.w, torch.tensor(self.row_map, device=device),
                        torch.tensor(self.tab, device=device), self.band)


def build_small_tables(offsets_np, coords_np, pages_np=None):
    """The small-term posting tables as numpy SmallTabs, or None
    (copied from the numpy body of device_index.py:149, at its default
    widths, budget and band limit)."""
    counts = np.diff(np.asarray(offsets_np, dtype=np.int64))
    t = counts.size
    if t == 0:
        return None
    coords_np = np.asarray(coords_np)
    n = coords_np.shape[0]
    budget = SMALL_TAB_BYTES
    out = []

    def emit(w: int, tids, band: bool) -> bool:
        nonlocal budget
        if tids.size == 0:
            # an empty band still gets a zero-row table so coverage
            # checks can tell "no terms" from "skipped by budget"
            if band:
                out.append(SmallTab(
                    w, np.full(t, -1, dtype=np.int32),
                    np.zeros((0, 2 * w if pages_np is not None else w),
                             dtype=np.int32),
                    band=True))
            return True
        rows = _bucket(int(tids.size), lo=8)
        nbytes = rows * w * 4 * (2 if pages_np is not None else 1)
        if nbytes > budget:
            return False
        budget -= nbytes
        row_map = np.full(t, -1, dtype=np.int32)
        row_map[tids] = np.arange(tids.size, dtype=np.int32)
        starts = np.asarray(offsets_np, dtype=np.int64)[tids]
        cnts = counts[tids].astype(np.int32)
        idx = np.minimum(
            starts[:, None] + np.arange(w, dtype=np.int64)[None, :], n - 1
        )
        lane = np.arange(w, dtype=np.int32)[None, :]
        cols = 2 * w if pages_np is not None else w
        tab = np.full((rows, cols), INF32, dtype=np.int32)
        vals = coords_np[idx].astype(np.int32) if n else tab[: tids.size, :w]
        tab[: tids.size, :w] = np.where(
            lane < cnts[:, None], vals, INF32)
        if pages_np is not None and n:
            pgs = np.asarray(pages_np)[idx].astype(np.int32)
            tab[: tids.size, w:] = np.where(
                lane < cnts[:, None], pgs, INF32)
        out.append(SmallTab(w, row_map, tab, band=band))
        return True

    for w in SMALL_TAB_WIDTHS:
        emit(w, np.flatnonzero(counts <= w).astype(np.int64), band=False)
    w = max(SMALL_TAB_WIDTHS) * 2
    while w <= SMALL_TAB_BAND_MAX and budget > 0:
        tids = np.flatnonzero(
            (counts > w // 2) & (counts <= w)).astype(np.int64)
        if not emit(w, tids, band=True):
            break  # budget exhausted: larger bands only get bigger
        w *= 2
    return tuple(out) or None


def build_postings(term_ids: torch.Tensor, coords: torch.Tensor,
                   num_terms: int):
    """Sort the (term, coord) tuple stream and emit CSR offsets
    (device_index.py:275): one stable sort on the packed int64 key
    term << 32 | coord, then searchsorted. Padding slots carry term
    INF32 and sort past every term. Returns (terms, coords,
    offsets int32[T+1])."""
    key = (term_ids.long() << 32) | coords.long()
    order = torch.sort(key, stable=True).indices
    st = term_ids[order]
    sc = coords[order]
    offsets = torch.searchsorted(
        st, torch.arange(num_terms + 1, dtype=torch.int32,
                         device=st.device), right=False).to(torch.int32)
    return st, sc, offsets


# ---------------------------------------------------------------------------
# packed token transfer (device_index.py:287-390): one uint32 a token,
# a 12-bit coordinate delta over a 20-bit term id. A row whose term field
# is PACK_SENTINEL carries no posting: escape rows advance the coordinate
# cursor by their delta (gaps of PACK_DELTA_MAX or more), padding rows
# (PACK_PAD_ROW) by 0. The device rebuilds coordinates with one cumsum.
# ---------------------------------------------------------------------------

PACK_TERM_BITS = 20
PACK_SENTINEL = (1 << PACK_TERM_BITS) - 1          # term ids must stay below
PACK_DELTA_MAX = (1 << (32 - PACK_TERM_BITS)) - 1  # 4095
PACK_ESCAPE_ROW = np.uint32((PACK_DELTA_MAX << PACK_TERM_BITS)
                            | PACK_SENTINEL)
PACK_PAD_ROW = np.uint32(PACK_SENTINEL)  # delta 0, no posting


def pack_tokens(ids: np.ndarray, starts: np.ndarray) -> np.ndarray:
    """Pack a (term id, start) stream into uint32 rows (numpy): `starts`
    ascending, every id below PACK_SENTINEL. One row a token plus one
    escape row per PACK_DELTA_MAX of gap before it."""
    n = ids.size
    if n == 0:
        return np.empty(0, dtype=np.uint32)
    if int(ids.max()) >= PACK_SENTINEL:
        raise ValueError(f"term id {int(ids.max())} does not fit a packed "
                         f"row (ids must stay below {PACK_SENTINEL})")
    deltas = np.diff(starts.astype(np.int64), prepend=np.int64(0))
    if int(deltas.max()) < PACK_DELTA_MAX:
        return (deltas.astype(np.uint32) << np.uint32(PACK_TERM_BITS)
                ) | ids.astype(np.uint32)
    n_esc = deltas // PACK_DELTA_MAX
    rem = (deltas - n_esc * PACK_DELTA_MAX).astype(np.uint32)
    token_pos = np.arange(n, dtype=np.int64) + np.cumsum(n_esc)
    out = np.full(int(token_pos[-1]) + 1, PACK_ESCAPE_ROW, dtype=np.uint32)
    out[token_pos] = (rem << np.uint32(PACK_TERM_BITS)) | ids.astype(
        np.uint32)
    return out


def split_packed(packed: np.ndarray, max_rows: int) -> List[np.ndarray]:
    """A packed stream cut into parts of at most max_rows rows (numpy;
    device_index.py:334). A later part keeps absolute coordinates: it
    starts with escape rows that advance the cursor to the last
    coordinate of the rows cut before it (the sum of their delta
    fields), so every part builds on its own."""
    out = []
    while packed.size > max_rows:
        part = packed[:max_rows]
        out.append(part)
        base = int((part >> np.uint32(PACK_TERM_BITS))
                   .astype(np.int64).sum())
        n_esc, rem = divmod(base, PACK_DELTA_MAX)
        if n_esc + 1 >= max_rows:
            raise ValueError(f"max_rows {max_rows} cannot hold the escape "
                             f"prefix of {n_esc + 1} rows")
        prefix = np.full(n_esc + (1 if rem else 0), PACK_ESCAPE_ROW,
                         dtype=np.uint32)
        if rem:
            prefix[-1] = np.uint32((rem << PACK_TERM_BITS) | PACK_SENTINEL)
        packed = np.concatenate([prefix, packed[max_rows:]])
    out.append(packed)
    return out


def pack_tokens_split(ids: np.ndarray, starts: np.ndarray,
                      max_rows: int) -> List[np.ndarray]:
    """pack_tokens cut at tokens into parts of at most max_rows rows
    (numpy; device_index.py:360). Each part packs absolute starts (its
    first delta escapes across the text before it), so parts build on
    their own."""
    out = []
    while ids.size:
        deltas = np.diff(starts.astype(np.int64), prepend=np.int64(0))
        token_pos = (np.arange(ids.size, dtype=np.int64)
                     + np.cumsum(deltas // PACK_DELTA_MAX))
        if token_pos[-1] < max_rows:
            out.append(pack_tokens(ids, starts))
            break
        k = int(np.searchsorted(token_pos, max_rows, side="left"))
        if k == 0:
            raise ValueError(f"max_rows {max_rows} cannot hold the first "
                             f"token's escape rows")
        out.append(pack_tokens(ids[:k], starts[:k]))
        ids, starts = ids[k:], starts[k:]
    return out


def build_postings_packed(packed: torch.Tensor, num_terms: int):
    """build_postings over a packed stream (int32 tensor of the uint32
    rows' bits): term = mask, delta = shift and mask, coordinates = one
    int32 cumsum; escape and padding rows get term and coordinate INF32
    and sort past every term. Returns (terms, coords, offsets)."""
    tid = packed & PACK_SENTINEL
    delta = (packed >> PACK_TERM_BITS) & PACK_DELTA_MAX
    coords = torch.cumsum(delta, 0, dtype=torch.int32)
    is_pad = tid == PACK_SENTINEL
    return build_postings(torch.where(is_pad, INF32, tid),
                          torch.where(is_pad, INF32, coords), num_terms)


# ---------------------------------------------------------------------------
# posting fetch
# ---------------------------------------------------------------------------

def _tab_serves(small, cap: int) -> bool:
    """Whether combined (coords || pages) tables fully serve this cap
    (device_index.py:487)."""
    tabs = fetch_tables(small, cap)
    return tabs is not None and all(
        st.tab.shape[1] == 2 * st.w for st in tabs)


# ---------------------------------------------------------------------------
# the plain route: AND fold -> locate -> top-k -> doc grouping
# ---------------------------------------------------------------------------

def _fold_select(skip, acc, keep_acc, n_acc, vals, keep):
    """The previous fold state (padded to the new width) where `skip`,
    the fresh AND result elsewhere (device_index.py:256)."""
    pad = vals.shape[1] - acc.shape[1]
    acc_w = torch.cat([acc, acc.new_full((acc.shape[0], pad), INF32)], dim=1)
    keep_w = torch.cat([keep_acc, keep_acc.new_zeros((acc.shape[0], pad))],
                       dim=1)
    s = skip[:, None]
    return (torch.where(s, acc_w, vals), torch.where(s, keep_w, keep),
            torch.where(skip, n_acc, keep.sum(dim=1, dtype=torch.int32)))


def _live(acc, n_acc):
    return torch.arange(acc.shape[1], device=acc.device)[None, :] \
        < n_acc[:, None]


def eval_and_query(coords, term_offsets, terms, rs, cap: int, small=None):
    """Proximity-AND left fold over each row's terms [B, W], one variant
    per word, -1 padded (device_index.py:548): a padded word is the
    identity, and each step past the first compacts the running stream
    back into a sorted operand. Returns the masked stream (vals
    ascending incl. dropped slots, keep, r)."""
    acc, n_acc = gather_term(coords, term_offsets, terms[:, 0], cap, small)
    keep_acc = _live(acc, n_acc)
    r_acc = rs[:, 0]
    for q in range(1, terms.shape[1]):
        if q > 1:
            acc, n_acc = compact(acc, keep_acc)
            keep_acc = _live(acc, n_acc)
        b, nb = gather_term(coords, term_offsets, terms[:, q], cap, small)
        vals, keep, r_out = and_masked(acc, n_acc, r_acc, b, nb, rs[:, q])
        skip = terms[:, q] < 0
        acc, keep_acc, n_acc = _fold_select(skip, acc, keep_acc, n_acc,
                                            vals, keep)
        r_acc = torch.where(skip, r_acc, r_out)
    return acc, keep_acc, r_acc


def gather_variants(coords, term_offsets, terms, cap: int, small=None):
    """gather_term of every variant of terms [B, V]: (vals [B, V, cap],
    n [B, V])."""
    bsz, v = terms.shape
    vals, n = gather_term(coords, term_offsets, terms.reshape(-1), cap, small)
    return vals.reshape(bsz, v, cap), n.reshape(bsz, v)


def gather_word_variants(coords, term_offsets, variants, cap: int,
                         small=None):
    """One word's variants [B, V] (-1 padded) OR-folded into one dense
    ascending operand (device_index.py:588): (vals [B, V cap], n)."""
    acc, n_acc = gather_term(coords, term_offsets, variants[:, 0], cap,
                             small)
    if variants.shape[1] == 1:
        return acc, n_acc
    keep_acc = _live(acc, n_acc)
    for q in range(1, variants.shape[1]):
        if q > 1:
            acc, n_acc = compact(acc, keep_acc)
            keep_acc = _live(acc, n_acc)
        b, nb = gather_term(coords, term_offsets, variants[:, q], cap, small)
        vals, keep = or_masked(acc, n_acc, b, nb)
        acc, keep_acc, n_acc = _fold_select(variants[:, q] < 0, acc,
                                            keep_acc, n_acc, vals, keep)
    return compact(acc, keep_acc)


def eval_and_query_variants(coords, term_offsets, terms, rs, cap: int,
                            small=None):
    """AND fold where each word is an OR of variants (device_index.py
    :616): terms [B, W, V] (-1 padded both ways), rs [B, W]."""
    acc, n_acc = gather_word_variants(coords, term_offsets, terms[:, 0],
                                      cap, small)
    keep_acc = _live(acc, n_acc)
    r_acc = rs[:, 0]
    w = terms.shape[1]
    for q in range(1, w):
        b, nb = gather_word_variants(coords, term_offsets, terms[:, q], cap,
                                     small)
        vals, keep, r_out = and_masked(acc, n_acc, r_acc, b, nb, rs[:, q])
        skip = terms[:, q, 0] < 0
        acc, keep_acc, n_acc = _fold_select(skip, acc, keep_acc, n_acc,
                                            vals, keep)
        r_acc = torch.where(skip, r_acc, r_out)
        if q < w - 1:
            acc, n_acc = compact(acc, keep_acc)
            keep_acc = _live(acc, n_acc)
    return acc, keep_acc, r_acc


def eval_query_masked(coords, term_offsets, terms, rs, cap: int,
                      small=None):
    """One bucket of queries to masked streams (device_index.py:942):
    terms [B, W] is the plain AND fold; [B, W, V] is the AND fold of
    per-word variant ORs, one merge for W <= 2. Returns (vals, keep)."""
    if terms.dim() == 2 or terms.shape[2] == 1:
        t = terms if terms.dim() == 2 else terms[:, :, 0]
        vals, keep, _ = eval_and_query(coords, term_offsets, t, rs, cap,
                                       small)
        return vals, keep
    w = terms.shape[1]
    if w == 1:
        return or_variants_sorted(*gather_variants(
            coords, term_offsets, terms[:, 0], cap, small))
    if w == 2:
        sa, na = gather_variants(coords, term_offsets, terms[:, 0], cap,
                                 small)
        sb, nb = gather_variants(coords, term_offsets, terms[:, 1], cap,
                                 small)
        vals, keep, _ = and_variants_sorted(sa, na, rs[:, 0], sb, nb,
                                            rs[:, 1], terms[:, 1, 0] < 0)
        return vals, keep
    vals, keep, _ = eval_and_query_variants(coords, term_offsets, terms, rs,
                                            cap, small)
    return vals, keep


def locate_topk_masked(vals, keep, bounds, topk: int):
    """Masked coordinate streams [B, n] -> each row's top-k pages
    (device_index.py:715): (pages int32 -1 pad, ranks f32, counts
    int32), each [B, topk], by (rank descending, slot ascending). Every
    page run of the row is ranked, unlike locate_full's first-topk-runs
    cut; topk may exceed n."""
    page = rank_in_sorted(vals, bounds, strict=False)
    page = page.clamp_max(bounds.shape[0] - 1)
    pg, rk, ct, _ = page_runs(vals, keep, page, vals.shape[1])
    return qk.runs_topk(pg, rk, ct, topk)


def locate_topk(coords, n, bounds, page_doc, topk: int):
    """locate_topk_masked over dense streams coords [B, p] of lengths
    n [B] (device_index.py:922; page_doc is unused, as there)."""
    lane = torch.arange(coords.shape[1], device=coords.device)[None, :]
    keep = (lane < n[:, None]) & (coords < INF32)
    return locate_topk_masked(coords, keep, bounds, topk)


def query_step(term_offsets, coords, bounds, page_doc, terms, rs, cap: int,
               topk: int, small=None):
    """A batch of queries terms / rs [B, W] end to end on the torch
    route (device_index.py:931): AND fold -> top-k ranked pages."""
    vals, keep, _ = eval_and_query(coords, term_offsets, terms, rs, cap,
                                   small)
    return locate_topk_masked(vals, keep, bounds, topk)


def batched_query_step(term_offsets, coords, bounds, page_doc, terms, rs,
                       cap: int, topk: int, small=None):
    """device_index.py:1864, the JAX package's vmap of query_step; here
    query_step takes the batch itself. Returns (pages int32[B, topk],
    ranks f32[B, topk], counts int32[B, topk])."""
    return query_step(term_offsets, coords, bounds, page_doc, terms, rs,
                      cap, topk, small)


def batched_query_step_variants(term_offsets, coords, bounds, page_doc,
                                terms, rs, cap: int, topk: int, small=None):
    """The page-level step of rows whose words are ORs of variants
    (device_index.py:647): terms [B, W, V] (-1 padded both ways), rs
    [B, W], the AND fold of each word's variant OR on the torch route,
    then each row's top-k pages. Returns (pages int32[B, topk], ranks
    f32[B, topk], counts int32[B, topk]); page_doc is unused, as
    there."""
    vals, keep, _ = eval_and_query_variants(coords, term_offsets, terms, rs,
                                            cap, small)
    return locate_topk_masked(vals, keep, bounds, topk)


class LocateFull(NamedTuple):
    """Full per-query result, batched (device_index.py:726): pages /
    ranks / counts rank-ordered [B, topk], the untruncated totals, the
    doc grouping (None without docs) and the kept hits [B, hit_cap]."""

    pages: torch.Tensor
    ranks: torch.Tensor
    counts: torch.Tensor
    n_pages: torch.Tensor
    docs: Optional[torch.Tensor]
    doc_ranks: Optional[torch.Tensor]
    hits: torch.Tensor
    n_hits: torch.Tensor


class PreFull(NamedTuple):
    """A bucket's result before the rank top-k and doc grouping
    (device_index.py:752): first-topk runs in slot order."""

    pg_c: torch.Tensor
    rk_c: torch.Tensor
    ct_c: torch.Tensor
    n_pages: torch.Tensor
    n_hits: torch.Tensor
    hits: torch.Tensor


def doc_group_topk(top_page, top_rank, page_doc, is_header):
    """Doc ordinal of every top-k slot, and doc rank = 1 + ln(sum of the
    doc's top-k page ranks), x10 when the doc's header page is among
    them, at each doc's first top-k slot (device_index.py:777), over
    rows [B, topk].

    Doc and header are plain page_doc / is_header gathers; the
    reference's doc-start compare-all (P <= DOC_CA_MAX) only avoids
    gathers on the TPU and gives the same result. The per-doc sums keep the reference's segmented Hillis-Steele order
    (device_index.py:835-855): prefix-sum differences lose an ulp and
    break exact doc-rank ties."""
    bsz, topk = top_page.shape
    dev = top_page.device
    valid_top = top_rank > 0
    safe = top_page.clamp_min(0).long()
    docs = torch.where(valid_top, page_doc[safe], -1).to(torch.int32)
    hdr = is_header[safe] & valid_top

    key = torch.where(valid_top, docs, INF32)
    skey, skidx = torch.sort(key, dim=1, stable=True)
    srank = torch.gather(top_rank, 1, skidx)
    shdr = torch.gather(hdr.to(torch.int32), 1, skidx)
    start = torch.cat([torch.ones((bsz, 1), dtype=torch.bool, device=dev),
                       skey[:, 1:] != skey[:, :-1]], dim=1)
    run_sum, run_hdr = srank, shdr
    d = 1
    while d < topk:
        same = torch.cat([skey[:, d:], skey.new_full((bsz, d), -7)],
                         dim=1) == skey
        run_sum = run_sum + torch.where(
            same, torch.cat([run_sum[:, d:], run_sum.new_zeros((bsz, d))],
                            dim=1), 0.0)
        run_hdr = run_hdr + torch.where(
            same, torch.cat([run_hdr[:, d:], run_hdr.new_zeros((bsz, d))],
                            dim=1), 0)
        d <<= 1
    doc_rank = 1.0 + torch.log(run_sum.clamp_min(1e-30))
    doc_rank = torch.where(run_hdr > 0, doc_rank * 10.0, doc_rank)
    sval = torch.where(start & (skey < INF32), doc_rank, 0.0)
    out = torch.empty_like(sval).scatter_(1, skidx, sval)
    return docs, out


def locate_full(vals, keep, bounds, page_doc, is_header, topk: int,
                hit_cap: int, with_docs: bool = True) -> LocateFull:
    """Masked streams [B, n] -> full results (device_index.py:865).

    The page runs compact to their first `topk` in slot order by a
    prefix-sum scatter (the reference's [topk, n] one-hot would be
    hundreds of MB a row at caps near 1M); n_pages stays exact, and a
    row with more runs is re-served on the host by its caller. The hits
    compact to their first hit_cap. Runs past n_pages carry page -1
    here where the reference's XLA route leaves 0; the top-k tail masks
    both."""
    page = rank_in_sorted(vals, bounds, strict=False)
    page = page.clamp_max(bounds.shape[0] - 1)
    pg_c, rk_c, ct_c, n_pages, n_hits, hits = locate_compact(
        vals, keep, page, topk, hit_cap)
    pages, ranks, counts, _ = qk.streams_topk_tail(pg_c, rk_c, ct_c,
                                                   n_pages, topk)
    docs = doc_ranks = None
    if with_docs:
        docs, doc_ranks = doc_group_topk(pages, ranks, page_doc, is_header)
    return LocateFull(pages=pages, ranks=ranks, counts=counts,
                      n_pages=n_pages, docs=docs, doc_ranks=doc_ranks,
                      hits=hits, n_hits=n_hits)


def query_step_full(term_offsets, coords, bounds, page_doc, is_header,
                    terms, rs, cap: int, topk: int, hit_cap: int,
                    with_docs: bool = True, small=None) -> LocateFull:
    """A batch of queries end to end on the plain route
    (device_index.py:981); terms [B, W] or [B, W, V]."""
    vals, keep = eval_query_masked(coords, term_offsets, terms, rs, cap,
                                   small)
    return locate_full(vals, keep, bounds, page_doc, is_header, topk,
                       hit_cap, with_docs=with_docs)


# ---------------------------------------------------------------------------
# kernel routing and the multi-bucket dispatcher
# ---------------------------------------------------------------------------

def _fetcher(coords, term_offsets, page_of, cap: int, carried: bool):
    """The posting fetch of a kernel bucket (query_kernels.fetch_postings,
    one launch on the card): terms [B] -> (vals [B, cap], pages or None,
    n [B]), or terms [B, V] -> ([B, V, cap], pages or None, [B, V]).
    Pages ride the fetch when the bucket is carried."""

    def fetch(terms):
        with profiling.span("route.fetch"):
            vals, pgs, ln = qk.fetch_postings(
                coords, term_offsets, terms, cap,
                page_of=page_of if carried else None)
        shape = tuple(terms.shape)
        return (vals.reshape(shape + (cap,)),
                None if pgs is None else pgs.reshape(shape + (cap,)),
                ln.reshape(shape))
    return fetch


def _variants(tq):
    """V of a bucket's terms: [B, W] or [B, W, V]."""
    return tq.shape[2] if tq.dim() == 3 else 1


def _pack(outs, tail: bool, ranked: bool = True):
    """A route's six outputs as its bucket result: the PreFull, or with
    `tail` the LocateFull before doc grouping. `ranked`: the wrapper
    finished the rank top-k itself; else the outputs are first-topk runs
    and streams_topk_tail ends them here."""
    if not tail:
        return PreFull(*outs)
    pages, ranks, counts, n_pages, n_hits, hits = outs
    if not ranked:
        with profiling.span("tail.topk"):
            pages, ranks, counts, _ = qk.streams_topk_tail(
                pages, ranks, counts, n_pages, pages.shape[1])
    return LocateFull(pages=pages, ranks=ranks, counts=counts,
                      n_pages=n_pages, docs=None, doc_ranks=None, hits=hits,
                      n_hits=n_hits)


def _kernel_bucket_full(term_offsets, coords, bounds, tq, rq, *, cap: int,
                        topk: int, hit_cap: int, small=None, page_of=None,
                        tail: bool = False, sort_topk: bool = True):
    """One bucket [B, W] or [B, W, V] through the slot kernels (device_
    index._pallas_bucket_full, :1618-1800) up to its PreFull, or with
    `tail` up to its LocateFull without docs (sort_topk False: through
    the top-k-mode kernels), or None when its shape is not admitted:
    W > 2; with variants (V > 1) a stream W V cap past 1024 lanes; else
    a W = 2 cap past 512, a W = 1 cap past 1024 (256 without carried
    pages), or W = 1 with topk > cap.

    Pages ride the fetch when combined small tables serve the cap
    (carried); otherwise the wrappers look them up (shared)."""
    w, v = tq.shape[1], _variants(tq)
    if w > 2:
        return None
    carried = page_of is not None and _tab_serves(small, cap)
    fetch = _fetcher(coords, term_offsets, page_of, cap, carried)
    kw = dict(topk=topk, hit_cap=hit_cap, tail=tail, sort_topk=sort_topk)
    if v > 1:
        if w * v * cap > qk.MAX_STREAM_WIDTH:
            return None
        a, apg, na = fetch(tq[:, 0])
        if w == 1:
            with profiling.span("route.locate"):
                outs = qk.union_locate_full(a, na, bounds, a_pg=apg, **kw)
            return _pack(outs, tail)
        b, bpg, nb = fetch(tq[:, 1])
        with profiling.span("route.locate"):
            outs = qk.variants_and_locate_full(
                a, na, rq[:, 0].contiguous(), b, nb, rq[:, 1].contiguous(),
                tq[:, 1, 0] < 0, bounds, a_pg=apg, b_pg=bpg, **kw)
        return _pack(outs, tail)
    if tq.dim() == 3:
        tq = tq[:, :, 0]
    single = w == 1
    w1_limit = qk.MAX_STREAM_WIDTH if carried else qk.W1_FULL_STREAM_MAX
    limit = w1_limit if single else qk.MAX_SORTED_PALLAS_CAP
    if cap > limit or (single and topk > cap):
        return None
    a, apg, na = fetch(tq[:, 0])
    kw["a_pg"] = apg
    b = bpg = nb = None
    if not single:
        b, bpg, nb = fetch(tq[:, 1])
    with profiling.span("route.locate"):
        if single and cap > qk.MAX_PALLAS_CAP:
            outs = qk.union_locate_full(
                a[:, None, :], na[:, None], bounds,
                **dict(kw, a_pg=None if apg is None else apg[:, None, :]))
        elif single:
            outs = qk.single_locate_full(a, na, bounds, **kw)
        else:
            outs = qk.sorted_and_locate_full(
                a, na, rq[:, 0].contiguous(), b, nb, rq[:, 1].contiguous(),
                bounds, b_pg=bpg, **kw)
    return _pack(outs, tail)


# smallest bucket batch the chunked route admits (device_index.py:995,
# _chunk_min_b's default; its DOCODO_CHUNK_MIN_B override is not read)
CHUNK_MIN_B = 1


def _chunked_bucket_full(term_offsets, coords, bounds, tq, rq, *, cap: int,
                         topk: int, hit_cap: int, small=None, page_of=None,
                         tail: bool = False, sort_topk: bool = True,
                         keep=None):
    """One bucket past slot admission through the chunked kernels (the
    chunked branches of device_index._bucket_full, :1329-1398, as a TPU
    takes them) up to its PreFull, or with `tail` up to its LocateFull
    without docs, or None for W >= 3 with variants or fewer than
    CHUNK_MIN_B rows. Pages ride the fetch and the merges
    when the small tables carry them; otherwise the locate kernel looks
    them up. Where the JAX package sorts blocks that are already sorted,
    the merge kernel gives the same (coord, tag) stream.

    W = 2 (caps past slot admission, so 2 cap >= 2048, the JAX
    package's condition): with carried pages and 2 cap <= 4096 the
    fused merge + AND + locate kernel (:1124-1167), or with sort_topk
    False its three-step form (pallas_query.py:2755): merge_and_locate's
    full-width streams, the hit compaction and locate_streams_topk;
    otherwise the merge, the AND keep and the locate kernels
    (:1168-1196).

    W = 1: the gathered block is the kept stream, and the locate kernel
    takes it (:1371-1398). The JAX package gives W = 1 streams narrower
    than 2048 lanes to its XLA locate instead; the results are the same.

    W >= 3: the carried left fold (_chunked_and_full_multi, :1199-1249):
    each step merges the running stream with the next word's block and
    keeps the AND, and every step but the last compacts its kept stream
    into the next step's operand.

    Variants (V > 1), W = 2: every variant block of both words merges
    into one stream for the variants AND kernel (_chunked_variants_full,
    :1252-1299); W = 1: the merged blocks with word B empty and every row
    flagged bpad, so the same kernel keeps the union's run starts. The
    JAX package takes uncarried W = 2 and every W = 1 variant bucket past
    slot admission, and the uncarried W >= 3 fold, on its XLA program
    instead; the results are the same.

    keep: a coordinate range (lo, hi) the locate keeps hits in (a document
    shard's own postings, its neighbours' outside); the fused kernel,
    which has no such range, is then passed over."""
    w, v = tq.shape[1], _variants(tq)
    if (w > 2 and v > 1) or tq.shape[0] < CHUNK_MIN_B:
        return None
    carried = page_of is not None and _tab_serves(small, cap)
    fetch = _fetcher(coords, term_offsets, page_of, cap, carried)
    kw = dict(topk=topk, hit_cap=hit_cap)
    if keep is not None:
        kw["keep"] = keep
    if v > 1:
        a, apg, na = fetch(tq[:, 0])
        if w == 1:
            with profiling.span("route.merge"):
                vals, tag, pg = qk.merge_tagged(a, na, None, None, apg)
            with profiling.span("route.keep"):
                ones = torch.ones_like(na[:, 0])
                hv = qk.variants_keep(vals, tag, ones, ones, ones)
        else:
            b, bpg, nb = fetch(tq[:, 1])
            with profiling.span("route.merge"):
                vals, tag, pg = qk.merge_tagged(a, na, b, nb, apg, bpg)
            with profiling.span("route.keep"):
                hv = qk.variants_keep(vals, tag, rq[:, 0].contiguous(),
                                      rq[:, 1].contiguous(), tq[:, 1, 0] < 0)
        with profiling.span("route.locate"):
            outs = qk.locate_runs(hv, bounds, pg=pg, **kw)
        return _pack(outs, tail, False)
    if tq.dim() == 3:
        tq = tq[:, :, 0]
    a, apg, na = fetch(tq[:, 0])
    if w == 1:
        with profiling.span("route.locate"):
            outs = qk.locate_runs(a, bounds, pg=apg, **kw)
        return _pack(outs, tail, False)
    ra = rq[:, 0].contiguous()
    if w == 2 and carried and 2 * cap <= qk.FUSED_AND_MAX and keep is None:
        b, bpg, nb = fetch(tq[:, 1])
        rb = rq[:, 1].contiguous()
        if sort_topk:
            with profiling.span("route.fused"):
                outs = qk.merge_and_locate_topk(a, na, ra, b, nb, rb, apg,
                                                bpg, **kw)
            return _pack(outs, tail, False)
        with profiling.span("route.fused"):
            hv, page_s, rank_s, cnt_s = qk.merge_and_locate(
                a, na, ra, b, nb, rb, apg, bpg)
        with profiling.span("route.keep"):
            hits, n_hits = compact_hits(hv, hv < INF32, hit_cap)
        with profiling.span("route.locate"):
            pages, ranks, counts, n_pages = qk.locate_streams_topk(
                page_s, rank_s, cnt_s, topk)
        return _pack((pages, ranks, counts, n_pages, n_hits, hits), tail)
    for q in range(1, w):
        b, bpg, nb = fetch(tq[:, q])
        rb = rq[:, q].contiguous()
        with profiling.span("route.merge"):
            vals, tag, pg = qk.merge_tagged(a, na, b, nb, apg, bpg)
        if q < w - 1:
            with profiling.span("route.keep"):
                a, apg, na = qk.and_keep_compact(vals, tag, ra, rb, pg)
            ra = combine_r(ra, rb)
    with profiling.span("route.keep"):
        hv = qk.and_keep(vals, tag, ra, rb)
    with profiling.span("route.locate"):
        outs = qk.locate_runs(hv, bounds, pg=pg, **kw)
    return _pack(outs, tail, False)


def _bucket_full(term_offsets, coords, bounds, page_doc, is_header, tq, rq,
                 cap: int, topk: int, hit_cap: int, with_docs: bool,
                 use_kernels: bool, small=None, page_of=None,
                 tail: bool = True, sort_topk: bool = True):
    """One full-result bucket (device_index.py:1302): with the kernels,
    the slot kernels' result where admitted, else the chunked kernels';
    without them, or for a shape no kernel takes, the plain route's
    finished LocateFull. With `tail` a kernel bucket ends its own rank
    top-k and doc grouping (a finished LocateFull); with tail=False it
    returns the PreFull that multi_bucket_query_full's shared tail
    takes. sort_topk=False (only with `tail`) hands the slot wrappers'
    keyword through: the top-k-mode kernels."""
    if sort_topk is False and not tail:
        raise ValueError("sort_topk=False ends each bucket's top k in its "
                         "kernel: it has no tail=False form")
    if use_kernels:
        for route in (_kernel_bucket_full, _chunked_bucket_full):
            out = route(term_offsets, coords, bounds, tq, rq, cap=cap,
                        topk=topk, hit_cap=hit_cap, small=small,
                        page_of=page_of, tail=tail, sort_topk=sort_topk)
            if out is None:
                continue
            if tail and with_docs:
                with profiling.span("tail.docs"):
                    docs, doc_ranks = doc_group_topk(out.pages, out.ranks,
                                                     page_doc, is_header)
                out = out._replace(docs=docs, doc_ranks=doc_ranks)
            return out
    with profiling.span("route.plain"):
        return query_step_full(term_offsets, coords, bounds, page_doc,
                               is_header, tq, rq, cap=cap, topk=topk,
                               hit_cap=hit_cap, with_docs=with_docs,
                               small=small)


def bucket_pre(term_offsets, coords, bounds, tq, rq, *, cap: int,
               topk: int, hit_cap: int, use_kernels: bool, keep=None,
               small=None) -> PreFull:
    """One bucket up to its first-topk runs in slot order (a PreFull),
    the hits in the range `keep` (lo, hi) only when it is given: the
    chunked kernels, or where they take no such bucket (W >= 3 with
    variants), or without the kernels, the plain route's fold and
    compaction. What a document shard with its neighbours' postings
    runs: no slot kernel, since none keeps a range."""
    if use_kernels:
        out = _chunked_bucket_full(term_offsets, coords, bounds, tq, rq,
                                   cap=cap, topk=topk, hit_cap=hit_cap,
                                   small=small, tail=False, keep=keep)
        if out is not None:
            return out
    with profiling.span("route.plain"):
        vals, kept = eval_query_masked(coords, term_offsets, tq, rq, cap,
                                       small)
        if keep is not None:
            kept = kept & (vals >= keep[0]) & (vals < keep[1])
        page = rank_in_sorted(vals, bounds, strict=False).clamp_max(
            bounds.shape[0] - 1)
        return PreFull(*locate_compact(vals, kept, page, topk, hit_cap))


def batched_query_full(term_offsets, coords, bounds, page_doc, is_header,
                       terms, rs, cap: int, topk: int, hit_cap: int,
                       with_docs: bool = True, use_kernels: bool = False,
                       small=None, page_of=None,
                       sort_topk: bool = True) -> LocateFull:
    """One bucket of full-result queries ([B, W] or [B, W, V] terms),
    finished (device_index.py:1417): what a server launches per bucket,
    because the buckets of a request wave change from wave to wave.
    sort_topk=False takes the top-k-mode kernels where a slot kernel or
    the fused W = 2 kernel serves the bucket (the JAX routing always
    passes True); served rows (n_pages <= topk) come out the same."""
    return _bucket_full(term_offsets, coords, bounds, page_doc, is_header,
                        terms, rs, cap=cap, topk=topk, hit_cap=hit_cap,
                        with_docs=with_docs, use_kernels=use_kernels,
                        small=small, page_of=page_of, tail=True,
                        sort_topk=sort_topk)


def multi_bucket_query_full(term_offsets, coords, bounds, page_doc,
                            is_header, terms_list, rs_list, caps,
                            topk: int, hit_caps, with_docs: bool = True,
                            use_kernels: bool = False, small=None,
                            page_of=None):
    """Every bucket of a batch (device_index.py:1438), each with its own
    cap and hit buffer width. With the kernels, each kernel bucket
    returns its first-topk runs and one rank top-k plus one doc grouping
    run over all of them; rows are independent, so the results equal
    per-bucket tails. Returns one LocateFull per bucket."""
    outs = [
        _bucket_full(term_offsets, coords, bounds, page_doc, is_header, tq,
                     rq, cap=cap, topk=topk, hit_cap=hb, with_docs=with_docs,
                     use_kernels=use_kernels, small=small, page_of=page_of,
                     tail=False)
        for tq, rq, cap, hb in zip(terms_list, rs_list, caps, hit_caps)
    ]
    idxs = [i for i, o in enumerate(outs) if isinstance(o, PreFull)]
    if idxs:
        pre = [outs[i] for i in idxs]
        with profiling.span("tail.topk"):
            pages, ranks, counts, _ = qk.streams_topk_tail(
                torch.cat([p.pg_c for p in pre]),
                torch.cat([p.rk_c for p in pre]),
                torch.cat([p.ct_c for p in pre]),
                torch.cat([p.n_pages for p in pre]), topk)
        docs = doc_ranks = None
        if with_docs:
            with profiling.span("tail.docs"):
                docs, doc_ranks = doc_group_topk(pages, ranks, page_doc,
                                                 is_header)
        off = 0
        for i, p in zip(idxs, pre):
            sl = slice(off, off + p.pg_c.shape[0])
            outs[i] = LocateFull(
                pages=pages[sl], ranks=ranks[sl], counts=counts[sl],
                n_pages=p.n_pages,
                docs=None if docs is None else docs[sl],
                doc_ranks=None if doc_ranks is None else doc_ranks[sl],
                hits=p.hits, n_hits=p.n_hits)
            off += p.pg_c.shape[0]
    return outs


def _chained(terms_list, chain):
    """Each bucket's terms with `chain` (a 0-d float32 tensor) mixed in as
    zero: a call reading them waits for the call that made `chain`."""
    zero = (chain * 0).to(torch.int32)
    return [t + zero for t in terms_list]


def multi_bucket_query_full_chained(term_offsets, coords, bounds, page_doc,
                                    is_header, terms_list, rs_list, chain,
                                    caps, topk: int, hit_caps,
                                    with_docs: bool = True,
                                    use_kernels: bool = False, small=None,
                                    page_of=None):
    """multi_bucket_query_full with a dependency chain (device_index.py
    :1505): `chain`, a 0-d float32 tensor on the index's device, enters
    the term ids as zero, and the call returns (outs, s) with s the sum
    of every bucket's ranks plus the sum of its n_hits (float32). Reps
    chained through s run in order, and one readback of the last s
    waits for all of them. On the card the stream orders the calls
    already; the chain keeps the data dependency and the checksum."""
    outs = multi_bucket_query_full(
        term_offsets, coords, bounds, page_doc, is_header,
        _chained(terms_list, chain), rs_list, caps, topk, hit_caps,
        with_docs=with_docs, use_kernels=use_kernels, small=small,
        page_of=page_of)
    s = chain.new_zeros(())
    for o in outs:
        s = s + o.ranks.sum() + o.n_hits.to(torch.float32).sum()
    return outs, s


def _kernel_bucket(term_offsets, coords, bounds, tq, rq, cap: int,
                   topk: int, small=None, page_of=None):
    """One page-level (cap, W <= 2) bucket through the page-level kernels
    (device_index._pallas_bucket, :1529): the posting blocks are
    fetched, with their pages where combined small tables serve the cap
    (carried), and the whole bucket is one launch. Without carried
    pages the kernel looks them up in bounds, where the JAX package
    looks them up before its kernel when it has page_of."""
    carried = page_of is not None and _tab_serves(small, cap)
    fetch = _fetcher(coords, term_offsets, page_of, cap, carried)
    a, apg, na = fetch(tq[:, 0])
    if tq.shape[1] == 1:
        return qk.batched_single_locate(a, na, bounds, topk=topk, a_pg=apg)
    b, bpg, nb = fetch(tq[:, 1])
    return qk.sorted_and_locate(a, na, rq[:, 0].contiguous(), b, nb,
                                rq[:, 1].contiguous(), bounds, topk=topk,
                                a_pg=apg, b_pg=bpg)


def multi_bucket_query_step(term_offsets, coords, bounds, page_doc,
                            terms_list, rs_list, caps, topk: int,
                            use_kernels: bool = False, small=None,
                            page_of=None):
    """Every page-level bucket of a batch (device_index.py:1804):
    terms_list / rs_list hold [Bi, Wi] tensors, caps the matching
    posting caps. With the kernels, W = 1 buckets up to MAX_PALLAS_CAP
    and W = 2 buckets up to MAX_SORTED_PALLAS_CAP take a page-level
    kernel; the rest take query_step. Returns one (pages, ranks, counts)
    triple per bucket."""
    outs = []
    for tq, rq, cap in zip(terms_list, rs_list, caps):
        limit = (qk.MAX_PALLAS_CAP if tq.shape[1] == 1
                 else qk.MAX_SORTED_PALLAS_CAP)
        if use_kernels and cap <= limit and tq.shape[1] <= 2:
            outs.append(_kernel_bucket(term_offsets, coords, bounds, tq, rq,
                                       cap, topk, small=small,
                                       page_of=page_of))
        else:
            outs.append(query_step(term_offsets, coords, bounds, page_doc,
                                   tq, rq, cap, topk, small))
    return tuple(outs)


def multi_bucket_query_step_chained(term_offsets, coords, bounds, page_doc,
                                    terms_list, rs_list, chain, caps,
                                    topk: int, use_kernels: bool = False,
                                    small=None, page_of=None):
    """multi_bucket_query_step with the dependency chain of
    multi_bucket_query_full_chained (device_index.py:1841): returns
    (outs, s), s the sum of every bucket's ranks."""
    outs = multi_bucket_query_step(
        term_offsets, coords, bounds, page_doc, _chained(terms_list, chain),
        rs_list, caps, topk, use_kernels=use_kernels, small=small,
        page_of=page_of)
    s = chain.new_zeros(())
    for _, ranks, _ in outs:
        s = s + ranks.sum()
    return outs, s


# ---------------------------------------------------------------------------
# host-side wrapper
# ---------------------------------------------------------------------------

_STATE_ARRAYS = ("term_offsets", "coords", "bounds", "page_doc",
                 "is_header", "page_of")


@dataclass
class DeviceIndex:
    """Device arrays plus the host dictionaries for query compilation
    (device_index.py:1903)."""

    term_offsets: torch.Tensor
    coords: torch.Tensor
    bounds: torch.Tensor
    page_doc: torch.Tensor
    is_header: torch.Tensor
    page_of: torch.Tensor
    small: Optional[tuple]
    terms: List[str]
    page_ids: List[str]
    doc_names: List[str]
    _tmap: dict
    offsets_np: np.ndarray
    page_doc_np: np.ndarray
    bounds_np: np.ndarray
    _cgq_cache: dict = field(default_factory=dict)
    # a batcher's collector and completion threads both fill the cache
    _cgq_lock: threading.Lock = field(default_factory=threading.Lock,
                                      repr=False)
    # search_batch_full's sequence numbers, which its spans carry
    _batch_seq: Iterator[int] = field(default_factory=itertools.count,
                                      repr=False)

    @property
    def device(self) -> torch.device:
        return self.coords.device

    @classmethod
    def from_index(cls, ind, device="cuda") -> "DeviceIndex":
        """Stage a host index (docodo_tpu_torch.index.build_index's, or
        any object with its `arr` CSR and `pages` table) on `device`
        (device_index.py:1939)."""
        arr = ind.arr
        if arr.coords is None:
            raise ValueError("device upload requires an in-memory index")
        if arr.max_coord >= INF32:
            raise ValueError(
                f"corpus spans {arr.max_coord} chars >= 2^31-1: a single "
                f"device shard's int32 coordinate space is full")
        pt = ind.pages
        offsets_np = np.asarray(arr.offsets, dtype=np.int64)
        page_doc_np = np.asarray(pt.page_doc, dtype=np.int32)
        if np.any(np.diff(page_doc_np) < 0):
            raise ValueError("page_doc must be non-decreasing "
                             "(contiguous doc page runs)")
        bounds_np = pt.bounds.astype(np.int64)
        header_np = np.fromiter((pid == "0" for pid in pt.page_ids),
                                dtype=bool, count=len(pt.page_ids))
        coords64 = arr.coords.astype(np.int64)
        with profiling.phase("stage.page_of"):
            pages_np = build_page_of(bounds_np, coords64)
        arrays = {
            "term_offsets": offsets_np.astype(np.int32),
            "coords": coords64.astype(np.int32),
            "bounds": bounds_np.astype(np.int32),
            "page_doc": page_doc_np,
            "is_header": header_np,
            "page_of": pages_np,
        }
        with profiling.phase("stage.small_tables"):
            small = build_small_tables(offsets_np, coords64,
                                       pages_np=pages_np)
            for i, st in enumerate(small or ()):
                arrays.update(_small_state(i, st))
        with profiling.phase("stage.copies"):
            return cls.from_state(arrays, list(arr.terms),
                                  list(pt.page_ids), list(pt.doc_names),
                                  device=device)

    @classmethod
    def from_state(cls, arrays, terms, page_ids, doc_names,
                   device="cuda") -> "DeviceIndex":
        """Stage the index from numpy arrays: the six named in
        `_STATE_ARRAYS` plus small{i}_w / _band / _row_map / _tab for
        each small table, as `state()` returns them, or as the JAX
        package's DeviceIndex holds them."""
        dev = torch.device(device)
        t = {k: torch.tensor(np.asarray(arrays[k]), device=dev)
             for k in _STATE_ARRAYS}
        small = []
        i = 0
        while f"small{i}_w" in arrays:
            small.append(SmallTab(
                int(arrays[f"small{i}_w"]),
                np.asarray(arrays[f"small{i}_row_map"]),
                np.asarray(arrays[f"small{i}_tab"]),
                bool(arrays[f"small{i}_band"])).to(dev))
            i += 1
        offsets_np = np.asarray(arrays["term_offsets"], dtype=np.int64)
        return cls(
            term_offsets=t["term_offsets"], coords=t["coords"],
            bounds=t["bounds"], page_doc=t["page_doc"],
            is_header=t["is_header"], page_of=t["page_of"],
            small=tuple(small) or None, terms=list(terms),
            page_ids=list(page_ids), doc_names=list(doc_names),
            _tmap={w: i for i, w in enumerate(terms)},
            offsets_np=offsets_np,
            page_doc_np=np.asarray(arrays["page_doc"], dtype=np.int32),
            bounds_np=np.asarray(arrays["bounds"], dtype=np.int64),
        )

    def state(self) -> dict:
        """The staged arrays as numpy, keyed as from_state takes them."""
        out = {k: getattr(self, k).cpu().numpy() for k in _STATE_ARRAYS}
        for i, st in enumerate(self.small or ()):
            out.update(_small_state(i, st))
        return out

    def device_bytes(self) -> int:
        ts = [getattr(self, k) for k in _STATE_ARRAYS]
        for st in self.small or ():
            ts += [st.row_map, st.tab]
        return sum(x.numel() * x.element_size() for x in ts)

    def header_mask(self) -> torch.Tensor:
        """The staged header-page ("0") mask, bool[P] on the index's
        device (device_index.py:1930)."""
        return self.is_header

    def term_id(self, term: str) -> int:
        return self._tmap.get(term, -1)

    def posting_count(self, term: str) -> int:
        tid = self.term_id(term)
        if tid < 0:
            return 0
        return int(self.offsets_np[tid + 1] - self.offsets_np[tid])

    def compile_queries(self, queries, pad_w: int = 0):
        """[(word, R), ...] per query -> padded (terms int32[B, W],
        rs int32[B, W]) numpy arrays and the posting cap of the batch
        (device_index.py:1998). A query with an unknown word matches
        nothing: its row stays all -1, which evaluates empty."""
        w = max(max((len(q) for q in queries), default=1), pad_w, 1)
        terms = np.full((len(queries), w), -1, dtype=np.int32)
        rs = np.ones((len(queries), w), dtype=np.int32)
        max_len = 1
        for i, q in enumerate(queries):
            if any(self.term_id(word) < 0 for word, _ in q):
                continue
            for j, (word, r) in enumerate(q):
                terms[i, j] = self.term_id(word)
                rs[i, j] = r
                max_len = max(max_len, self.posting_count(word))
        return terms, rs, _bucket(max_len)

    def search_batch(self, queries, topk: int = 16,
                     cap: Optional[int] = None, use_kernels: bool = True,
                     cap_ladder=None):
        """Evaluate a batch of AND / phrase queries, each a list of
        (word, R), to their top-k pages (device_index.py:2022): numpy
        (pages int32 -1 pad, ranks f32, counts int32), each [B, topk],
        in rank order.

        Queries group into (posting cap, word count) buckets, the cap a
        power of two from 64, or the first rung of `cap_ladder` that
        holds the longest list, or `cap` for every query (longer lists
        are then cut to their first `cap` postings). A query with an
        unknown word matches nothing and never reaches the device.

        use_kernels: the page-level CUDA kernels for the buckets they
        admit (on the CPU their plain versions), or with False the torch
        route for every bucket."""
        b = len(queries)
        pages = np.full((b, topk), -1, dtype=np.int32)
        ranks = np.zeros((b, topk), dtype=np.float32)
        counts = np.zeros((b, topk), dtype=np.int32)

        round_cap = _cap_rounder(cap, cap_ladder)
        buckets = {}
        for i, q in enumerate(queries):
            if any(self.term_id(word) < 0 for word, _ in q):
                continue
            need = max((self.posting_count(word) for word, _ in q),
                       default=1)
            buckets.setdefault((round_cap(max(need, 1)), max(len(q), 1)),
                               []).append(i)
        terms_list, rs_list, caps_list, idx_list = [], [], [], []
        dev = self.device
        for (qcap, w), idxs in sorted(buckets.items()):
            brows = _bucket(len(idxs), lo=8)
            terms = np.full((brows, w), -1, dtype=np.int32)
            rs = np.ones((brows, w), dtype=np.int32)
            for row, i in enumerate(idxs):
                for j, (word, r) in enumerate(queries[i]):
                    terms[row, j] = self.term_id(word)
                    rs[row, j] = r
            terms_list.append(torch.as_tensor(terms, device=dev))
            rs_list.append(torch.as_tensor(rs, device=dev))
            caps_list.append(qcap)
            idx_list.append(idxs)
        if not idx_list:
            return pages, ranks, counts
        # an explicit cap may cut long lists, which the small tables
        # cannot serve (no row for a count past the cap), and then no
        # page stream is carried either: the kernels locate from bounds
        outs = multi_bucket_query_step(
            self.term_offsets, self.coords, self.bounds, self.page_doc,
            terms_list, rs_list, caps_list, topk, use_kernels=use_kernels,
            small=self.small if cap is None else None,
            page_of=self.page_of if cap is None else None)
        # one transfer per field for the whole batch
        host = [torch.cat([o[f] for o in outs]).cpu().numpy()
                for f in range(3)]
        off = 0
        for idxs, o in zip(idx_list, outs):
            n = len(idxs)
            pages[idxs] = host[0][off: off + n]
            ranks[idxs] = host[1][off: off + n]
            counts[idxs] = host[2][off: off + n]
            off += o[0].shape[0]
        return pages, ranks, counts

    def compile_group_query(self, query):
        """One group query [(codes, r), ...] -> (id rows, rs, w, v, cap
        need, min_need), or None when some group has no known term
        (device_index.py:2106). Cached per query."""
        return self._compile_cached(query)[0]

    def _compile_cached(self, query):
        """compile_group_query's result and how the cache served it: 0 a
        hit, 1 a miss, 2 a miss the cache, at its cap, could not keep."""
        return compile_cached(self._cgq_cache, self._cgq_lock, query,
                              self._compile_group_query_uncached)

    def _compile_group_query_uncached(self, query):
        rows, rvals = [], []
        need = 1
        min_need = None
        for codes, r in query:
            if isinstance(codes, str):
                codes = (codes,)
            ids = []
            group_vol = 0
            for c in codes:
                tid = self.term_id(c)
                if tid >= 0:
                    ids.append(tid)
                    cnt = self.posting_count(c)
                    need = max(need, cnt)
                    group_vol += cnt
            if not ids:
                return None
            min_need = group_vol if min_need is None else min(
                min_need, group_vol)
            rows.append(ids)
            rvals.append(r)
        w = max(len(rows), 1)
        v = max((len(ids) for ids in rows), default=1)
        return rows, rvals, w, v, need, min_need or 1

    def search_batch_full(self, queries, topk: int = 64,
                          hit_cap: int = 512, want_docs: bool = True,
                          use_kernels: Optional[bool] = None,
                          cap: Optional[int] = None,
                          cap_ladder: Optional[Sequence[int]] = None,
                          fused: bool = True, deferred: bool = False,
                          clamp_budgets: bool = False,
                          sort_topk: bool = True):
        """Full-result batch evaluation with per-word variant ORs
        (device_index.py:2170). queries: per query a list of (codes, r)
        groups; codes is a term key or a sequence of OR'd variant keys
        (the reference's code sets and `a|b` alternations). Buckets
        group queries by (cap, W, V rounded up to a power of two, hit
        tier); the cap is a power of two from 64, or the first rung of
        `cap_ladder` that holds the longest list, or `cap` for every
        query (longer lists are then cut to their first `cap` postings,
        and neither the small tables nor carried pages serve).

        Returns a dict of numpy arrays: pages / ranks / counts [B, topk],
        n_pages / n_hits [B], hits [B, hit_cap] (ascending kept
        coordinates, INF32 padded) and, with want_docs, docs /
        doc_ranks [B, topk]. n_pages > topk or n_hits > hit_cap flags
        rank truncation.

        fused: every bucket shares one rank top-k and one doc grouping
        and the hit buffers come in tiers (128 / 512 / hit_cap by the
        smallest operand). With False, the shape a server sends
        (batcher.py:701-768): one hit tier, rows padded to a power of
        four, and each bucket finished on its own (batched_query_full).

        clamp_budgets (the escalated pass of truncated rows, per-bucket
        path): each bucket's topk is cut to its cap and its hit buffer
        to min(hit_cap, cap * max(2, 2 V)), and the row's budgets come
        back in out["topk_eff"] / out["hit_cap_eff"] for the caller's
        truncation check.

        deferred: returns `finish` instead of the dict. Every launch and
        the copies into pinned host memory are queued on the stream;
        nothing is waited for or scattered into the result until
        finish() is called, so the caller can bucket the next wave
        meanwhile.

        use_kernels: the CUDA kernels (default on a CUDA device; on the
        CPU their plain versions) or, with False, the plain route for
        every bucket. sort_topk=False (per-bucket path only): the
        top-k-mode kernels, see batched_query_full."""
        if use_kernels is None:
            use_kernels = self.device.type == "cuda"
        per_bucket = not fused or clamp_budgets
        if not sort_topk and not per_bucket:
            raise ValueError("sort_topk=False needs the per-bucket path: "
                             "fused=False or clamp_budgets=True")
        b = len(queries)
        seq = next(self._batch_seq)
        with profiling.span("query.dispatch", seq):
            out = {
                "pages": np.full((b, topk), -1, dtype=np.int32),
                "ranks": np.zeros((b, topk), dtype=np.float32),
                "counts": np.zeros((b, topk), dtype=np.int32),
                "n_pages": np.zeros(b, dtype=np.int32),
                "n_hits": np.zeros(b, dtype=np.int32),
                "hits": np.full((b, hit_cap), INF32, dtype=np.int32),
            }
            if want_docs:
                out["docs"] = np.full((b, topk), -1, dtype=np.int32)
                out["doc_ranks"] = np.zeros((b, topk), dtype=np.float32)
            if clamp_budgets:
                out["topk_eff"] = np.full(b, topk, dtype=np.int64)
                out["hit_cap_eff"] = np.full(b, hit_cap, dtype=np.int64)

            round_cap = _cap_rounder(cap, cap_ladder)
            tiers = hit_tiers(hit_cap, fused)

            compiled = []
            buckets = {}
            misses = full = 0
            with profiling.span("query.compile", seq):
                for i, q in enumerate(queries):
                    cg, how = self._compile_cached(q)
                    compiled.append(cg)
                    if how:
                        misses += 1
                        full += how == 2
                    if cg is None:
                        continue
                    _rows, _rvals, w, v, need, min_need = cg
                    buckets.setdefault(
                        (round_cap(need), w, _bucket(v, lo=1),
                         hit_tier(tiers, min_need, hit_cap)), []).append(i)

            terms_list, rs_list, caps_list, hcaps_list, idx_list = (
                [], [], [], [], [])
            topks_list = []
            dev = self.device
            for (qcap, w, vb, hb), idxs in sorted(buckets.items(),
                                                   key=_bucket_sort_key):
                with profiling.span("query.pack", seq):
                    topk_b = topk
                    if clamp_budgets:
                        topk_b = min(topk, qcap)
                        hb = min(hit_cap, qcap * max(2, 2 * vb))
                        out["topk_eff"][idxs] = topk_b
                        out["hit_cap_eff"][idxs] = hb
                    topks_list.append(topk_b)
                    brows = (_bucket(len(idxs), lo=8) if fused
                             else _bucket4(len(idxs)))
                    terms, rs = bucket_arrays(compiled, idxs, brows, w, vb)
                # each copy from pageable memory waits for the stream
                with profiling.span("query.upload", seq):
                    terms_list.append(torch.as_tensor(terms, device=dev))
                    rs_list.append(torch.as_tensor(rs, device=dev))
                caps_list.append(qcap)
                hcaps_list.append(hb)
                idx_list.append(idxs)
            if not idx_list:
                _count_batch(b, misses, full, 0, 0)
                return (lambda: out) if deferred else out
            # an explicit cap may cut long lists, which the small tables
            # cannot serve (no row for a count past the cap), and then no
            # page stream is carried either
            small = self.small if cap is None else None
            page_of = self.page_of if cap is None else None
            with profiling.span("query.launch", seq):
                if not per_bucket:
                    outs = multi_bucket_query_full(
                        self.term_offsets, self.coords, self.bounds,
                        self.page_doc, self.is_header, terms_list, rs_list,
                        caps_list, topk, hcaps_list, with_docs=want_docs,
                        use_kernels=use_kernels, small=small,
                        page_of=page_of)
                else:
                    outs = [
                        batched_query_full(
                            self.term_offsets, self.coords, self.bounds,
                            self.page_doc, self.is_header, tq, rq, cap=qcap,
                            topk=tk, hit_cap=hb, with_docs=want_docs,
                            use_kernels=use_kernels, small=small,
                            page_of=page_of, sort_topk=sort_topk)
                        for tq, rq, qcap, hb, tk in zip(
                            terms_list, rs_list, caps_list, hcaps_list,
                            topks_list)]
            fields = ["pages", "ranks", "counts", "n_pages", "n_hits", "hits"]
            if want_docs:
                fields += ["docs", "doc_ranks"]
            with profiling.span("query.readback", seq):
                host, ready = _to_host({f: [getattr(o, f) for o in outs]
                                        for f in fields})
            _count_batch(b, misses, full, len(idx_list),
                         sum(a.nbytes for parts in host.values()
                             for a in parts))

        def finish():
            with profiling.span("query.finish", seq):
                with profiling.span("query.finish.wait", seq):
                    if ready is not None:
                        ready.synchronize()
                with profiling.span("query.finish.scatter", seq):
                    for k, (idxs, hb, tk) in enumerate(zip(
                            idx_list, hcaps_list, topks_list)):
                        n = len(idxs)
                        for f in ("pages", "ranks", "counts", "docs",
                                  "doc_ranks"):
                            if f in host:
                                out[f][idxs, :tk] = host[f][k][:n]
                        out["n_pages"][idxs] = host["n_pages"][k][:n]
                        nh = host["n_hits"][k][:n]
                        # a query overflowing its tier must flag truncation
                        out["n_hits"][idxs] = (
                            np.where(nh > hb, np.int32(hit_cap + 1), nh)
                            if hb < hit_cap else nh)
                        out["hits"][idxs, :hb] = host["hits"][k][:n]
            return out

        return finish if deferred else finish()


# the most compiled queries a compile cache keeps
COMPILE_CACHE_MAX = 200_000


def compile_cached(cache: dict, lock, query, compile_one):
    """compile_one(query) through `cache` (keyed by the query's codes and
    windows, at most COMPILE_CACHE_MAX entries), and how the cache served
    it: 0 a hit, 1 a miss, 2 a miss the cache, at its cap, could not
    keep. `lock` guards the cache: a batcher's collector and completion
    threads both fill it."""
    try:
        key = tuple((codes if isinstance(codes, str) else tuple(codes), r)
                    for codes, r in query)
    except TypeError:
        return compile_one(query), 1
    with lock:
        if key in cache:
            return cache[key], 0
    out = compile_one(query)
    with lock:
        if len(cache) < COMPILE_CACHE_MAX:
            cache[key] = out
            return out, 1
    return out, 2


def hit_tiers(hit_cap: int, fused: bool) -> List[int]:
    """The hit buffers a full-result batch reads back: by the fused path
    128 / 512 / hit_cap, so that a query whose smallest operand bounds
    its result small reads back a small buffer (an overflow still flags
    through n_hits); one, hit_cap, a bucket on the per-bucket path, where
    each extra tier is another launch."""
    return sorted({min(hit_cap, t) for t in (128, 512, hit_cap)}
                  ) if fused else [hit_cap]


def hit_tier(tiers: Sequence[int], min_need: int, hit_cap: int) -> int:
    """The tier of a query whose smallest group holds min_need
    postings."""
    want = 4 * min_need + 16
    return next((t for t in tiers if want <= t), hit_cap)


def bucket_arrays(compiled, idxs, rows: int, w: int, vb: int):
    """A bucket's terms int32 [rows, W] (vb 1) or [rows, W, vb] and rs
    int32 [rows, W] from compiled queries ((id rows, rvals, ...) each):
    row j is query idxs[j], -1 terms and R 1 past them."""
    terms = np.full((rows, w, vb), -1, dtype=np.int32)
    rs = np.ones((rows, w), dtype=np.int32)
    for row, i in enumerate(idxs):
        for j, (ids, r) in enumerate(zip(compiled[i][0], compiled[i][1])):
            terms[row, j, : len(ids)] = ids
            rs[row, j] = r
    return (terms[:, :, 0] if vb == 1 else terms), rs


def _count_batch(queries: int, misses: int, full: int, buckets: int,
                 readback_bytes: int, uploads: Optional[int] = None) -> None:
    """search_batch_full's counters, added once a call: its queries, the
    compile cache's misses (and those it was too full to keep), its
    buckets, their uploads (by default terms and rs each) and the bytes
    read back."""
    profiling.count("query.batches")
    profiling.count("query.queries", queries)
    profiling.count("query.compile_miss", misses)
    profiling.count("query.compile_uncached_full", full)
    profiling.count("query.buckets", buckets)
    profiling.count("query.uploads",
                    2 * buckets if uploads is None else uploads)
    profiling.count("readback.bytes", readback_bytes)


def _to_host(fields: dict):
    """Copies of per-bucket device tensors on the host, {field: [numpy
    view per bucket]}: a field whose buckets agree in width goes in one
    transfer. On a CUDA device the copies go to pinned memory without
    waiting; the second result is the event that says they have
    landed (None on the CPU)."""
    host = {}
    cuda = False
    for f, tensors in fields.items():
        cuda = tensors[0].is_cuda
        if len({t.shape[1:] for t in tensors}) == 1:
            parts = torch.split(_host_copy(torch.cat(tensors)),
                                [t.shape[0] for t in tensors])
        else:
            parts = [_host_copy(t) for t in tensors]
        host[f] = [p.numpy() for p in parts]
    ready = None
    if cuda:
        ready = torch.cuda.Event()
        ready.record()
    return host, ready


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    if not t.is_cuda:
        return t
    dst = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return dst.copy_(t, non_blocking=True)


def _small_state(i: int, st: SmallTab) -> dict:
    def host(x):
        return x.cpu().numpy() if isinstance(x, torch.Tensor) else \
            np.asarray(x)

    return {f"small{i}_w": np.int64(st.w), f"small{i}_band": np.bool_(st.band),
            f"small{i}_row_map": host(st.row_map),
            f"small{i}_tab": host(st.tab)}
