"""The query kernels: twin of docodo_tpu/ops/pallas_query.py.

One wrapper per hand-written CUDA kernel (csrc/locate_full.cu,
csrc/variants.cu, csrc/chunked.cu, the W = 1 kernel of
csrc/w1_kernel.cuh, csrc/fetch.cu), each with its plain PyTorch version
beside it. Every kernel bucket's operands come from

  fetch_postings          each term's postings (and pages) padded to the
                          bucket's cap (device_index.py:397, :499)

The full-result kernels:

  sorted_and_locate_full  W = 2, cap <= 512   (pallas_query.py:1164)
  single_locate_full      W = 1, cap <= 128   (pallas_query.py:1243)
  union_locate_full       W = 1, V = 1, cap <= 1024 (pallas_query.py:977)
  merge_and_locate_topk   W = 2, 2 cap <= 4096 (pallas_query.py:2739)
  merge_tagged            sorted blocks -> one (coord, tag) stream
                          (pallas_query.py:2332)
  and_keep                the AND's kept stream, any width, or a fold
                          step's compacted operand (pallas_query.py:2810)
  locate_runs             page runs of a kept stream, any width
                          (pallas_query.py:1769)
  variants_and_locate_full  W = 2 variant ORs, (Va + Vb) cap <= 1024
                          (pallas_query.py:904)
  union_merge_locate_full W = 1, V > 1, V cap <= 1024 (pallas_query.py:977)
  variants_keep           the variants AND's kept stream, any width
                          (pallas_query.py:2880)

The page-level kernels, which rank every run of a row and pick its top
k themselves (pages, ranks, counts int32, each [B, topk]):

  sorted_and_locate       W = 2, cap <= 512   (pallas_query.py:1080)
  batched_and_locate      the same kernel without page streams
                          (pallas_query.py:1355)
  batched_single_locate   W = 1, cap <= 128   (pallas_query.py:1403)

A wrapper launches its kernel for CUDA tensors and takes the plain
version for CPU tensors only; any other device raises. The plain
versions run on any device, so a run on the card can hold each kernel
against its plain version on the same inputs.

The full-result wrappers return the slot-mode outputs of
`_full_stream_call_slots` (pallas_query.py:826): the first min(topk, n)
page runs in slot order, padded to topk with -1 / 0 / 0, n_pages and
n_hits, and the first hit_cap kept hits, INF32 padded; with tail=True
the rank top-k of those runs (streams_topk_tail) replaces the runs.

With sort_topk=False the four slot wrappers take their top-k-mode
kernels instead (`_full_stream_call`, pallas_query.py:789), which end a
row inside the kernel: the true top k over EVERY run of the row (counts
int32), n_pages, n_hits and the first hit_cap kept hits. The two modes
differ only on rows with n_pages > topk, which are flagged truncated.

  sorted_and_locate_full_topk    pallas_query.py:498
  variants_and_locate_full_topk  pallas_query.py:526
  union_locate_full_topk         pallas_query.py:550 (any V >= 1: V = 1
                                 on the W = 1 body, V > 1 on the
                                 variant merge body)
  single_locate_full_topk        pallas_query.py:218

  merge_and_locate        W = 2, 2 cap <= 4096: the kept stream and the
                          in-slot run streams at full width
                          (pallas_query.py:2695), with the torch tails
                          compact_streams_topk / locate_streams_topk
"""

from __future__ import annotations

import torch

from docodo_tpu_torch.ops import _cuda
from docodo_tpu_torch.ops.seqops import (
    INF32,
    combine_r,
    compact_hits,
    fold_dups,
    gather_term,
    gather_term_paged,
    locate_compact,
    page_runs,
    run_starts,
    segment_and,
    select_slots,
    sort_tagged,
    topk_nonneg,
    variant_blocks,
    variants_keep_mask,
)
from docodo_tpu_torch.utils import profiling

# kernel admission, as in the JAX package (pallas_query.py:61, 780, 786,
# 1067)
MAX_PALLAS_CAP = 128
MAX_STREAM_WIDTH = 1024
W1_FULL_STREAM_MAX = 256
MAX_SORTED_PALLAS_CAP = 512
FUSED_AND_MAX = 4096  # pallas_query.py:2478, without its env override


def shared_pg(vals: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
    """Page of every slot: #bounds <= val, clamped to P-1
    (pallas_query._shared_pg). INF32 slots land on the last page."""
    pg = torch.searchsorted(bounds, vals, right=True)
    return pg.clamp_max(bounds.shape[0] - 1).to(torch.int32)


def streams_topk_tail(pg_c, rk_c, ct_c, n_pages, topk: int):
    """Rank top-k over compacted first-topk run streams
    (pallas_query.py:1747): (pages -1 pad, ranks, counts int32,
    n_pages). Ties go to the lowest slot."""
    top_rank, top_slot = topk_nonneg(rk_c[:, :topk], topk)
    valid_top = top_rank > 0
    top_page = torch.where(valid_top, select_slots(pg_c[:, :topk], top_slot),
                           -1)
    top_cnt = torch.where(valid_top, select_slots(ct_c[:, :topk], top_slot),
                          0.0).to(torch.int32)
    return top_page, top_rank, top_cnt, n_pages


def _masked(a, na):
    lane = torch.arange(a.shape[1], device=a.device)[None, :]
    return torch.where(lane < na[:, None], a, INF32)


def _slots_glue(outs, topk: int, hit_cap: int, tail: bool,
                sort_topk: bool = True):
    """Pad the kernel's first-kpad runs to topk (-1 / 0 / 0) and its
    first-hpad hits to hit_cap (INF32); with `tail`, finish the rank
    top-k (pallas_query.py:875-899). A top-k-mode kernel's runs
    (sort_topk False) are finished already: only the hits are padded
    (pallas_query.py:817-823)."""
    pg_c, rk_c, ct_c, n_pages, n_hits, hits = outs
    bsz, kpad = pg_c.shape
    if not sort_topk:
        tail = False
    elif kpad < topk:
        z = topk - kpad
        pg_c = torch.cat([pg_c, pg_c.new_full((bsz, z), -1)], dim=1)
        rk_c = torch.cat([rk_c, rk_c.new_zeros((bsz, z))], dim=1)
        ct_c = torch.cat([ct_c, ct_c.new_zeros((bsz, z))], dim=1)
    if hits.shape[1] < hit_cap:
        hits = torch.cat(
            [hits, hits.new_full((bsz, hit_cap - hits.shape[1]), INF32)],
            dim=1)
    hits = hits[:, :hit_cap]
    if not tail:
        return pg_c, rk_c, ct_c, n_pages, n_hits, hits
    pages, ranks, counts, _ = streams_topk_tail(pg_c, rk_c, ct_c, n_pages,
                                                topk)
    return pages, ranks, counts, n_pages, n_hits, hits


def _check_mode(tail: bool, sort_topk: bool) -> None:
    if not (tail or sort_topk):
        raise ValueError("sort_topk=False ends the top k in the kernel: "
                         "it has no tail=False form")


def _full_topk(vals, keep, page, topk: int, hpad: int):
    """Plain version of the kernels' locate_full_topk_tail: every run of
    the masked stream ranked, the top `topk` by (rank descending, lane
    ascending), the exact totals and the first hpad kept hits."""
    pg, rk, ct, n_pages = page_runs(vals, keep, page, vals.shape[1])
    hits, n_hits = compact_hits(vals, keep, hpad)
    return (*runs_topk(pg, rk, ct, topk), n_pages, n_hits, hits)


def _on_device(kernel, plain, *args):
    """The kernel for CUDA tensors, the plain version for CPU ones."""
    dev = args[0].device
    if dev.type == "cuda":
        return kernel(*args)
    if dev.type == "cpu":
        return plain(*args)
    raise ValueError(f"no kernel for device {dev}")


# ---------------------------------------------------------------------------
# the posting fetch
# ---------------------------------------------------------------------------

def _fetch_plain(coords, term_offsets, terms, cap, page_of):
    """Plain version of docodo_fetch_postings: seqops.gather_term, or
    gather_term_paged with page_of, over the flat terms."""
    flat = terms.reshape(-1)
    profiling.count("fetch.plain_rows", flat.shape[0])
    if page_of is None:
        vals, ln = gather_term(coords, term_offsets, flat, cap)
        return vals, None, ln
    return gather_term_paged(coords, page_of, term_offsets, flat, cap)


def _fetch_kernel(coords, term_offsets, terms, cap, page_of):
    """docodo_fetch_postings over terms as they lie (their strides go to
    the kernel, nothing is copied)."""
    if terms.dim() not in (1, 2):
        raise ValueError(f"terms must be [B] or [B, V], got "
                         f"{tuple(terms.shape)}")
    if terms.dtype != torch.int32:
        terms = terms.to(torch.int32)
    if terms.device != coords.device:
        raise ValueError(f"terms lie on {terms.device}, the postings on "
                         f"{coords.device}")
    for t, name in ((coords, "coords"), (term_offsets, "term_offsets"),
                    (page_of, "page_of")):
        if t is not None:
            _cuda.check(t, name, torch.int32, (t.shape[0],))
    v = terms.shape[1] if terms.dim() == 2 else 1
    rows = terms.shape[0] * v
    dev = coords.device
    vals = torch.empty((rows, cap), dtype=torch.int32, device=dev)
    pgs = None if page_of is None else torch.empty_like(vals)
    ln = torch.empty((rows,), dtype=torch.int32, device=dev)
    _cuda.FETCH.launch(dev, coords, page_of, term_offsets, terms, rows, v,
                       terms.stride(0), terms.stride(-1), cap, vals, pgs, ln)
    profiling.count("fetch.kernel_rows", rows)
    return vals, pgs, ln


def fetch_postings(coords, term_offsets, terms, cap: int, *, page_of=None):
    """Each term's postings padded to `cap`, in one launch on the card:
    for terms [B] or [B, V] (rows = B V in row-major order), vals int32
    [rows, cap] holds the first min(count, cap) of the term's coords then
    INF32, ln int32 [rows] that length (term < 0: an empty row), and with
    page_of, pgs [rows, cap] the same span of page_of, INF32 padded (else
    None). Returns (vals, pgs, ln), bit for bit gather_term's /
    gather_term_paged's. Both read the CSR at every cap: under the small
    tables' contract (every real term's count <= cap) their rows hold the
    same spans. The counters fetch.kernel_rows / fetch.plain_rows add the
    rows each version fetched."""
    return _on_device(_fetch_kernel, _fetch_plain, coords, term_offsets,
                      terms, cap, page_of)


# ---------------------------------------------------------------------------
# W = 2: sorted AND + locate
# ---------------------------------------------------------------------------

def _sorted_and_plain(a, a_pg, na, ra, b, b_pg, nb, rb, kpad, hpad,
                      finish=locate_compact):
    """Plain version of docodo_sorted_and_locate_full: the plain merge
    (a stable sort on coord << 2 | tag), the plain AND keep, the locate
    tail."""
    vals, tag, page = _merge_tagged_plain(a, a_pg, na, b, b_pg, nb)
    keep = _and_keep_plain(vals, tag, ra, rb) < INF32
    return finish(vals, keep, page, kpad, hpad)


def _sorted_and_topk_plain(a, a_pg, na, ra, b, b_pg, nb, rb, topk, hpad):
    """Plain version of docodo_sorted_and_locate_full_topk."""
    return _sorted_and_plain(a, a_pg, na, ra, b, b_pg, nb, rb, topk, hpad,
                             finish=_full_topk)


def _sorted_and_topk_kernel(a, a_pg, na, ra, b, b_pg, nb, rb, topk, hpad):
    return _cuda.full_result(_cuda.SORTED_AND_TOPK,
                             [a, a_pg, na, ra, b, b_pg, nb, rb],
                             2 * a.shape[1], 2 * MAX_SORTED_PALLAS_CAP,
                             topk, hpad, topk_mode=True)


def _sorted_and_kernel(a, a_pg, na, ra, b, b_pg, nb, rb, kpad, hpad):
    return _cuda.full_result(_cuda.SORTED_AND,
                             [a, a_pg, na, ra, b, b_pg, nb, rb],
                             2 * a.shape[1], 2 * MAX_SORTED_PALLAS_CAP,
                             kpad, hpad)


def _sorted_and_call(core, a, na, ra, b, nb, rb, bounds, topk, hit_cap,
                     a_pg, b_pg, tail, sort_topk=True):
    _check_mode(tail, sort_topk)
    cap = a.shape[1]
    if cap > MAX_SORTED_PALLAS_CAP or b.shape[1] != cap:
        raise ValueError(f"W=2 kernel takes equal caps <= "
                         f"{MAX_SORTED_PALLAS_CAP}, got {cap}/{b.shape[1]}")
    if a_pg is None:
        a_pg = shared_pg(_masked(a, na), bounds)
        b_pg = shared_pg(_masked(b, nb), bounds)
    n = 2 * cap
    outs = core(a, a_pg, na, ra, b, b_pg, nb, rb,
                min(topk, n) if sort_topk else topk, min(hit_cap, n))
    return _slots_glue(outs, topk, hit_cap, tail, sort_topk)


def sorted_and_locate_full(a, na, ra, b, nb, rb, bounds, *, topk: int,
                           hit_cap: int, a_pg=None, b_pg=None,
                           tail: bool = True, sort_topk: bool = True):
    """W = 2 full-result AND + locate over [B, cap] posting blocks
    a / b with lengths na / nb and windows ra / rb (all int32).
    a_pg / b_pg: the blocks' page streams, carried from the posting
    fetch; without them the pages are looked up here (shared_pg).
    Returns (pages, ranks, counts, n_pages, n_hits, hits[B, hit_cap]),
    or with tail=False the first-topk runs (pg_c, rk_c, ct_c) in place
    of the first three. The top k is that of the row's first topk runs;
    with sort_topk=False (pallas_query.py:1232) it is the true top k of
    every run, picked inside the top-k-mode kernel."""
    kernel, plain = ((_sorted_and_kernel, _sorted_and_plain) if sort_topk
                     else (_sorted_and_topk_kernel, _sorted_and_topk_plain))
    return _sorted_and_call(
        lambda *x: _on_device(kernel, plain, *x), a, na, ra, b, nb, rb,
        bounds, topk, hit_cap, a_pg, b_pg, tail, sort_topk)


def sorted_and_locate_full_plain(a, na, ra, b, nb, rb, bounds, *,
                                 topk: int, hit_cap: int, a_pg=None,
                                 b_pg=None, tail: bool = True,
                                 sort_topk: bool = True):
    """sorted_and_locate_full through its plain version, on any device."""
    plain = _sorted_and_plain if sort_topk else _sorted_and_topk_plain
    return _sorted_and_call(plain, a, na, ra, b, nb, rb, bounds, topk,
                            hit_cap, a_pg, b_pg, tail, sort_topk)


# ---------------------------------------------------------------------------
# W = 1: single word, and the V = 1 union
# ---------------------------------------------------------------------------

def _single_plain(a, a_pg, na, kpad, hpad, finish=locate_compact):
    """Plain version of docodo_single_locate_full: the block's first na
    slots are the kept stream."""
    lane = torch.arange(a.shape[1], device=a.device)[None, :]
    keep = lane < na[:, None]
    return finish(torch.where(keep, a, INF32), keep, a_pg, kpad, hpad)


def _single_topk_mode_plain(a, a_pg, na, topk, hpad):
    """Plain version of docodo_single_locate_full_topk."""
    return _single_plain(a, a_pg, na, topk, hpad, finish=_full_topk)


def _single_topk_mode_kernel(a, a_pg, na, topk, hpad):
    return _cuda.full_result(_cuda.SINGLE_TOPK, [a, a_pg, na], a.shape[1],
                             MAX_PALLAS_CAP, topk, hpad, topk_mode=True)


def _single_kernel(a, a_pg, na, kpad, hpad):
    return _cuda.full_result(_cuda.SINGLE, [a, a_pg, na], a.shape[1],
                             MAX_PALLAS_CAP, kpad, hpad)


def _union_plain(a, a_pg, na, kpad, hpad, finish=locate_compact):
    """Plain version of docodo_union_locate_full: a slot is kept where it
    is valid and differs from the previous slot."""
    vals = _masked(a, na)
    prev = torch.cat([torch.full_like(vals[:, :1], -1), vals[:, :-1]],
                     dim=1)
    keep = (vals < INF32) & (vals != prev)
    return finish(vals, keep, a_pg, kpad, hpad)


def _union_kernel(a, a_pg, na, kpad, hpad):
    return _cuda.full_result(_cuda.UNION, [a, a_pg, na], a.shape[1],
                             MAX_STREAM_WIDTH, kpad, hpad)


def _w1_call(core, limit, a, na, bounds, topk, hit_cap, a_pg, tail,
             sort_topk=True):
    _check_mode(tail, sort_topk)
    cap = a.shape[1]
    if cap > limit:
        raise ValueError(f"W=1 kernel takes caps <= {limit}, got {cap}")
    if a_pg is None:
        a_pg = shared_pg(_masked(a, na), bounds)
    outs = core(a, a_pg, na, min(topk, cap) if sort_topk else topk,
                min(hit_cap, cap))
    return _slots_glue(outs, topk, hit_cap, tail, sort_topk)


def single_locate_full(a, na, bounds, *, topk: int, hit_cap: int,
                       a_pg=None, tail: bool = True, sort_topk: bool = True):
    """W = 1 full-result locate over [B, cap <= 128] posting blocks;
    outputs and modes as sorted_and_locate_full."""
    kernel, plain = ((_single_kernel, _single_plain) if sort_topk else
                     (_single_topk_mode_kernel, _single_topk_mode_plain))
    return _w1_call(lambda *x: _on_device(kernel, plain, *x), MAX_PALLAS_CAP,
                    a, na, bounds, topk, hit_cap, a_pg, tail, sort_topk)


def single_locate_full_plain(a, na, bounds, *, topk: int, hit_cap: int,
                             a_pg=None, tail: bool = True,
                             sort_topk: bool = True):
    """single_locate_full through its plain version, on any device."""
    plain = _single_plain if sort_topk else _single_topk_mode_plain
    return _w1_call(plain, MAX_PALLAS_CAP, a, na, bounds, topk, hit_cap, a_pg,
                    tail, sort_topk)


def _v1(a, na, a_pg):
    return a[:, 0], na[:, 0], None if a_pg is None else a_pg[:, 0]


def union_locate_full(a, na, bounds, *, topk: int, hit_cap: int,
                      a_pg=None, tail: bool = True, sort_topk: bool = True):
    """W = 1 full-result locate of one word's variant union: a [B, V, cap]
    with V cap <= 1024, na [B, V]; outputs and modes as
    sorted_and_locate_full. V = 1 takes the union kernel, V > 1
    union_merge_locate_full; sort_topk=False the top-k-mode kernel at
    any V."""
    if not sort_topk or a.shape[1] > 1:
        return union_merge_locate_full(a, na, bounds, topk=topk,
                                       hit_cap=hit_cap, a_pg=a_pg, tail=tail,
                                       sort_topk=sort_topk)
    a, na, a_pg = _v1(a, na, a_pg)
    return _w1_call(
        lambda *x: _on_device(_union_kernel, _union_plain, *x),
        MAX_STREAM_WIDTH, a, na, bounds, topk, hit_cap, a_pg, tail)


def union_locate_full_plain(a, na, bounds, *, topk: int, hit_cap: int,
                            a_pg=None, tail: bool = True,
                            sort_topk: bool = True):
    """union_locate_full through its plain versions, on any device."""
    if not sort_topk or a.shape[1] > 1:
        return union_merge_locate_full_plain(a, na, bounds, topk=topk,
                                             hit_cap=hit_cap, a_pg=a_pg,
                                             tail=tail, sort_topk=sort_topk)
    a, na, a_pg = _v1(a, na, a_pg)
    return _w1_call(_union_plain, MAX_STREAM_WIDTH, a, na, bounds, topk,
                    hit_cap, a_pg, tail)


# ---------------------------------------------------------------------------
# variant ORs within a slot: kernels E (W = 2) and F (W = 1)
# ---------------------------------------------------------------------------

MAX_BLOCKS = 32  # variant blocks a slot kernel merges (csrc kMaxBlocks)


def _block_pages(a, na, a_pg, bounds):
    """The page streams of [B, V, cap] blocks: carried, or looked up in
    bounds (pages at padding lanes are never read)."""
    if a_pg is not None:
        return a_pg
    return shared_pg(variant_blocks(a, na), bounds).reshape(a.shape)


def _variants_and_plain(a, a_pg, na, ra, b, b_pg, nb, rb, bpad, kpad, hpad,
                        finish=locate_compact):
    """Plain version of docodo_variants_and_locate_full: the variant
    blocks merge by one stable sort on coord << 2 | tag, then
    and_variants_sorted's run-dedupe and segmentation and the locate
    tail."""
    vals, tag, pg = _merge_tagged_plain(a, a_pg, na, b, b_pg, nb)
    keep = variants_keep_mask(vals, tag, ra, rb, bpad != 0)
    return finish(vals, keep, pg, kpad, hpad)


def _variants_and_topk_plain(a, a_pg, na, ra, b, b_pg, nb, rb, bpad, topk,
                             hpad):
    """Plain version of docodo_variants_and_locate_full_topk."""
    return _variants_and_plain(a, a_pg, na, ra, b, b_pg, nb, rb, bpad, topk,
                               hpad, finish=_full_topk)


def _check_blocks(rows, blocks):
    for name, t, v, cap in blocks:
        if t is not None:
            _cuda.check(t, name, torch.int32, (rows, v, cap))


def _variants_and_kernel(a, a_pg, na, ra, b, b_pg, nb, rb, bpad, kpad,
                         hpad, kernel=_cuda.VARIANTS_AND):
    rows, va, cap = a.shape
    vb = b.shape[1]
    n = (va + vb) * cap
    topk_mode = kernel is _cuda.VARIANTS_AND_TOPK
    if not 0 < n <= MAX_STREAM_WIDTH or va + vb > MAX_BLOCKS:
        raise ValueError(f"{kernel.symbol}: {va} + {vb} blocks of {cap} "
                         f"lanes")
    _cuda.check_budgets(kernel, n, kpad, hpad, topk_mode)
    _check_blocks(rows, [("a", a, va, cap), ("a_pg", a_pg, va, cap),
                         ("b", b, vb, cap), ("b_pg", b_pg, vb, cap)])
    _cuda.check(na, "na", torch.int32, (rows, va))
    _cuda.check(nb, "nb", torch.int32, (rows, vb))
    for name, t in (("ra", ra), ("rb", rb), ("bpad", bpad)):
        _cuda.check(t, name, torch.int32, (rows,))
    outs = _cuda.full_result_outputs(rows, kpad, hpad, a.device, topk_mode)
    kernel.launch(a.device, a, a_pg, na, ra, b, b_pg, nb, rb, bpad, rows, va,
                  vb, cap, kpad, hpad, *outs)
    return outs


def _variants_and_topk_kernel(a, a_pg, na, ra, b, b_pg, nb, rb, bpad, topk,
                              hpad):
    return _variants_and_kernel(a, a_pg, na, ra, b, b_pg, nb, rb, bpad, topk,
                                hpad, kernel=_cuda.VARIANTS_AND_TOPK)


def _variants_and_call(core, a, na, ra, b, nb, rb, bpad, bounds, topk,
                       hit_cap, a_pg, b_pg, tail, sort_topk=True):
    _check_mode(tail, sort_topk)
    cap = a.shape[2]
    n = (a.shape[1] + b.shape[1]) * cap
    if n > MAX_STREAM_WIDTH or b.shape[2] != cap:
        raise ValueError(f"W=2 variant kernel takes equal caps with "
                         f"(Va + Vb) cap <= {MAX_STREAM_WIDTH}, got "
                         f"{tuple(a.shape)} / {tuple(b.shape)}")
    a_pg = _block_pages(a, na, a_pg, bounds)
    b_pg = _block_pages(b, nb, b_pg, bounds)
    outs = core(a, a_pg, na, ra, b, b_pg, nb, rb, bpad.to(torch.int32),
                min(topk, n) if sort_topk else topk, min(hit_cap, n))
    return _slots_glue(outs, topk, hit_cap, tail, sort_topk)


def variants_and_locate_full(a, na, ra, b, nb, rb, bpad, bounds, *,
                             topk: int, hit_cap: int, a_pg=None, b_pg=None,
                             tail: bool = True, sort_topk: bool = True):
    """W = 2 full-result AND of two variant ORs
    (pallas_variants_and_locate_full): a [B, Va, cap] / b [B, Vb, cap]
    variant blocks with lengths na / nb, windows ra / rb [B], bpad [B]
    (word B is query padding: the result is word A's union),
    (Va + Vb) cap <= 1024. Pages carried in a_pg / b_pg or looked up.
    Outputs and modes as sorted_and_locate_full."""
    kernel, plain = ((_variants_and_kernel, _variants_and_plain) if sort_topk
                     else (_variants_and_topk_kernel,
                           _variants_and_topk_plain))
    return _variants_and_call(
        lambda *x: _on_device(kernel, plain, *x), a, na, ra, b, nb, rb, bpad,
        bounds, topk, hit_cap, a_pg, b_pg, tail, sort_topk)


def variants_and_locate_full_plain(a, na, ra, b, nb, rb, bpad, bounds, *,
                                   topk: int, hit_cap: int, a_pg=None,
                                   b_pg=None, tail: bool = True,
                                   sort_topk: bool = True):
    """variants_and_locate_full through its plain version, on any
    device."""
    plain = _variants_and_plain if sort_topk else _variants_and_topk_plain
    return _variants_and_call(plain, a, na, ra, b, nb, rb, bpad, bounds,
                              topk, hit_cap, a_pg, b_pg, tail, sort_topk)


def _union_merge_plain(a, a_pg, na, kpad, hpad, finish=locate_compact):
    """Plain version of docodo_union_merge_locate_full: one stable sort
    of the variant blocks (pages riding along), then the V = 1 union's
    plain version over the merged stream."""
    vals = variant_blocks(a, na)
    order = torch.sort(vals, dim=1, stable=True).indices
    return _union_plain(torch.gather(vals, 1, order),
                        torch.gather(a_pg.reshape(vals.shape), 1, order),
                        (vals < INF32).sum(dim=1, dtype=torch.int32), kpad,
                        hpad, finish=finish)


def _union_topk_plain(a, a_pg, na, topk, hpad):
    """Plain version of docodo_union_locate_full_topk."""
    return _union_merge_plain(a, a_pg, na, topk, hpad, finish=_full_topk)


def _union_merge_kernel(a, a_pg, na, kpad, hpad, kernel=_cuda.UNION_MERGE):
    rows, v, cap = a.shape
    n = v * cap
    topk_mode = kernel is _cuda.UNION_TOPK
    if not 0 < n <= MAX_STREAM_WIDTH or v > MAX_BLOCKS:
        raise ValueError(f"{kernel.symbol}: {v} blocks of {cap} lanes")
    _cuda.check_budgets(kernel, n, kpad, hpad, topk_mode)
    _check_blocks(rows, [("a", a, v, cap), ("a_pg", a_pg, v, cap)])
    _cuda.check(na, "na", torch.int32, (rows, v))
    outs = _cuda.full_result_outputs(rows, kpad, hpad, a.device, topk_mode)
    kernel.launch(a.device, a, a_pg, na, rows, v, cap, kpad, hpad, *outs)
    return outs


def _union_topk_kernel(a, a_pg, na, topk, hpad):
    return _union_merge_kernel(a, a_pg, na, topk, hpad,
                               kernel=_cuda.UNION_TOPK)


def _union_merge_call(core, a, na, bounds, topk, hit_cap, a_pg, tail,
                      sort_topk=True):
    _check_mode(tail, sort_topk)
    n = a.shape[1] * a.shape[2]
    if n > MAX_STREAM_WIDTH:
        raise ValueError(f"W=1 variant kernel takes V cap <= "
                         f"{MAX_STREAM_WIDTH}, got {tuple(a.shape)}")
    outs = core(a, _block_pages(a, na, a_pg, bounds), na,
                min(topk, n) if sort_topk else topk, min(hit_cap, n))
    return _slots_glue(outs, topk, hit_cap, tail, sort_topk)


def union_merge_locate_full(a, na, bounds, *, topk: int, hit_cap: int,
                            a_pg=None, tail: bool = True,
                            sort_topk: bool = True):
    """W = 1 full-result locate of one word's variant union
    (pallas_union_locate_full at V > 1): a [B, V, cap], na [B, V],
    V cap <= 1024, the blocks merged in the kernel. Outputs and modes as
    sorted_and_locate_full; the top-k-mode kernel also takes V = 1."""
    kernel, plain = ((_union_merge_kernel, _union_merge_plain) if sort_topk
                     else (_union_topk_kernel, _union_topk_plain))
    return _union_merge_call(
        lambda *x: _on_device(kernel, plain, *x), a, na, bounds, topk,
        hit_cap, a_pg, tail, sort_topk)


def union_merge_locate_full_plain(a, na, bounds, *, topk: int,
                                  hit_cap: int, a_pg=None,
                                  tail: bool = True, sort_topk: bool = True):
    """union_merge_locate_full through its plain version, on any
    device."""
    plain = _union_merge_plain if sort_topk else _union_topk_plain
    return _union_merge_call(plain, a, na, bounds, topk, hit_cap, a_pg, tail,
                             sort_topk)


# ---------------------------------------------------------------------------
# the chunked family: buckets past slot admission
# ---------------------------------------------------------------------------

def _fused_hpad(hit_cap: int, n: int) -> int:
    """The fused kernel's hit width: hit_cap rounded up to 128 lanes,
    at most the stream (pallas_query.py:2761)."""
    return min(-(-hit_cap // 128) * 128, n)


def _merge_and_locate_kernel(a, a_pg, na, ra, b, b_pg, nb, rb, kpad, hpad):
    return _cuda.full_result(_cuda.MERGE_AND_LOCATE,
                             [a, a_pg, na, ra, b, b_pg, nb, rb],
                             2 * a.shape[1], FUSED_AND_MAX, kpad, hpad)


def _merge_and_locate_call(core, a, na, ra, b, nb, rb, a_pg, b_pg, topk,
                           hit_cap):
    cap = a.shape[1]
    n = 2 * cap
    if n > FUSED_AND_MAX or b.shape[1] != cap:
        raise ValueError(f"fused W=2 kernel takes equal caps with 2 cap <= "
                         f"{FUSED_AND_MAX}, got {cap}/{b.shape[1]}")
    outs = core(a, a_pg, na, ra, b, b_pg, nb, rb, min(topk, n),
                _fused_hpad(hit_cap, n))
    return _slots_glue(outs, topk, hit_cap, tail=False)


def merge_and_locate_topk(a, na, ra, b, nb, rb, a_pg, b_pg, *, topk: int,
                          hit_cap: int):
    """W = 2 merge + AND + locate of [B, cap] posting blocks with their
    carried page streams, 2 cap <= 4096 (pallas_merge_and_locate_topk).
    Returns (pg_c, rk_c, ct_c [B, topk], n_pages, n_hits,
    hits [B, hit_cap]): the first topk runs in slot order."""
    return _merge_and_locate_call(
        lambda *x: _on_device(_merge_and_locate_kernel, _sorted_and_plain,
                              *x),
        a, na, ra, b, nb, rb, a_pg, b_pg, topk, hit_cap)


def merge_and_locate_topk_plain(a, na, ra, b, nb, rb, a_pg, b_pg, *,
                                topk: int, hit_cap: int):
    """merge_and_locate_topk through its plain version (the W = 2 slot
    kernel's, at any width), on any device."""
    return _merge_and_locate_call(_sorted_and_plain, a, na, ra, b, nb, rb,
                                  a_pg, b_pg, topk, hit_cap)


def _merge_and_locate_streams_plain(a, a_pg, na, ra, b, b_pg, nb, rb):
    """Plain version of docodo_merge_and_locate: the plain merge and AND
    keep, every run ranked (page_runs), each run's page, rank and count
    put at the run's first lane."""
    vals, tag, page = _merge_tagged_plain(a, a_pg, na, b, b_pg, nb)
    hv = _and_keep_plain(vals, tag, ra, rb)
    keep = hv < INF32
    first, _ = run_starts(vals, keep, page)
    _, rk, ct, _ = page_runs(vals, keep, page, vals.shape[1])
    run = (torch.cumsum(first, dim=1) - 1).clamp_min(0)
    return (hv, torch.where(first, page, -1),
            torch.where(first, torch.gather(rk, 1, run), 0.0),
            torch.where(first, torch.gather(ct, 1, run), 0).to(torch.float32))


def _merge_and_locate_streams_kernel(a, a_pg, na, ra, b, b_pg, nb, rb):
    rows, cap = a.shape
    for name, t in (("a", a), ("a_pg", a_pg), ("b", b), ("b_pg", b_pg)):
        _cuda.check(t, name, torch.int32, (rows, cap))
    for name, t in (("na", na), ("ra", ra), ("nb", nb), ("rb", rb)):
        _cuda.check(t, name, torch.int32, (rows,))
    hits = torch.empty((rows, 2 * cap), dtype=torch.int32, device=a.device)
    page_s = torch.empty_like(hits)
    rank_s = torch.empty_like(hits, dtype=torch.float32)
    cnt_s = torch.empty_like(rank_s)
    _cuda.MERGE_AND_LOCATE_STREAMS.launch(
        a.device, a, a_pg, na, ra, b, b_pg, nb, rb, rows, cap, hits, page_s,
        rank_s, cnt_s)
    return hits, page_s, rank_s, cnt_s


def _merge_and_locate_streams_call(core, a, na, ra, b, nb, rb, a_pg, b_pg):
    cap = a.shape[1]
    if not 0 < 2 * cap <= FUSED_AND_MAX or b.shape[1] != cap:
        raise ValueError(f"fused W=2 kernel takes equal caps with 2 cap <= "
                         f"{FUSED_AND_MAX}, got {cap}/{b.shape[1]}")
    return core(a, a_pg, na, ra, b, b_pg, nb, rb)


def merge_and_locate(a, na, ra, b, nb, rb, a_pg, b_pg):
    """W = 2 merge + AND + locate of [B, cap] posting blocks with their
    carried page streams, 2 cap <= 4096, at full width
    (pallas_merge_and_locate): (hits, page_s, rank_s, cnt_s), each
    [B, 2 cap]. hits is the kept stream in slot order (INF32 at dropped
    lanes); a run's first lane carries its page, rank and count, every
    other lane -1 / 0.0 / 0.0. compact_streams_topk or
    locate_streams_topk finish the runs, compact_hits the hits."""
    return _merge_and_locate_streams_call(
        lambda *x: _on_device(_merge_and_locate_streams_kernel,
                              _merge_and_locate_streams_plain, *x),
        a, na, ra, b, nb, rb, a_pg, b_pg)


def merge_and_locate_plain(a, na, ra, b, nb, rb, a_pg, b_pg):
    """merge_and_locate through its plain version, on any device."""
    return _merge_and_locate_streams_call(
        _merge_and_locate_streams_plain, a, na, ra, b, nb, rb, a_pg, b_pg)


def compact_streams_topk(page_s, rank_s, cnt_s, topk: int):
    """In-slot run streams [B, n] (a run's page, rank and count at its
    first lane, rank 0 elsewhere) -> the first `topk` runs in slot order
    and the exact run count (pallas_query.compact_streams_topk): (pg_c
    int32, rk_c f32, ct_c f32, each [B, topk], zeros past the row's
    runs; n_pages int32[B])."""
    start = rank_s > 0
    run = torch.cumsum(start, dim=1) - 1
    sel = torch.where(start & (run < topk), run, topk)

    def put(x):
        out = torch.zeros((x.shape[0], topk + 1), dtype=x.dtype,
                          device=x.device)
        return out.scatter(1, sel, x)[:, :topk]
    return (put(page_s), put(rank_s), put(cnt_s),
            start.sum(dim=1, dtype=torch.int32))


def locate_streams_topk(page_s, rank_s, cnt_s, topk: int):
    """The rank top-k over in-slot run streams
    (pallas_query.locate_streams_topk): the first topk runs compacted,
    then streams_topk_tail. Returns (pages -1 pad, ranks, counts int32,
    each [B, topk]; n_pages)."""
    return streams_topk_tail(*compact_streams_topk(page_s, rank_s, cnt_s,
                                                   topk), topk)


def _merge_tagged_plain(a, a_pg, na, b, b_pg, nb):
    """Plain version of docodo_merge_tagged: one stable sort on the
    packed key coord << 2 | tag (tag 0 = word A, 1 = word B, 2 =
    padding), the pages riding along."""
    a, a_pg, na, b, b_pg, nb = as_variant_blocks(a, a_pg, na, b, b_pg, nb)
    av, bv = variant_blocks(a, na), variant_blocks(b, nb)
    vals = torch.cat([av, bv], dim=1)
    tag = torch.cat([torch.where(av < INF32, 0, 2),
                     torch.where(bv < INF32, 1, 2)], dim=1).to(torch.int32)
    pg = None
    if a_pg is not None:
        pg = torch.cat([a_pg.reshape(av.shape), b_pg.reshape(bv.shape)],
                       dim=1)
    return sort_tagged(vals, tag, pg)


def _merge_tagged_kernel(a, a_pg, na, b, b_pg, nb):
    rows = a.shape[0]
    (va, cap_a), (vb, cap_b) = (
        (1, x.shape[1]) if x.dim() == 2 else x.shape[1:] for x in (a, b))
    if va + vb > 65535:
        raise ValueError(f"docodo_merge_tagged: {va} + {vb} blocks")
    for name, t, shape in (("a", a, a.shape), ("a_pg", a_pg, a.shape),
                           ("na", na, a.shape[:-1]), ("b", b, b.shape),
                           ("b_pg", b_pg, b.shape), ("nb", nb, b.shape[:-1])):
        if t is not None:
            _cuda.check(t, name, torch.int32, shape)
    dev = a.device
    vals = torch.empty((rows, va * cap_a + vb * cap_b), dtype=torch.int32,
                       device=dev)
    tag = torch.empty_like(vals)
    pg = None if a_pg is None else torch.empty_like(vals)
    # a tree of passes takes turns with the outputs in a second stream of
    # the same planes; a view of a shared buffer is made on the host like
    # a tensor of its own, so these stay separate allocations
    scratch = (None if _cuda.merge_passes(va, cap_a, vb, cap_b) <= 1 else
               vals.new_empty((2 if pg is None else 3,) + vals.shape))
    _cuda.MERGE_TAGGED.launch(dev, a, a_pg, na, b, b_pg, nb, rows, va, cap_a,
                              vb, cap_b, vals, tag, pg, scratch)
    return vals, tag, pg


def as_variant_blocks(a, a_pg, na, b, b_pg, nb):
    """merge_tagged's core arguments (a, a_pg, na, b, b_pg, nb) with a
    word's one block [B, cap] (lengths [B]) as one variant block
    [B, 1, cap] ([B, 1])."""
    one = lambda x: None if x is None else x.unsqueeze(1)
    if a.dim() == 2:
        a, a_pg, na = one(a), one(a_pg), one(na)
    if b.dim() == 2:
        b, b_pg, nb = one(b), one(b_pg), one(nb)
    return a, a_pg, na, b, b_pg, nb


def _merge_tagged_call(core, a, na, b, nb, a_pg, b_pg):
    if b is None:
        b = a.new_empty((a.shape[0], 0, 1))
        nb = na.new_empty((a.shape[0], 0))
        b_pg = None if a_pg is None else b
    if (a_pg is None) != (b_pg is None) or a.shape[0] != b.shape[0]:
        raise ValueError("merge_tagged takes blocks of one batch and both "
                         "page streams or neither")
    return core(a, a_pg, na, b, b_pg, nb)


def merge_tagged(a, na, b, nb, a_pg=None, b_pg=None):
    """Merge ascending posting blocks into one stream in (coord, tag)
    order: word A's blocks a [B, Va, cap_a] (lengths na [B, Va]), or one
    block a [B, cap_a] (na [B]), and word B's likewise, or None for no
    word B. Equal (coord, tag) lanes keep block order. Returns (vals
    [B, Va cap_a + Vb cap_b] INF32-padded, tag 0 / 1 / 2 for word A /
    word B / padding, pages or None). Pages at padding lanes are
    unspecified."""
    return _merge_tagged_call(
        lambda *x: _on_device(_merge_tagged_kernel, _merge_tagged_plain, *x),
        a, na, b, nb, a_pg, b_pg)


def merge_tagged_plain(a, na, b, nb, a_pg=None, b_pg=None):
    """merge_tagged through its plain version, on any device."""
    return _merge_tagged_call(_merge_tagged_plain, a, na, b, nb, a_pg, b_pg)


def _and_keep_plain(vals, tag, ra, rb):
    """Plain version of docodo_and_keep: the W = 2 slot kernel's fold and
    segmentation over the already merged stream."""
    valid = vals < INF32
    isa, isb, ghost = fold_dups(vals, (tag == 0) & valid, (tag == 1) & valid,
                                valid)
    keep = segment_and(vals, isa, isb, ghost, valid, combine_r(ra, rb))
    return torch.where(keep, vals, INF32)


def _compact_kept(hv, pg):
    """A kept stream's values (and pages) moved to the front in order,
    INF32 after them, and their count."""
    keep = hv < INF32
    n = hv.shape[1]
    slot = torch.where(keep, torch.cumsum(keep, dim=1) - 1, n)

    def put(x):
        out = torch.full((hv.shape[0], n + 1), INF32, dtype=torch.int32,
                         device=hv.device)
        return out.scatter(1, slot, x)[:, :n]
    return (put(hv), None if pg is None else put(pg),
            keep.sum(dim=1, dtype=torch.int32))


def _keep_launch(kernel, vals, tag, ra, rb, bpad, pg, compact: bool):
    """Launch docodo_and_keep or docodo_variants_keep: the kept stream
    hv, or with `compact` (cvals, cpages or None, count)."""
    rows, n = vals.shape
    _cuda.check(vals, "vals", torch.int32, (rows, n))
    _cuda.check(tag, "tag", torch.int32, (rows, n))
    for name, t in (("ra", ra), ("rb", rb), ("bpad", bpad)):
        if t is not None:
            _cuda.check(t, name, torch.int32, (rows,))
    if pg is not None:
        _cuda.check(pg, "pg", torch.int32, (rows, n))
    dev = vals.device
    hv = torch.empty_like(vals)
    seg = torch.empty((rows, n + 1, 2), dtype=torch.int32, device=dev)
    cvals = cpg = count = None
    if compact:
        cvals = torch.empty_like(vals)
        cpg = None if pg is None else torch.empty_like(vals)
        count = torch.empty((rows,), dtype=torch.int32, device=dev)
    args = (vals, tag, ra, rb) + ((bpad,) if kernel is _cuda.VARIANTS_KEEP
                                  else ())
    scratch = _cuda.tile_scratch("docodo_keep_scratch", dev, rows, n)
    kernel.launch(dev, *args, pg, rows, n, hv, seg, cvals, cpg, count,
                  *scratch)
    return (cvals, cpg, count) if compact else hv


def _and_keep_kernel(vals, tag, ra, rb):
    return _keep_launch(_cuda.AND_KEEP, vals, tag, ra, rb, None, None, False)


def and_keep(vals, tag, ra, rb):
    """Proximity-AND over a merged tagged stream [B, n] of any width with
    the words' windows ra / rb [B] (pallas_chunked_and): the kept stream,
    the value at kept lanes and INF32 elsewhere. Runs of equal
    coordinates must be at most two lanes long (one lane of each
    word)."""
    return _on_device(_and_keep_kernel, _and_keep_plain, vals, tag, ra, rb)


def and_keep_plain(vals, tag, ra, rb):
    """and_keep through its plain version, on any device."""
    return _and_keep_plain(vals, tag, ra, rb)


def _and_keep_compact_plain(vals, tag, ra, rb, pg):
    """Plain version of and_keep_compact."""
    return _compact_kept(_and_keep_plain(vals, tag, ra, rb), pg)


def _and_keep_compact_kernel(vals, tag, ra, rb, pg):
    return _keep_launch(_cuda.AND_KEEP, vals, tag, ra, rb, None, pg, True)


def and_keep_compact(vals, tag, ra, rb, pg=None):
    """and_keep with its kept values compacted, as a step of a W >= 3
    fold feeds them to the next merge: (cvals [B, n] ascending, INF32
    after the kept ones; their pages from pg [B, n] or None; count [B]).
    The same kernel as and_keep, writing the compacted stream in its
    second sweep."""
    return _on_device(_and_keep_compact_kernel, _and_keep_compact_plain,
                      vals, tag, ra, rb, pg)


def and_keep_compact_plain(vals, tag, ra, rb, pg=None):
    """and_keep_compact through its plain version, on any device."""
    return _and_keep_compact_plain(vals, tag, ra, rb, pg)


# ---------------------------------------------------------------------------
# kernel G: the variants AND's kept stream, any width
# ---------------------------------------------------------------------------

def _variants_keep_plain(vals, tag, ra, rb, bpad):
    """Plain version of docodo_variants_keep: and_variants_sorted's keep
    over the already merged stream."""
    keep = variants_keep_mask(vals, tag, ra, rb, bpad != 0)
    return torch.where(keep, vals, INF32)


def _variants_keep_kernel(vals, tag, ra, rb, bpad):
    return _keep_launch(_cuda.VARIANTS_KEEP, vals, tag, ra, rb, bpad, None,
                        False)


def variants_keep(vals, tag, ra, rb, bpad):
    """Proximity-AND of two variant ORs over their merged (coord, tag)
    stream [B, n] of any width (pallas_chunked_variants_and): each run
    of equal coordinates folds onto its first lane with every word of
    the run; rows with bpad [B] keep the run starts (word A's union).
    Returns the kept stream, INF32 at dropped lanes."""
    return _on_device(_variants_keep_kernel, _variants_keep_plain, vals, tag,
                      ra, rb, bpad.to(torch.int32))


def variants_keep_plain(vals, tag, ra, rb, bpad):
    """variants_keep through its plain version, on any device."""
    return _variants_keep_plain(vals, tag, ra, rb, bpad.to(torch.int32))


def _locate_runs_plain(hv, pg, bounds, kpad, hpad, keep=(0, INF32)):
    """Plain version of docodo_locate_runs."""
    page = pg if pg is not None else shared_pg(hv, bounds)
    kept = hv < INF32
    if keep != (0, INF32):
        kept = kept & (hv >= keep[0]) & (hv < keep[1])
        hv = torch.where(kept, hv, INF32)
    return locate_compact(hv, kept, page, kpad, hpad)


def _locate_runs_kernel(hv, pg, bounds, kpad, hpad, keep=(0, INF32)):
    rows, n = hv.shape
    _cuda.check(hv, "hv", torch.int32, (rows, n))
    if pg is not None:
        _cuda.check(pg, "pg", torch.int32, (rows, n))
    _cuda.check(bounds, "bounds", torch.int32, (bounds.shape[0],))
    outs = _cuda.full_result_outputs(rows, kpad, hpad, hv.device)
    scratch = _cuda.tile_scratch("docodo_locate_runs_scratch", hv.device,
                                 rows, n, kpad)
    _cuda.LOCATE_RUNS.launch(hv.device, hv, pg, bounds, bounds.shape[0],
                             rows, n, kpad, hpad, *keep, *outs, *scratch)
    return outs


def _locate_runs_call(core, hv, bounds, topk, hit_cap, pg, keep):
    n = hv.shape[1]
    lo, hi = (0, INF32) if keep is None else (int(keep[0]), int(keep[1]))
    if not 0 <= lo <= hi <= INF32:
        raise ValueError(f"locate_runs: keep range {keep} outside "
                         f"[0, {INF32}]")
    outs = core(hv, pg, bounds, min(topk, n), min(hit_cap, n), (lo, hi))
    return _slots_glue(outs, topk, hit_cap, tail=False)


def locate_runs(hv, bounds, *, topk: int, hit_cap: int, pg=None,
                keep=None):
    """Page runs of a kept stream hv [B, n] of any width (INF32 at
    dropped lanes, kept values ascending), pages carried in pg or looked
    up in bounds (pallas_chunked_locate with tail=False, plus the hits
    compaction of device_index._locate_full_chunked). keep: a value range
    (lo, hi); kept values outside it are dropped as well (a document
    shard's postings of its neighbours). Returns (pg_c, rk_c, ct_c
    [B, topk], n_pages, n_hits, hits [B, hit_cap])."""
    return _locate_runs_call(
        lambda *x: _on_device(_locate_runs_kernel, _locate_runs_plain, *x),
        hv, bounds, topk, hit_cap, pg, keep)


def locate_runs_plain(hv, bounds, *, topk: int, hit_cap: int, pg=None,
                      keep=None):
    """locate_runs through its plain version, on any device."""
    return _locate_runs_call(_locate_runs_plain, hv, bounds, topk, hit_cap,
                             pg, keep)


# ---------------------------------------------------------------------------
# the page-level kernels: every run ranked, the top k picked in the kernel
# ---------------------------------------------------------------------------

def runs_topk(pg, rk, ct, topk: int):
    """The top `topk` of a row's page runs (pages, ranks, counts, each
    [B, n] in run order, rank 0 past the runs) by (rank descending, run
    ordinal ascending): plain version of the kernels' locate_topk_tail
    (pallas_query._locate_rank_topk). Returns (pages -1 pad, ranks
    0 pad, counts int32 0 pad), each [B, topk]; topk may exceed n."""
    bsz, n = rk.shape
    if n < topk:
        z = topk - n
        pg = torch.cat([pg, pg.new_full((bsz, z), -1)], dim=1)
        rk = torch.cat([rk, rk.new_zeros((bsz, z))], dim=1)
        ct = torch.cat([ct, ct.new_zeros((bsz, z))], dim=1)
    top_rank, top_slot = topk_nonneg(rk, topk)
    valid = top_rank > 0
    return (torch.where(valid, select_slots(pg, top_slot), -1), top_rank,
            torch.where(valid, select_slots(ct, top_slot), 0))


def _masked_topk(vals, keep, page, topk: int):
    pg, rk, ct, _ = page_runs(vals, keep, page, vals.shape[1])
    return runs_topk(pg, rk, ct, topk)


def _and_topk_plain(a, a_pg, na, ra, b, b_pg, nb, rb, bounds, topk):
    """Plain version of docodo_and_locate_topk: the plain merge, the
    plain AND keep, every run ranked, the plain top-k. Without page
    streams the merged lanes' pages are looked up in bounds."""
    vals, tag, page = _merge_tagged_plain(a, a_pg, na, b, b_pg, nb)
    if page is None:
        page = shared_pg(vals, bounds)
    keep = _and_keep_plain(vals, tag, ra, rb) < INF32
    return _masked_topk(vals, keep, page, topk)


def _topk_outputs(rows: int, topk: int, dev):
    return (torch.empty((rows, topk), dtype=torch.int32, device=dev),
            torch.empty((rows, topk), dtype=torch.float32, device=dev),
            torch.empty((rows, topk), dtype=torch.int32, device=dev))


def _and_topk_kernel(a, a_pg, na, ra, b, b_pg, nb, rb, bounds, topk):
    rows, cap = a.shape
    if not 0 < cap <= MAX_SORTED_PALLAS_CAP or topk <= 0:
        raise ValueError(f"docodo_and_locate_topk: cap {cap}, topk {topk}")
    for name, t in (("a", a), ("a_pg", a_pg), ("b", b), ("b_pg", b_pg)):
        if t is not None:
            _cuda.check(t, name, torch.int32, (rows, cap))
    for name, t in (("na", na), ("ra", ra), ("nb", nb), ("rb", rb)):
        _cuda.check(t, name, torch.int32, (rows,))
    _cuda.check(bounds, "bounds", torch.int32, (bounds.shape[0],))
    outs = _topk_outputs(rows, topk, a.device)
    _cuda.AND_LOCATE_TOPK.launch(a.device, a, a_pg, na, ra, b, b_pg, nb, rb,
                                 bounds, bounds.shape[0], rows, cap, topk,
                                 *outs)
    return outs


def _and_topk_call(core, a, na, ra, b, nb, rb, bounds, topk, a_pg, b_pg):
    cap = a.shape[1]
    if cap > MAX_SORTED_PALLAS_CAP or b.shape[1] != cap:
        raise ValueError(f"page-level W=2 kernel takes equal caps <= "
                         f"{MAX_SORTED_PALLAS_CAP}, got {cap}/{b.shape[1]}")
    if (a_pg is None) != (b_pg is None):
        raise ValueError("both page streams or neither")
    return core(a, a_pg, na, ra, b, b_pg, nb, rb, bounds, topk)


def sorted_and_locate(a, na, ra, b, nb, rb, bounds, *, topk: int,
                      a_pg=None, b_pg=None):
    """Page-level W = 2 AND + locate + top-k over [B, cap <= 512] posting
    blocks a / b with lengths na / nb and windows ra / rb
    (pallas_sorted_and_locate): every page run of the row is ranked and
    the best topk by (rank descending, lane ascending) come back as
    (pages int32 -1 pad, ranks f32, counts int32), each [B, topk]. Pages
    come from the carried streams a_pg / b_pg, or are looked up in
    bounds inside the kernel; topk may exceed 2 cap."""
    return _and_topk_call(
        lambda *x: _on_device(_and_topk_kernel, _and_topk_plain, *x),
        a, na, ra, b, nb, rb, bounds, topk, a_pg, b_pg)


def sorted_and_locate_plain(a, na, ra, b, nb, rb, bounds, *, topk: int,
                            a_pg=None, b_pg=None):
    """sorted_and_locate through its plain version, on any device."""
    return _and_topk_call(_and_topk_plain, a, na, ra, b, nb, rb, bounds,
                          topk, a_pg, b_pg)


def batched_and_locate(a, na, ra, b, nb, rb, bounds, *, topk: int):
    """pallas_batched_and_locate: sorted_and_locate's function with the
    pages always looked up in bounds (the TPU kernel merges by
    compare-all inside; here both are one kernel)."""
    return sorted_and_locate(a, na, ra, b, nb, rb, bounds, topk=topk)


def batched_and_locate_plain(a, na, ra, b, nb, rb, bounds, *, topk: int):
    """batched_and_locate through its plain version, on any device."""
    return sorted_and_locate_plain(a, na, ra, b, nb, rb, bounds, topk=topk)


def _single_topk_plain(a, a_pg, na, bounds, topk):
    """Plain version of docodo_single_locate_topk: the block's first na
    slots are the kept stream."""
    lane = torch.arange(a.shape[1], device=a.device)[None, :]
    keep = lane < na[:, None]
    vals = torch.where(keep, a, INF32)
    page = a_pg if a_pg is not None else shared_pg(vals, bounds)
    return _masked_topk(vals, keep, page, topk)


def _single_topk_kernel(a, a_pg, na, bounds, topk):
    rows, cap = a.shape
    if not 0 < cap <= MAX_PALLAS_CAP or topk <= 0:
        raise ValueError(f"docodo_single_locate_topk: cap {cap}, topk "
                         f"{topk}")
    _cuda.check(a, "a", torch.int32, (rows, cap))
    if a_pg is not None:
        _cuda.check(a_pg, "a_pg", torch.int32, (rows, cap))
    _cuda.check(na, "na", torch.int32, (rows,))
    _cuda.check(bounds, "bounds", torch.int32, (bounds.shape[0],))
    outs = _topk_outputs(rows, topk, a.device)
    _cuda.SINGLE_LOCATE_TOPK.launch(a.device, a, a_pg, na, bounds,
                                    bounds.shape[0], rows, cap, topk, *outs)
    return outs


def _single_topk_call(core, a, na, bounds, topk, a_pg):
    cap = a.shape[1]
    if cap > MAX_PALLAS_CAP:
        raise ValueError(f"page-level W=1 kernel takes caps <= "
                         f"{MAX_PALLAS_CAP}, got {cap}")
    return core(a, a_pg, na, bounds, topk)


def batched_single_locate(a, na, bounds, *, topk: int, a_pg=None):
    """Page-level W = 1 locate + top-k over [B, cap <= 128] posting
    blocks (pallas_batched_single_locate); outputs and page sources as
    sorted_and_locate."""
    return _single_topk_call(
        lambda *x: _on_device(_single_topk_kernel, _single_topk_plain, *x),
        a, na, bounds, topk, a_pg)


def batched_single_locate_plain(a, na, bounds, *, topk: int, a_pg=None):
    """batched_single_locate through its plain version, on any device."""
    return _single_topk_call(_single_topk_plain, a, na, bounds, topk, a_pg)
