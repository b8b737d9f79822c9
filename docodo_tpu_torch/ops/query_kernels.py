"""The slice's full-result kernels: twin of docodo_tpu/ops/pallas_query.py.

Seven wrappers, one per hand-written CUDA kernel (csrc/locate_full.cu,
csrc/chunked.cu), each with its plain PyTorch version beside it:

  sorted_and_locate_full  W = 2, cap <= 512   (pallas_query.py:1164)
  single_locate_full      W = 1, cap <= 128   (pallas_query.py:1243)
  union_locate_full       W = 1, V = 1, cap <= 1024 (pallas_query.py:977)
  merge_and_locate_topk   W = 2, 2 cap <= 4096 (pallas_query.py:2739)
  merge_tagged            two sorted blocks -> one (coord, tag) stream
                          (pallas_query.py:2332)
  and_keep                the AND's kept stream, any width
                          (pallas_query.py:2810)
  locate_runs             page runs of a kept stream, any width
                          (pallas_query.py:1769)

A wrapper launches its kernel for CUDA tensors and takes the plain
version for CPU tensors only; any other device raises. The plain
versions run on any device, so a run on the card can hold each kernel
against its plain version on the same inputs.

The full-result wrappers return the slot-mode outputs of
`_full_stream_call_slots` (pallas_query.py:826): the first min(topk, n)
page runs in slot order, padded to topk with -1 / 0 / 0, n_pages and
n_hits, and the first hit_cap kept hits, INF32 padded; with tail=True
the rank top-k of those runs (streams_topk_tail) replaces the runs.
"""

from __future__ import annotations

import torch

from docodo_tpu_torch.ops import _cuda
from docodo_tpu_torch.ops.seqops import (
    INF32,
    combine_r,
    fold_dups,
    locate_compact,
    segment_and,
    select_slots,
    topk_nonneg,
)

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


def _slots_glue(outs, topk: int, hit_cap: int, tail: bool):
    """Pad the kernel's first-kpad runs to topk (-1 / 0 / 0) and its
    first-hpad hits to hit_cap (INF32); with `tail`, finish the rank
    top-k (pallas_query.py:875-899)."""
    pg_c, rk_c, ct_c, n_pages, n_hits, hits = outs
    bsz, kpad = pg_c.shape
    if kpad < topk:
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


def _on_device(kernel, plain, *args):
    """The kernel for CUDA tensors, the plain version for CPU ones."""
    dev = args[0].device
    if dev.type == "cuda":
        return kernel(*args)
    if dev.type == "cpu":
        return plain(*args)
    raise ValueError(f"no kernel for device {dev}")


# ---------------------------------------------------------------------------
# W = 2: sorted AND + locate
# ---------------------------------------------------------------------------

def _sorted_and_plain(a, a_pg, na, ra, b, b_pg, nb, rb, kpad, hpad):
    """Plain version of docodo_sorted_and_locate_full: a stable sort on
    coord << 2 | tag merges the operands (tag 0 = word A, 1 = word B,
    2 = padding), then the AND keep and the locate tail."""
    lane = torch.arange(a.shape[1], device=a.device)[None, :]
    ia = lane < na[:, None]
    ib = lane < nb[:, None]
    vals = torch.cat([torch.where(ia, a, INF32), torch.where(ib, b, INF32)],
                     dim=1)
    tag = torch.cat([torch.where(ia, 0, 2), torch.where(ib, 1, 2)], dim=1)
    order = torch.sort((vals.long() << 2) | tag, dim=1, stable=True).indices
    vals = torch.gather(vals, 1, order)
    tag = torch.gather(tag, 1, order)
    page = torch.gather(torch.cat([a_pg, b_pg], dim=1), 1, order)
    valid = vals < INF32
    isa, isb, ghost = fold_dups(vals, (tag == 0) & valid, (tag == 1) & valid,
                                valid)
    keep = segment_and(vals, isa, isb, ghost, valid, combine_r(ra, rb))
    return locate_compact(vals, keep, page, kpad, hpad)


def _sorted_and_kernel(a, a_pg, na, ra, b, b_pg, nb, rb, kpad, hpad):
    return _cuda.full_result(_cuda.SORTED_AND,
                             [a, a_pg, na, ra, b, b_pg, nb, rb],
                             2 * a.shape[1], 2 * MAX_SORTED_PALLAS_CAP,
                             kpad, hpad)


def _sorted_and_call(core, a, na, ra, b, nb, rb, bounds, topk, hit_cap,
                     a_pg, b_pg, tail):
    cap = a.shape[1]
    if cap > MAX_SORTED_PALLAS_CAP or b.shape[1] != cap:
        raise ValueError(f"W=2 kernel takes equal caps <= "
                         f"{MAX_SORTED_PALLAS_CAP}, got {cap}/{b.shape[1]}")
    if a_pg is None:
        a_pg = shared_pg(_masked(a, na), bounds)
        b_pg = shared_pg(_masked(b, nb), bounds)
    n = 2 * cap
    outs = core(a, a_pg, na, ra, b, b_pg, nb, rb, min(topk, n),
                min(hit_cap, n))
    return _slots_glue(outs, topk, hit_cap, tail)


def sorted_and_locate_full(a, na, ra, b, nb, rb, bounds, *, topk: int,
                           hit_cap: int, a_pg=None, b_pg=None,
                           tail: bool = True):
    """W = 2 full-result AND + locate over [B, cap] posting blocks
    a / b with lengths na / nb and windows ra / rb (all int32).
    a_pg / b_pg: the blocks' page streams, carried from the posting
    fetch; without them the pages are looked up here (shared_pg).
    Returns (pages, ranks, counts, n_pages, n_hits, hits[B, hit_cap]),
    or with tail=False the first-topk runs (pg_c, rk_c, ct_c) in place
    of the first three."""
    return _sorted_and_call(
        lambda *x: _on_device(_sorted_and_kernel, _sorted_and_plain, *x),
        a, na, ra, b, nb, rb, bounds, topk, hit_cap, a_pg, b_pg, tail)


def sorted_and_locate_full_plain(a, na, ra, b, nb, rb, bounds, *,
                                 topk: int, hit_cap: int, a_pg=None,
                                 b_pg=None, tail: bool = True):
    """sorted_and_locate_full through its plain version, on any device."""
    return _sorted_and_call(_sorted_and_plain, a, na, ra, b, nb, rb, bounds,
                            topk, hit_cap, a_pg, b_pg, tail)


# ---------------------------------------------------------------------------
# W = 1: single word, and the V = 1 union
# ---------------------------------------------------------------------------

def _single_plain(a, a_pg, na, kpad, hpad):
    """Plain version of docodo_single_locate_full: the block's first na
    slots are the kept stream."""
    lane = torch.arange(a.shape[1], device=a.device)[None, :]
    keep = lane < na[:, None]
    return locate_compact(torch.where(keep, a, INF32), keep, a_pg, kpad,
                          hpad)


def _single_kernel(a, a_pg, na, kpad, hpad):
    return _cuda.full_result(_cuda.SINGLE, [a, a_pg, na], a.shape[1],
                             MAX_PALLAS_CAP, kpad, hpad)


def _union_plain(a, a_pg, na, kpad, hpad):
    """Plain version of docodo_union_locate_full: a slot is kept where it
    is valid and differs from the previous slot."""
    vals = _masked(a, na)
    prev = torch.cat([torch.full_like(vals[:, :1], -1), vals[:, :-1]],
                     dim=1)
    keep = (vals < INF32) & (vals != prev)
    return locate_compact(vals, keep, a_pg, kpad, hpad)


def _union_kernel(a, a_pg, na, kpad, hpad):
    return _cuda.full_result(_cuda.UNION, [a, a_pg, na], a.shape[1],
                             MAX_STREAM_WIDTH, kpad, hpad)


def _w1_call(core, limit, a, na, bounds, topk, hit_cap, a_pg, tail):
    cap = a.shape[1]
    if cap > limit:
        raise ValueError(f"W=1 kernel takes caps <= {limit}, got {cap}")
    if a_pg is None:
        a_pg = shared_pg(_masked(a, na), bounds)
    outs = core(a, a_pg, na, min(topk, cap), min(hit_cap, cap))
    return _slots_glue(outs, topk, hit_cap, tail)


def single_locate_full(a, na, bounds, *, topk: int, hit_cap: int,
                       a_pg=None, tail: bool = True):
    """W = 1 full-result locate over [B, cap <= 128] posting blocks;
    outputs as sorted_and_locate_full."""
    return _w1_call(
        lambda *x: _on_device(_single_kernel, _single_plain, *x),
        MAX_PALLAS_CAP, a, na, bounds, topk, hit_cap, a_pg, tail)


def single_locate_full_plain(a, na, bounds, *, topk: int, hit_cap: int,
                             a_pg=None, tail: bool = True):
    """single_locate_full through its plain version, on any device."""
    return _w1_call(_single_plain, MAX_PALLAS_CAP, a, na, bounds, topk,
                    hit_cap, a_pg, tail)


def _v1(a, na, a_pg):
    if a.dim() != 3 or a.shape[1] != 1:
        raise NotImplementedError(
            "union_locate_full takes one variant ([B, 1, cap]); V > 1 is "
            "ROADMAP Queue B (b), the wide surface")
    return a[:, 0], na[:, 0], None if a_pg is None else a_pg[:, 0]


def union_locate_full(a, na, bounds, *, topk: int, hit_cap: int,
                      a_pg=None, tail: bool = True):
    """W = 1 full-result locate of one word's variant union, V = 1:
    a [B, 1, cap <= 1024], na [B, 1]; outputs as
    sorted_and_locate_full."""
    a, na, a_pg = _v1(a, na, a_pg)
    return _w1_call(
        lambda *x: _on_device(_union_kernel, _union_plain, *x),
        MAX_STREAM_WIDTH, a, na, bounds, topk, hit_cap, a_pg, tail)


def union_locate_full_plain(a, na, bounds, *, topk: int, hit_cap: int,
                            a_pg=None, tail: bool = True):
    """union_locate_full through its plain version, on any device."""
    a, na, a_pg = _v1(a, na, a_pg)
    return _w1_call(_union_plain, MAX_STREAM_WIDTH, a, na, bounds, topk,
                    hit_cap, a_pg, tail)


# ---------------------------------------------------------------------------
# the chunked family: W <= 2 buckets past slot admission
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


def _merge_tagged_plain(a, a_pg, na, b, b_pg, nb):
    """Plain version of docodo_merge_tagged: one stable sort on the
    packed key coord << 2 | tag (tag 0 = word A, 1 = word B, 2 =
    padding), the pages riding along."""
    lane = torch.arange(a.shape[1], device=a.device)[None, :]
    ia = lane < na[:, None]
    ib = lane < nb[:, None]
    vals = torch.cat([torch.where(ia, a, INF32), torch.where(ib, b, INF32)],
                     dim=1)
    tag = torch.cat([torch.where(ia, 0, 2), torch.where(ib, 1, 2)],
                    dim=1).to(torch.int32)
    order = torch.sort((vals.long() << 2) | tag, dim=1, stable=True).indices
    pg = None
    if a_pg is not None:
        pg = torch.gather(torch.cat([a_pg, b_pg], dim=1), 1, order)
    return torch.gather(vals, 1, order), torch.gather(tag, 1, order), pg


def _merge_tagged_kernel(a, a_pg, na, b, b_pg, nb):
    rows, cap = a.shape
    for name, t in (("a", a), ("b", b), ("a_pg", a_pg), ("b_pg", b_pg)):
        if t is not None:
            _cuda.check(t, name, torch.int32, (rows, cap))
    _cuda.check(na, "na", torch.int32, (rows,))
    _cuda.check(nb, "nb", torch.int32, (rows,))
    dev = a.device
    vals = torch.empty((rows, 2 * cap), dtype=torch.int32, device=dev)
    tag = torch.empty_like(vals)
    pg = None if a_pg is None else torch.empty_like(vals)
    _cuda.MERGE_TAGGED.launch(dev, a, a_pg, na, b, b_pg, nb, rows, cap,
                              vals, tag, pg)
    return vals, tag, pg


def _merge_tagged_call(core, a, na, b, nb, a_pg, b_pg):
    if b.shape != a.shape or (a_pg is None) != (b_pg is None):
        raise ValueError("merge_tagged takes equal-shape blocks and both "
                         "page streams or neither")
    return core(a, a_pg, na, b, b_pg, nb)


def merge_tagged(a, na, b, nb, a_pg=None, b_pg=None):
    """Merge two [B, cap] ascending posting blocks (lengths na / nb) into
    one [B, 2 cap] stream in (coord, tag) order: (vals INF32-padded,
    tag 0 / 1 / 2 for word A / word B / padding, pages or None). Pages
    at padding lanes are unspecified."""
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


def _and_keep_kernel(vals, tag, ra, rb):
    rows, n = vals.shape
    _cuda.check(vals, "vals", torch.int32, (rows, n))
    _cuda.check(tag, "tag", torch.int32, (rows, n))
    _cuda.check(ra, "ra", torch.int32, (rows,))
    _cuda.check(rb, "rb", torch.int32, (rows,))
    hv = torch.empty_like(vals)
    seg = torch.empty((rows, n + 1, 2), dtype=torch.int32, device=vals.device)
    _cuda.AND_KEEP.launch(vals.device, vals, tag, ra, rb, rows, n, hv, seg)
    return hv


def and_keep(vals, tag, ra, rb):
    """Proximity-AND over a merged tagged stream [B, n] of any width with
    the words' windows ra / rb [B] (pallas_chunked_and): the kept stream,
    the value at kept lanes and INF32 elsewhere."""
    return _on_device(_and_keep_kernel, _and_keep_plain, vals, tag, ra, rb)


def and_keep_plain(vals, tag, ra, rb):
    """and_keep through its plain version, on any device."""
    return _and_keep_plain(vals, tag, ra, rb)


def _locate_runs_plain(hv, pg, bounds, kpad, hpad):
    """Plain version of docodo_locate_runs."""
    page = pg if pg is not None else shared_pg(hv, bounds)
    return locate_compact(hv, hv < INF32, page, kpad, hpad)


def _locate_runs_kernel(hv, pg, bounds, kpad, hpad):
    rows, n = hv.shape
    _cuda.check(hv, "hv", torch.int32, (rows, n))
    if pg is not None:
        _cuda.check(pg, "pg", torch.int32, (rows, n))
    _cuda.check(bounds, "bounds", torch.int32, (bounds.shape[0],))
    outs = _cuda.full_result_outputs(rows, kpad, hpad, hv.device)
    _cuda.LOCATE_RUNS.launch(hv.device, hv, pg, bounds, bounds.shape[0],
                             rows, n, kpad, hpad, *outs)
    return outs


def _locate_runs_call(core, hv, bounds, topk, hit_cap, pg):
    n = hv.shape[1]
    outs = core(hv, pg, bounds, min(topk, n), min(hit_cap, n))
    return _slots_glue(outs, topk, hit_cap, tail=False)


def locate_runs(hv, bounds, *, topk: int, hit_cap: int, pg=None):
    """Page runs of a kept stream hv [B, n] of any width (INF32 at
    dropped lanes, kept values ascending), pages carried in pg or looked
    up in bounds (pallas_chunked_locate with tail=False, plus the hits
    compaction of device_index._locate_full_chunked). Returns
    (pg_c, rk_c, ct_c [B, topk], n_pages, n_hits, hits [B, hit_cap])."""
    return _locate_runs_call(
        lambda *x: _on_device(_locate_runs_kernel, _locate_runs_plain, *x),
        hv, bounds, topk, hit_cap, pg)


def locate_runs_plain(hv, bounds, *, topk: int, hit_cap: int, pg=None):
    """locate_runs through its plain version, on any device."""
    return _locate_runs_call(_locate_runs_plain, hv, bounds, topk, hit_cap,
                             pg)
