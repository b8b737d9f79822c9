"""Each CUDA kernel of docodo_tpu_torch against its plain PyTorch
version, on a CUDA card; every kernel test skips without one (one test
reads the kernel sources as text and needs no card). The module
imports no jax, so on a GPU machine without jax it runs alone:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: int fields and hits exact; ranks within 1 ulp (the kernel's
logf and torch.log on the card)."""

import importlib.util
import json
import os
import re
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from docodo_tpu_torch.ops import query_kernels as qk

INF32 = 2**31 - 1
BOUNDS = np.arange(1, 80, dtype=np.int32) * 60
FIELDS = ("pg_c", "rk_c", "ct_c", "n_pages", "n_hits", "hits")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


def _batch(rng, bsz, cap):
    """Two ascending subsets of one pool per row (shared coordinates),
    empty and full rows, both window signs."""
    pool = np.cumsum(rng.integers(1, 30, size=(bsz, 2 * cap)), axis=1)
    pick = lambda: np.sort(np.argsort(rng.random((bsz, 2 * cap)), axis=1)
                           [:, :cap], axis=1)
    a = np.take_along_axis(pool, pick(), axis=1).astype(np.int32)
    b = np.take_along_axis(pool, pick(), axis=1).astype(np.int32)
    na = rng.integers(0, cap + 1, bsz).astype(np.int32)
    nb = rng.integers(0, cap + 1, bsz).astype(np.int32)
    na[::7], nb[1::7], na[2::5], nb[2::5] = 0, 0, cap, cap
    ra = np.where(np.arange(bsz) % 2 == 0, 25, -25).astype(np.int32)
    rb = np.where(np.arange(bsz) % 2 == 0, 20, -20).astype(np.int32)
    return a, na, ra, b, nb, rb


def _pages(x):
    return np.minimum(np.searchsorted(BOUNDS, x, side="right"),
                      BOUNDS.size - 1).astype(np.int32)


def _w1_rows(rng, a, na, cap, dups):
    """A W = 1 batch's lengths past cap on every 11th row (clamped to
    cap) and, with `dups`, about one lane in ten holding the value of the
    lane before it (the V = 1 union keeps one lane of each run)."""
    na = na.copy()
    na[3::11] = cap + 9
    if dups:
        lane = np.arange(cap)[None, :]
        src = np.where(rng.random(a.shape) < 0.1, np.maximum(lane - 1, 0),
                       lane)
        a = np.take_along_axis(a, src, axis=1)
    return a, na


# (kernel, cap, rows): the W = 2 slot kernel at two widths, and the W = 1
# kernel (row 2 at caps 64 / 128, row 3 at V = 1 at caps 256-1024) at one
# wave (128 rows, a lane a thread) and past it (4096 rows, 4 lanes a
# thread), at rows that leave the last block part-filled, and at caps that
# are not a multiple of 4 (scalar loads)
@pytest.mark.cuda
@pytest.mark.parametrize("name,cap,rows", [
    ("sorted_and_locate_full", 64, 512), ("sorted_and_locate_full", 512, 512),
    ("single_locate_full", 128, 512), ("union_locate_full", 1024, 512),
    ("single_locate_full", 64, 128), ("single_locate_full", 64, 4096),
    ("single_locate_full", 128, 128), ("single_locate_full", 128, 4096),
    ("single_locate_full", 64, 1), ("single_locate_full", 128, 7),
    ("single_locate_full", 64, 129), ("single_locate_full", 126, 129),
    ("single_locate_full", 126, 4096),
    ("union_locate_full", 256, 128), ("union_locate_full", 256, 4096),
    ("union_locate_full", 512, 128), ("union_locate_full", 512, 4096),
    ("union_locate_full", 1024, 128), ("union_locate_full", 1024, 4096),
    ("union_locate_full", 256, 1), ("union_locate_full", 512, 7),
    ("union_locate_full", 1024, 129), ("union_locate_full", 250, 4096),
    ("union_locate_full", 1001, 7),
])
def test_kernel_matches_plain_on_card(cuda_device, name, cap, rows):
    rng = np.random.default_rng(cap)
    a, na, ra, b, nb, rb = _batch(rng, rows, cap)
    if name != "sorted_and_locate_full":
        a, na = _w1_rows(rng, a, na, cap, name == "union_locate_full")
    c = lambda x: torch.as_tensor(x, device=cuda_device)
    topk = 16
    kw = dict(topk=topk, hit_cap=1024, tail=False)
    if name == "sorted_and_locate_full":
        args = (c(a), c(na), c(ra), c(b), c(nb), c(rb), c(BOUNDS))
        kw.update(a_pg=c(_pages(a)), b_pg=c(_pages(b)))
    elif name == "single_locate_full":
        args = (c(a), c(na), c(BOUNDS))
        kw.update(a_pg=c(_pages(a)))
    else:
        args = (c(a)[:, None], c(na)[:, None], c(BOUNDS))
        kw.update(a_pg=c(_pages(a))[:, None])
    got = getattr(qk, name)(*args, **kw)
    torch.cuda.synchronize()
    want = getattr(qk, name + "_plain")(*args, **kw)
    for field, g, w in zip(FIELDS, got, want):
        g, w = g.cpu(), w.cpu()
        if field == "rk_c":
            d = (g.view(torch.int32).long() - w.view(torch.int32).long())
            assert int(d.abs().max()) <= 1, field
        else:
            assert torch.equal(g, w), field
    if rows > 2:  # row 2 is full
        assert int(got[3].max()) > topk  # rows with more runs than topk
    if name == "union_locate_full" and rows > 2:  # duplicates dropped
        assert bool((got[4].cpu() < torch.as_tensor(na).clamp(0, cap))
                    .any())


@pytest.mark.cuda
def test_kernel_rejects_what_it_cannot_take(cuda_device):
    a = torch.zeros((8, 256), dtype=torch.int32, device=cuda_device)
    n = torch.zeros(8, dtype=torch.int32, device=cuda_device)
    bounds = torch.as_tensor(BOUNDS, device=cuda_device)
    with pytest.raises(ValueError, match="caps <= 128"):
        qk.single_locate_full(a, n, bounds, topk=8, hit_cap=64, a_pg=a)
    with pytest.raises(ValueError, match="contiguous"):
        qk.single_locate_full(a[:, ::2], n, bounds, topk=8, hit_cap=64,
                              a_pg=a[:, ::2])


def _merged(rng, bsz, cap, dev, page=None):
    """_batch's blocks with pages: of BOUNDS, or with `page` of pages of
    that many coordinates over the whole pool."""
    a, na, ra, b, nb, rb = _batch(rng, bsz, cap)
    bounds = BOUNDS
    if page is not None:  # and a full first row, so that B = 1 keeps hits
        na[0] = nb[0] = cap
        top = int(max(a.max(), b.max())) + 1
        bounds = np.arange(page, top + page, page).astype(np.int32)
    pages = lambda x: np.minimum(np.searchsorted(bounds, x, side="right"),
                                 bounds.size - 1).astype(np.int32)
    c = lambda x: torch.as_tensor(x, device=dev)
    return dict(a=c(a), na=c(na), ra=c(ra), b=c(b), nb=c(nb), rb=c(rb),
                a_pg=c(pages(a)), b_pg=c(pages(b)), bounds=c(bounds))


def _assert_fields_equal(got, want):
    for field, g, w in zip(FIELDS, got, want):
        g, w = g.cpu(), w.cpu()
        if field == "rk_c":
            d = (g.view(torch.int32).long() - w.view(torch.int32).long())
            assert int(d.abs().max()) <= 1, field
        else:
            assert torch.equal(g, w), field


@pytest.mark.cuda
@pytest.mark.parametrize("cap,topk", [(1024, 64), (2048, 2048)])
def test_merge_and_locate_topk_matches_plain_on_card(cuda_device, cap, topk):
    x = _merged(np.random.default_rng(cap), 256, cap, cuda_device)
    args = (x["a"], x["na"], x["ra"], x["b"], x["nb"], x["rb"], x["a_pg"],
            x["b_pg"])
    got = qk.merge_and_locate_topk(*args, topk=topk, hit_cap=1000)
    torch.cuda.synchronize()
    want = qk.merge_and_locate_topk_plain(*args, topk=topk, hit_cap=1000)
    _assert_fields_equal(got, want)
    assert int(got[4].max()) > 0


# (cap, carried pages, rows): the W = 2 bucket shapes, and cap 262144
# (n = 524288, 128 tiles a row) at the few rows of a wide bucket
CHUNKED_SHAPES = [(512, True, 128), (4096, True, 128), (4096, False, 128),
                  (262144, True, 1), (262144, False, 1), (262144, True, 3),
                  (262144, False, 3), (262144, True, 8), (262144, False, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("cap,paged,bsz", CHUNKED_SHAPES)
def test_chunked_kernels_match_plain_on_card(cuda_device, cap, paged, bsz):
    """merge_tagged -> and_keep -> locate_runs, each against its plain
    version on the same inputs."""
    x = _merged(np.random.default_rng(cap + paged + bsz), bsz, cap,
                cuda_device, page=256 if cap > 4096 else None)
    apg, bpg = (x["a_pg"], x["b_pg"]) if paged else (None, None)
    vals, tag, pg = qk.merge_tagged(x["a"], x["na"], x["b"], x["nb"], apg,
                                    bpg)
    torch.cuda.synchronize()
    wv, wt, wp = qk.merge_tagged_plain(x["a"], x["na"], x["b"], x["nb"],
                                       apg, bpg)
    assert torch.equal(vals, wv) and torch.equal(tag, wt)
    if paged:
        live = wv < INF32
        assert torch.equal(pg[live], wp[live])
    hv = qk.and_keep(vals, tag, x["ra"], x["rb"])
    torch.cuda.synchronize()
    assert torch.equal(hv, qk.and_keep_plain(vals, tag, x["ra"], x["rb"]))
    assert int((hv < INF32).sum()) > 0
    kw = dict(topk=16, hit_cap=1000, pg=pg)
    got = qk.locate_runs(hv, x["bounds"], **kw)
    torch.cuda.synchronize()
    _assert_fields_equal(got, qk.locate_runs_plain(hv, x["bounds"], **kw))
    assert int(got[3].max()) > 16


@pytest.mark.cuda
@pytest.mark.parametrize("cap,paged,bsz", [(4096, True, 128),
                                           (4096, False, 128),
                                           (262144, True, 3),
                                           (262144, False, 8)])
def test_locate_runs_keep_range_matches_plain_on_card(cuda_device, cap,
                                                      paged, bsz):
    """locate_runs with a kept range (a document shard's own postings)
    against its plain version, and against the same stream with the
    values outside the range dropped beforehand."""
    x = _merged(np.random.default_rng(7 * cap + bsz), bsz, cap, cuda_device,
                page=256 if cap > 4096 else None)
    apg, bpg = (x["a_pg"], x["b_pg"]) if paged else (None, None)
    vals, tag, pg = qk.merge_tagged(x["a"], x["na"], x["b"], x["nb"], apg,
                                    bpg)
    hv = qk.and_keep(vals, tag, x["ra"], x["rb"])
    live = hv[hv < INF32]
    lo, hi = (int(torch.quantile(live.double(), q)) for q in (0.3, 0.7))
    kw = dict(topk=16, hit_cap=1000, pg=pg)
    got = qk.locate_runs(hv, x["bounds"], keep=(lo, hi), **kw)
    torch.cuda.synchronize()
    _assert_fields_equal(got, qk.locate_runs_plain(hv, x["bounds"],
                                                   keep=(lo, hi), **kw))
    cut = torch.where((hv >= lo) & (hv < hi), hv, INF32)
    _assert_fields_equal(got, qk.locate_runs(cut, x["bounds"], **kw))
    assert 0 < int(got[4].sum()) < int((hv < INF32).sum())


def _variant_blocks(rng, bsz, va, vb, cap, dev, spacing=12):
    """Two words' variant blocks per row from one per-row pool (shared
    coordinates within and across words), ragged lengths, word B empty
    and flagged bpad on every fifth row, both window signs, pages."""
    pool = np.cumsum(rng.integers(1, spacing, size=(bsz, 2 * cap)), axis=1)

    def blocks(v):
        pick = np.sort(np.argsort(rng.random((bsz, v, 2 * cap)), axis=2)
                       [:, :, :cap], axis=2)
        x = np.take_along_axis(pool[:, None, :], pick, axis=2)
        n = rng.integers(0, cap + 1, (bsz, v)).astype(np.int32)
        n[::3] = cap
        return x.astype(np.int32), n

    a, na = blocks(va)
    b, nb = blocks(vb)
    bpad = np.arange(bsz) % 5 == 3
    nb[bpad] = 0
    c = lambda x: torch.as_tensor(np.ascontiguousarray(x), device=dev)
    ra = np.where(np.arange(bsz) % 2 == 0, 60, -9).astype(np.int32)
    rb = np.where(np.arange(bsz) % 2 == 0, 45, -10).astype(np.int32)
    bounds = np.arange(37, int(pool.max()) + 38, 37, dtype=np.int32)
    pg = lambda x: np.minimum(np.searchsorted(bounds, x, side="right"),
                              bounds.size - 1).astype(np.int32)
    return dict(a=c(a), na=c(na), b=c(b), nb=c(nb), ra=c(ra), rb=c(rb),
                bpad=c(bpad), bounds=c(bounds), a_pg=c(pg(a)),
                b_pg=c(pg(b)))


# The variant slot kernels are compiled for stream widths N = 128, 256,
# 512 and 1024 and dispatched on n = V cap, with a lane a thread when a
# launch's rows fit in one wave of that shape (up to ~130-1000 rows on an
# H100, by N) and else 4 lanes a thread, 8, 4, 2 and 1 rows a block: the
# cases reach each width in both shapes, row counts that leave the last
# block part-filled or hold one row, and 2 to 32 blocks a row.
@pytest.mark.cuda
@pytest.mark.parametrize("va,vb,cap,carried,rows", [
    (2, 2, 128, True, 512), (4, 4, 128, False, 512), (1, 4, 64, True, 512),
    (2, 2, 32, True, 7), (1, 1, 64, False, 2049),     # N = 128
    (2, 2, 64, True, 129), (4, 4, 32, False, 1),      # N = 256
    (2, 2, 64, False, 1031),
    (4, 4, 64, False, 7),                             # N = 512
    (4, 4, 128, True, 128),                           # the serving shape
    (8, 8, 64, True, 7), (16, 16, 32, False, 129)])   # 16 and 32 blocks
def test_variants_and_locate_full_matches_plain_on_card(cuda_device, va, vb,
                                                        cap, carried, rows):
    x = _variant_blocks(np.random.default_rng(cap + va), rows, va, vb, cap,
                        cuda_device)
    args = (x["a"], x["na"], x["ra"], x["b"], x["nb"], x["rb"], x["bpad"],
            x["bounds"])
    kw = dict(topk=16, hit_cap=1024, tail=False)
    if carried:
        kw.update(a_pg=x["a_pg"], b_pg=x["b_pg"])
    got = qk.variants_and_locate_full(*args, **kw)
    torch.cuda.synchronize()
    _assert_fields_equal(got, qk.variants_and_locate_full_plain(*args, **kw))
    assert int(got[4].min()) >= 0
    if rows == 512:
        assert int(got[3].max()) > 16
    if rows > 8:
        assert int(got[4].max()) > 0 and int(x["bpad"].sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("v,cap,rows,topk,hit_cap,carried", [
    (2, 512, 512, 16, 1024, True), (4, 256, 512, 16, 1024, True),
    (8, 128, 512, 16, 1024, True),
    (2, 32, 7, 16, 1024, False), (4, 32, 2049, 16, 1024, True),  # N = 128
    (2, 128, 1, 16, 1024, True), (2, 128, 1031, 16, 1024, False),  # 256
    (8, 64, 129, 64, 1024, False), (8, 64, 513, 16, 1024, True),   # 512
    (8, 128, 128, 64, 1024, True),        # the serving shape
    (8, 128, 512, 128, 2048, True),       # the escalated shape
    (16, 64, 7, 16, 1024, False), (32, 32, 129, 64, 1024, True)])
def test_union_merge_locate_full_matches_plain_on_card(cuda_device, v, cap,
                                                       rows, topk, hit_cap,
                                                       carried):
    x = _variant_blocks(np.random.default_rng(v), rows, v, 1, cap,
                        cuda_device)
    kw = dict(topk=topk, hit_cap=hit_cap, tail=False,
              a_pg=x["a_pg"] if carried else None)
    got = qk.union_merge_locate_full(x["a"], x["na"], x["bounds"], **kw)
    torch.cuda.synchronize()
    _assert_fields_equal(got, qk.union_merge_locate_full_plain(
        x["a"], x["na"], x["bounds"], **kw))
    if rows > 8:
        assert int(got[4].max()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("va,vb,cap,bsz", [(2, 2, 512, 64), (4, 4, 4096, 64),
                                           (8, 0, 256, 64),
                                           (4, 4, 32768, 3)])
def test_variants_merge_and_keep_match_plain_on_card(cuda_device, va, vb,
                                                     cap, bsz):
    """merge_tagged over variant blocks, then variants_keep, each
    against its plain version; vb = 0 is a word's union alone."""
    x = _variant_blocks(np.random.default_rng(va * cap), bsz, va, max(vb, 1),
                        cap, cuda_device, spacing=4)
    b, nb, b_pg = ((x["b"], x["nb"], x["b_pg"]) if vb
                   else (None, None, None))
    vals, tag, pg = qk.merge_tagged(x["a"], x["na"], b, nb, x["a_pg"], b_pg)
    torch.cuda.synchronize()
    wv, wt, wp = qk.merge_tagged_plain(x["a"], x["na"], b, nb, x["a_pg"],
                                       b_pg)
    live = wv < INF32
    assert torch.equal(vals, wv) and torch.equal(tag, wt)
    assert torch.equal(pg[live], wp[live])
    bpad = x["bpad"] if vb else torch.ones_like(x["bpad"])
    hv = qk.variants_keep(vals, tag, x["ra"], x["rb"], bpad)
    torch.cuda.synchronize()
    assert torch.equal(hv, qk.variants_keep_plain(vals, tag, x["ra"],
                                                  x["rb"], bpad))
    assert int((hv < INF32).sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cap,paged,bsz", [(2048, True, 128),
                                           (262144, True, 1),
                                           (262144, False, 3),
                                           (262144, True, 8)])
def test_and_keep_compact_matches_plain_on_card(cuda_device, cap, paged,
                                                bsz):
    x = _merged(np.random.default_rng(5 + bsz), bsz, cap, cuda_device,
                page=256 if cap > 4096 else None)
    vals, tag, pg = qk.merge_tagged(x["a"], x["na"], x["b"], x["nb"],
                                    x["a_pg"], x["b_pg"])
    pg = pg if paged else None
    got = qk.and_keep_compact(vals, tag, x["ra"], x["rb"], pg)
    torch.cuda.synchronize()
    want = qk.and_keep_compact_plain(vals, tag, x["ra"], x["rb"], pg)
    assert all(g is w is None or torch.equal(g, w) for g, w in zip(got, want))
    assert int(got[2].max()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("bsz,carried", [(1, True), (3, False), (8, True),
                                         (8, False)])
def test_locate_runs_on_posting_block_matches_plain_on_card(cuda_device, bsz,
                                                            carried):
    """The W = 1 form of locate_runs: a posting block of n = 262144
    lanes (64 tiles a row), INF32 after its length."""
    x = _merged(np.random.default_rng(bsz), bsz, 262144, cuda_device,
                page=256)
    lane = torch.arange(262144, device=cuda_device)[None, :]
    block = torch.where(lane < x["na"][:, None], x["a"], INF32)
    kw = dict(topk=64, hit_cap=1024, pg=x["a_pg"] if carried else None)
    got = qk.locate_runs(block, x["bounds"], **kw)
    torch.cuda.synchronize()
    _assert_fields_equal(got, qk.locate_runs_plain(block, x["bounds"], **kw))
    assert int(got[3].max()) > 64


def _spread_batch(rng, bsz, cap):
    """_batch with the pool's steps varied by row: dense rows (runs of
    many hits), rows with one hit on most 60-char pages (runs tied at
    rank 1.0) and rows in between, so that more runs than topk tie."""
    kind = np.arange(bsz)[:, None] % 3
    pool = np.cumsum(rng.integers(np.choose(kind, [1, 50, 10]),
                                  np.choose(kind, [30, 70, 40]),
                                  size=(bsz, 2 * cap)), axis=1)
    pick = lambda: np.sort(np.argsort(rng.random((bsz, 2 * cap)), axis=1)
                           [:, :cap], axis=1)
    a = np.take_along_axis(pool, pick(), axis=1).astype(np.int32)
    b = np.take_along_axis(pool, pick(), axis=1).astype(np.int32)
    na = rng.integers(0, cap + 1, bsz).astype(np.int32)
    nb = rng.integers(0, cap + 1, bsz).astype(np.int32)
    na[::7], nb[1::7], na[2::5], nb[2::5] = 0, 0, cap, cap
    ra = np.where(np.arange(bsz) % 2 == 0, 75, -75).astype(np.int32)
    rb = np.where(np.arange(bsz) % 2 == 0, 70, -70).astype(np.int32)
    bounds = np.arange(60, int(pool.max()) + 61, 60, dtype=np.int32)
    pg = lambda x: np.minimum(np.searchsorted(bounds, x, side="right"),
                              bounds.size - 1).astype(np.int32)
    return a, na, ra, b, nb, rb, bounds, pg(a), pg(b)


def _assert_topk_equal(got, want):
    """Page-level outputs: pages and counts exact, ranks within 1 ulp."""
    for field, g, w in zip(("pages", "ranks", "counts"), got, want):
        g, w = g.cpu(), w.cpu()
        assert g.shape == w.shape and g.dtype == w.dtype, field
        if field == "ranks":
            d = (g.view(torch.int32).long() - w.view(torch.int32).long())
            assert int(d.abs().max()) <= 1, field
        else:
            assert torch.equal(g, w), field


@pytest.mark.cuda
@pytest.mark.parametrize("cap,topk,carried", [
    (64, 16, True), (512, 16, True), (256, 64, False), (32, 128, False)])
def test_and_locate_topk_matches_plain_on_card(cuda_device, cap, topk,
                                               carried):
    rng = np.random.default_rng(cap + topk)
    a, na, ra, b, nb, rb, bounds, apg, bpg = _spread_batch(rng, 512, cap)
    c = lambda x: torch.as_tensor(x, device=cuda_device)
    args = (c(a), c(na), c(ra), c(b), c(nb), c(rb), c(bounds))
    kw = dict(topk=topk)
    if carried:
        kw.update(a_pg=c(apg), b_pg=c(bpg))
    got = qk.sorted_and_locate(*args, **kw)
    torch.cuda.synchronize()
    want = qk.sorted_and_locate_plain(*args, **kw)
    _assert_topk_equal(got, want)
    if topk < 2 * cap:  # a full row whose last two served runs tie
        full = want[0][:, -1] >= 0
        assert bool((full & (want[1][:, -1] == want[1][:, -2])).any())
    if not carried:  # the bounds form is batched_and_locate's
        _assert_topk_equal(qk.batched_and_locate(*args, topk=topk), want)


@pytest.mark.cuda
@pytest.mark.parametrize("cap,topk,carried", [
    (64, 16, True), (128, 16, False), (128, 64, True), (32, 64, False)])
def test_single_locate_topk_matches_plain_on_card(cuda_device, cap, topk,
                                                  carried):
    rng = np.random.default_rng(cap * topk)
    a, na, _, _, _, _, bounds, apg, _ = _spread_batch(rng, 512, cap)
    c = lambda x: torch.as_tensor(x, device=cuda_device)
    kw = dict(topk=topk, a_pg=c(apg) if carried else None)
    got = qk.batched_single_locate(c(a), c(na), c(bounds), **kw)
    torch.cuda.synchronize()
    want = qk.batched_single_locate_plain(c(a), c(na), c(bounds), **kw)
    _assert_topk_equal(got, want)
    if topk < cap:
        full = want[0][:, -1] >= 0
        assert bool((full & (want[1][:, -1] == want[1][:, -2])).any())


@pytest.mark.cuda
def test_page_kernels_reject_what_they_cannot_take(cuda_device):
    z = lambda *s: torch.zeros(s, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="caps <= 128"):
        qk.batched_single_locate(z(8, 256), z(8), z(4), topk=8)
    with pytest.raises(ValueError, match="contiguous"):
        qk.batched_single_locate(z(8, 128)[:, ::2], z(8), z(4), topk=8)
    with pytest.raises(ValueError, match="contiguous"):
        qk.sorted_and_locate(z(8, 64), z(8), z(8, 2)[:, 0], z(8, 64), z(8),
                             z(8), z(4), topk=8)


def _assert_finished_equal(got, want):
    """Top-k-mode outputs (pages, ranks, counts int32, n_pages, n_hits,
    hits): ranks within 1 ulp, the rest exact."""
    names = ("pages", "ranks", "counts", "n_pages", "n_hits", "hits")
    for field, g, w in zip(names, got, want):
        g, w = g.cpu(), w.cpu()
        assert g.shape == w.shape and g.dtype == w.dtype, field
        if field == "ranks":
            d = (g.view(torch.int32).long() - w.view(torch.int32).long())
            assert int(d.abs().max()) <= 1, field
        else:
            assert torch.equal(g, w), field


# (kernel, cap, topk, hit_cap, carried pages, rows); row 15d (the W = 1
# kernel with the top-k tail) at both launch shapes (128 rows: a lane a
# thread; 4096: 4 lanes), part-filled last blocks and a cap that is not a
# multiple of 4
@pytest.mark.cuda
@pytest.mark.parametrize("name,cap,topk,hit_cap,carried,rows", [
    ("sorted_and_locate_full", 64, 16, 1024, True, 512),
    ("sorted_and_locate_full", 512, 64, 1024, False, 512),
    ("sorted_and_locate_full", 128, 2048, 8192, True, 512),
    ("single_locate_full", 64, 16, 32, True, 512),
    ("single_locate_full", 128, 64, 1024, False, 512),
    ("union_locate_full", 1024, 64, 1024, True, 512),
    ("union_locate_full", 256, 2048, 8192, False, 512),
    ("single_locate_full", 64, 16, 1024, True, 128),
    ("single_locate_full", 64, 64, 1024, False, 4096),
    ("single_locate_full", 128, 16, 64, True, 128),
    ("single_locate_full", 128, 2048, 8192, True, 4096),
    ("single_locate_full", 64, 16, 1024, True, 1),
    ("single_locate_full", 128, 64, 1024, True, 7),
    ("single_locate_full", 128, 16, 1024, False, 129),
    ("single_locate_full", 126, 16, 100, True, 129),
])
def test_topk_mode_kernel_matches_plain_on_card(cuda_device, name, cap, topk,
                                                hit_cap, carried, rows):
    """The top-k-mode slot kernels (sort_topk=False) over rows with tied
    runs, more runs than topk, empty rows, lengths past cap (W = 1), and
    topk / hit_cap past the stream."""
    rng = np.random.default_rng(cap + topk)
    a, na, ra, b, nb, rb, bounds, apg, bpg = _spread_batch(rng, rows, cap)
    if name == "single_locate_full":
        a, na = _w1_rows(rng, a, na, cap, False)
    c = lambda x: torch.as_tensor(x, device=cuda_device)
    kw = dict(topk=topk, hit_cap=hit_cap, sort_topk=False)
    if name == "sorted_and_locate_full":
        args = (c(a), c(na), c(ra), c(b), c(nb), c(rb), c(bounds))
        if carried:
            kw.update(a_pg=c(apg), b_pg=c(bpg))
    elif name == "single_locate_full":
        args = (c(a), c(na), c(bounds))
        kw.update(a_pg=c(apg) if carried else None)
    else:
        args = (c(a)[:, None], c(na)[:, None], c(bounds))
        kw.update(a_pg=c(apg)[:, None] if carried else None)
    got = getattr(qk, name)(*args, **kw)
    torch.cuda.synchronize()
    want = getattr(qk, name + "_plain")(*args, **kw)
    _assert_finished_equal(got, want)
    width = cap * (2 if name == "sorted_and_locate_full" else 1)
    if topk < width and rows >= 128:
        assert int(got[3].max()) > topk
        full = want[0][:, -1] >= 0
        assert bool((full & (want[1][:, -1] == want[1][:, -2])).any())
    # the slot mode serves the same rows the same way
    slot = getattr(qk, name)(*args, **dict(kw, sort_topk=True))
    served = (got[3] <= topk).cpu()
    for g, s in zip(got[:3], slot[:3]):
        assert torch.equal(g.cpu()[served], s.cpu()[served].to(g.dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("va,vb,cap,topk,carried,rows", [
    (2, 2, 128, 16, True, 512), (4, 4, 128, 64, False, 512),
    (1, 4, 64, 2048, True, 512),
    (2, 2, 32, 16, False, 2049), (2, 2, 64, 64, True, 7),  # N = 128, 256
    (4, 4, 64, 16, True, 1),                               # N = 512
    (4, 4, 128, 64, True, 128),                            # serving shape
    (8, 8, 64, 16, False, 129), (16, 16, 32, 64, True, 7)])
def test_variants_topk_mode_matches_plain_on_card(cuda_device, va, vb, cap,
                                                  topk, carried, rows):
    x = _variant_blocks(np.random.default_rng(cap + va), rows, va, vb, cap,
                        cuda_device)
    args = (x["a"], x["na"], x["ra"], x["b"], x["nb"], x["rb"], x["bpad"],
            x["bounds"])
    kw = dict(topk=topk, hit_cap=1024, sort_topk=False)
    if carried:
        kw.update(a_pg=x["a_pg"], b_pg=x["b_pg"])
    got = qk.variants_and_locate_full(*args, **kw)
    torch.cuda.synchronize()
    _assert_finished_equal(got,
                           qk.variants_and_locate_full_plain(*args, **kw))
    if rows == 512:
        assert int(got[3].max()) > 16
    if rows > 8:
        assert int(got[4].max()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("v,cap,topk,rows", [
    (2, 512, 64, 512), (4, 256, 16, 512), (8, 128, 2048, 512),
    (4, 32, 16, 7), (2, 128, 64, 129), (8, 64, 16, 1),  # N = 128-512
    (2, 64, 16, 2049), (2, 128, 64, 1031),
    (8, 128, 128, 512),                   # the escalated shape
    (1, 1024, 64, 129),                   # V = 1, past the W = 1 kernel
    (16, 64, 64, 129), (32, 32, 16, 7)])
def test_union_topk_mode_matches_plain_on_card(cuda_device, v, cap, topk,
                                               rows):
    x = _variant_blocks(np.random.default_rng(v), rows, v, 1, cap,
                        cuda_device)
    kw = dict(topk=topk, hit_cap=8192, sort_topk=False, a_pg=x["a_pg"])
    got = qk.union_locate_full(x["a"], x["na"], x["bounds"], **kw)
    torch.cuda.synchronize()
    _assert_finished_equal(got, qk.union_locate_full_plain(
        x["a"], x["na"], x["bounds"], **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [64, 1024, 2048])
def test_merge_and_locate_matches_plain_on_card(cuda_device, cap):
    """The full-width streams, then the torch tails over them against
    merge_and_locate_topk's outputs (its three-step form)."""
    x = _merged(np.random.default_rng(cap), 256, cap, cuda_device)
    args = (x["a"], x["na"], x["ra"], x["b"], x["nb"], x["rb"], x["a_pg"],
            x["b_pg"])
    got = qk.merge_and_locate(*args)
    torch.cuda.synchronize()
    want = qk.merge_and_locate_plain(*args)
    for field, g, w in zip(("hits", "page_s", "rank_s", "cnt_s"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, field
        if field == "rank_s":
            d = (g.view(torch.int32).long() - w.view(torch.int32).long())
            assert int(d.abs().max()) <= 1, field
        else:
            assert torch.equal(g, w), field
    assert int((got[0] < INF32).sum()) > 0 and int((got[2] > 0).sum()) > 0
    fused = qk.merge_and_locate_topk(*args, topk=16, hit_cap=1000)
    pg_c, rk_c, ct_c, n_pages = qk.compact_streams_topk(*got[1:], 16)
    live = rk_c > 0
    assert torch.equal(n_pages, fused[3])
    assert torch.equal(pg_c[live], fused[0][live])
    assert torch.equal(ct_c, fused[2])
    d = rk_c.view(torch.int32).long() - fused[1].view(torch.int32).long()
    assert int(d.abs().max()) <= 1


@pytest.mark.cuda
def test_new_kernels_reject_what_they_cannot_take(cuda_device):
    z = lambda *s: torch.zeros(s, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="2 cap <= 4096"):
        qk.merge_and_locate(z(8, 4096), z(8), z(8), z(8, 4096), z(8), z(8),
                            z(8, 4096), z(8, 4096))
    with pytest.raises(ValueError, match="contiguous"):
        qk.merge_and_locate(z(8, 128)[:, ::2], z(8), z(8), z(8, 64), z(8),
                            z(8), z(8, 64), z(8, 64))
    with pytest.raises(ValueError, match="caps <= 128"):
        qk.single_locate_full(z(8, 256), z(8), z(4), topk=8, hit_cap=64,
                              a_pg=z(8, 256), sort_topk=False)
    with pytest.raises(ValueError, match="tail=False"):
        qk.single_locate_full(z(8, 64), z(8), z(4), topk=8, hit_cap=64,
                              a_pg=z(8, 64), sort_topk=False, tail=False)


def _tagged_blocks(rng, rows, v, cap, pool):
    """v ascending blocks a row from the row's pool, INF32 past lengths
    that are ragged, 0 on every fifth row, the cap on every third and
    past it (clamped) on every seventh."""
    x = np.full((rows, v, cap), INF32, np.int64)
    n = rng.integers(0, cap + 1, (rows, v))
    n[::3], n[1::7], n[2::5] = cap, cap + 5, 0
    for i in range(rows):
        for j in range(v):
            k = min(int(n[i, j]), cap)
            x[i, j, :k] = np.sort(rng.choice(pool[i], k, replace=False))
    return x.astype(np.int32), n.astype(np.int32)


# (va, vb, cap_a, cap_b, rows, paged): k = 2, 3, 8 and 16 blocks, rows of
# one tile and of many, and a fold step's running stream (cap_a) against
# the next word's block (cap_b); rows of at most 32 blocks whose caps are
# multiples of 8 merge in one block up to 2048 lanes (up to 5 levels),
# the rest in passes
MERGE_TAGGED_SHAPES = [
    (1, 1, 512, 512, 300, True), (1, 1, 512, 512, 300, False),
    (4, 4, 256, 256, 100, True), (8, 0, 64, 1, 50, False),
    (4, 4, 1024, 1024, 40, True),
    (2, 1, 40, 24, 70, True), (16, 16, 64, 64, 20, False),
    (17, 16, 8, 8, 30, True),
    (1, 1, 32768, 32768, 8, True), (1, 1, 262144, 262144, 3, False),
    (2, 1, 4096, 4096, 16, True), (1, 2, 1000, 1000, 9, False),
    (4, 4, 32768, 32768, 3, True), (4, 4, 512, 512, 128, False),
    (8, 8, 1024, 1024, 64, True), (8, 8, 4096, 4096, 4, False),
    (1, 1, 65536, 32768, 4, True), (1, 1, 8192, 1024, 40, False),
    (3, 0, 2048, 1, 33, True), (0, 2, 1, 777, 10, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("va,vb,cap_a,cap_b,rows,paged", MERGE_TAGGED_SHAPES)
def test_merge_tagged_shapes_match_plain_on_card(cuda_device, va, vb, cap_a,
                                                 cap_b, rows, paged):
    """The merge-path kernel, one pass or a tree of passes, against the
    stable sort of its plain version: values and tags everywhere, pages
    at the real lanes."""
    rng = np.random.default_rng(va * 31 + vb * 7 + cap_a + cap_b)
    size = 2 * max(cap_a, cap_b)
    pool = np.cumsum(rng.integers(1, 4, size=(rows, size)), axis=1)
    a, na = _tagged_blocks(rng, rows, va, cap_a, pool)
    b, nb = _tagged_blocks(rng, rows, vb, cap_b, pool)
    c = lambda x: torch.as_tensor(x, device=cuda_device)
    pgs = ((c(a // 60), c(b // 60 + 1)) if paged else (None, None))
    args = (c(a), c(na), c(b), c(nb)) + pgs
    vals, tag, pg = qk.merge_tagged(*args)
    torch.cuda.synchronize()
    wv, wt, wp = qk.merge_tagged_plain(*args)
    assert torch.equal(vals, wv) and torch.equal(tag, wt)
    live = wv < INF32
    assert int(live.sum()) > 0
    if paged:
        assert torch.equal(pg[live], wp[live])
        assert int(pg[~live].abs().sum()) == 0
    else:
        assert pg is None


# (cap, rows): each stream width the W = 2 slot kernel is compiled for
# (N = 128, 256, 512, 1024), with row counts that leave the last block
# part-filled (8, 8, 4 and 2 rows a block) or hold one row
SLOT_ROW_SHAPES = [(64, 1), (64, 1003), (37, 77), (128, 9), (128, 517),
                   (256, 5), (256, 4099), (200, 31), (512, 3), (512, 1025)]


@pytest.mark.cuda
@pytest.mark.parametrize("cap,rows", SLOT_ROW_SHAPES)
@pytest.mark.parametrize("sort_topk", [True, False])
def test_w2_slot_kernel_row_groups_match_plain_on_card(cuda_device, cap,
                                                       rows, sort_topk):
    """The W = 2 slot kernel with several rows a block and both tails:
    empty word A or word B rows, full rows, ordered windows (both R < 0)
    on every second row, pages carried on half the shapes."""
    rng = np.random.default_rng(cap * rows)
    a, na, ra, b, nb, rb = _batch(rng, rows, cap)
    c = lambda x: torch.as_tensor(x, device=cuda_device)
    args = (c(a), c(na), c(ra), c(b), c(nb), c(rb), c(BOUNDS))
    kw = dict(topk=16, hit_cap=1024, sort_topk=sort_topk)
    if rows % 2:
        kw.update(a_pg=c(_pages(a)), b_pg=c(_pages(b)))
    if sort_topk:
        kw["tail"] = False
    got = qk.sorted_and_locate_full(*args, **kw)
    torch.cuda.synchronize()
    want = qk.sorted_and_locate_full_plain(*args, **kw)
    if sort_topk:
        _assert_fields_equal(got, want)
    else:
        _assert_finished_equal(got, want)
    if rows > 8:
        assert int(got[3].max()) > 16 and int(got[4].max()) > 0
        assert int((got[4] == 0).sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cap,rows", SLOT_ROW_SHAPES)
@pytest.mark.parametrize("carried", [True, False])
def test_page_w2_kernel_row_groups_match_plain_on_card(cuda_device, cap,
                                                       rows, carried):
    """The page-level W = 2 kernel on the slot kernel's row groups, with
    carried pages and with pages from bounds (batched_and_locate's
    form), at topk 16 and at a topk above every row's runs: dense rows,
    rows of runs tied at rank 1.0, empty word A or word B rows."""
    rng = np.random.default_rng(cap * rows + carried)
    a, na, ra, b, nb, rb, bounds, apg, bpg = _spread_batch(rng, rows, cap)
    c = lambda x: torch.as_tensor(x, device=cuda_device)
    args = (c(a), c(na), c(ra), c(b), c(nb), c(rb), c(bounds))
    pgs = dict(a_pg=c(apg), b_pg=c(bpg)) if carried else {}
    for topk in (16, 2 * cap + 3):
        got = qk.sorted_and_locate(*args, topk=topk, **pgs)
        torch.cuda.synchronize()
        want = qk.sorted_and_locate_plain(*args, topk=topk, **pgs)
        _assert_topk_equal(got, want)
        if not carried:
            _assert_topk_equal(qk.batched_and_locate(*args, topk=topk), want)
    assert int((want[0][:, 0] < 0).sum()) > 0  # rows serving nothing
    if rows > 8:
        top16 = qk.sorted_and_locate_plain(*args, topk=16, **pgs)
        full = top16[0][:, -1] >= 0
        assert bool((full & (top16[1][:, -1] == top16[1][:, -2])).any())


# (cap, rows): the fused kernels' two stream widths (N = 2048 for caps
# 513-1024 and below, 4096 for 1025-2048), one row, odd caps, and the
# row counts of the fused batches
FUSED_ROW_SHAPES = [(1024, 1), (1024, 8), (1000, 37), (2048, 1), (2048, 8),
                    (1531, 19), (700, 64), (64, 5), (2048, 133)]


@pytest.mark.cuda
@pytest.mark.parametrize("cap,rows", FUSED_ROW_SHAPES)
def test_fused_kernels_match_plain_on_card(cuda_device, cap, rows):
    """merge_and_locate_topk (first-kpad runs, at topk 64 and at a topk
    past the stream) and merge_and_locate (full-width streams) against
    their plain versions: dense rows with long page runs, runs tied at
    rank 1.0, empty operands, ordered windows on every second row."""
    rng = np.random.default_rng(cap + 7 * rows)
    a, na, ra, b, nb, rb, bounds, apg, bpg = _spread_batch(rng, rows, cap)
    c = lambda x: torch.as_tensor(x, device=cuda_device)
    args = (c(a), c(na), c(ra), c(b), c(nb), c(rb), c(apg), c(bpg))
    for topk, hit_cap in ((64, 1024), (4 * cap, 8192)):
        got = qk.merge_and_locate_topk(*args, topk=topk, hit_cap=hit_cap)
        torch.cuda.synchronize()
        _assert_fields_equal(got, qk.merge_and_locate_topk_plain(
            *args, topk=topk, hit_cap=hit_cap))
    streams = qk.merge_and_locate(*args)
    torch.cuda.synchronize()
    want = qk.merge_and_locate_plain(*args)
    for field, g, w in zip(("hits", "page_s", "rank_s", "cnt_s"), streams,
                           want):
        assert g.shape == w.shape and g.dtype == w.dtype, field
        if field == "rank_s":
            d = (g.view(torch.int32).long() - w.view(torch.int32).long())
            assert int(d.abs().max()) <= 1, field
        else:
            assert torch.equal(g, w), field
    if rows > 1:
        assert int(got[3].max()) > 64 and int((got[4] == 0).sum()) > 0


# (cap, rows) of row 14, the W = 1 kernel with the page-level tail: a
# lane a thread within one wave (1-129 rows) and 4 lanes past it (4093
# rows, the last block part-filled), at caps 32-128 and at a cap that is
# no multiple of 4 (scalar loads)
PAGE_W1_SHAPES = [(cap, rows) for cap in (32, 64, 128, 126)
                  for rows in (1, 7, 128, 129, 4093)]


@pytest.mark.cuda
@pytest.mark.parametrize("cap,rows", PAGE_W1_SHAPES)
@pytest.mark.parametrize("carried", [True, False])
def test_page_w1_kernel_row_groups_match_plain_on_card(cuda_device, cap,
                                                       rows, carried):
    """batched_single_locate on the W = 1 kernel's row groups, with
    carried pages and with pages looked up in the bounds inside the
    kernel, at topk 16 (below most full rows' runs, with runs tied at
    the cut), at the most runs a row holds and past every row's runs;
    lengths past cap on every 11th row, empty rows."""
    rng = np.random.default_rng(cap * rows + carried)
    a, na, _, _, _, _, bounds, apg, _ = _spread_batch(rng, rows, cap)
    a, na = _w1_rows(rng, a, na, cap, dups=False)
    c = lambda x: torch.as_tensor(x, device=cuda_device)
    args = (c(a), c(na), c(bounds))
    pgs = dict(a_pg=c(apg) if carried else None)
    every = qk.batched_single_locate_plain(*args, topk=cap + 5, **pgs)
    runs = (every[0] >= 0).sum(dim=1)
    most = max(int(runs.max()), 1)
    for topk in (16, most, cap + 5):
        got = qk.batched_single_locate(*args, topk=topk, **pgs)
        torch.cuda.synchronize()
        want = qk.batched_single_locate_plain(*args, topk=topk, **pgs)
        _assert_topk_equal(got, want)
    if rows > 8:
        assert int((runs == 0).sum()) > 0 and bool((runs > 16).any())
        # a row whose 16th and 17th runs tie: the cut falls inside a tie
        rk = every[1]
        assert bool(((rk[:, 15] == rk[:, 16]) & (every[0][:, 16] >= 0))
                    .any())


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [256, 512, 1024, 1021])
@pytest.mark.parametrize("rows", [128, 4093])
def test_union_v1_topk_mode_matches_plain_on_card(cuda_device, cap, rows):
    """Row 15c at V = 1 (union_locate_full with sort_topk=False on the
    W = 1 body with the top-k tail) against its plain version: about one
    lane in ten repeating the lane before it, lengths past cap, topk 64
    with hit_cap 1024 and a topk past the stream with hit_cap 8192."""
    rng = np.random.default_rng(cap + rows)
    a, na, *_ = _spread_batch(rng, rows, cap)
    a, na = _w1_rows(rng, a, na, cap, dups=True)
    c = lambda x: torch.as_tensor(x, device=cuda_device)
    args = (c(a)[:, None], c(na)[:, None], c(BOUNDS))
    for topk, hit_cap in ((64, 1024), (cap + 5, 8192)):
        kw = dict(topk=topk, hit_cap=hit_cap, sort_topk=False,
                  a_pg=c(_pages(a))[:, None])
        got = qk.union_locate_full(*args, **kw)
        torch.cuda.synchronize()
        want = qk.union_locate_full_plain(*args, **kw)
        _assert_finished_equal(got, want)
    assert int(want[3].max()) > 64  # rows with more runs than topk
    assert bool((want[4].cpu() < torch.as_tensor(na).clamp(0, cap))
                .any())  # repeated lanes dropped


THREADS = 6


def _thread_calls(rng, dev):
    """One thread's calls: (kernel name, wrapper, plain, args, kwargs), a
    slot kernel launched through launch_by_rows in each of its launch
    shapes (a wave's rows and more) and the fused kernels, which raise
    their shared memory limit at their first launch."""
    c = lambda x: torch.as_tensor(np.ascontiguousarray(x), device=dev)
    calls = []
    for rows in (128, 4093):
        a, na, ra, b, nb, rb, bounds, apg, bpg = _spread_batch(rng, rows, 128)
        w1 = (c(a), c(na), c(bounds))
        calls += [
            ("single_locate_full", qk.single_locate_full, w1,
             dict(topk=16, hit_cap=1024, tail=False, a_pg=c(apg))),
            ("single_locate_topk", qk.batched_single_locate, w1,
             dict(topk=16, a_pg=c(apg))),
            ("single_locate_topk", qk.batched_single_locate, w1,
             dict(topk=16)),
            ("sorted_and_locate_full", qk.sorted_and_locate_full,
             (c(a), c(na), c(ra), c(b), c(nb), c(rb), c(bounds)),
             dict(topk=16, hit_cap=1024, tail=False, a_pg=c(apg),
                  b_pg=c(bpg)))]
        x = _variant_blocks(rng, rows, 4, 1, 128, dev)
        calls.append(("union_merge_locate_full", qk.union_merge_locate_full,
                      (x["a"], x["na"], x["bounds"]),
                      dict(topk=16, hit_cap=1024, tail=False,
                           a_pg=x["a_pg"])))
        a, na, *_ = _spread_batch(rng, rows, 1024)
        v1 = (c(a)[:, None], c(na)[:, None], c(BOUNDS))
        v1_pg = c(_pages(a))[:, None]
        calls += [("union_locate_full", qk.union_locate_full, v1,
                   dict(topk=64, hit_cap=1024, tail=False, a_pg=v1_pg)),
                  ("union_locate_full_topk", qk.union_locate_full, v1,
                   dict(topk=64, hit_cap=1024, sort_topk=False,
                        a_pg=v1_pg))]
    a, na, ra, b, nb, rb, _, apg, bpg = _spread_batch(rng, 16, 2048)
    fused = tuple(c(x) for x in (a, na, ra, b, nb, rb, apg, bpg))
    calls += [("merge_and_locate_topk", qk.merge_and_locate_topk, fused,
               dict(topk=64, hit_cap=1024)),
              ("merge_and_locate", qk.merge_and_locate, fused, {})]
    return calls


def launch_from_threads(n_threads: int = THREADS) -> dict:
    """Each of n_threads threads on its own stream makes _thread_calls'
    calls at once (a barrier before the first), then holds each output
    against its plain version on that stream. Returns the calls made and
    the launches counted per kernel, and the outputs that differ. Run in
    a fresh process, so that the launch caches start cold."""
    from docodo_tpu_torch.ops import _cuda

    dev = torch.device("cuda")
    start = threading.Barrier(n_threads, timeout=300)
    made, differ, errors = {}, [], []
    lock = threading.Lock()

    def work(k):
        try:
            stream = torch.cuda.Stream()
            with torch.cuda.stream(stream):
                calls = _thread_calls(np.random.default_rng(k), dev)
                stream.synchronize()
                start.wait()
                outs = [fn(*args, **kw) for _, fn, args, kw in calls]
                stream.synchronize()
                for (name, fn, args, kw), got in zip(calls, outs):
                    plain = getattr(qk, fn.__name__ + "_plain")
                    try:
                        if name == "single_locate_topk":
                            _assert_topk_equal(got, plain(*args, **kw))
                        elif name == "merge_and_locate":  # rank_s: 1 ulp
                            for i, (g, w) in enumerate(zip(got,
                                                           plain(*args))):
                                d = (g.view(torch.int32).long()
                                     - w.view(torch.int32).long()).abs()
                                assert int(d.max()) <= (i == 2)
                        elif kw.get("sort_topk") is False:
                            _assert_finished_equal(got, plain(*args, **kw))
                        else:
                            _assert_fields_equal(got, plain(*args, **kw))
                    except AssertionError as e:
                        with lock:
                            differ.append(f"thread {k} {name}: {e}")
                with lock:
                    for name, *_ in calls:
                        made[name] = made.get(name, 0) + 1
        except Exception as e:  # reported, not lost with the thread
            with lock:
                errors.append(f"thread {k}: {e!r}")

    threads = [threading.Thread(target=work, args=(k,))
               for k in range(n_threads)]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # interleave the threads' Python often
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(switch)
    errors += [f"{t.name} did not finish" for t in threads if t.is_alive()]
    return dict(made=made, errors=errors, differ=differ,
                launches={name: _cuda.KERNELS[name].launches
                          for name in made})


@pytest.mark.cuda
def test_kernels_launch_from_threads_with_cold_caches(cuda_device):
    """The batcher launches from several threads. Six threads, each on
    its own stream, launch the slot kernels and the fused kernels at once
    in a process that has launched nothing yet (cold wave caches and
    shared-memory bits); every output equals its plain version and every
    kernel's launch count equals the calls made."""
    repo = Path(__file__).resolve().parents[1]
    code = ("import json, test_torch_cuda as t; "
            "print(json.dumps(t.launch_from_threads()))")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(repo), str(repo / "tests")]))
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert not res["errors"] and not res["differ"], res
    assert len(res["made"]) == 8 and res["launches"] == res["made"], res


def test_profiler_kernel_names_are_kernels():
    """tools/profile_batch.py reads each kernel's device time by a name in
    the profiler's events (KERNEL_NAMES): each must start with a
    __global__ function of csrc/, and each docodo:: type it spells must be
    a struct there, or a renamed kernel would read 0 ms without an error.
    Reads the sources as text; needs no card."""
    repo = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location(
        "profile_batch", repo / "tools" / "profile_batch.py")
    pb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(pb)
    text = "".join(f.read_text() for f in sorted(
        (repo / "docodo_tpu_torch" / "csrc").glob("*.cu*")))
    kernels = set(re.findall(
        r"__global__\s+void\s+(?:__launch_bounds__\([^;{]*?\)\s+)?(\w+)\s*\(",
        text))
    structs = set(re.findall(r"\bstruct\s+(\w+)", text))
    assert {"w1_locate_full_kernel", "sorted_and_locate_full_kernel"} <= kernels
    for name, events in pb.KERNEL_NAMES.items():
        for event in (events,) if isinstance(events, str) else events:
            assert event.split("<")[0] in kernels, (name, event)
            for t in re.findall(r"docodo::(\w+)", event):
                assert t in structs, (name, event, t)


def _serving_index():
    """A seeded Zipf corpus through the port's host engine (page text
    kept), with its serve_qps-recipe and wide requests."""
    from docodo_tpu_torch.index import Index, ListDataSource
    from docodo_tpu_torch.mix import serve_requests, wide_requests
    from docodo_tpu_torch.synthetic import zipf_documents

    ind = Index()
    ind.add_data_source(ListDataSource(
        "synth", zipf_documents(400_000, seed=2, vocab=3000,
                                doc_chars=20_000)))
    ind.create()
    return ind, serve_requests(ind, 240) + wide_requests(ind, 80)


@pytest.mark.cuda
@pytest.mark.parametrize("pipeline", [False, True],
                         ids=["direct", "pipelined"])
@pytest.mark.parametrize("materialize", [True, False],
                         ids=["materialized", "brief"])
def test_batcher_on_card_from_threads_with_a_restage(cuda_device, pipeline,
                                                     materialize):
    """The executor on a CUDA index, 16 client threads, create() on the
    same documents after the first third of the requests: every request
    equal to the host engine (brief doc ranks within 1 ulp, orders
    equal), the stats adding up, and every kernel's launch count equal
    to the sum of the launches the executor's batches made."""
    import concurrent.futures as cf

    from docodo_tpu_torch.ops import _cuda
    from docodo_tpu_torch.query.batcher import BatchExecutor
    from docodo_tpu_torch.query.search import brief_ulps, result_fields

    ind, reqs = _serving_index()
    hosts = {r: ind.search(r) for r in set(reqs)}
    want = {r: result_fields(h) for r, h in hosts.items()}
    ex = BatchExecutor(ind, pipeline=pipeline, materialize=materialize,
                       max_wait_ms=2.0)
    assert ex.di.device.type == "cuda"
    waves = []
    total = lambda: sum(k.launches for k in _cuda.KERNELS.values())
    search_batch_full = type(ex.di).search_batch_full

    def counted(self, *a, **k):  # the collector's calls, one a batch
        before = total()
        out = search_batch_full(self, *a, **k)
        waves.append(total() - before)
        return out

    gen = ind.generation
    for k in _cuda.KERNELS.values():
        k.launches = 0
    type(ex.di).search_batch_full = counted
    try:
        def client(k):
            out = []
            for i, req in enumerate(reqs[k::16]):
                if k == 0 and i == len(reqs) // 48:
                    ind.create()
                out.append((req, ex.search(req)))
            return out

        with cf.ThreadPoolExecutor(16) as pool:
            served = [r for f in [pool.submit(client, k) for k in range(16)]
                      for r in f.result(timeout=600)]
        # a few more on the restaged index
        served += [(r, ex.search(r)) for r in reqs[:32]]
    finally:
        type(ex.di).search_batch_full = search_batch_full
        ex.close()
    assert ind.generation == gen + 1 and ex._gen == ind.generation
    for req, res in served:
        if result_fields(res) == want[req]:
            continue
        assert not materialize, req
        worst = brief_ulps(res, hosts[req])
        assert worst is not None and worst <= 1, (req, worst)
    st = ex.stats
    assert st["device_queries"] + st["host_queries"] \
        + st["truncated_fallbacks"] == len(served)
    assert st["device_queries"] > len(served) // 2
    assert sum(waves) == total() > 0 and len(waves) == st["batches"]


def _packed_stream(rng, n: int, num_terms: int):
    """A seeded packed token stream with escape rows (gaps of 4095 and
    k * 4095 + r) and PACK_PAD_ROW padding."""
    from docodo_tpu_torch.ops import device_index as di

    gaps = rng.integers(0, 40, n)
    gaps[rng.choice(n, 6, replace=False)] = [4095, 8190, 3 * 4095 + 7,
                                            4094, 4096, 40_000]
    ids = rng.integers(0, num_terms, n).astype(np.int32)
    packed = di.pack_tokens(ids, np.cumsum(gaps))
    return np.concatenate([packed, np.full(53, di.PACK_PAD_ROW, np.uint32)])


@pytest.mark.cuda
@pytest.mark.parametrize("n,num_terms", [(5000, 300), (2_000_000, 50_000)])
def test_build_postings_packed_on_card_equals_cpu(cuda_device, n,
                                                  num_terms):
    from docodo_tpu_torch.ops import device_index as di

    rows = torch.from_numpy(_packed_stream(np.random.default_rng(n), n,
                                           num_terms).view(np.int32))
    want = di.build_postings_packed(rows, num_terms)
    got = di.build_postings_packed(rows.to(cuda_device), num_terms)
    for g, w in zip(got, want):
        assert g.is_cuda and g.dtype == w.dtype == torch.int32
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["int32-coords", "many-terms",
                                  "int64-coords"])
def test_sort_postings_on_card_equals_cpu(cuda_device, case):
    from docodo_tpu_torch import index as host

    rng = np.random.default_rng(len(case))
    num_terms = 2**20 + 8 if case == "many-terms" else 3000
    keys = rng.integers(0, num_terms, 50_000).astype(np.int32)
    coords = np.cumsum(rng.integers(0, 5000, 50_000)).astype(np.uint64)
    if case == "int64-coords":
        coords[25_000:] += np.uint64(2**31)
    got = host.sort_postings(keys, coords, num_terms, cuda_device)
    want = host.sort_postings(keys, coords, num_terms, "cpu")
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("native", [True, False])
def test_index_create_on_card_equals_cpu(cuda_device, native):
    """Index.create with the CSR sorted on the card equals the same build
    sorted on the CPU, array for array."""
    from docodo_tpu_torch.index import Index, ListDataSource
    from docodo_tpu_torch.synthetic import zipf_documents

    docs = zipf_documents(2_000_000, seed=9, vocab=8000, doc_chars=30_000)
    built = []
    for device in (cuda_device, "cpu"):
        ind = Index(native=native, device=device)
        ind.add_data_source(ListDataSource("synth", docs))
        ind.create()
        built.append(ind.host)
    got, want = built
    assert got.arr.terms == want.arr.terms and len(got.arr.terms) > 5000
    assert got.pages.page_ids == want.pages.page_ids
    assert got.pages.doc_names == want.pages.doc_names
    assert got.arr.max_coord == want.arr.max_coord
    for a, b in ((got.arr.offsets, want.arr.offsets),
                 (got.arr.coords, want.arr.coords),
                 (got.pages.bounds, want.pages.bounds),
                 (got.pages.page_doc, want.pages.page_doc)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _sharded_pair(ind, mesh):
    """(ShardedDeviceIndex on `mesh`, the same on four CPU shards)."""
    from docodo_tpu_torch.parallel import sharding as sh
    from docodo_tpu_torch.parallel.serving import ShardedDeviceIndex

    return (ShardedDeviceIndex.from_index(ind, mesh),
            ShardedDeviceIndex.from_index(ind, sh.make_mesh(
                len(mesh), devices=["cpu"] * len(mesh))))


def _check_sharded_on_card(ind, reqs, sdi, cpu, monkeypatch):
    """Every bucket of the requests' rows through sharded_query_full on
    the card (the kernels) against the CPU shards' plain route, field for
    field (ranks within 1 ulp), no bucket on the plain route but W >= 3
    with variants; then search_batch's results equal to the CPU shards'
    and, where served, to the host engine's."""
    from docodo_tpu_torch.ops import _cuda
    from docodo_tpu_torch.ops import device_index as tdi
    from docodo_tpu_torch.parallel import sharding as sh
    from docodo_tpu_torch.query.batcher import compile_request
    from docodo_tpu_torch.query.search import result_fields

    rows = [c for c in (compile_request(ind, r) for r in reqs) if c]
    plain = []
    inner = tdi.query_step_full
    monkeypatch.setattr(tdi, "query_step_full", lambda *a, **k: (
        a[5].is_cuda and plain.append((a[5].shape[1], tdi._variants(a[5])))
        or inner(*a, **k)))
    for k in _cuda.KERNELS.values():
        k.launches = 0
    for _, cap, terms, rs in sdi.bucket_arrays(rows):
        kw = dict(cap=cap, topk=64, hit_cap=1024)
        got = sh.sharded_query_full(
            sdi.devices, sdi._off, sdi._sc, sdi._bounds, sdi._page_doc,
            sdi._is_header, terms, rs, small=sdi._small,
            page_of=sdi._page_of, **kw)
        want = sh.sharded_query_full(
            cpu.devices, cpu._off, cpu._sc, cpu._bounds, cpu._page_doc,
            cpu._is_header, terms, rs, use_kernels=False, **kw)
        for f, (g, x) in enumerate(zip(got, want)):
            g, x = g.cpu(), x.cpu()
            if x.dtype == torch.float32:
                assert _ulps(g, x) <= 1, (cap, terms.shape, f)
            else:
                assert torch.equal(g, x), (cap, terms.shape, f)
    assert all(w >= 3 and v > 1 for w, v in plain) and sum(
        k.launches for k in _cuda.KERNELS.values()) > 0
    monkeypatch.setattr(tdi, "query_step_full", inner)
    got = sdi.search_batch(rows, materialize="defer")
    want = cpu.search_batch(rows, materialize="defer")
    served = 0
    for row, g, x in zip(rows, got, want):
        assert (g is None) == (x is None)
        if g is not None:
            a, b = result_fields(g), result_fields(x)
            assert a == b
            served += 1
    assert served > len(rows) // 3


def _ulps(a, b) -> int:
    x = a.contiguous().view(torch.int32).long()
    y = b.contiguous().view(torch.int32).long()
    return int((x - y).abs().max()) if x.numel() else 0


@pytest.mark.cuda
def test_sharded_full_path_on_card_equals_cpu(cuda_device, monkeypatch):
    """Four shards on one card: the kernels on every shard equal the CPU
    shards' plain route, and search_batch equals them."""
    from docodo_tpu_torch.parallel import sharding as sh

    ind, reqs = _serving_index()
    sdi, cpu = _sharded_pair(ind, sh.make_mesh(4, devices=["cuda:0"] * 4))
    assert {t.device for t in sdi._sc} == {torch.device("cuda", 0)}
    _check_sharded_on_card(ind, reqs, sdi, cpu, monkeypatch)


@pytest.mark.cuda
def test_sharded_full_path_on_two_cards(cuda_device, monkeypatch):
    """make_mesh(4) round robin over the host's cards (two or more):
    shards launch on cards other than cuda:0, with the same results."""
    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip("needs two CUDA cards")
    from docodo_tpu_torch.parallel import sharding as sh

    ind, reqs = _serving_index()
    mesh = sh.make_mesh(4)
    assert [d.index for d in mesh] == [i % cards for i in range(4)]
    sdi, cpu = _sharded_pair(ind, mesh)
    assert [t.device.index for t in sdi._sc] == [d.index for d in mesh]
    _check_sharded_on_card(ind, reqs, sdi, cpu, monkeypatch)


@pytest.mark.cuda
def test_batcher_mesh_on_card_from_threads(cuda_device):
    """BatchExecutor(mesh=make_mesh(4)) from 16 client threads: every
    request equal to the host engine, the stats adding up."""
    import concurrent.futures as cf

    from docodo_tpu_torch.parallel import sharding as sh
    from docodo_tpu_torch.query.batcher import BatchExecutor
    from docodo_tpu_torch.query.search import result_fields

    ind, reqs = _serving_index()
    want = {r: result_fields(ind.search(r)) for r in set(reqs)}
    ex = BatchExecutor(ind, mesh=sh.make_mesh(4), max_wait_ms=2.0)
    try:
        assert ex.pipeline is False and ex.sdi.devices[0].type == "cuda"
        with cf.ThreadPoolExecutor(16) as pool:
            served = list(pool.map(lambda r: (r, ex.search(r)), reqs))
    finally:
        ex.close()
    for req, res in served:
        assert result_fields(res) == want[req], req
    st = ex.stats
    assert st["device_queries"] + st["host_queries"] \
        + st["truncated_fallbacks"] == len(served)
    assert st["device_queries"] > 0 and st["device_timeouts"] == 0


def _disk_pair(tmp_path, device):
    """A seeded Zipf corpus written to disk by Index(path) on `device`
    and loaded back from its files, beside the same corpus built in
    memory: (loaded index, in-memory index, requests)."""
    from docodo_tpu_torch.index import Index, ListDataSource
    from docodo_tpu_torch.mix import serve_requests, wide_requests
    from docodo_tpu_torch.synthetic import zipf_documents

    docs = zipf_documents(400_000, seed=2, vocab=3000, doc_chars=20_000)
    disk = Index(str(tmp_path), device=device)
    disk.add_data_source(ListDataSource("synth", docs))
    disk.create()
    disk.dispose()
    loaded = Index(str(tmp_path), device=device)
    loaded.add_data_source(ListDataSource("synth", docs))
    mem = Index(device=device)
    mem.add_data_source(ListDataSource("synth", docs))
    mem.create()
    assert loaded.can_search and loaded.arr.terms == mem.arr.terms
    for a, b in ((loaded.arr.offsets, mem.arr.offsets),
                 (loaded.arr.coords, mem.arr.coords),
                 (loaded.pages.bounds, mem.pages.bounds),
                 (loaded.pages.page_doc, mem.pages.page_doc)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert loaded.pages.page_ids == mem.pages.page_ids
    assert loaded.arr.max_coord == mem.arr.max_coord
    return loaded, mem, serve_requests(mem, 240) + wide_requests(mem, 80)


@pytest.mark.cuda
def test_loaded_index_on_card_equals_the_in_memory_build(cuda_device,
                                                         tmp_path):
    """An index written by Index(path) and loaded from its files, staged
    on the card: the standard and wide mixes through the kernel route
    equal the in-memory build's device index field for field, and the
    kernels launched."""
    from docodo_tpu_torch.mix import (
        mix_queries,
        standard_mix,
        wide_mix,
    )
    from docodo_tpu_torch.ops import _cuda
    from docodo_tpu_torch.ops.device_index import DeviceIndex

    loaded, mem, _ = _disk_pair(tmp_path, cuda_device)
    a, b = DeviceIndex.from_index(loaded), DeviceIndex.from_index(mem)
    counts = np.diff(b.offsets_np)
    terms, rs = standard_mix(counts, b.terms, 2000)
    wt, wr, _ = wide_mix(counts, b.terms, 1000, seed=77)
    for k in _cuda.KERNELS.values():
        k.launches = 0
    for queries in (mix_queries(terms, rs, b.terms),
                    mix_queries(wt, wr, b.terms)):
        got = a.search_batch_full(queries, use_kernels=True)
        want = b.search_batch_full(queries, use_kernels=True)
        assert got.keys() == want.keys()
        for f in got:
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    assert sum(k.launches for k in _cuda.KERNELS.values()) > 0


@pytest.mark.cuda
def test_loaded_index_served_on_card_from_threads(cuda_device, tmp_path):
    """BatchExecutor over the loaded index on the card, 16 client threads:
    every request equal to the in-memory build's host engine, snippets
    included, some served on the card."""
    import concurrent.futures as cf

    from docodo_tpu_torch.query.batcher import BatchExecutor
    from docodo_tpu_torch.query.search import result_fields

    loaded, mem, reqs = _disk_pair(tmp_path, cuda_device)
    want = {r: result_fields(mem.search(r)) for r in set(reqs)}
    ex = BatchExecutor(loaded, max_wait_ms=2.0)
    try:
        assert ex.di.device.type == "cuda"
        with cf.ThreadPoolExecutor(16) as pool:
            served = list(pool.map(lambda r: (r, ex.search(r)), reqs))
    finally:
        ex.close()
    for req, res in served:
        assert result_fields(res) == want[req], req
    assert ex.stats["device_queries"] > 0
    assert ex.stats["device_timeouts"] == 0


# ---------------------------------------------------------------------------
# the probe kernels (csrc/probes.cu): PERF.md rows 18 and 19
# ---------------------------------------------------------------------------

def _probe_inputs(rng, rows, n, bounds):
    """Merged (coord, tag) rows of n lanes: word-A coordinates over the
    pages, word-B ones near them (so that rows keep hits), each row's
    length 1..n with INF32 / tag 2 after it, duplicates across the words,
    both window signs; and int32 bounds."""
    end = int(bounds[-1])
    vals = np.full((rows, n), INF32, np.int32)
    tag = np.full((rows, n), 2, np.int32)
    for i in range(rows):
        m = int(rng.integers(1, n + 1))
        a = rng.integers(0, end, size=(m + 1) // 2)
        b = np.minimum(rng.choice(a, size=m // 2) + rng.integers(0, 40,
                                                                  m // 2),
                       end + 50)
        v = np.concatenate([a, b]).astype(np.int64)
        t = np.concatenate([np.zeros(a.size), np.ones(b.size)])
        order = np.lexsort((t, v))
        vals[i, :m], tag[i, :m] = v[order], t[order]
    ra = np.where(np.arange(rows) % 3 == 0, -12, 30).astype(np.int32)
    rb = np.where(np.arange(rows) % 3 == 0, -9, 262).astype(np.int32)
    return vals, tag, ra, rb


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ("bounds", "arith", "two_level"))
@pytest.mark.parametrize("n,rows,pages,uneven", [
    (128, 5952, 578, False), (128, 61, 3000, True), (100, 33, 100, False),
    (256, 100, 256, True), (512, 9, 21971, True), (1024, 7, 129, True)])
def test_probe_locate_matches_plain_on_card(cuda_device, policy, n, rows,
                                            pages, uneven):
    """docodo_probe_locate under each page policy against its plain
    version: every output exact, ranks within 1 ulp; two_level equal to
    bounds; stream widths 100-1024, rows that leave the last block
    part-filled, one to 172 blocks of 128 bounds."""
    from docodo_tpu_torch.ops import probe_kernels as pk

    rng = np.random.default_rng(n + rows)
    bounds = (np.cumsum(rng.integers(500, 6000, size=pages)) if uneven
              else np.arange(1, pages + 1) * 3000).astype(np.int32)
    args = [torch.from_numpy(x).to(cuda_device)
            for x in _probe_inputs(rng, rows, n, bounds) + (bounds,)]
    got = pk.probe_locate(*args, policy=policy)
    want = pk.probe_locate_plain(*args, policy=policy)
    torch.cuda.synchronize()
    for k, (g, w) in enumerate(zip(got, want)):
        if g.dtype == torch.float32:
            assert _ulps(g, w) <= 1, k
        else:
            assert torch.equal(g, w), k
    assert int(got[4].sum()) > 0
    if policy == "two_level":
        base = pk.probe_locate(*args, policy="bounds")
        assert all(torch.equal(g, b) for g, b in zip(got, base))


def _ulps(a, b) -> int:
    ia = a.contiguous().view(torch.int32).long()
    ib = b.contiguous().view(torch.int32).long()
    return int((ia - ib).abs().max()) if a.numel() else 0


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ("copy", "sum128"))
@pytest.mark.parametrize("q", (32, 64, 128))
@pytest.mark.parametrize("r,n,b", [(512, 256, 100), (1, 128, 77),
                                   (16384, 2048, 1000), (300, 4096, 333),
                                   (64, 24576, 5)])
def test_row_gather_matches_plain_on_card(cuda_device, mode, q, r, n, b):
    """docodo_row_gather against tab[ids] and the sum formula, exact: B
    not a multiple of q, ids that repeat, one row, rows of 1-6 ring
    slots (96 KB a block)."""
    from docodo_tpu_torch.ops import probe_kernels as pk

    rng = np.random.default_rng(r + n + b + q)
    tab = torch.from_numpy(rng.integers(-(1 << 30), 1 << 30, (r, n))
                           .astype(np.int32)).to(cuda_device)
    ids = rng.integers(0, r, b).astype(np.int32)
    ids[::3] = ids[0]
    ids = torch.from_numpy(ids).to(cuda_device)
    before = pk._cuda.ROW_GATHER.launches
    got = pk.row_gather(tab, ids, mode=mode, q=q)
    want = pk.row_gather_plain(tab, ids, mode=mode, q=q)
    torch.cuda.synchronize()
    assert pk._cuda.ROW_GATHER.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_row_gather_copies_rows_of_any_quad_width(cuda_device):
    from docodo_tpu_torch.ops import probe_kernels as pk

    tab = torch.arange(5 * 20, dtype=torch.int32,
                       device=cuda_device).reshape(5, 20)
    ids = torch.tensor([4, 0, 0, 3], dtype=torch.int32, device=cuda_device)
    assert torch.equal(pk.row_gather(tab, ids), tab[ids.long()])


@pytest.mark.cuda
def test_probe_kernels_reject_what_they_cannot_take(cuda_device):
    from docodo_tpu_torch.ops import probe_kernels as pk

    tab = torch.zeros((8, 256), dtype=torch.int32, device=cuda_device)
    ids = torch.tensor([0, 8], dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        pk.row_gather(tab, ids)                     # an id past the table
    with pytest.raises(ValueError):
        pk.row_gather(tab, ids[:1], q=16)           # no such q
    with pytest.raises(ValueError):
        pk.row_gather(tab[:, :200], ids[:1], mode="sum128")
    vals = torch.zeros((2, 2048), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        pk.probe_locate(vals, vals, vals[:, 0], vals[:, 0],
                        torch.ones(3, dtype=torch.int32, device=cuda_device))
    with pytest.raises(ValueError):
        pk.probe_locate(vals[:, :128], vals[:, :128], vals[:, 0], vals[:, 0],
                        torch.ones(3, dtype=torch.int32, device=cuda_device),
                        policy="compare_all")


# the launch shapes of the redesigned probe kernels: row_gather's
# persistent grid (in both modes 264 blocks of 12 slots at n = 2048 on an
# H100 80GB HBM3) and probe_locate's warp a row

@pytest.mark.cuda
@pytest.mark.parametrize("mode", ("copy", "sum128"))
@pytest.mark.parametrize("q", (32, 64, 128))
@pytest.mark.parametrize("r,n,b", [(64, 2048, 0), (4096, 2048, 100),
                                   (4096, 2048, 1000), (16384, 2048, 10_007),
                                   (9, 24576, 300), (700, 128, 50_000)])
def test_row_gather_persistent_grid_on_card(cuda_device, mode, q, r, n, b):
    """docodo_row_gather exact against its plain version: no ids, fewer
    ids than the grid's blocks, shares of unequal length, ids repeated,
    rows as wide as the ring takes, more rows a block than its ring has
    slots; one launch a call with ids, none without."""
    from docodo_tpu_torch.ops import probe_kernels as pk

    rng = np.random.default_rng(r + n + b + q)
    tab = torch.from_numpy(rng.integers(-(1 << 30), 1 << 30, (r, n))
                           .astype(np.int32)).to(cuda_device)
    ids = rng.integers(0, r, b).astype(np.int32)
    ids[::5] = r - 1
    ids = torch.from_numpy(ids).to(cuda_device)
    before = pk._cuda.ROW_GATHER.launches
    got = pk.row_gather(tab, ids, mode=mode, q=q)
    want = pk.row_gather_plain(tab, ids, mode=mode, q=q)
    torch.cuda.synchronize()
    assert pk._cuda.ROW_GATHER.launches == before + (1 if b else 0)
    assert got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("q", (32, 64, 128))
def test_row_gather_copies_rows_of_four_lanes_on_card(cuda_device, q):
    from docodo_tpu_torch.ops import probe_kernels as pk

    rng = np.random.default_rng(q)
    tab = torch.from_numpy(rng.integers(-99, 99, (100, 4)).astype(np.int32)
                           ).to(cuda_device)
    ids = torch.from_numpy(rng.integers(0, 100, 5000).astype(np.int32)
                           ).to(cuda_device)
    assert torch.equal(pk.row_gather(tab, ids, q=q), tab[ids.long()])


def _probe_check(args, policy):
    from docodo_tpu_torch.ops import probe_kernels as pk

    got = pk.probe_locate(*args, policy=policy)
    want = pk.probe_locate_plain(*args, policy=policy)
    torch.cuda.synchronize()
    for k, (g, w) in enumerate(zip(got, want)):
        if g.dtype == torch.float32:
            assert _ulps(g, w) <= 1, k
        else:
            assert torch.equal(g, w), k
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ("bounds", "arith", "two_level"))
@pytest.mark.parametrize("n", (128, 1024))
def test_probe_locate_edge_rows_on_card(cuda_device, policy, n):
    """docodo_probe_locate against its plain version on rows of all
    INF32 padding, rows that keep no lane (word A only), a run across a
    page bound, and with one page."""
    rng = np.random.default_rng(n)
    bounds = np.arange(1, 41, dtype=np.int32) * 3000
    vals, tag, ra, rb = _probe_inputs(rng, 8, n, bounds)
    vals[0], tag[0] = INF32, 2
    tag[1, vals[1] < INF32] = 0
    vals[2, :4], tag[2, :4] = (2990, 2995, 3001, 3004), (0, 1, 0, 1)
    vals[2, 4:], tag[2, 4:] = INF32, 2
    for bd in (bounds, bounds[:1]):
        args = [torch.from_numpy(x).to(cuda_device)
                for x in (vals, tag, ra, rb, bd)]
        got = _probe_check(args, policy)
        assert int(got[4][0]) == 0 and int(got[3][0]) == 0
        assert int(got[4][1]) == 0
        assert int(got[4][2]) == 4
    assert int(got[3][2]) == 1  # one page: the run does not break


@pytest.mark.cuda
@pytest.mark.parametrize("n", (128, 1024))
def test_probe_locate_two_level_at_its_most_pages_on_card(cuda_device, n):
    from docodo_tpu_torch.ops import probe_kernels as pk

    rng = np.random.default_rng(n + 1)
    bounds = (np.arange(1, pk.MAX_TWO_LEVEL_PAGES + 1) * 7).astype(np.int32)
    args = [torch.from_numpy(x).to(cuda_device)
            for x in _probe_inputs(rng, 300, n, bounds) + (bounds,)]
    base = _probe_check(args, "bounds")
    got = _probe_check(args, "two_level")
    assert all(torch.equal(g, b) for g, b in zip(got, base))


@pytest.mark.cuda
def test_probe_locate_no_rows_launches_nothing(cuda_device):
    from docodo_tpu_torch.ops import probe_kernels as pk

    empty = torch.zeros((0, 128), dtype=torch.int32, device=cuda_device)
    one = torch.zeros((0,), dtype=torch.int32, device=cuda_device)
    before = pk._cuda.PROBE_LOCATE.launches
    got = pk.probe_locate(empty, empty, one, one,
                          torch.ones(3, dtype=torch.int32, device=cuda_device))
    assert pk._cuda.PROBE_LOCATE.launches == before
    assert got[0].shape == (0, 128) and got[3].shape == (0,)


def _chained_index(device):
    from docodo_tpu_torch.ops.device_index import DeviceIndex
    from docodo_tpu_torch.synthetic import build_index, zipf_documents

    ind = build_index(zipf_documents(2_000_000, seed=3), device="cpu")
    return DeviceIndex.from_index(ind, device=device)


@pytest.mark.cuda
def test_chained_calls_on_card_equal_unchained(cuda_device, monkeypatch):
    """Three reps of the standard mix's buckets through
    multi_bucket_query_full_chained on the kernel route, chained through
    their checksums and read back once: every field equal to the
    unchained call's, every checksum equal to the sums over its outputs,
    the kernels launched; likewise the page-level step."""
    from docodo_tpu_torch.mix import mix_queries, standard_mix
    from docodo_tpu_torch.ops import _cuda
    from docodo_tpu_torch.ops import device_index as di

    dix = _chained_index(cuda_device)
    terms, rs = standard_mix(np.diff(dix.offsets_np), dix.terms, 2000)
    queries = mix_queries(terms, rs, dix.terms)
    seen = {}
    for name in ("multi_bucket_query_full", "multi_bucket_query_step"):
        def record(*a, _inner=getattr(di, name), _name=name, **k):
            seen[_name] = (a, k)
            return _inner(*a, **k)
        monkeypatch.setattr(di, name, record)
    dix.search_batch_full(queries, topk=64, hit_cap=1024, use_kernels=True)
    dix.search_batch(queries, topk=16, use_kernels=True)
    monkeypatch.undo()
    for name, fields in (("multi_bucket_query_full",
                          ("pages", "ranks", "counts", "n_pages", "docs",
                           "doc_ranks", "hits", "n_hits")),
                         ("multi_bucket_query_step", (0, 1, 2))):
        a, k = seen[name]
        split = 5 if name.endswith("full") else 4
        plain = getattr(di, name)(*a, **k)
        want = torch.zeros((), device=cuda_device)
        for o in plain:
            want = (want + o.ranks.sum() + o.n_hits.float().sum()
                    if name.endswith("full") else want + o[1].sum())
        for kern in _cuda.KERNELS.values():
            kern.launches = 0
        chain = torch.zeros((), device=cuda_device)
        reps = []
        for _ in range(3):
            outs, chain = getattr(di, name + "_chained")(
                *a[:split + 2], chain, *a[split + 2:], **k)
            reps.append((outs, chain))
        assert float(chain) == float(want) > 0
        assert sum(kern.launches for kern in _cuda.KERNELS.values()) > 0
        for outs, s in reps:
            assert float(s) == float(want)
            for g, w in zip(outs, plain):
                for f in fields:
                    x = g[f] if isinstance(f, int) else getattr(g, f)
                    y = w[f] if isinstance(f, int) else getattr(w, f)
                    assert x.is_cuda and torch.equal(x, y), (name, f)


@pytest.mark.cuda
def test_set_ops_on_card_equal_cpu(cuda_device):
    """device_and / device_or / batch_and / batch_or / device_locate_rank
    and batched_query_step_variants on the card against the same calls
    on the CPU, on seeded posting lists: ints exact, ranks within 1 ulp."""
    from docodo_tpu_torch.ops import device_index as di
    from docodo_tpu_torch.ops import seqops

    rng = np.random.default_rng(23)
    bsz, cap = 64, 512
    base = np.cumsum(rng.integers(1, 40, size=(bsz, 2 * cap)), axis=1)
    pick = lambda: np.sort(np.argsort(rng.random((bsz, 2 * cap)), axis=1)
                           [:, :cap], axis=1)
    a = np.take_along_axis(base, pick(), axis=1).astype(np.int32)
    b = np.take_along_axis(base, pick(), axis=1).astype(np.int32)
    na = rng.integers(0, cap + 1, bsz).astype(np.int32)
    nb = rng.integers(0, cap + 1, bsz).astype(np.int32)
    ra = np.where(np.arange(bsz) % 2 == 0, 25, -25).astype(np.int32)
    rb = np.full(bsz, 20, dtype=np.int32)
    cpu = [torch.from_numpy(x) for x in (a, na, ra, b, nb, rb)]
    card = [x.to(cuda_device) for x in cpu]
    for op in (seqops.batch_and, seqops.batch_or):
        for out_cap in (None, 300):
            for g, w in zip(op(*card, out_cap=out_cap),
                            op(*cpu, out_cap=out_cap)):
                assert g.is_cuda and torch.equal(g.cpu(), w)
    for op in (seqops.device_and, seqops.device_or):
        for q in range(0, bsz, 9):
            args = [x[q] for x in card]
            for g, w in zip(op(*args), op(*[x[q] for x in cpu])):
                assert torch.equal(g.cpu(), w)
    bounds = torch.from_numpy(np.cumsum(rng.integers(50, 900, 400))
                              .astype(np.int32))
    page_doc = torch.arange(400, dtype=torch.int32) // 4
    out, n, _ = seqops.batch_and(*cpu)
    for q in range(0, bsz, 7):
        got = seqops.device_locate_rank(out[q].to(cuda_device), n[q],
                                        bounds.to(cuda_device),
                                        page_doc.to(cuda_device), 256)
        want = seqops.device_locate_rank(out[q], n[q], bounds, page_doc, 256)
        for g, w in zip(got[:3], want[:3]):
            assert torch.equal(g.cpu(), w)
        assert _ulps(got[3].cpu(), want[3]) <= 1

    dix = _chained_index("cpu")
    ddx = _chained_index(cuda_device)
    counts = np.diff(dix.offsets_np)
    pool = np.flatnonzero((counts > 64) & (counts <= 128))
    terms = rng.choice(pool, size=(256, 2, 3)).astype(np.int32)
    terms[::3, :, 2] = -1
    rs = np.where(rng.random((256, 2)) < 0.3, -9, 262).astype(np.int32)
    t, r = torch.from_numpy(terms), torch.from_numpy(rs)
    want = di.batched_query_step_variants(
        dix.term_offsets, dix.coords, dix.bounds, dix.page_doc, t, r, 128,
        16, dix.small)
    got = di.batched_query_step_variants(
        ddx.term_offsets, ddx.coords, ddx.bounds, ddx.page_doc,
        t.to(cuda_device), r.to(cuda_device), 128, 16, ddx.small)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[2].cpu(), want[2])
    assert _ulps(got[1].cpu(), want[1]) <= 1
    assert (want[2] > 0).any()
