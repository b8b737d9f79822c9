"""The wide request surface's chunked bucket routes on the CPU: the
port's W >= 3 fold and oversize variant buckets, on the kernel route
(the kernels' plain versions here) and on the plain route, against the
JAX package's batched_query_full on its forced chunked route
(chunked="force", the interpret-mode Pallas kernels).

Tolerances: ranks and doc ranks within 2 ulp, because torch.log and
XLA's log differ by 1 ulp on about 1% of counts on the CPU; every other
field exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from docodo_tpu.ops import device_index as jdi
from docodo_tpu_torch.ops import device_index as tdi

RANK_ULPS = 2
T = torch.as_tensor
J = jnp.asarray
FIELDS = ("pages", "ranks", "counts", "n_pages", "n_hits", "hits", "docs",
          "doc_ranks")


def f32_ulps(a, b) -> int:
    a = np.ascontiguousarray(a, dtype=np.float32).view(np.int32)
    b = np.ascontiguousarray(b, dtype=np.float32).view(np.int32)
    return int(np.abs(a.astype(np.int64) - b).max()) if a.size else 0


def assert_fields_equal(got, want, what):
    for name in FIELDS:
        g, w = np.asarray(got[name]), np.asarray(want[name])
        assert g.shape == w.shape, (what, name)
        if name in ("ranks", "doc_ranks"):
            assert f32_ulps(g, w) <= RANK_ULPS, (what, name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {name}")


def _postings(seed, n_terms, lo, hi, small_counts, span):
    """The seeded corpus of tests/test_pallas_query.py's fold and
    oversize-variant tests: n_terms terms of lo..hi postings (the last
    ones small, for the banded tables' cumulative base), 3000-char
    pages, and page-carrying small tables."""
    nprng = np.random.default_rng(seed)
    counts = nprng.integers(lo, hi, size=n_terms)
    counts[-len(small_counts):] = small_counts
    tids = np.repeat(np.arange(n_terms), counts).astype(np.int32)
    coords = np.sort(nprng.choice(span, size=int(counts.sum()),
                                  replace=False)).astype(np.int32)
    nprng.shuffle(tids)
    _, sc, off = jdi.build_postings(J(tids), J(coords), n_terms)
    sc, off = np.array(sc), np.array(off)
    bounds = np.arange(3000, span + 3000, 3000, dtype=np.int32)
    pages = jdi.build_page_of(bounds, sc)
    small = jdi.build_small_tables(off.astype(np.int64), sc, pages_np=pages)
    tsmall = tdi.build_small_tables(off.astype(np.int64), sc, pages_np=pages)
    return nprng, dict(off=off, sc=sc, bounds=bounds, pages=pages,
                       small=small,
                       tsmall=tuple(st.to("cpu") for st in tsmall))


def _route_case(x, tq, rq, cap, pd, hdr, monkeypatch):
    """One bucket through JAX's forced chunked route and through the
    port's kernel and plain routes; the port's chunked route must serve
    it."""
    kw = dict(cap=cap, topk=16, hit_cap=512, with_docs=True)
    want = jdi.batched_query_full(
        J(x["off"]), J(x["sc"]), J(x["bounds"]), J(pd), J(hdr), J(tq), J(rq),
        use_pallas=True, chunked="force", page_of=J(x["pages"]),
        small=x["small"], **kw)
    want = {f: np.asarray(getattr(want, f)) for f in FIELDS}
    served = []
    inner = tdi._chunked_bucket_full

    def seen(*a, **k):
        out = inner(*a, **k)
        served.append(out is not None)
        return out
    monkeypatch.setattr(tdi, "_chunked_bucket_full", seen)
    for use_kernels in (True, False):
        (got,) = tdi.multi_bucket_query_full(
            T(x["off"]), T(x["sc"]), T(x["bounds"]), T(pd), T(hdr),
            [T(tq)], [T(rq)], [cap], 16, [512], with_docs=True,
            use_kernels=use_kernels, small=x["tsmall"],
            page_of=T(x["pages"]))
        assert_fields_equal({f: getattr(got, f).numpy() for f in FIELDS},
                            want, f"kernels {use_kernels}")
    assert served == [True]
    return want


@pytest.mark.parametrize("w,bsz", [(3, 9), (4, 6)])
def test_fold_route_matches_jax(monkeypatch, w, bsz):
    """The W >= 3 carried fold (merge, AND keep with compaction, and the
    locate kernel per step) on tests/test_pallas_query.py:529-585's
    inputs: ordered and proximity rows, rows with empty results."""
    nprng, x = _postings(77, 12, 200, 900, (30, 70), 400_000)
    npg = x["bounds"].shape[0]
    pd = (np.arange(npg) // 9).astype(np.int32)
    hdr = np.arange(npg) % 9 == 0
    assert tdi._tab_serves(x["tsmall"], 1024)
    for w_ in (3, 4):  # the draws of the original test, in its order
        tq = nprng.integers(0, 10, (9 if w_ == 3 else 6, w_)).astype(
            np.int32)
        if w_ == w:
            break
    rv = np.where(np.arange(bsz)[:, None] % 2, 5000, -9)
    rq = np.broadcast_to(rv, (bsz, w)).astype(np.int32)
    want = _route_case(x, tq, rq, 1024, pd, hdr, monkeypatch)
    assert want["n_hits"].max() > 0 and (want["n_hits"] == 0).any()


@pytest.mark.parametrize("v,bsz,cap", [(3, 8, 512), (4, 6, 512),
                                       (3, 8, 1024), (4, 6, 2048)])
def test_oversize_variants_route_matches_jax(monkeypatch, v, bsz, cap):
    """W = 2 variant buckets past slot admission (merge of every variant
    block, the variants keep kernel, the locate kernel) on
    tests/test_pallas_query.py:587-650's inputs: cross-variant duplicate
    coordinates, empty variants, a padded word B, a term shared across
    words, ordered and proximity windows."""
    nprng, x = _postings(55, 16, 150, 500, (25, 60), 300_000)
    npg = x["bounds"].shape[0]
    pd = (np.arange(npg) // 8).astype(np.int32)
    hdr = np.arange(npg) % 8 == 0
    for case in ((3, 8, 512), (4, 6, 512), (3, 8, 1024), (4, 6, 2048)):
        tq = nprng.integers(0, 14, (case[1], 2, case[0])).astype(np.int32)
        if case == (v, bsz, cap):
            break
    tq[0, 1, :] = -1
    tq[1, 0, 1:] = -1
    tq[2, 1, 0] = tq[2, 0, 0]
    rv = np.where(np.arange(bsz)[:, None] % 2, 4000, -9)
    rq = np.broadcast_to(rv, (bsz, 2)).astype(np.int32)
    want = _route_case(x, tq, rq, cap, pd, hdr, monkeypatch)
    assert want["n_hits"].max() > 0
