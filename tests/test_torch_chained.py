"""The chained query calls (multi_bucket_query_full_chained,
multi_bucket_query_step_chained), the page-level step of variant rows
(batched_query_step_variants) and DeviceIndex.header_mask against the
JAX package's, on one seeded Zipf corpus, the JAX Pallas kernels in
interpret mode and the port's wrappers on their plain versions, as
tests/test_torch_serving_path.py runs them.

Tolerances: every int field exact; ranks and doc ranks within 2 ulp
(torch.log and XLA's log differ by 1 ulp on about 1% of counts on the
CPU); checksums within 1e-6 relative (float32 sums in another order).
Against the port's own unchained calls everything is exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from docodo_tpu.ops import device_index as jdi
from docodo_tpu_torch.ops import device_index as tdi
from docodo_tpu_torch.synthetic import build_index, zipf_documents

from test_torch_page_leg import assert_topk_equal, f32_ulps, page_queries

TOPK = 64
HIT_CAP = 512
PAGE_TOPK = 16
FULL_FIELDS = ("pages", "ranks", "counts", "n_pages", "docs", "doc_ranks",
               "hits", "n_hits")


@pytest.fixture(scope="module")
def corpus():
    ind = build_index(zipf_documents(300_000, seed=5, vocab=2500,
                                     doc_chars=30_000), device="cpu")
    jdx = jdi.DeviceIndex.from_index(ind)
    tdx = tdi.DeviceIndex.from_index(ind, device="cpu")
    return jdx, tdx, page_queries(tdx)


def _full_buckets(tdx, queries, monkeypatch):
    """The buckets search_batch_full hands multi_bucket_query_full:
    (terms_list, rs_list, caps, hit_caps)."""
    seen = []
    inner = tdi.multi_bucket_query_full

    def record(*a, **k):
        seen.append(a[5:10])
        return inner(*a, **k)

    monkeypatch.setattr(tdi, "multi_bucket_query_full", record)
    tdx.search_batch_full(queries, topk=TOPK, hit_cap=HIT_CAP,
                          use_kernels=True)
    monkeypatch.undo()
    (terms, rs, caps, _, hcaps), = seen
    return terms, rs, caps, hcaps


def _step_buckets(tdx, queries):
    """W = 1 rows at cap 128, W = 2 rows at cap 512 (both page-level
    kernels) and W = 3 rows at cap 128 (the torch route), each padded to
    whole rows of the Pallas programs."""
    groups = [([q for q in queries if len(q) == 1 and
                tdx.posting_count(q[0][0]) <= 128], 128),
              ([q for q in queries if len(q) == 2 and all(
                  0 < tdx.posting_count(w) <= 512 for w, _ in q)], 512),
              ([q for q in queries if len(q) == 3], 128)]
    terms, rs, caps = [], [], []
    for qs, cap in groups:
        t, r, _ = tdx.compile_queries(qs)
        pad = 8 - len(qs) % 8
        terms.append(np.concatenate(
            [t, np.full((pad, t.shape[1]), -1, np.int32)]))
        rs.append(np.concatenate([r, np.ones((pad, r.shape[1]), np.int32)]))
        caps.append(cap)
    return terms, rs, caps


def _assert_full_equal(got, want, exact: bool):
    for g, w in zip(got, want):
        for f in FULL_FIELDS:
            gv = getattr(g, f)
            gv = gv.numpy() if isinstance(gv, torch.Tensor) else gv
            wv = np.asarray(getattr(w, f))
            assert gv.shape == wv.shape and gv.dtype == wv.dtype, f
            if f in ("ranks", "doc_ranks") and not exact:
                assert f32_ulps(gv, wv) <= 2, f
            else:
                np.testing.assert_array_equal(gv, wv, err_msg=f)


def test_full_chained_equals_jax(corpus, monkeypatch):
    """Every bucket of the batch through the chained full call on the
    kernel route: each field equal to the JAX package's chained call
    (Pallas in interpret mode) and to the port's unchained call; the
    checksum (sum of ranks plus sum of n_hits) within 1e-6 of the JAX
    package's and equal to the same sums over the unchained outputs; a
    second rep chained through the first's checksum gives the same
    outputs."""
    jdx, tdx, queries = corpus
    terms, rs, caps, hcaps = _full_buckets(tdx, queries, monkeypatch)
    assert len(terms) >= 6 and {t.shape[1] for t in terms} >= {1, 2, 3}
    args = (tdx.term_offsets, tdx.coords, tdx.bounds, tdx.page_doc,
            tdx.header_mask())
    kw = dict(use_kernels=True, small=tdx.small, page_of=tdx.page_of)
    chain = torch.zeros((), dtype=torch.float32)
    got, s = tdi.multi_bucket_query_full_chained(
        *args, terms, rs, chain, caps, TOPK, hcaps, **kw)
    assert s.dtype == torch.float32 and s.dim() == 0
    plain = tdi.multi_bucket_query_full(*args, terms, rs, caps, TOPK, hcaps,
                                        **kw)
    _assert_full_equal(got, plain, exact=True)
    want_s = torch.zeros(())
    for o in plain:
        want_s = want_s + o.ranks.sum() + o.n_hits.to(torch.float32).sum()
    assert float(s) == float(want_s) > 0
    again, s2 = tdi.multi_bucket_query_full_chained(
        *args, terms, rs, s, caps, TOPK, hcaps, **kw)
    _assert_full_equal(again, got, exact=True)
    assert float(s2) == float(s)

    want, js = jdi.multi_bucket_query_full_chained(
        jdx.term_offsets, jdx.coords, jdx.bounds, jdx.page_doc,
        jdx.header_mask(), tuple(jnp.asarray(t.numpy()) for t in terms),
        tuple(jnp.asarray(r.numpy()) for r in rs), jnp.float32(0),
        tuple(caps), TOPK, tuple(hcaps), use_pallas=True, small=jdx.small,
        page_of=jdx.page_of)
    _assert_full_equal(got, want, exact=False)
    assert float(s) == pytest.approx(float(js), rel=1e-6)


def test_step_chained_equals_jax(corpus):
    """The chained page-level step on the kernel route, bucket for bucket
    against the JAX package's chained step (Pallas in interpret mode)
    and the port's unchained one; the checksum (sum of ranks)
    likewise."""
    jdx, tdx, queries = corpus
    terms, rs, caps = _step_buckets(tdx, queries)
    args = (tdx.term_offsets, tdx.coords, tdx.bounds, tdx.page_doc)
    tt = [torch.as_tensor(t) for t in terms]
    tr = [torch.as_tensor(r) for r in rs]
    kw = dict(use_kernels=True, small=tdx.small, page_of=tdx.page_of)
    got, s = tdi.multi_bucket_query_step_chained(
        *args, tt, tr, torch.zeros(()), caps, PAGE_TOPK, **kw)
    plain = tdi.multi_bucket_query_step(*args, tt, tr, caps, PAGE_TOPK, **kw)
    want_s = torch.zeros(())
    for g, p in zip(got, plain):
        assert_topk_equal(g, p, "unchained")
        for a, b in zip(g, p):
            assert torch.equal(a, b)
        want_s = want_s + p[1].sum()
    assert float(s) == float(want_s) > 0
    again, s2 = tdi.multi_bucket_query_step_chained(
        *args, tt, tr, s, caps, PAGE_TOPK, **kw)
    assert all(torch.equal(a, b) for g, h in zip(again, got)
               for a, b in zip(g, h)) and float(s2) == float(s)

    want, js = jdi.multi_bucket_query_step_chained(
        jdx.term_offsets, jdx.coords, jdx.bounds, jdx.page_doc,
        tuple(map(jnp.asarray, terms)), tuple(map(jnp.asarray, rs)),
        jnp.float32(0), tuple(caps), PAGE_TOPK, use_pallas=True,
        small=jdx.small, page_of=jdx.page_of)
    for g, w, cap in zip(got, want, caps):
        assert_topk_equal(g, w, f"bucket cap {cap}")
    assert float(s) == pytest.approx(float(js), rel=1e-6)


def _variant_rows(tdx, rng, rows: int, w: int, v: int, cap: int):
    """Rows of w words of up to v variants each (terms of count in
    (cap / 2, cap], so that rows find hits; -1 padded, a few rows with
    fewer words or variants), windows of both signs."""
    counts = np.diff(tdx.offsets_np)
    pool = np.flatnonzero((counts > cap // 2) & (counts <= cap))
    terms = rng.choice(pool, size=(rows, w, v)).astype(np.int32)
    nv = rng.integers(1, v + 1, size=(rows, w))
    terms[np.arange(v)[None, None, :] >= nv[:, :, None]] = -1
    if w > 1:
        terms[::5, w - 1] = -1
    rs = np.where(rng.random((rows, w)) < 0.3,
                  -rng.integers(8, 12, size=(rows, w)),
                  rng.integers(250, 270, size=(rows, w))).astype(np.int32)
    return terms, rs


@pytest.mark.parametrize("w,v,cap", [(1, 3, 128), (2, 4, 128),
                                     (3, 2, 128)])
def test_batched_query_step_variants_equals_jax(corpus, w, v, cap):
    jdx, tdx, _ = corpus
    rng = np.random.default_rng(w * 10 + v)
    terms, rs = _variant_rows(tdx, rng, 24, w, v, cap)
    got = tdi.batched_query_step_variants(
        tdx.term_offsets, tdx.coords, tdx.bounds, tdx.page_doc,
        torch.as_tensor(terms), torch.as_tensor(rs), cap, PAGE_TOPK,
        tdx.small)
    want = jdi.batched_query_step_variants(
        jdx.term_offsets, jdx.coords, jdx.bounds, jdx.page_doc,
        jnp.asarray(terms), jnp.asarray(rs), cap, PAGE_TOPK, small=jdx.small)
    assert_topk_equal(got, want, f"W {w} V {v}")
    assert (got[2] > 0).any()


def test_step_variants_of_one_variant_equal_the_step(corpus):
    """V = 1 rows through batched_query_step_variants equal
    batched_query_step on the same [B, W] rows."""
    _, tdx, _ = corpus
    terms, rs = _variant_rows(tdx, np.random.default_rng(3), 32, 2, 1, 128)
    args = (tdx.term_offsets, tdx.coords, tdx.bounds, tdx.page_doc)
    got = tdi.batched_query_step_variants(
        *args, torch.as_tensor(terms), torch.as_tensor(rs), 128, PAGE_TOPK,
        tdx.small)
    want = tdi.batched_query_step(
        *args, torch.as_tensor(terms[:, :, 0]), torch.as_tensor(rs), 128,
        PAGE_TOPK, tdx.small)
    for g, h in zip(got, want):
        assert torch.equal(g, h)


def test_header_mask_equals_jax(corpus):
    jdx, tdx, _ = corpus
    mask = tdx.header_mask()
    assert mask is tdx.is_header and mask.dtype == torch.bool
    assert mask.device == tdx.device
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jdx.header_mask()))
    assert mask.any() and not mask.all()
