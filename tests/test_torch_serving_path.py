"""The serving shape of the full-result leg: docodo_tpu_torch's
search_batch_full with the keywords a server sends (fused=False,
cap_ladder, deferred=True, and the escalated pass's clamp_budgets=True),
with an explicit cap, and batched_query_full per bucket shape, against
the JAX package's with the same keywords and its Pallas kernels in
interpret mode, on the corpus and mix of test_torch_slice.py plus
variant rows. sort_topk=False, which the JAX routing never passes, is
held against sort_topk=True on every row it serves whole.

Tolerances: ranks and doc_ranks within 2 ulp (torch.log and XLA's log
differ by 1 ulp on about 1% of counts on the CPU); every other field
exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from docodo_tpu.ops import device_index as jdi
from docodo_tpu_torch.ops import device_index as tdi
from docodo_tpu_torch.ops import query_kernels as qk
from docodo_tpu_torch.synthetic import build_index, zipf_documents

from test_torch_slice import assert_results_equal, f32_ulps, mixed_queries

TOPK = 64
HIT_CAP = 512
ESC_TOPK = 2048      # batcher.py:606-612
ESC_HIT_CAP = 1 << 13
ESC_CAP_MAX = 2048
LADDER = (128, 1024, 16384)  # batcher.py:746, as far as this corpus goes
SERVE = dict(cap_ladder=LADDER, fused=False)
TOPK_MODE = ("sorted_and_locate_full", "single_locate_full",
             "union_locate_full", "variants_and_locate_full",
             "merge_and_locate")


def _by_count(dix, lo, hi, k):
    counts = np.diff(dix.offsets_np)
    return [dix.terms[t]
            for t in np.flatnonzero((counts > lo) & (counts <= hi))[:k]]


@pytest.fixture(scope="module")
def serving():
    ind = build_index(zipf_documents(480_000, seed=7, vocab=5000,
                                     doc_chars=40_000), device="cpu")
    jdx = jdi.DeviceIndex.from_index(ind)
    tdx = tdi.DeviceIndex.from_index(ind, device="cpu")
    low, mid = _by_count(tdx, 32, 128, 6), _by_count(tdx, 300, 1024, 4)
    queries = mixed_queries(tdx) + [
        [(tuple(low[:2]), 260)],                          # W=1 V=2 slot
        [(tuple(low[:2]), 262), (tuple(low[2:4]), 258)],  # W=2 V=2 slot
        [(tuple(low[:3]), -10), (low[4], -12)],           # W=2 V=4 slot
        [(tuple(mid[:2]), 260), (mid[2], 262)],           # W=2 V=2 chunked
        [(low[0], 300), (low[1], 300), (mid[0], 300)],    # W=3 fold
    ]
    return jdx, tdx, queries


def _need(dix, q) -> int:
    cg = dix.compile_group_query(q)
    return 0 if cg is None else cg[4]


def _assert_served_rows_equal(got, want, budget):
    """Every field equal on the rows served whole (n_pages within the
    row's budget); the totals and hits on every row."""
    served = want["n_pages"] <= budget
    assert served.any() and not served.all()
    for k, w in want.items():
        rows = slice(None) if k in ("n_pages", "n_hits", "hits", "topk_eff",
                                    "hit_cap_eff") else served
        np.testing.assert_array_equal(got[k][rows], w[rows], err_msg=k)


def _count_modes(monkeypatch):
    """Which wrappers a batch calls, by sort_topk (merge_and_locate is
    the fused W = 2 kernel's sort_topk=False form)."""
    seen = set()
    for name in TOPK_MODE:
        fn = getattr(qk, name)

        def counted(*a, _fn=fn, _name=name, **k):
            seen.add((_name, k.get("sort_topk",
                                   _name != "merge_and_locate")))
            return _fn(*a, **k)
        monkeypatch.setattr(qk, name, counted)
    return seen


def test_per_bucket_path_equals_jax(serving, monkeypatch):
    jdx, tdx, queries = serving
    finish = jdx.search_batch_full(queries, topk=TOPK, hit_cap=HIT_CAP,
                                   deferred=True, use_pallas=True, **SERVE)
    want = finish()
    plain = []
    inner = tdi.query_step_full
    monkeypatch.setattr(tdi, "query_step_full",
                        lambda *a, **k: plain.append(1) or inner(*a, **k))
    finish = tdx.search_batch_full(queries, topk=TOPK, hit_cap=HIT_CAP,
                                   deferred=True, use_kernels=True, **SERVE)
    assert callable(finish)
    got = finish()
    assert_results_equal(got, want)
    assert not plain  # no W >= 3 bucket with variants in this mix
    assert (want["n_pages"] > TOPK).any() and (want["n_hits"] > 0).sum() > 10
    # the same batch at once, without docs, and on the plain route
    now = tdx.search_batch_full(queries, topk=TOPK, hit_cap=HIT_CAP,
                                use_kernels=True, want_docs=False, **SERVE)
    assert sorted(now) == sorted(set(want) - {"docs", "doc_ranks"})
    for k, v in now.items():
        np.testing.assert_array_equal(v, got[k], err_msg=k)
    assert_results_equal(
        tdx.search_batch_full(queries, topk=TOPK, hit_cap=HIT_CAP,
                              use_kernels=False, **SERVE), want)
    # one hit tier and power-of-four rows; the fused path keeps its tiers
    fused = tdx.search_batch_full(queries, topk=TOPK, hit_cap=HIT_CAP,
                                  use_kernels=True)
    untiered = fused["n_hits"] <= HIT_CAP
    for k in got:
        np.testing.assert_array_equal(got[k][untiered], fused[k][untiered],
                                      err_msg=k)


def test_sort_topk_false_equals_true_on_served_rows(serving, monkeypatch):
    jdx, tdx, queries = serving
    kw = dict(topk=TOPK, hit_cap=HIT_CAP, use_kernels=True, **SERVE)
    want = tdx.search_batch_full(queries, **kw)
    seen = _count_modes(monkeypatch)
    got = tdx.search_batch_full(queries, sort_topk=False, **kw)
    assert seen == {(name, False) for name in TOPK_MODE}, seen
    _assert_served_rows_equal(got, want, TOPK)
    # a truncated row's top-k-mode ranks are the true top k: no lower
    # than the first-topk-runs' ranks, slot for slot
    cut = want["n_pages"] > TOPK
    assert (got["ranks"][cut] >= want["ranks"][cut]).all()
    with pytest.raises(ValueError, match="per-bucket path"):
        tdx.search_batch_full(queries[:2], sort_topk=False)


def test_clamped_budgets_equal_jax(serving, monkeypatch):
    """The escalated pass: rows of cap <= 2048 at topk 2048 and 8192
    hits, each bucket's budgets cut to its cap."""
    jdx, tdx, queries = serving
    rows = [q for q in queries if 0 < _need(tdx, q) <= ESC_CAP_MAX]
    assert len(rows) > 20
    esc = dict(topk=ESC_TOPK, hit_cap=ESC_HIT_CAP, clamp_budgets=True,
               **SERVE)
    want = jdx.search_batch_full(rows, use_pallas=True, **esc)
    got = tdx.search_batch_full(rows, use_kernels=True, **esc)
    assert_results_equal(got, want)
    assert {128, 1024, 2048} <= set(got["topk_eff"].tolist())
    assert set(got["hit_cap_eff"].tolist()) >= {256, 2048, 8192}
    assert (got["n_pages"] > TOPK).any()
    assert (got["n_pages"] <= got["topk_eff"]).all()
    seen = _count_modes(monkeypatch)
    alt = tdx.search_batch_full(rows, use_kernels=True, sort_topk=False,
                                **esc)
    assert ("merge_and_locate", False) in seen
    for k, v in got.items():
        np.testing.assert_array_equal(alt[k], v, err_msg=k)
    # clamp_budgets alone also takes the per-bucket path (JAX :2353)
    fused = tdx.search_batch_full(rows[:12], use_kernels=True,
                                  topk=ESC_TOPK, hit_cap=ESC_HIT_CAP,
                                  clamp_budgets=True, cap_ladder=LADDER)
    for k, v in fused.items():
        np.testing.assert_array_equal(v, got[k][:12], err_msg=k)


@pytest.mark.parametrize("fused", [True, False])
def test_explicit_cap_equals_jax(serving, fused):
    """cap=256 for every query: longer lists are cut to 256 postings, no
    small table serves and no pages are carried."""
    jdx, tdx, queries = serving
    rows = queries[:12] + queries[-12:]
    assert max(_need(tdx, q) for q in rows) > 256
    kw = dict(topk=TOPK, hit_cap=HIT_CAP, cap=256, fused=fused)
    want = jdx.search_batch_full(rows, use_pallas=True, **kw)
    assert_results_equal(tdx.search_batch_full(rows, use_kernels=True, **kw),
                         want)


def _bucket_terms(tdx, cap, w, v, rows=8):
    """A bucket's padded terms and windows: words with more than cap / 2
    and at most cap postings, a padding row at the end."""
    words = _by_count(tdx, cap // 2, cap, rows + w * v)
    shape = (rows, w, v) if v > 1 else (rows, w)
    terms = np.full(shape, -1, np.int32)
    rs = np.ones((rows, w), np.int32)
    for i in range(rows - 1):
        ids = [tdx.term_id(words[(i + k) % len(words)])
               for k in range(w * v)]
        terms[i] = np.asarray(ids, np.int32).reshape(shape[1:])
        if v > 1 and i % 3 == 0:
            terms[i, :, -1] = -1  # a word with fewer variants
        # three rare words meet only within a wide window
        rs[i] = 30_000 if w > 2 else (-11 if i % 2 else 261)
    return terms, rs


@pytest.mark.parametrize("cap,w,v,topk", [
    (64, 1, 1, 64), (128, 2, 1, 64), (128, 1, 2, 16), (128, 2, 2, 16),
    (512, 1, 1, 16), (1024, 2, 1, 16), (1024, 2, 1, 2048),
    (2048, 1, 1, 16), (128, 3, 1, 16),
])
def test_batched_query_full_equals_jax(serving, cap, w, v, topk):
    jdx, tdx, _ = serving
    terms, rs = _bucket_terms(tdx, cap, w, v)
    hit_cap = 256
    want = jdi.batched_query_full(
        jdx.term_offsets, jdx.coords, jdx.bounds, jdx.page_doc,
        jdx.header_mask(), jnp.asarray(terms), jnp.asarray(rs), cap=cap,
        topk=topk, hit_cap=hit_cap, with_docs=True, use_pallas=True,
        small=jdx.small, page_of=jdx.page_of)
    args = (tdx.term_offsets, tdx.coords, tdx.bounds, tdx.page_doc,
            tdx.is_header, torch.as_tensor(terms), torch.as_tensor(rs))
    kw = dict(cap=cap, topk=topk, hit_cap=hit_cap, with_docs=True,
              use_kernels=True, small=tdx.small, page_of=tdx.page_of)
    got = tdi.batched_query_full(*args, **kw)
    assert isinstance(got, tdi.LocateFull)
    alt = tdi.batched_query_full(*args, sort_topk=False, **kw)
    served = got.n_pages.numpy() <= topk
    assert served[-1] and got.n_pages[-1] == 0 and (got.n_pages > 0).any()
    for name in tdi.LocateFull._fields:
        g, a, x = (getattr(o, name) for o in (got, alt, want))
        g, a, x = g.numpy(), a.numpy(), np.asarray(x)
        assert g.shape == x.shape and g.dtype == x.dtype, name
        if name in ("ranks", "doc_ranks"):
            assert f32_ulps(g, x) <= 2, name
        else:
            np.testing.assert_array_equal(g, x, err_msg=name)
        rows = served if name in ("pages", "ranks", "counts", "docs",
                                  "doc_ranks") else slice(None)
        np.testing.assert_array_equal(a[rows], g[rows], err_msg=name)


def test_bucket_full_refuses_sort_topk_false_without_tail(serving):
    _, tdx, _ = serving
    terms, rs = _bucket_terms(tdx, 64, 1, 1)
    with pytest.raises(ValueError, match="tail=False"):
        tdi._bucket_full(tdx.term_offsets, tdx.coords, tdx.bounds,
                         tdx.page_doc, tdx.is_header, torch.as_tensor(terms),
                         torch.as_tensor(rs), cap=64, topk=8, hit_cap=64,
                         with_docs=False, use_kernels=True, tail=False,
                         sort_topk=False)


@pytest.mark.parametrize("n,want", [(0, 8), (8, 8), (9, 32), (33, 128),
                                    (512, 512), (513, 2048)])
def test_bucket4_matches_jax(n, want):
    assert tdi._bucket4(n) == jdi._bucket4(n) == want
