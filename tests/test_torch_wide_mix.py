"""docodo_tpu_torch's search_batch_full against the JAX package's on a
seeded wide mix that reaches every bucket kind (W = 1-4 words, V = 1, 2,
4 and 8 variants, slot and chunked caps), on the kernel route (the
kernels' plain versions here) and on the plain route, and every served
row against the numpy host fold.

Tolerances: ranks and doc ranks within 2 ulp, because torch.log and
XLA's log differ by 1 ulp on about 1% of counts on the CPU; every other
field exact."""

import numpy as np
import pytest

from docodo_tpu.ops.device_index import DeviceIndex as JaxDeviceIndex
from docodo_tpu_torch.mix import mix_queries, wide_mix
from docodo_tpu_torch.ops import device_index as tdi
from docodo_tpu_torch.ops import query_kernels as qk
from docodo_tpu_torch.oracle import fold_row
from docodo_tpu_torch.synthetic import build_index, zipf_documents

RANK_ULPS = 2
TOPK = 64
HIT_CAP = 512
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


def alternations(counts, id_to_term, n, seed=77):
    """`a|b` alternation queries: one word of two variants, or a pair of
    such words."""
    rng = np.random.default_rng(seed)
    eligible = np.flatnonzero(counts >= 2)
    terms = np.full((n, 2, 2), -1, np.int32)
    rs = np.ones((n, 2), np.int32)
    for i in range(n):
        p = rng.choice(eligible, size=4, replace=False)
        w = 1 + i % 2
        terms[i, :w] = p[: 2 * w].reshape(w, 2)
        rs[i, :w] = -9 if i % 3 == 0 else 262
    return terms, rs


@pytest.fixture(scope="module")
def wide_corpus():
    """A seeded Zipf corpus, the wide mix over it with extra rows by
    posting count (caps 256-4096: the chunked variant and fold routes),
    `a|b` alternations, and the JAX package's results for them."""
    ind = build_index(zipf_documents(240_000, seed=5, vocab=3000,
                                     doc_chars=30_000), device="cpu")
    tdx = tdi.DeviceIndex.from_index(ind, device="cpu")
    counts = np.diff(tdx.offsets_np)
    terms, rs, _ = wide_mix(counts, tdx.terms, 35, seed=5)
    queries = mix_queries(terms, rs, tdx.terms)
    at, ar = alternations(counts, tdx.terms, 8)
    queries += mix_queries(at, ar, tdx.terms)
    top = [tdx.terms[t] for t in np.argsort(-counts, kind="stable")[:8]]
    mid = [tdx.terms[t] for t in np.flatnonzero((counts > 128)
                                                & (counts <= 512))[:6]]
    queries += [
        [(tuple(top[:3]), 262), (top[3], 260)],          # W=2 V=4 chunked
        [(tuple(mid[:4]), 260), (tuple(top[4:6]), -9)],
        [(tuple(mid[:8] + top[:1]), 260)],               # W=1 V=8 chunked
        [(top[0], 300), (top[1], 300), (top[2], 300)],   # W=3 big caps
        [(mid[0], -10), (top[1], -9), (mid[1], -9), (top[5], -12)],
    ]
    jdx = JaxDeviceIndex.from_index(ind)
    want = jdx.search_batch_full(queries, topk=TOPK, hit_cap=HIT_CAP,
                                 use_pallas=False)
    return tdx, queries, want


def test_search_batch_full_wide_mix_matches_jax(wide_corpus, monkeypatch):
    tdx, queries, want = wide_corpus
    kinds = set()
    for q in queries:
        cg = tdx.compile_group_query(q)
        kinds.add((cg[2], tdi._bucket(cg[3], lo=1)))
    assert {(1, 1), (2, 1), (3, 1), (4, 1), (1, 2), (2, 2), (2, 4),
            (1, 8)} <= kinds, kinds
    called = {}
    for name in ("variants_and_locate_full", "union_merge_locate_full",
                 "variants_keep", "and_keep_compact", "merge_tagged",
                 "locate_runs"):
        fn = getattr(qk, name)

        def counted(*a, _fn=fn, _name=name, **k):
            called[_name] = called.get(_name, 0) + 1
            return _fn(*a, **k)
        monkeypatch.setattr(qk, name, counted)
    plain = []
    inner = tdi.query_step_full
    monkeypatch.setattr(tdi, "query_step_full",
                        lambda *a, **k: plain.append(1) or inner(*a, **k))
    got = tdx.search_batch_full(queries, topk=TOPK, hit_cap=HIT_CAP,
                                use_kernels=True)
    assert_fields_equal(got, want, "kernel route")
    assert not plain and len(called) == 6, called
    assert_fields_equal(tdx.search_batch_full(queries, topk=TOPK,
                                              hit_cap=HIT_CAP,
                                              use_kernels=False),
                        want, "plain route")
    assert (got["n_hits"] > 0).sum() > len(queries) // 2


def test_wide_rows_match_the_host_fold(wide_corpus):
    """Every served row against the numpy fold: each word's variants
    OR-merged, then the proximity-AND left fold."""
    tdx, queries, want = wide_corpus
    coords = tdx.coords.numpy()
    off = tdx.offsets_np
    checked = 0
    for i, q in enumerate(queries):
        words = [[coords[off[t]: off[t + 1]] for t in
                  (tdx.term_id(c) for c in
                   ((codes,) if isinstance(codes, str) else codes))
                  if t >= 0] for codes, _ in q]
        acc = fold_row(words, [r for _, r in q])
        assert int(want["n_hits"][i]) == acc.size, i
        if acc.size <= HIT_CAP:
            np.testing.assert_array_equal(want["hits"][i][: acc.size], acc)
            checked += 1
    assert checked > len(queries) // 2
