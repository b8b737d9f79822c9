"""The page-level leg end to end: docodo_tpu_torch's search_batch and
multi_bucket_query_step against the JAX package's on one seeded Zipf
corpus, on the kernel route (the JAX Pallas kernels in interpret mode,
the port's wrappers on their plain versions) and on the torch / XLA
route. The queries reach both page-level kernels (W=1 caps 64-128, W=2
caps 64-512), buckets past their admission (W=1 cap 256, W=2 cap 1024,
W=3), ordered rows and an unknown word.

Tolerances: pages and counts exact; ranks within 2 ulp (torch.log and
XLA's log differ by 1 ulp on about 1% of counts on the CPU)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from docodo_tpu.ops import device_index as jdi
from docodo_tpu_torch.ops import device_index as tdi
from docodo_tpu_torch.ops import query_kernels as qk
from docodo_tpu_torch.synthetic import build_index, zipf_documents

TOPK = 16
RANK_ULPS = 2


def f32_ulps(a, b) -> int:
    a = np.ascontiguousarray(a, dtype=np.float32).view(np.int32)
    b = np.ascontiguousarray(b, dtype=np.float32).view(np.int32)
    return int(np.abs(a.astype(np.int64) - b).max()) if a.size else 0


def assert_topk_equal(got, want, what=""):
    for field, g, w in zip(("pages", "ranks", "counts"), got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, (what, field)
        if field == "ranks":
            assert f32_ulps(g, w) <= RANK_ULPS, (what, field)
        else:
            bad = np.argwhere(g != w)
            assert bad.size == 0, f"{what} {field} differs at {bad[:5]}"


def page_queries(dix):
    """Words by posting count, alone, paired (ordered and not) and in
    threes, so that the batch holds W=1 buckets at caps 64, 128 and 256,
    W=2 buckets at caps 64, 256, 512 and 1024 and a W=3 bucket, plus a
    query with an unknown word and an empty query."""
    counts = np.diff(dix.offsets_np)

    def by_count(lo, hi, k=3):
        ids = np.flatnonzero((counts > lo) & (counts <= hi))[:k]
        assert ids.size == k, (lo, hi)
        return [dix.terms[t] for t in ids]

    c64, c128 = by_count(20, 64), by_count(64, 128)
    c256, c512 = by_count(128, 256), by_count(256, 512)
    c1k = by_count(512, 1024, k=2)
    return [
        [(c64[0], 260)], [(c64[1], 261)], [(c128[0], 262)],
        [(c256[0], 259)],
        [(c64[0], 260), (c64[1], 258)], [(c64[1], -9), (c64[2], -10)],
        [(c64[2], 262), (c64[0], 262)],
        [(c256[0], 261), (c128[1], 260)], [(c256[1], -11), (c256[2], -9)],
        [(c512[0], 263), (c64[0], 259)], [(c512[1], -12), (c512[2], -8)],
        [(c1k[0], 260), (c1k[1], 262)],
        [(c128[0], 260), (c128[1], 261), (c128[2], 262)],
        [(c64[0], -9), (c128[0], -10), (c64[1], -11)],
        [("nosuchword", 260), (c64[0], 260)], [],
        [(c128[2], 258)], [(c512[0], 262), (c512[1], 262)],
    ]


@pytest.fixture(scope="module")
def corpus():
    ind = build_index(zipf_documents(300_000, seed=5, vocab=2500,
                                     doc_chars=30_000), device="cpu")
    jdx = jdi.DeviceIndex.from_index(ind)
    tdx = tdi.DeviceIndex.from_index(ind, device="cpu")
    return jdx, tdx, page_queries(tdx)


@pytest.fixture
def kernel_calls(monkeypatch):
    """Counts of the page-level wrappers' and the torch route's calls."""
    calls = {}

    def counting(mod, name):
        fn = getattr(mod, name)

        def wrapped(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **k)
        monkeypatch.setattr(mod, name, wrapped)

    counting(qk, "sorted_and_locate")
    counting(qk, "batched_single_locate")
    counting(tdi, "query_step")
    return calls


def test_search_batch_kernel_route_equals_jax(corpus, kernel_calls):
    jdx, tdx, queries = corpus
    want = jdx.search_batch(queries, topk=TOPK, use_pallas=True)
    got = tdx.search_batch(queries, topk=TOPK, use_kernels=True)
    assert_topk_equal(got, want, "kernel route")
    # W=1 caps 64, 128; W=2 caps 64, 256, 512; past admission W=1 cap
    # 256, W=2 cap 1024 and the W=3 bucket
    assert kernel_calls == {"batched_single_locate": 2,
                            "sorted_and_locate": 3, "query_step": 3}
    pages = got[0]
    assert (pages[14] == -1).all() and (pages[15] == -1).all()
    assert (pages[:12, 0] >= 0).sum() >= 9 and (pages[12:14, 0] >= 0).any()


def test_search_batch_torch_route_equals_jax(corpus, kernel_calls):
    jdx, tdx, queries = corpus
    want = jdx.search_batch(queries, topk=TOPK, use_pallas=False)
    got = tdx.search_batch(queries, topk=TOPK, use_kernels=False)
    assert_topk_equal(got, want, "torch route")
    assert set(kernel_calls) == {"query_step"}
    assert_topk_equal(tdx.search_batch(queries, topk=TOPK), got, "default")


def test_search_batch_cap_override_equals_jax(corpus, kernel_calls):
    """cap=64 cuts longer lists to their first 64 postings and passes
    neither the small tables nor page_of: the kernels locate from
    bounds."""
    jdx, tdx, queries = corpus
    want = jdx.search_batch(queries, topk=TOPK, cap=64, use_pallas=True)
    got = tdx.search_batch(queries, topk=TOPK, cap=64, use_kernels=True)
    assert_topk_equal(got, want, "cap override")
    assert kernel_calls == {"batched_single_locate": 1,
                            "sorted_and_locate": 1, "query_step": 1}
    full = tdx.search_batch(queries, topk=TOPK)
    assert (got[2] != full[2]).any()  # the cut changed some counts


def test_search_batch_cap_ladder_equals_jax(corpus, kernel_calls):
    jdx, tdx, queries = corpus
    ladder = (128, 512)
    want = jdx.search_batch(queries, topk=TOPK, cap_ladder=ladder,
                            use_pallas=True)
    got = tdx.search_batch(queries, topk=TOPK, cap_ladder=ladder,
                           use_kernels=True)
    assert_topk_equal(got, want, "cap ladder")
    # W=1 at 128 (kernel) and 512; W=2 at 128, 512 (kernels) and 1024
    # (past the ladder: its power of two); W=3 at 128
    assert kernel_calls == {"batched_single_locate": 1,
                            "sorted_and_locate": 2, "query_step": 3}
    assert_topk_equal(got, tdx.search_batch(queries, topk=TOPK), "ladder")


def test_search_batch_topk_past_the_stream(corpus):
    """topk 256 at caps 64 and 128 (n = 64 to 256): the kernel route and
    the torch route pad alike."""
    _, tdx, queries = corpus
    small = [q for q in queries[:7]]
    got = tdx.search_batch(small, topk=256, use_kernels=True)
    want = tdx.search_batch(small, topk=256, use_kernels=False)
    assert_topk_equal(got, want, "topk 256")
    assert got[0].shape == (7, 256) and (got[0][:, 128:] == -1).all()


def test_compile_queries_equals_jax(corpus):
    jdx, tdx, queries = corpus
    for pad_w in (0, 4):
        got = tdx.compile_queries(queries, pad_w=pad_w)
        want = jdx.compile_queries(queries, pad_w=pad_w)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2] and got[0].dtype == want[0].dtype
    assert (got[0][14] == -1).all()  # the unknown word's row


@pytest.mark.parametrize("use_kernels", [True, False])
def test_multi_bucket_query_step_equals_jax(corpus, use_kernels):
    """The dispatcher on compile_queries' arrays, bucket for bucket:
    W=1 at cap 128, W=2 at cap 512 and W=3 at cap 128, and
    batched_query_step on the last."""
    jdx, tdx, queries = corpus
    groups = [([q for q in queries if len(q) == 1 and
                tdx.posting_count(q[0][0]) <= 128], 128),
              ([q for q in queries if len(q) == 2 and all(
                  0 < tdx.posting_count(w) <= 512 for w, _ in q)], 512),
              ([q for q in queries if len(q) == 3], 128)]
    terms, rs, caps = [], [], []
    for qs, cap in groups:
        t, r, need = tdx.compile_queries(qs)
        assert need <= cap and len(qs) >= 2
        pad = 8 - len(qs) % 8  # whole rows of the Pallas programs
        terms.append(np.concatenate(
            [t, np.full((pad, t.shape[1]), -1, np.int32)]))
        rs.append(np.concatenate([r, np.ones((pad, r.shape[1]), np.int32)]))
        caps.append(cap)
    want = jdi.multi_bucket_query_step(
        jdx.term_offsets, jdx.coords, jdx.bounds, jdx.page_doc,
        tuple(map(jnp.asarray, terms)), tuple(map(jnp.asarray, rs)),
        tuple(caps), TOPK, use_pallas=use_kernels, small=jdx.small,
        page_of=jdx.page_of)
    got = tdi.multi_bucket_query_step(
        tdx.term_offsets, tdx.coords, tdx.bounds, tdx.page_doc,
        list(map(torch.as_tensor, terms)), list(map(torch.as_tensor, rs)),
        caps, TOPK, use_kernels=use_kernels, small=tdx.small,
        page_of=tdx.page_of)
    assert len(got) == 3
    for g, w, cap in zip(got, want, caps):
        assert_topk_equal(g, w, f"bucket cap {cap}")
    step = tdi.batched_query_step(
        tdx.term_offsets, tdx.coords, tdx.bounds, tdx.page_doc,
        torch.as_tensor(terms[2]), torch.as_tensor(rs[2]), 128, TOPK,
        tdx.small)
    assert_topk_equal(step, want[2], "batched_query_step")


def test_page_level_entry_points_default_to_the_kernels():
    import inspect

    sig = inspect.signature(tdi.DeviceIndex.search_batch)
    assert sig.parameters["use_kernels"].default is True
    assert sig.parameters["topk"].default == 16
