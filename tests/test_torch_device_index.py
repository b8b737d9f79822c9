"""docodo_tpu_torch's device index and plain route against the JAX
package's: staged state, the device build, the posting fetch at every
cap the small tables serve, the AND, doc grouping and kernel admission.
Inputs are seeded numpy arrays handed to both packages."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from docodo_tpu.ops import device_index as jdi
from docodo_tpu.ops import seqops as jseq
from docodo_tpu_torch.ops import device_index as tdi
from docodo_tpu_torch.ops import seqops as tseq
from docodo_tpu_torch.synthetic import build_index, zipf_documents

T = torch.as_tensor


def f32_ulps(a, b) -> int:
    a = np.ascontiguousarray(a, dtype=np.float32).view(np.int32)
    b = np.ascontiguousarray(b, dtype=np.float32).view(np.int32)
    return int(np.abs(a.astype(np.int64) - b).max()) if a.size else 0


@pytest.fixture(scope="module")
def indexes():
    ind = build_index(zipf_documents(300_000, seed=11, vocab=4000,
                                     doc_chars=20_000), device="cpu")
    return (ind, jdi.DeviceIndex.from_index(ind),
            tdi.DeviceIndex.from_index(ind, device="cpu"))


def _jax_state(jdx) -> dict:
    out = {
        "term_offsets": np.asarray(jdx.term_offsets),
        "coords": np.asarray(jdx.coords),
        "bounds": np.asarray(jdx.bounds),
        "page_doc": np.asarray(jdx.page_doc),
        "is_header": np.asarray(jdx.header_mask()),
        "page_of": np.asarray(jdx.page_of),
    }
    for i, st in enumerate(jdx.small or ()):
        out[f"small{i}_w"] = np.int64(st.w)
        out[f"small{i}_band"] = np.bool_(st.band)
        out[f"small{i}_row_map"] = np.asarray(st.row_map)
        out[f"small{i}_tab"] = np.asarray(st.tab)
    return out


def _assert_state_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_from_index_stages_the_jax_state(indexes):
    ind, jdx, tdx = indexes
    want = _jax_state(jdx)
    assert any(k.endswith("_band") and want[k] for k in want)
    _assert_state_equal(tdx.state(), want)
    again = tdi.DeviceIndex.from_state(want, jdx.terms, jdx.page_ids,
                                       jdx.doc_names, device="cpu")
    _assert_state_equal(again.state(), want)
    assert again.terms == tdx.terms and again.page_ids == tdx.page_ids
    np.testing.assert_array_equal(again.offsets_np, jdx.offsets_np)


def test_build_postings_matches_jax(rng):
    n, n_terms = 5000, 300
    tids = rng.integers(0, n_terms, n).astype(np.int32)
    coords = rng.permutation(1 << 20)[:n].astype(np.int32)
    tids[-40:] = jdi.INT32_MAX          # padding slots
    coords[-40:] = jdi.INT32_MAX
    want = jdi.build_postings(jnp.asarray(tids), jnp.asarray(coords),
                              n_terms)
    got = tdi.build_postings(T(tids), T(coords), n_terms)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_gather_term_paged_every_cap(indexes):
    """Every cap the cumulative and banded tables serve, plus a cap past
    them and no tables at all: the port fetches what the JAX package
    fetches, coords and pages."""
    _, jdx, tdx = indexes
    counts = np.diff(jdx.offsets_np)
    caps = sorted({st.w for st in tdx.small} | {65536})
    rng = np.random.default_rng(3)
    for cap in caps:
        ok = np.flatnonzero(counts <= cap)
        terms = rng.choice(ok, size=12).astype(np.int32)
        terms[3] = -1
        assert jdi._tab_serves(jdx.small, cap) == tdi._tab_serves(
            tdx.small, cap)
        modes = [(jdx.small, tdx.small)]
        if cap in (64, 256, 65536):
            modes.append((None, None))
        for small_j, small_t in modes:
            want = jax.jit(jax.vmap(lambda t: jdi.gather_term_paged(
                jdx.coords, jdx.page_of, jdx.term_offsets, t, cap,
                small_j)))(jnp.asarray(terms))
            got = tdi.gather_term_paged(tdx.coords, tdx.page_of,
                                        tdx.term_offsets, T(terms), cap,
                                        small_t)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                              err_msg=f"cap {cap}")
            wv, wn = jax.jit(jax.vmap(lambda t: jdi.gather_term(
                jdx.coords, jdx.term_offsets, t, cap, small_j)))(
                    jnp.asarray(terms))
            gv, gn = tdi.gather_term(tdx.coords, tdx.term_offsets,
                                     T(terms), cap, small_t)
            np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
            np.testing.assert_array_equal(gn.numpy(), np.asarray(wn))


@pytest.mark.parametrize("ordered", [False, True])
def test_and_masked_matches_jax(rng, ordered):
    bsz, cap = 12, 64
    a = np.full((bsz, cap), jseq.INF32, np.int32)
    b = np.full((bsz, cap), jseq.INF32, np.int32)
    na = rng.integers(0, cap + 1, bsz).astype(np.int32)
    nb = rng.integers(0, cap + 1, bsz).astype(np.int32)
    for i in range(bsz):
        pool = np.cumsum(rng.integers(1, 25, 2 * cap))
        a[i, :na[i]] = np.sort(rng.choice(pool, na[i], replace=False))
        b[i, :nb[i]] = np.sort(rng.choice(pool, nb[i], replace=False))
    sign = -1 if ordered else 1
    ra = np.full(bsz, 22 * sign, np.int32)
    rb = np.full(bsz, 18 * sign, np.int32)
    want = jax.vmap(jseq.and_masked)(jnp.asarray(a), jnp.asarray(na),
                                     jnp.asarray(ra), jnp.asarray(b),
                                     jnp.asarray(nb), jnp.asarray(rb))
    got = tseq.and_masked(T(a), T(na), T(ra), T(b), T(nb), T(rb))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_topk_nonneg_ties_go_to_the_lowest_slot():
    ranks = np.array([[1.5, 3.0, 3.0, 0.0, 3.0, 2.0, 1.5, 0.0]],
                     np.float32)
    wv, ws = jseq.topk_nonneg(jnp.asarray(ranks), 6)
    gv, gs = tseq.topk_nonneg(T(ranks), 6)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))


@pytest.mark.parametrize("n_pages", [90, 5000])
def test_doc_group_topk_matches_jax(rng, n_pages):
    """Both of the reference's doc lookups (doc-start compare-all within
    DOC_CA_MAX pages, gather above) against the port's gather, exact
    rank ties, invalid slots and header boosts."""
    bsz, topk = 16, 64
    # doc ordinals are dense, as in an index: every doc has its header
    # page, so the reference's doc-start count equals the gather
    page_doc = np.unique(rng.integers(0, n_pages // 6, n_pages),
                         return_inverse=True)[1].astype(np.int32)
    page_doc.sort()
    starts = np.concatenate([[True], page_doc[1:] != page_doc[:-1]])
    is_header = starts & (rng.random(n_pages) < 0.7)
    top_page = rng.integers(0, n_pages, (bsz, topk)).astype(np.int32)
    top_page[:, :8] = np.flatnonzero(starts)[:8]
    top_rank = rng.choice(np.float32([1.0, 2.0, 2.0 + np.log(3.0), 4.5]),
                          (bsz, topk)).astype(np.float32)
    cut = rng.integers(0, topk + 1, bsz)
    for i in range(bsz):
        top_rank[i, cut[i]:] = 0.0
        top_page[i, cut[i]:] = -1
    wd, wr = jax.vmap(jdi.doc_group_topk, in_axes=(0, 0, None, None))(
        jnp.asarray(top_page), jnp.asarray(top_rank),
        jnp.asarray(page_doc), jnp.asarray(is_header))
    gd, gr = tdi.doc_group_topk(T(top_page), T(top_rank), T(page_doc),
                                T(is_header))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
    assert f32_ulps(gr.numpy(), np.asarray(wr)) <= 2


def test_kernel_admission_matches_the_jax_rules(indexes):
    """_kernel_bucket_full declines exactly the shapes the JAX routing
    leaves to XLA: W=2 past cap 512, W=1 past 1024 (carried) and topk
    above the cap for W=1, W >= 3."""
    _, _, tdx = indexes

    def admitted(w, cap, topk=8, page_of=tdx.page_of):
        tq = torch.full((8, w), -1, dtype=torch.int32)
        rq = torch.ones((8, w), dtype=torch.int32)
        return tdi._kernel_bucket_full(
            tdx.term_offsets, tdx.coords, tdx.bounds, tq, rq, cap=cap,
            topk=topk, hit_cap=64, small=tdx.small,
            page_of=page_of) is not None

    assert admitted(2, 512) and not admitted(2, 1024)
    assert admitted(1, 1024) and not admitted(1, 2048)
    assert admitted(1, 64, topk=64) and not admitted(1, 64, topk=128)
    assert admitted(1, 256, page_of=None)
    assert not admitted(1, 512, page_of=None)
    assert not admitted(3, 64)


def test_wide_queries_raise_not_implemented(indexes):
    """The two shapes the port once refused, three words and a word of
    two variants, now equal the JAX package's search_batch_full on the
    kernel route (the kernels' plain versions here) and the plain
    route."""
    _, jdx, tdx = indexes
    counts = np.diff(tdx.offsets_np)
    words = [tdx.terms[t] for t in np.argsort(-counts, kind="stable")[:3]]
    queries = [[(w, 260) for w in words], [(tuple(words[:2]), 260)]]
    want = jdx.search_batch_full(queries, use_pallas=False)
    for use_kernels in (True, False):
        got = tdx.search_batch_full(queries, use_kernels=use_kernels)
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            if k in ("ranks", "doc_ranks"):
                assert f32_ulps(got[k], w) <= 2, k
            else:
                np.testing.assert_array_equal(got[k], w, err_msg=k)
    assert (want["n_hits"] > 0).all()


def test_multiword_variant_folds_match_jax(indexes):
    """W >= 3 with variant ORs, which no kernel takes in either package:
    the plain route's fold of per-word variant unions against the JAX
    package's, on both of the port's routes."""
    _, jdx, tdx = indexes
    counts = np.diff(tdx.offsets_np)
    top = [tdx.terms[t] for t in np.argsort(-counts, kind="stable")[:10]]
    queries = [
        [(tuple(top[:2]), 262), (top[2], 260), (tuple(top[3:6]), 263)],
        [(top[0], 280), (tuple(top[6:8]), 290), (top[8], 280),
         (tuple(top[1:3]), 300)],
        [(top[0], -9), (tuple(top[6:8]), -10), (top[8], -9)],
        [(tuple(top[4:6]), 300), ("nosuchword", 300), (top[9], 300)],
    ]
    want = jdx.search_batch_full(queries, use_pallas=False)
    for use_kernels in (True, False):
        got = tdx.search_batch_full(queries, use_kernels=use_kernels)
        for k, w in want.items():
            if k in ("ranks", "doc_ranks"):
                assert f32_ulps(got[k], w) <= 2, k
            else:
                np.testing.assert_array_equal(got[k], w, err_msg=k)
    assert (want["n_hits"][:2] > 0).all()
