"""The port's document sharding (docodo_tpu_torch.parallel.sharding)
against the JAX package's (docodo_tpu.parallel.sharding) on the CPU: the
host staging array for array; the sharded build, the page-level query
and the full-result leg over S = 2, 4 and 8 shards, every field of
[S, B, ...] against the JAX package's on its CPU mesh of 8 virtual
devices, with the JAX side on its XLA route and, for one small bucket
each of W = 1, W = 2 and V > 1, on its Pallas kernels in interpret mode.
Both sides stage the same host index (the port's build) through their
own ShardedDeviceIndex.from_index, whose staging is held equal too.

Tolerances: ranks and doc ranks within 2 float32 ulp (torch.log and
XLA's log differ by 1 ulp on about 1% of counts on the CPU); every other
field exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from docodo_tpu.parallel import serving as jserving
from docodo_tpu.parallel import sharding as jsh
from docodo_tpu_torch.parallel import sharding as sh
from docodo_tpu_torch.parallel.serving import ShardedDeviceIndex
from docodo_tpu_torch.synthetic import build_index, zipf_documents

from test_torch_slice import f32_ulps

RANK_ULPS = 2
FIELDS = ("pages", "ranks", "counts", "n_pages", "docs", "doc_ranks", "hits",
          "n_hits")


def _docs(seed, n_docs, rng_len=(5, 40), vocab=30):
    """Documents as (term_id, coord) streams with page ends, and their
    numpy twins."""
    rng = np.random.default_rng(seed)
    docs, doc_pages = [], []
    for _ in range(n_docs):
        n = int(rng.integers(*rng_len))
        coords = np.cumsum(rng.integers(2, 9, size=n)) - 2
        tids = rng.integers(0, vocab, size=n)
        docs.append(list(zip(tids.tolist(), coords.tolist())))
        ends = sorted(set(rng.integers(1, int(coords[-1]) + 2,
                                       size=int(rng.integers(0, 3))).tolist()))
        doc_pages.append([e for e in ends if e <= coords[-1]]
                         + [int(coords[-1]) + 3])
    doc_tids = [np.array([t for t, _ in d], dtype=np.int32) for d in docs]
    doc_coords = [np.array([c for _, c in d], dtype=np.int32) for d in docs]
    return docs, doc_pages, doc_tids, doc_coords


def _corpus_equal(got, want):
    for f in ("term_ids", "coords", "bounds", "page_doc", "page_base",
              "n_tokens"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert got.terms == want.terms and got.doc_assign == want.doc_assign


@pytest.mark.parametrize("seed,n_docs,shards", [(1, 7, 2), (2, 12, 4),
                                                (3, 30, 8), (4, 5, 8)])
def test_host_staging_equals_jax(seed, n_docs, shards):
    docs, doc_pages, doc_tids, doc_coords = _docs(seed, n_docs)
    sizes = [t.size for t in doc_tids]
    extents = [p[-1] for p in doc_pages]
    assert sh._assign_docs(sizes, extents, shards) == \
        jsh._assign_docs(sizes, extents, shards)
    contiguous = sh.assign_docs_contiguous(sizes, extents, shards)
    assert contiguous == jsh.assign_docs_contiguous(sizes, extents, shards)
    terms = [f"t{i}" for i in range(30)]
    _corpus_equal(sh.stage_shards(docs, doc_pages, terms, shards),
                  jsh.stage_shards(docs, doc_pages, terms, shards))
    for assign in (None, contiguous):
        _corpus_equal(
            sh.stage_shards_arrays(doc_tids, doc_coords, doc_pages, shards,
                                   terms, assign=assign),
            jsh.stage_shards_arrays(doc_tids, doc_coords, doc_pages, shards,
                                    terms, assign=assign))


@pytest.mark.parametrize("extents,shards", [([(1 << 31) + 5], 4),
                                            ([(1 << 30) + 9] * 5, 2)])
def test_shard_coordinate_overflow_equals_jax(extents, shards):
    sizes = [10] * len(extents)
    for fn in ("_assign_docs", "assign_docs_contiguous"):
        with pytest.raises(jsh.ShardCoordinateOverflow) as want:
            getattr(jsh, fn)(sizes, extents, shards)
        with pytest.raises(sh.ShardCoordinateOverflow) as got:
            getattr(sh, fn)(sizes, extents, shards)
        assert str(got.value) == str(want.value)
        assert issubclass(sh.ShardCoordinateOverflow, ValueError)


def test_make_mesh_needs_cuda_or_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sh.make_mesh(2)
    assert sh.make_mesh(3, devices=["cpu"] * 3) == (torch.device("cpu"),) * 3
    with pytest.raises(ValueError):
        sh.make_mesh(2, devices=["cpu"])


@pytest.fixture(scope="module")
def index():
    # 24 documents of ~20 KB: 3-4 pages each, a few hundred terms
    return build_index(zipf_documents(480_000, seed=5, vocab=2000,
                                      doc_chars=20_000), device="cpu")


@pytest.fixture(scope="module", params=[2, 4, 8])
def pair(request, index):
    """(port ShardedDeviceIndex, JAX ShardedDeviceIndex, S) over one
    index."""
    s = request.param
    mine = ShardedDeviceIndex.from_index(index, sh.make_mesh(
        s, devices=["cpu"] * s))
    ref = jserving.ShardedDeviceIndex.from_index(index, jsh.make_mesh(s))
    return mine, ref, s


def test_from_index_staging_equals_jax(pair):
    mine, ref, s = pair
    _corpus_equal(mine.corpus, ref.corpus)
    assert len(mine.shard_tables) == len(ref.shard_tables) == s
    for a, b in zip(mine.shard_tables, ref.shard_tables):
        assert np.array_equal(a.bounds, b.bounds) and a.bounds.dtype == \
            b.bounds.dtype
        assert np.array_equal(a.page_doc, b.page_doc)
        assert a.page_ids == b.page_ids and a.doc_names == b.doc_names
    assert np.array_equal(mine.boundaries, ref.boundaries)
    assert mine.boundaries.size == s - 1
    # each shard's page_of and small tables: the JAX package's stacked,
    # padded rows cut to the shard
    for k in range(s):
        n = int(mine.corpus.n_tokens[k])
        assert np.array_equal(mine._page_of[k].numpy()[:n],
                              np.asarray(ref._page_of)[k, :n])
        tabs = {(st.w, st.band): st for st in mine._small[k]}
        for w, band, row_map, tab in ref._small_stack:
            st = tabs.pop((w, band))
            rm = np.asarray(row_map)[k]
            assert np.array_equal(st.row_map.numpy(), rm)
            rows = st.tab.shape[0]
            assert np.array_equal(st.tab.numpy(), np.asarray(tab)[k, :rows])
        assert not tabs


def test_sharded_build_equals_jax(pair, index):
    mine, ref, s = pair
    corpus = mine.corpus
    num_terms = len(index.arr.terms)
    got = sh.sharded_build(sh.make_mesh(s, devices=["cpu"] * s),
                           corpus.term_ids, corpus.coords, num_terms)
    want = jsh.sharded_build(jsh.make_mesh(s), jnp.asarray(corpus.term_ids),
                             jnp.asarray(corpus.coords), num_terms)
    for g, w in zip(got, want):
        assert np.array_equal(torch.stack(g).numpy(), np.asarray(w))
    # the unpadded rows ShardedDeviceIndex stages: the padded rows cut
    for k in range(s):
        n = max(int(corpus.n_tokens[k]), 1)
        assert np.array_equal(mine._sc[k].numpy(), np.asarray(want[1])[k, :n])
        assert np.array_equal(mine._off[k].numpy(), np.asarray(want[2])[k])


def _pairs(sdi, rng, n, lo=2, hi=400):
    """[n, 2] term ids of words with lo..hi postings (some rows one word,
    -1 padded), windows of both signs."""
    counts = sdi._counts
    ok = np.flatnonzero((counts >= lo) & (counts <= hi))
    terms = rng.choice(ok, size=(n, 2)).astype(np.int32)
    terms[::3, 1] = -1
    rs = np.where(rng.random((n, 2)) < 0.3, -40, 300).astype(np.int32)
    return terms, rs


def test_sharded_query_equals_jax(pair):
    mine, ref, s = pair
    terms, rs = _pairs(mine, np.random.default_rng(s), 24)
    corpus = mine.corpus
    got = sh.sharded_query(mine.devices, mine._off, mine._sc, corpus.bounds,
                           corpus.page_doc, corpus.page_base, terms, rs,
                           cap=512, topk=16)
    want = jsh.sharded_query(
        ref.mesh, ref._off, ref._sc, ref._bounds, ref._page_doc,
        jnp.asarray(corpus.page_base), jnp.asarray(terms), jnp.asarray(rs),
        cap=512, topk=16)
    for f, (g, w) in enumerate(zip(got, want)):
        g, w = g.numpy(), np.asarray(w)
        if f == 1:
            assert f32_ulps(g, w) <= RANK_ULPS
        else:
            assert np.array_equal(g, w), f
    assert (np.asarray(want[0]) >= 0).sum() > 20


def _buckets(sdi, queries):
    """The port's (cap, W, V) buckets of `queries` as padded arrays."""
    return [(cap, terms, rs) for _, cap, terms, rs in
            sdi.bucket_arrays(queries)]


def _queries(sdi, rng, n):
    """Rows of every bucket kind: W = 1 and 2 words of few and many
    postings (the slot and chunked kernel routes), W = 3 phrases,
    variant ORs of W = 1 and 2."""
    terms = sdi.terms
    counts = sdi._counts
    few = [terms[t] for t in np.flatnonzero((counts > 3) & (counts <= 100))]
    many = [terms[t] for t in np.flatnonzero(counts > 150)]
    pick = lambda pool, k: [pool[i] for i in rng.choice(len(pool), k)]
    qs = []
    for i in range(n):
        kind = i % 6
        r = 260 if i % 4 else -30
        if kind == 0:
            qs.append([(pick(few, 1)[0], r)])
        elif kind == 1:
            qs.append([(w, r) for w in pick(few, 2)])
        elif kind == 2:
            qs.append([(w, r) for w in pick(many, 2)])
        elif kind == 3:
            qs.append([(w, 300) for w in pick(few + many, 3)])
        elif kind == 4:
            qs.append([(tuple(pick(few, 3)), r)])
        else:
            qs.append([(tuple(pick(few, 2)), r), (pick(few + many, 1)[0], r)])
    return qs


def _full_equal(got, want, what):
    for name, g, w in zip(FIELDS, got, want):
        if w is None:
            assert g is None, (what, name)
            continue
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, (what, name)
        if name in ("ranks", "doc_ranks"):
            assert f32_ulps(g, w) <= RANK_ULPS, (what, name)
        else:
            bad = np.argwhere(g != w)
            assert bad.size == 0, (what, name, bad[:4].tolist())


def test_sharded_query_full_equals_jax(pair):
    """Every bucket of a mixed batch through sharded_query_full on the
    kernel routes (the plain versions on the CPU), with each shard's
    page_of and small tables; the JAX package on its XLA route with its
    stacked tables; with and without docs."""
    mine, ref, s = pair
    rng = np.random.default_rng(10 + s)
    buckets = _buckets(mine, _queries(mine, rng, 36))
    assert {(t.shape[1], t.ndim) for _, t, _ in buckets} >= {
        (1, 2), (2, 2), (3, 2), (1, 3), (2, 3)}
    kinds = set()
    for cap, terms, rs in buckets:
        kw = dict(cap=cap, topk=16, hit_cap=128)
        got = sh.sharded_query_full(
            mine.devices, mine._off, mine._sc, mine._bounds, mine._page_doc,
            mine._is_header, terms, rs, small=mine._small,
            page_of=mine._page_of, **kw)
        want = jsh.sharded_query_full(
            ref.mesh, ref._off, ref._sc, ref._bounds, ref._page_doc,
            ref._is_header, jnp.asarray(terms), jnp.asarray(rs),
            small=ref._small_stack, page_of=ref._page_of, use_pallas=False,
            **kw)
        _full_equal(got, want, (cap, terms.shape))
        assert got[6].shape == (s, terms.shape[0], 128)
        kinds.add((cap, bool((want[3] > 16).any())))
    assert {c for c, _ in kinds} >= {128, 1024} and any(t for _, t in kinds)
    cap, terms, rs = buckets[0]
    got = sh.sharded_query_full(
        mine.devices, mine._off, mine._sc, mine._bounds, mine._page_doc,
        mine._is_header, terms, rs, cap=cap, topk=16, hit_cap=128,
        with_docs=False)
    assert got[4] is None and got[5] is None
    want = jsh.sharded_query_full(
        ref.mesh, ref._off, ref._sc, ref._bounds, ref._page_doc,
        ref._is_header, jnp.asarray(terms), jnp.asarray(rs), cap=cap,
        topk=16, hit_cap=128, with_docs=False, use_pallas=False)
    _full_equal(got, want, "without docs")


@pytest.mark.parametrize("kind", ["w1", "w2", "variants"])
def test_sharded_query_full_equals_jax_pallas(index, kind):
    """One small bucket each against the JAX package's Pallas kernels in
    interpret mode (its TPU mesh route), four shards."""
    mine = ShardedDeviceIndex.from_index(index, sh.make_mesh(
        4, devices=["cpu"] * 4))
    ref = jserving.ShardedDeviceIndex.from_index(index, jsh.make_mesh(4))
    counts = mine._counts
    few = np.flatnonzero((counts > 3) & (counts <= 60))[:16]
    if kind == "w1":
        terms = few[:8, None].astype(np.int32)
    elif kind == "w2":
        terms = np.stack([few[:8], few[8:]], axis=1).astype(np.int32)
    else:
        terms = np.stack([few[:8], few[8:]], axis=1)[:, None, :].astype(
            np.int32)
    rs = np.full(terms.shape[:2], 300, dtype=np.int32)
    kw = dict(cap=128, topk=16, hit_cap=128)
    got = sh.sharded_query_full(
        mine.devices, mine._off, mine._sc, mine._bounds, mine._page_doc,
        mine._is_header, terms, rs, small=mine._small,
        page_of=mine._page_of, **kw)
    want = jsh.sharded_query_full(
        ref.mesh, ref._off, ref._sc, ref._bounds, ref._page_doc,
        ref._is_header, jnp.asarray(terms), jnp.asarray(rs),
        small=ref._small_stack, page_of=ref._page_of, use_pallas=True, **kw)
    _full_equal(got, want, kind)
    assert (np.asarray(want[7]) > 0).any()


@pytest.mark.parametrize("n", [2, 4, 8])
def test_dryrun_multichip_on_cpu(n):
    sh.dryrun_multichip(n, devices=["cpu"] * n)
