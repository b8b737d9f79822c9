"""The port's document-sharded serving (docodo_tpu_torch.parallel.serving
ShardedDeviceIndex, BatchExecutor(mesh=), DocodoServer(mesh=)) on a CPU
mesh, the twin of every case of tests/test_sharded_serving.py: each
result held whole (result_fields, the words aside where the batch
leaves them to the caller) against the port's host engine
(Index.search), and its documents (names, ranks, pages, positions)
against docodo_tpu's ShardedDeviceIndex or BatchExecutor(mesh=) over
the same documents (built by both packages on one build thread), or,
where noted, over the port's own build. The boundary-reserve case does
not depend on the string hash seed; the reserve-rate case runs on a
seeded Zipf corpus.

Tolerance: exact."""

import json
import random
import urllib.request

import numpy as np
import pytest

import docodo_tpu
from docodo_tpu.native import pipeline as npipe
from docodo_tpu.parallel import serving as jserving
from docodo_tpu.parallel import sharding as jsh
from docodo_tpu.query import batcher as jbatcher
from docodo_tpu.sources.base import IndexPagedTextFile as JaxPagedTextFile
from docodo_tpu.sources.base import ListDataSource as JaxListDataSource
from docodo_tpu_torch.index import Index, IndexPagedTextFile, ListDataSource
from docodo_tpu_torch.parallel import sharding as sh
from docodo_tpu_torch.parallel.serving import ShardedDeviceIndex
from docodo_tpu_torch.query.batcher import BatchExecutor, compile_request
from docodo_tpu_torch.query.search import result_fields
from docodo_tpu_torch.server import DocodoServer
from docodo_tpu_torch.synthetic import zipf_documents

# fill the reference tokenizer's lazy tables on the collecting thread
# (ROADMAP Queue C: the first build of a process can race them)
npipe._tables()

_BODIES = [
    "the pickwick club met at noon and the club adjourned for dinner",
    "mr pickwick spoke to the club about travels and adventures abroad",
    "travels through kent were recounted by the club members at length",
    "noon came and went while pickwick pondered the proposed club rules",
    "the lady smiled at the club members who wandered through the town",
    "dinner was served at noon and the members of the club were pleased",
    "kent roads carried the club carriage through villages and fields",
    "adventures abroad were rare but the club pondered them at dinner",
    "a quiet dinner for the club closed the adventures of the evening",
    "pickwick and the club wandered through kent before dinner at noon",
]
# each doc padded past the default window (255 + len chars) with
# doc-unique filler, as tests/test_sharded_serving.py pads them
TEXTS = [b + " " + " ".join(f"filler{i}x{j}" for j in range(60))
         for i, b in enumerate(_BODIES)]
REQS = ["club", "pickwick club", '"pickwick club"', "dinner noon",
        "adventures abroad", "club kent", "wandered through", '"the club"']


def cpu_mesh(n):
    return sh.make_mesh(n, devices=["cpu"] * n)


def build_pair(docs, path):
    """(the port's Index, docodo_tpu.Index) over (name, text) docs."""
    ref = docodo_tpu.Index(path=str(path), in_memory=True)
    ref.max_degree_of_parallelism = 1
    ref.add_data_source(JaxListDataSource(
        "docs", [JaxPagedTextFile(n, t, "") for n, t in docs]))
    ref.create()
    mine = Index(device="cpu")
    mine.add_data_source(ListDataSource(
        "docs", [IndexPagedTextFile(n, t, "") for n, t in docs]))
    mine.create()
    return mine, ref


def _doc_view(res):
    return [(d.name, [(p.id, list(p.pos)) for p in d.pages], d.rank)
            for d in res.found_docs]


def _fields(res):
    """result_fields without the words, which search_batch leaves to
    its caller (the batcher fills them)."""
    out = result_fields(res)
    del out["words"]
    return out


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    mine, ref = build_pair([(f"d{i}", t) for i, t in enumerate(TEXTS)],
                           tmp_path_factory.mktemp("shsrv"))
    yield mine, ref
    ref.dispose()


@pytest.fixture(scope="module")
def sdis(pair):
    mine, ref = pair
    return (ShardedDeviceIndex.from_index(mine, cpu_mesh(8)),
            jserving.ShardedDeviceIndex.from_index(ref, jsh.make_mesh(8)))


def _both(pair, sdis, reqs, **kw):
    """Each request through both packages' search_batch, checked equal
    (the JAX package's own compile_request on its own index)."""
    mine, ref = pair
    got = sdis[0].search_batch([compile_request(mine, r) for r in reqs],
                               **kw)
    want = sdis[1].search_batch([jbatcher.compile_request(ref, r)
                                 for r in reqs], **kw)
    for req, g, w in zip(reqs, got, want):
        assert (g is None) == (w is None), req
        if g is not None:
            assert _doc_view(g) == _doc_view(w), req
            assert g.boundary_reserved == w.boundary_reserved, req
    return got


def test_sharded_serving_matches_host(pair, sdis):
    results = _both(pair, sdis, REQS, topk=32, hit_cap=256)
    for req, res in zip(REQS, results):
        assert res is not None, f"unexpected truncation for {req}"
        assert _fields(res) == _fields(pair[0].search(req)), req


def test_sharded_serving_unknown_word_matches_nothing(pair, sdis):
    [res] = _both(pair, sdis, ["club zzzzqqq"], topk=8, hit_cap=64)
    assert res is not None and res.found_docs == []


def test_sharded_serving_truncation_flags(pair, sdis):
    # 'club' is in every doc: a tiny budget must flag truncation
    [res] = _both(pair, sdis, ["club"], topk=1, hit_cap=2)
    assert res is None  # the caller re-serves it on the host


def test_sharded_staging_covers_all_docs(pair, sdis):
    sdi, ref = sdis
    names = sorted(n for t in sdi.shard_tables for n in t.doc_names)
    assert names == sorted(pair[0].pages.doc_names)
    assert sum(len(t.page_ids) for t in sdi.shard_tables) == \
        len(pair[0].pages.page_ids)
    assert sdi.corpus.doc_assign == ref.corpus.doc_assign
    assert sum(sdi.device_bytes()) > 0 and len(sdi.device_bytes()) == 8


def test_cross_document_groups_match_within_shard(tmp_path):
    """Coordinates are corpus-global, so windows span documents;
    contiguous assignment keeps such groups when both documents land on
    one shard."""
    docs = ["members gathered and talked about dinner",
            "pickwick arrived late to the gathering",
            "kent was quiet that particular evening",
            "travels resumed when the morning came"]
    mine, ref = build_pair([(f"c{i}", t) for i, t in enumerate(docs)],
                           tmp_path)
    try:
        sdi = ShardedDeviceIndex.from_index(mine, cpu_mesh(2))
        jsdi = jserving.ShardedDeviceIndex.from_index(ref, jsh.make_mesh(2))
        assert sdi.corpus.doc_assign == jsdi.corpus.doc_assign == \
            [[0, 1], [2, 3]]
        req = "dinner pickwick"  # spans the c0 / c1 boundary, one shard
        host = mine.search(req)
        assert host.found_docs
        [res] = sdi.search_batch([compile_request(mine, req)], topk=8,
                                 hit_cap=64)
        [want] = jsdi.search_batch([jbatcher.compile_request(ref, req)],
                                   topk=8, hit_cap=64)
        assert _fields(res) == _fields(host)
        assert _doc_view(res) == _doc_view(want)
    finally:
        ref.dispose()


def test_batcher_serves_from_mesh(pair):
    """BatchExecutor(mesh=) against the host engine (whole results) and
    the JAX package's BatchExecutor(mesh=): plain and phrase requests,
    wildcards, a field row and a -filter:, with the counters."""
    mine, ref = pair
    ex = BatchExecutor(mine, max_wait_ms=1.0, mesh=cpu_mesh(8), topk=32,
                       hit_cap=256)
    jex = jbatcher.BatchExecutor(ref, max_wait_ms=1.0, mesh=jsh.make_mesh(8),
                                 topk=32, hit_cap=256)
    try:
        assert ex.pipeline is False and ex.di is None
        reqs = ["club", '"pickwick club"', "dinner noon", "clu?",
                "{name=x} club", "club -filter:d[0-2]"]
        for req in reqs:
            got = ex.search(req)
            assert result_fields(got) == result_fields(mine.search(req)), req
            want = jex.search(req)
            assert _doc_view(got) == _doc_view(want), req
            assert [(w.word, w.n_found) for w in got.words] == \
                [(w.word, w.n_found) for w in want.words], req
        assert ex.search("club -filter:d[0-2]").found_docs
        for key in ("device_queries", "host_queries", "truncated_fallbacks",
                    "boundary_reserves", "boundary_risk"):
            assert ex.stats[key] == jex.stats[key] + (
                1 if key == "device_queries" else 0), key
        assert ex.stats["host_queries"] == 0
        assert ex.stats["boundary_reserves"] > 0
    finally:
        ex.close()
        jex.close()


def test_batcher_mesh_truncation_and_restage(tmp_path):
    """A request over the budget re-serves on the host engine (no
    escalation with a mesh); a create() restages the shards."""
    docs = [(f"d{i}", f"common words appear here plus unique{i} token")
            for i in range(40)]
    mine = Index(device="cpu")
    mine.add_data_source(ListDataSource(
        "docs", [IndexPagedTextFile(n, t, "") for n, t in docs]))
    mine.create()
    ex = BatchExecutor(mine, max_wait_ms=1.0, mesh=cpu_mesh(4), topk=8,
                       hit_cap=64)
    try:
        for req in ("common", "unique7", "common words"):
            assert result_fields(ex.search(req)) == \
                result_fields(mine.search(req)), req
        # "common" overflows; "common words" folds a window across the
        # short documents' shard boundaries and is evaluated on the host
        assert ex.stats["truncated_fallbacks"] == 1
        assert ex.stats["boundary_reserves"] == 1
        assert ex.stats["escalations"] == 0
        first = ex.sdi
        mine.create()
        assert result_fields(ex.search("unique3")) == \
            result_fields(mine.search("unique3"))
        assert ex.sdi is not first and ex._gen == mine.generation
    finally:
        ex.close()


def test_server_serves_from_mesh(pair):
    mine, _ = pair
    srv = DocodoServer(mine, port=0, host="127.0.0.1", mesh=cpu_mesh(2))
    srv.start(background=True)
    try:
        from docodo_tpu_torch.server import result_to_json

        for req in ("club", "dinner%20noon"):
            with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}"
                                        f"/search?req={req}") as r:
                body = json.loads(r.read().decode("utf-8"))
            want = result_to_json(mine.search(req.replace("%20", " ")))
            assert body == json.loads(json.dumps(want, ensure_ascii=False))
        assert srv.batcher.stats["device_queries"] == 2
    finally:
        srv.stop()


def test_sharded_brief_ranks_match_host_order(pair, sdis):
    [res] = _both(pair, sdis, ["club dinner"], topk=32, hit_cap=256,
                  materialize=False)
    host = pair[0].search("club dinner")
    assert [(d.name, d.rank) for d in res.found_docs] == \
        [(d.name, d.rank) for d in host.found_docs]


def test_mixed_batch_one_word_queries_not_annihilated(pair, sdis):
    reqs = ["noon", "dinner | travels", "pickwick club", '"the club"',
            "club dinner kent"]
    results = _both(pair, sdis, reqs, topk=32, hit_cap=256)
    for req, res in zip(reqs, results):
        host = pair[0].search(req)
        assert res is not None, req
        assert _fields(res) == _fields(host), req
        assert res.found_docs or not host.found_docs, req


BOUNDARY_DOCS = [("d0", "alpha filler words lead up to the ending tail"),
                 ("d1", "head starts the second document with omega words")]


def test_boundary_queries_reserve_to_exact_host_results(tmp_path):
    """A query whose window could cross the shard boundary re-serves
    exactly on the host under boundary="reserve" (the mesh result equals
    the host's, cross-boundary match included); boundary="flag" serves
    it from the shards, flagged, without the match. Both packages build
    on one thread, so nothing depends on the string hash seed."""
    mine, ref = build_pair(BOUNDARY_DOCS, tmp_path)
    try:
        sdi = ShardedDeviceIndex.from_index(mine, cpu_mesh(2))
        jsdi = jserving.ShardedDeviceIndex.from_index(ref, jsh.make_mesh(2))
        assert sdi.boundaries.size == 1
        assert np.array_equal(sdi.boundaries, jsdi.boundaries)
        queries = [[("tail", 259), ("head", 259)],  # spans the boundary
                   [("alpha", 260)]]                 # far from it
        host = mine.search("tail head")
        assert host.found_pages
        res = sdi.search_batch(queries, topk=8, hit_cap=64)
        want = jsdi.search_batch(queries, topk=8, hit_cap=64)
        assert res[0].boundary_reserved and not res[0].boundary_risk
        assert _fields(res[0]) == _fields(host)
        assert _fields(res[1]) == _fields(mine.search("alpha"))
        assert [_doc_view(r) for r in res] == [_doc_view(r) for r in want]
        flag = sdi.search_batch(queries, topk=8, hit_cap=64,
                                boundary="flag")
        assert flag[0].boundary_risk and not flag[0].found_docs
        assert flag[0].boundary_reserved is False
        if not flag[1].boundary_risk:
            assert _fields(flag[1]) == _fields(mine.search("alpha"))
    finally:
        ref.dispose()


@pytest.mark.parametrize("trial", range(3))
def test_boundary_reserve_straddling_windows_fuzz(tmp_path, trial):
    """Short documents (far below the window) put nearly every window
    across document, and so shard, boundaries: every result equals the
    host engine's, and the JAX package's."""
    rng = random.Random(4242 + trial)
    vocab = ("tail head alpha omega club dinner noon kent "
             "pickwick travels").split()
    docs = [(f"d{i}", " ".join(rng.choice(vocab)
                               for _ in range(rng.randrange(3, 9))))
            for i in range(rng.randrange(4, 10))]
    mine, ref = build_pair(docs, tmp_path)
    try:
        n = 2 if trial % 2 else 4
        sdis = (ShardedDeviceIndex.from_index(mine, cpu_mesh(n)),
                jserving.ShardedDeviceIndex.from_index(ref,
                                                       jsh.make_mesh(n)))
        reqs = [f"{rng.choice(vocab)} {rng.choice(vocab)}",
                f'"{rng.choice(vocab)} {rng.choice(vocab)}"',
                f"{rng.choice(vocab)} | {rng.choice(vocab)}",
                rng.choice(vocab)]
        results = _both((mine, ref), sdis, reqs, topk=64, hit_cap=1024)
        for req, res in zip(reqs, results):
            assert res is not None, req
            assert _fields(res) == _fields(mine.search(req)), req
    finally:
        ref.dispose()


def test_mesh_reserve_rate_bounds_at_corpus_scale():
    """The serving-shape mix over a seeded Zipf corpus of 16 documents on
    8 shards: reserves exist (windows straddle some of the 7 boundaries)
    but stay a minority, and every result checked equals the host
    engine's and the JAX package's ShardedDeviceIndex over the same
    build (brief ranks)."""
    docs = zipf_documents(240_000, seed=11, vocab=3000, doc_chars=15_000)
    mine = Index(device="cpu")
    mine.add_data_source(ListDataSource("docs", docs))
    mine.create()
    sdi = ShardedDeviceIndex.from_index(mine, cpu_mesh(8))
    assert sdi.boundaries.size == 7
    counts = sdi._counts
    order = np.argsort(-counts, kind="stable")
    words = [sdi.terms[t] for t in order[:400]
             if sdi.terms[t][0].isalpha() and len(sdi.terms[t]) >= 4][20:120]
    rng = random.Random(11)
    reqs = []
    for i in range(120):
        kind = i % 3
        if kind == 0:
            reqs.append(rng.choice(words))
        elif kind == 1:
            reqs.append(f'"{rng.choice(words)} {rng.choice(words)}"')
        else:
            reqs.append(f"{rng.choice(words)} {rng.choice(words)}")
    compiled = [compile_request(mine, r) for r in reqs]
    assert all(c is not None for c in compiled)
    results = sdi.search_batch(compiled, topk=64, hit_cap=1024)
    reserved = [i for i, r in enumerate(results)
                if r is not None and r.boundary_reserved]
    served = sum(r is not None for r in results)
    assert served >= 100, served
    assert 0 < len(reserved) <= served // 3, (len(reserved), served)
    sample = set(reserved) | {i for i in range(0, len(reqs), 7)
                              if results[i] is not None}
    for i in sample:
        assert _fields(results[i]) == _fields(mine.search(reqs[i])), reqs[i]
    # the JAX package's sharded serving over the port's build
    jsdi = jserving.ShardedDeviceIndex.from_index(mine, jsh.make_mesh(8))
    brief = sdi.search_batch(compiled, topk=64, hit_cap=1024,
                             materialize=False)
    want = jsdi.search_batch(compiled, topk=64, hit_cap=1024,
                             materialize=False)
    for req, g, w in zip(reqs, brief, want):
        assert (g is None) == (w is None), req
        if g is not None:
            assert _doc_view(g) == _doc_view(w), req
            assert g.boundary_reserved == w.boundary_reserved, req
