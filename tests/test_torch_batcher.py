"""The port's micro-batching executor (docodo_tpu_torch.query.batcher) and
server against the JAX package's: every case of tests/test_batcher.py but
the web crawl, on the same inline documents, the port's executor on a CPU
index (device="cpu": each kernel wrapper's plain version) held against
docodo_tpu's BatchExecutor and against docodo_tpu.Index.search, with the
fallback counters; then escalation against the reference's host
fallback, both pipeline modes, restaging after create() and 16 client
threads, and the HTTP server on the loopback.

Tolerance: exact (docs, pages, positions, ranks, words, summaries,
snippets, counters), except brief-mode doc ranks, which come off the
device: within 2 float32 ulp of the JAX package's executor (torch.log
and XLA's log differ by 1 ulp on the CPU, ROADMAP Queue C), and within
1e-4 relative of the host engine, as tests/test_batcher.py holds them.
Each index is built by both packages on one build thread."""

import concurrent.futures as cf
import json
import sys
import threading
import urllib.parse
import urllib.request
from contextlib import contextmanager

import numpy as np
import pytest
import torch

import docodo_tpu
from docodo_tpu.native import pipeline as npipe
from docodo_tpu.query import batcher as jax_batcher
from docodo_tpu.server import result_to_json as jax_result_to_json
from docodo_tpu.sources.base import IndexPagedTextFile as JaxPagedTextFile
from docodo_tpu.sources.base import ListDataSource as JaxListDataSource
from docodo_tpu_torch.index import Index, IndexPagedTextFile, ListDataSource
from docodo_tpu_torch.ops.device_index import DeviceIndex
from docodo_tpu_torch.query.batcher import BatchExecutor, compile_request
from docodo_tpu_torch.query.search import brief_ulps, result_fields
from docodo_tpu_torch.server import DocodoServer, result_to_json

# fill the reference tokenizer's lazy tables on the collecting thread
# (ROADMAP Queue C: the first build of a process can race them)
npipe._tables()

DOCS = [
    ("alpha", "the pickwick club met at noon near the old tavern", ""),
    ("beta", "the club adjourned after dinner and wandered home", ""),
    ("gamma", "dinner at the tavern started well before noon", ""),
]
FIELD_DOCS = [
    ("alpha", "the pickwick club met at noon", "name=alpha\nauthor=dickens"),
    ("beta", "the club adjourned after dinner", "name=beta\nauthor=trollope"),
]
COMMON_DOCS = [(f"d{i}", f"common words appear here plus unique{i} token", "")
               for i in range(40)]
COUNTERS = ("device_queries", "host_queries", "truncated_fallbacks",
            "fallback_unsupported", "fallback_shape", "fallback_no_index",
            "escalations")
PIPELINE = pytest.mark.parametrize("pipeline", [False, True],
                                   ids=["direct", "pipelined"])


def build_pair(tmp_path, docs=()):
    """(the port's Index, docodo_tpu.Index), both built over `docs`;
    without documents, neither has a source or a build."""
    ref = docodo_tpu.Index(path=str(tmp_path), in_memory=True)
    ref.max_degree_of_parallelism = 1
    mine = Index(device="cpu")
    if docs:
        ref.add_data_source(JaxListDataSource(
            "docs", [JaxPagedTextFile(*d) for d in docs]))
        mine.add_data_source(ListDataSource(
            "docs", [IndexPagedTextFile(*d) for d in docs]))
        ref.create()
        mine.create()
    return mine, ref


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    mine, ref = build_pair(tmp_path_factory.mktemp("bidx"), DOCS)
    yield mine, ref
    ref.dispose()


@contextmanager
def executors(mine, ref, **kw):
    """The port's executor on the CPU and the JAX package's, with the same
    arguments (pipeline and escalate given to both: their defaults
    differ, ROADMAP Queue C)."""
    kw.setdefault("pipeline", False)
    kw.setdefault("escalate", False)
    ex = BatchExecutor(mine, device="cpu", **kw)
    rex = jax_batcher.BatchExecutor(ref, **kw)
    try:
        yield ex, rex
    finally:
        ex.close()
        rex.close()


def assert_brief_equal(got, want, ulp: int = 2, rel: float = 0.0):
    """Brief-mode results: every field exact but doc ranks, which agree
    within `ulp` float32 ulp or, with `rel`, that relative error."""
    g, w = result_fields(got), result_fields(want)
    if not rel:
        assert g["pages"] == w["pages"]
        worst = brief_ulps(got, want)
        assert worst is not None and worst <= ulp, worst
        return
    gr = [d[1] for d in g.pop("docs")]
    wdocs = w.pop("docs")
    assert [d.name for d in got.found_docs] == [d[0] for d in wdocs]
    assert [p[:2] for p in g["pages"]] == [p[:2] for p in w["pages"]]
    for a, b in zip(gr, [d[1] for d in wdocs]):
        assert abs(a - b) <= rel * max(1.0, abs(b)), (a, b)


def check(ex, rex, mine, ref, req, brief=False):
    """One request through both executors and both host engines."""
    got, want, host = ex.search(req), rex.search(req), ref.search(req)
    assert result_fields(mine.search(req)) == result_fields(host), req
    if brief:
        assert_brief_equal(got, want)
        assert_brief_equal(got, host, rel=1e-4)
    else:
        assert result_fields(got) == result_fields(want), req
        assert result_fields(got) == result_fields(host), req
    return got


def assert_counters_equal(ex, rex):
    assert {k: ex.stats[k] for k in COUNTERS} == \
        {k: rex.stats[k] for k in COUNTERS}


COMPILE_REQS = [
    "pickwick club", '"pickwick club"', "pick?ick", "{Name=x} word",
    "a | b", "club -filter:xyz", "xy", 'apple "bank account"',
    '"bank account" apple', '"bank account"', '"bank account" "old tavern"',
    "club | tavern", "dinner (club|tavern)", "wandered", "club ~tavern",
    "?zzzzz?", "the club", "club zzqq",
]


@pytest.mark.parametrize("req", COMPILE_REQS)
def test_compile_request_forms(pair, req):
    """compile_request equals the JAX package's, without and with field
    rows and filters, and its fail reason too."""
    mine, ref = pair
    outs = []
    for mod, ind in ((sys.modules[compile_request.__module__], mine),
                     (jax_batcher, ref)):
        plain = mod.compile_request(ind, req)
        fields, filters, reason, words = [], [], [], []
        full = mod.compile_request(ind, req, words_out=words,
                                   reason_out=reason, field_out=fields,
                                   filters_out=filters)
        outs.append((plain, full, fields, filters, reason,
                     [w.word for w in words]))
    assert outs[0] == outs[1]


def test_compile_request_forms_as_the_reference_asserts(pair):
    mine, _ = pair
    c = compile_request(mine, "pickwick club")
    assert c is not None and len(c) == 2 and all(r > 0 for _, r in c)
    assert all(r < 0 for _, r in compile_request(mine, '"pickwick club"'))
    (codes, r), = compile_request(mine, "pick?ick")
    assert "pickwick" in codes and r == -(len("pick_ick") + 4)
    assert compile_request(mine, "{Name=x} word") is None
    fields = []
    assert compile_request(mine, "{Name=alpha} club",
                           field_out=fields) is not None
    assert fields[0][0][0][0].startswith("&name") and fields[0][0][1] == -1
    assert compile_request(mine, "a | b") is None
    assert compile_request(mine, "club -filter:xyz") is None
    assert compile_request(mine, "xy") is None


@PIPELINE
def test_batch_executor_matches_host_docs(pair, pipeline):
    mine, ref = pair
    with executors(mine, ref, max_wait_ms=1.0, pipeline=pipeline) as (ex, rex):
        for req in ["club", '"pickwick club"', "dinner tavern",
                    "club ~tavern"]:
            check(ex, rex, mine, ref, req)
        res = check(ex, rex, mine, ref, "club -filter:al.*")
        assert [d.name for d in res.found_docs] == ["docs:alpha"]
        assert ex.stats["device_queries"] == 4
        assert ex.stats["host_queries"] == ex.stats["fallback_unsupported"] == 1
        assert_counters_equal(ex, rex)


@PIPELINE
def test_batch_executor_concurrent(pair, pipeline):
    mine, ref = pair
    ex = BatchExecutor(mine, device="cpu", max_wait_ms=5.0, max_batch=64,
                       pipeline=pipeline)
    results = {}

    def worker(i):
        results[i] = ex.search("club" if i % 2 else "dinner")

    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert len(results) == 32
        want = {q: result_fields(ref.search(q)) for q in ("club", "dinner")}
        for i, r in results.items():
            assert result_fields(r) == want["club" if i % 2 else "dinner"]
        assert ex.stats["batches"] < 32  # actually batched
    finally:
        ex.close()


@pytest.mark.parametrize("req", ['apple "bank account"',
                                 '"bank account" apple', '"bank account"'])
def test_partial_quotes_compile_with_fold_reorder(pair, req):
    mine, ref = pair
    got = compile_request(mine, req)
    assert got == jax_batcher.compile_request(ref, req)
    assert [r < 0 for _, r in got] == ([True, True] if req.count(" ") == 1
                                       else [True, True, False])
    assert compile_request(mine, '"bank account" "old tavern"') is None


def test_or_and_morphology_compile(pair):
    mine, ref = pair
    for req in ("club | tavern", "dinner (club|tavern)", "wandered"):
        assert compile_request(mine, req) == \
            jax_batcher.compile_request(ref, req)
    (codes, r), = compile_request(mine, "club | tavern")
    assert set(codes) >= {"club", "tavern"} and r > 0
    c = compile_request(mine, "dinner (club|tavern)")
    assert len(c) == 2 and len(c[1][0]) >= 2
    assert compile_request(mine, "wandered")[0][0] == ("$wander",)


@PIPELINE
def test_batch_executor_or_parity(pair, pipeline):
    mine, ref = pair
    with executors(mine, ref, max_wait_ms=1.0, pipeline=pipeline) as (ex, rex):
        for req in ["club | tavern", "dinner (club|tavern)",
                    'noon "the tavern"', "wandered"]:
            check(ex, rex, mine, ref, req)
        assert_counters_equal(ex, rex)


def test_batch_executor_real_positions_and_snippets(pair):
    mine, ref = pair
    with executors(mine, ref, max_wait_ms=1.0) as (ex, rex):
        dev = check(ex, rex, mine, ref, "dinner tavern")
        assert dev.found_pages and all(
            p.pos and all(x >= 0 for x in p.pos) for p in dev.found_pages)
        assert all(d.summary for d in dev.found_docs)


def test_batch_executor_fills_words_info(pair):
    mine, ref = pair
    with executors(mine, ref, max_wait_ms=1.0) as (ex, rex):
        for req in ["club", "dinner tavern", '"pickwick club"', "club zzqq"]:
            dev = check(ex, rex, mine, ref, req)
            assert [(w.word, w.n_found) for w in dev.words] == \
                [(w.word, w.n_found) for w in ref.search(req).words]


@PIPELINE
def test_batcher_restages_after_rebuild(tmp_path, pipeline):
    """An executor made before any build serves host-side, stages on the
    first build and restages when the index rebuilds."""
    mine, ref = build_pair(tmp_path)
    for ind, src, doc in ((mine, ListDataSource, IndexPagedTextFile),
                          (ref, JaxListDataSource, JaxPagedTextFile)):
        ind.add_data_source(src("docs", [doc("a", "alpha words appear "
                                              "here today", "")]))
    with executors(mine, ref, max_wait_ms=1.0, pipeline=pipeline) as (ex, rex):
        res = check(ex, rex, mine, ref, "alpha")  # no index yet
        assert res.found_docs == [] and not res.success
        assert ex.stats["fallback_no_index"] == 1
        mine.create()
        ref.create()
        res = check(ex, rex, mine, ref, "alpha words")
        assert [d.name for d in res.found_docs] == ["docs:a"]
        for ind, src, doc in ((mine, ListDataSource, IndexPagedTextFile),
                              (ref, JaxListDataSource, JaxPagedTextFile)):
            ind.sources = []
            ind.add_data_source(src("docs", [doc("b", "omega tokens appear "
                                                  "here instead", "")]))
            ind.status = "Idle"
            ind.create()
        res = check(ex, rex, mine, ref, "omega tokens")
        assert [d.name for d in res.found_docs] == ["docs:b"]
        assert check(ex, rex, mine, ref, "alpha").found_docs == []
        assert_counters_equal(ex, rex)
    ref.dispose()


def test_batcher_pipelined_mode(pair):
    mine, ref = pair
    with executors(mine, ref, max_wait_ms=1.0, pipeline=True) as (ex, rex):
        reqs = ["club", '"pickwick club"', "dinner tavern", "noon"] * 8
        with cf.ThreadPoolExecutor(8) as pool:
            dev = list(pool.map(ex.search, reqs))
        for req, d in zip(reqs, dev):
            assert result_fields(d) == result_fields(ref.search(req)), req
        assert ex.stats["device_queries"] == len(reqs)


@PIPELINE
def test_brief_mode_device_doc_ranks_order_parity(pair, pipeline):
    mine, ref = pair
    with executors(mine, ref, max_wait_ms=1.0, materialize=False,
                   pipeline=pipeline) as (ex, rex):
        for req in ["club", "dinner tavern", "noon", '"pickwick club"',
                    "the club"]:
            check(ex, rex, mine, ref, req, brief=True)
        assert ex.stats["host_queries"] == 0
        assert_counters_equal(ex, rex)


def test_fallback_reason_counters(pair):
    mine, ref = pair
    with executors(mine, ref, max_wait_ms=1.0) as (ex, rex):
        check(ex, rex, mine, ref, "club ~tavren")   # unsupported
        check(ex, rex, mine, ref, "xy")             # shape
        assert ex.stats["fallback_unsupported"] == 1
        assert ex.stats["fallback_shape"] == 1
        assert ex.stats["host_queries"] == 2
        assert_counters_equal(ex, rex)


@PIPELINE
def test_wildcard_queries_ride_device(pair, pipeline):
    mine, ref = pair
    with executors(mine, ref, max_wait_ms=1.0, pipeline=pipeline) as (ex, rex):
        for req in ["clu?", "?avern", "d?nner", "club ?avern", "?zzzzz?"]:
            check(ex, rex, mine, ref, req)
        assert ex.stats["host_queries"] == 0
        assert ex.stats["device_queries"] == 5
        assert_counters_equal(ex, rex)


@pytest.fixture(scope="module")
def field_pair(tmp_path_factory):
    mine, ref = build_pair(tmp_path_factory.mktemp("f"), FIELD_DOCS)
    yield mine, ref
    ref.dispose()


@PIPELINE
def test_field_queries_ride_device(field_pair, pipeline):
    mine, ref = field_pair
    with executors(mine, ref, max_wait_ms=1.0, pipeline=pipeline) as (ex, rex):
        for req in ["club {author=dickens}", "{author=dickens}",
                    "{author=trollope} club", "dinner {name=beta}",
                    "{author=nobody} club"]:
            check(ex, rex, mine, ref, req)
        assert ex.stats["host_queries"] == 0
        assert ex.stats["device_queries"] == 5
        # multi-word values nest pair-evaluations -> host fallback
        check(ex, rex, mine, ref, "{author=charles dickens}")
        assert ex.stats["fallback_shape"] == 1
        assert_counters_equal(ex, rex)


def test_pipelined_mode_serves_fields_and_wildcards(field_pair):
    mine, ref = field_pair
    with executors(mine, ref, max_wait_ms=1.0, pipeline=True) as (ex, rex):
        for req in ["club {author=dickens}", "{author=trollope}", "clu?",
                    "dinner"]:
            check(ex, rex, mine, ref, req)
        assert ex.stats["host_queries"] == 0
        assert_counters_equal(ex, rex)


@pytest.fixture(scope="module")
def common_pair(tmp_path_factory):
    """40 documents that all hold 'common': n_pages 40 > topk 8."""
    mine, ref = build_pair(tmp_path_factory.mktemp("esc"), COMMON_DOCS)
    yield mine, ref
    ref.dispose()


@pytest.mark.parametrize("materialize", [True, False],
                         ids=["materialized", "brief"])
def test_truncated_queries_escalate_on_device(common_pair, materialize):
    """A query past the batch budgets re-serves on the device at the
    escalated budgets, equal to the host engine."""
    mine, ref = common_pair
    with executors(mine, ref, max_wait_ms=1.0, topk=8, hit_cap=16,
                   materialize=materialize, escalate=True) as (ex, rex):
        check(ex, rex, mine, ref, "common", brief=not materialize)
        assert ex.stats["escalations"] == 1
        assert ex.stats["host_queries"] == 0
        assert_counters_equal(ex, rex)


@PIPELINE
def test_escalation_equals_the_reference_host_fallback(common_pair, pipeline):
    """The port escalating (its default) against the JAX package serving
    the same truncated queries on its host (its default): equal results,
    the one on the device, the other on the host."""
    mine, ref = common_pair
    ex = BatchExecutor(mine, device="cpu", max_wait_ms=1.0, topk=8,
                       hit_cap=16, pipeline=pipeline)
    rex = jax_batcher.BatchExecutor(ref, max_wait_ms=1.0, topk=8, hit_cap=16,
                                    pipeline=False, escalate=False)
    try:
        reqs = ["common", "common words", '"appear here"', "unique7 token"]
        for req in reqs:
            assert result_fields(ex.search(req)) == \
                result_fields(rex.search(req)), req
        assert ex.stats["escalations"] == rex.stats["truncated_fallbacks"] == 3
        assert ex.stats["truncated_fallbacks"] == rex.stats["escalations"] == 0
        assert ex.stats["device_queries"] == 4
    finally:
        ex.close()
        rex.close()


@PIPELINE
def test_sixteen_clients_with_a_restage(tmp_path, pipeline):
    """16 client threads through one executor while the index rebuilds
    on the same documents mid-stream: every request equals the JAX
    package's host engine, before and after, and the counters add up."""
    docs = DOCS + COMMON_DOCS[:12]
    mine, ref = build_pair(tmp_path, docs)
    reqs = ["club", '"pickwick club"', "dinner tavern", "clu?", "common",
            "club | tavern", "club ~tavern", "xy", "common words",
            "noon -filter:al.*"] * 8
    want = {q: result_fields(ref.search(q)) for q in set(reqs)}
    ex = BatchExecutor(mine, device="cpu", max_wait_ms=2.0, topk=8,
                       hit_cap=16, pipeline=pipeline)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        gen = mine.generation

        def client(k):
            out = []
            for i, req in enumerate(reqs[k::16] * 3):
                if k == 0 and i == 5:
                    mine.create()  # the same documents, a new generation
                out.append((req, result_fields(ex.search(req))))
            return out

        with cf.ThreadPoolExecutor(16) as pool:
            served = [r for f in [pool.submit(client, k) for k in range(16)]
                      for r in f.result(timeout=120)]
        assert mine.generation == gen + 1
        assert ex._gen == mine.generation
        for req, got in served:
            assert got == want[req], req
        st = ex.stats
        assert st["device_queries"] + st["host_queries"] \
            + st["truncated_fallbacks"] == len(served) == 3 * len(reqs)
        assert st["fallback_unsupported"] == st["fallback_shape"] == 24
    finally:
        sys.setswitchinterval(switch)
        ex.close()
        ref.dispose()


def test_a_build_landing_while_the_executor_stages(monkeypatch):
    """create() on other documents lands after the executor has staged a
    build but before it records it: the executor records the generation
    it staged, stages again, and serves the new documents, never the old
    postings under the new generation."""
    mine = Index(device="cpu")
    mine.add_data_source(ListDataSource(
        "docs", [IndexPagedTextFile(*d) for d in DOCS]))
    ex = BatchExecutor(mine, device="cpu", max_wait_ms=1.0)  # no build yet
    mine.create()
    mine.sources = []
    mine.add_data_source(ListDataSource("docs", [IndexPagedTextFile(
        "delta", "omega tokens appear here instead of the club", "")]))
    stage = DeviceIndex.from_index
    staged = []

    def staging(host, device="cuda"):
        di = stage(host, device=device)
        staged.append(host)
        if len(staged) == 1:  # the second build lands from another thread
            t = threading.Thread(target=mine.create)
            t.start()
            t.join()
        return di

    monkeypatch.setattr(DeviceIndex, "from_index", staticmethod(staging))
    try:
        for req in ["omega tokens", "club", '"the club"', "noon"]:
            got = ex.search(req)
            assert result_fields(got) == result_fields(mine.search(req)), req
        assert [d.name for d in ex.search("club").found_docs] == \
            ["docs:delta"]
        assert mine.generation == 2 and ex._gen == 2
        assert len(staged) == 2 and staged[1] is mine.host
        assert ex.stats["device_queries"] == 5
    finally:
        ex.close()


@PIPELINE
def test_a_stalled_batch_fails_its_request(pair, pipeline):
    """A device batch that does not answer within search()'s timeout
    fails its request and counts it under device_timeouts: the request is
    not re-served on the host. Once the device answers again, requests
    are served as before."""
    mine, _ = pair
    ex = BatchExecutor(mine, device="cpu", max_wait_ms=1.0,
                       pipeline=pipeline)
    release = threading.Event()
    inner = ex.di.search_batch_full

    def stalled(*a, **k):
        release.wait(30)
        return inner(*a, **k)

    ex.di.search_batch_full = stalled
    try:
        res = ex.search("club", timeout=0.2)
        assert not res.success and res.found_docs == []
        assert "0.2 s" in res.error
        assert ex.stats["device_timeouts"] == 1
        assert ex.stats["host_queries"] == 0
        assert ex.stats["truncated_fallbacks"] == 0
        release.set()
        del ex.di.search_batch_full
        got = ex.search("club")
        assert got.success
        assert result_fields(got) == result_fields(mine.search("club"))
        assert ex.stats["device_timeouts"] == 1
    finally:
        release.set()
        ex.close()


def test_compile_group_query_cache_under_threads(pair):
    """The device index's query cache filled from 8 threads at once:
    every answer equals the uncached one and the cache holds each query
    once."""
    mine, _ = pair
    dix = DeviceIndex.from_index(mine, device="cpu")
    terms = dix.terms
    rng = np.random.default_rng(3)
    queries = [[((terms[int(i)],), 259), ((terms[int(j)], terms[int(k)]), -9)]
               for i, j, k in rng.integers(0, len(terms), size=(200, 3))]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with cf.ThreadPoolExecutor(8) as pool:
            outs = list(pool.map(dix.compile_group_query, queries * 8))
    finally:
        sys.setswitchinterval(switch)
    for q, got in zip(queries * 8, outs):
        assert got == dix._compile_group_query_uncached(q)
    assert len(dix._cgq_cache) == len({str(q) for q in queries})


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as r:
        return r.status, json.loads(r.read().decode("utf-8"))


def test_server_batched_search_over_loopback(field_pair):
    """The port's DocodoServer with device batching on a CPU index:
    /search answers result_to_json of the host engine's result, as the
    JAX package's server does, /status carries the batcher's stats and
    /suggest the host engine's completions."""
    mine, ref = field_pair
    srv = DocodoServer(mine, port=0, host="127.0.0.1", device_batching=True,
                       device="cpu")
    srv.start(background=True)
    try:
        for req in ["club", '"pickwick club"', "club {author=dickens}",
                    "clu?", "club ~tavern", "{author=trollope}"]:
            code, body = _get(srv.port, "/search?req="
                              + urllib.parse.quote(req))
            assert code == 200
            assert body == json.loads(json.dumps(
                result_to_json(mine.search(req)), ensure_ascii=False))
            assert body == json.loads(json.dumps(
                jax_result_to_json(ref.search(req)), ensure_ascii=False))
        _, st = _get(srv.port, "/status")
        assert st["canSearch"] is True and st["words"] == ref.count
        assert st["batcher"]["device_queries"] == 5
        assert st["batcher"]["fallback_unsupported"] == 1
        _, words = _get(srv.port, "/suggest?req=pick")
        assert words == ref.get_suggestions("pick") == ["wick"]
    finally:
        srv.stop()
    assert not srv.batcher._thread.is_alive()


def test_cuda_executor_and_server_raise_without_a_card(pair):
    """Without CUDA an executor or server left on its default device
    raises: it never serves from the CPU unasked."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    mine, _ = pair
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchExecutor(mine)
    with pytest.raises(RuntimeError, match="CUDA"):
        DocodoServer(mine, port=0, host="127.0.0.1", device_batching=True)


def test_server_serves_from_the_card_by_default(pair):
    """DocodoServer batches on the card unless told otherwise: without
    CUDA its defaults raise, the host engine alone needs device="cpu",
    and then /search answers result_to_json of Index.search."""
    mine, _ = pair
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            DocodoServer(mine)
    with pytest.raises(ValueError, match="device"):
        DocodoServer(mine, port=0, host="127.0.0.1", device_batching=False)
    srv = DocodoServer(mine, port=0, host="127.0.0.1", device_batching=False,
                       device="cpu")
    assert srv.batcher is None
    srv.start(background=True)
    try:
        for req in ["club", '"pickwick club"', "club ~tavern"]:
            code, body = _get(srv.port, "/search?req="
                              + urllib.parse.quote(req))
            assert code == 200
            assert body == json.loads(json.dumps(
                result_to_json(mine.search(req)), ensure_ascii=False))
    finally:
        srv.stop()
