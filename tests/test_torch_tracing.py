"""The query path's program spans and counters (utils/profiling: span,
tracing, count, counters) on the CPU over a small index: the span names
and their nesting in a torch.profiler trace, the batch numbers they
carry, nothing traced with tracing off, the same answers either way, the
counters a batch adds, and the collector's host.gc span."""

import gc

import numpy as np
import pytest
import torch

from docodo_tpu_torch.ops import device_index as tdi
from docodo_tpu_torch.synthetic import build_index, zipf_documents
from docodo_tpu_torch.utils import profiling

PROGRAM = ("query.", "route.", "tail.", "host.gc")
DISPATCH_CHILDREN = ("query.compile", "query.pack", "query.upload",
                     "query.launch", "query.readback")
FINISH_CHILDREN = ("query.finish.wait", "query.finish.scatter")


@pytest.fixture(scope="module")
def ind():
    return build_index(zipf_documents(200_000, seed=3, vocab=1500,
                                      doc_chars=20_000), device="cpu")


@pytest.fixture
def dix(ind):
    """A fresh DeviceIndex: an empty compile cache, batch numbers from 0."""
    return tdi.DeviceIndex.from_index(ind, device="cpu")


@pytest.fixture(autouse=True)
def tracing_off():
    yield
    profiling.tracing(False)


def _words(dix, n=24):
    cnt = np.diff(dix.offsets_np)
    return [dix.terms[i] for i in np.argsort(-cnt, kind="stable")
            if not dix.terms[i].startswith("$")][:n]


def _queries(dix):
    """W = 1, W = 2, V = 2 and W = 2 with V = 2 rows, 8 of each."""
    w = _words(dix)
    return ([[(w[i], 1)] for i in range(8)]
            + [[(w[i], 1), (w[i + 1], 3)] for i in range(8)]
            + [[((w[i], w[i + 5]), 1)] for i in range(8)]
            + [[((w[i], w[i + 5]), 1), (w[i + 2], 2)] for i in range(8)])


def _search(dix, queries):
    fin = dix.search_batch_full(queries, topk=16, hit_cap=256,
                                use_kernels=True, deferred=True)
    return fin()


def _annotations(prof):
    """(name, start, end) of the trace's CPU user annotations."""
    return [(e.name(), e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()
            if e.is_user_annotation()
            and str(e.device_type()).endswith("CPU")]


def _traced(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _annotations(prof)


def _inside(child, parents):
    return any(s <= child[1] and child[2] <= t for _, s, t in parents)


def test_query_spans_nest_and_carry_the_batch(dix, monkeypatch):
    real = torch.profiler.record_function
    args = []

    class Recorded(real):
        def __init__(self, name, arg=None):
            args.append((name, arg))
            super().__init__(name, arg)

    monkeypatch.setattr(torch.profiler, "record_function", Recorded)
    profiling.tracing(True)
    queries = _queries(dix)
    _, ann = _traced(lambda: (_search(dix, queries), _search(dix, queries)))
    names = {n for n, _, _ in ann}
    assert {"query.dispatch", "query.finish", *DISPATCH_CHILDREN,
            *FINISH_CHILDREN} <= names
    by = {n: [a for a in ann if a[0] == n] for n in names}
    assert len(by["query.dispatch"]) == len(by["query.finish"]) == 2
    for n in DISPATCH_CHILDREN:
        assert all(_inside(a, by["query.dispatch"]) for a in by[n]), n
    for n in FINISH_CHILDREN:
        assert all(_inside(a, by["query.finish"]) for a in by[n]), n
    # the collector may run anywhere; every other span is a route step
    for n in names - {"query.dispatch", "query.finish", *DISPATCH_CHILDREN,
                      *FINISH_CHILDREN, "host.gc"}:
        assert n.startswith(("route.", "tail.")), n
        assert all(_inside(a, by["query.launch"]) for a in by[n]), n
    # the two calls' spans carry batch numbers 0 and 1, in call order
    query_args = [a for n, a in args if n.startswith("query.")]
    assert set(query_args) == {"0", "1"}
    first = query_args.index("1")
    assert set(query_args[:first]) == {"0"}
    assert set(query_args[first:]) == {"1"}
    assert all(a is None for n, a in args if n.startswith("route."))


@pytest.mark.parametrize("w,v", [(2, 1), (1, 2)])
def test_route_spans_for_a_bucket(dix, w, v):
    """A W = 2 bucket and a V > 1 bucket each record their fetch and at
    least one more route step inside query.launch."""
    words = _words(dix)
    queries = [[(tuple(words[i + k * 6] for k in range(v)) if v > 1
                 else words[i + j], 1) for j in range(w)] for i in range(6)]
    profiling.tracing(True)
    _, ann = _traced(lambda: _search(dix, queries))
    routes = [a for a in ann if a[0].startswith("route.")]
    assert {"route.fetch"} < {n for n, _, _ in routes}
    launch = [a for a in ann if a[0] == "query.launch"]
    assert all(_inside(a, launch) for a in routes)


def test_tracing_off_records_no_program_span_and_same_answers(dix):
    queries = _queries(dix)
    off, ann = _traced(lambda: _search(dix, queries))
    assert not [n for n, _, _ in ann if n.startswith(PROGRAM)]
    profiling.tracing(True)
    on, ann = _traced(lambda: _search(dix, queries))
    assert any(n.startswith(PROGRAM) for n, _, _ in ann)
    assert off.keys() == on.keys()
    for k in off:
        np.testing.assert_array_equal(off[k], on[k])


def test_span_off_is_one_shared_no_op():
    profiling.tracing(False)
    assert profiling.span("query.dispatch", 3) is profiling.span("x")
    with profiling.span("query.dispatch", 3) as got:
        assert got is None


def test_counters_a_batch(dix, monkeypatch):
    buckets = []
    inner = tdi.multi_bucket_query_full

    def record(*a, **k):
        buckets.append(len(a[5]))
        return inner(*a, **k)

    monkeypatch.setattr(tdi, "multi_bucket_query_full", record)
    queries = _queries(dix)
    queries = queries + queries[:5]          # 5 repeats within the batch
    distinct = len({repr(q) for q in queries})
    profiling.reset()
    _search(dix, queries)
    first = profiling.counters()
    assert first["query.batches"] == 1
    assert first["query.queries"] == len(queries)
    assert first["query.compile_miss"] == distinct
    assert first["query.compile_uncached_full"] == 0
    assert first["query.buckets"] == buckets[0] > 1
    assert first["query.uploads"] == 2 * buckets[0]
    assert first["readback.bytes"] > 0
    _search(dix, queries)
    second = profiling.counters()
    assert second["query.compile_miss"] == distinct
    assert second["query.batches"] == 2
    assert second["query.buckets"] == sum(buckets)
    assert second["readback.bytes"] == 2 * first["readback.bytes"]
    profiling.reset()
    assert profiling.counters() == {}


def test_compile_cache_full_counts_uncached(dix):
    queries = _queries(dix)
    dix._cgq_cache.update({("filler", i): None for i in range(200_000)})
    profiling.reset()
    _search(dix, queries)
    got = profiling.counters()
    assert got["query.compile_miss"] == got["query.compile_uncached_full"] \
        == len(queries)


def test_gc_span_under_tracing():
    before = list(gc.callbacks)
    profiling.tracing(True)
    profiling.tracing(True)
    assert len(gc.callbacks) == len(before) + 1
    _, ann = _traced(lambda: gc.collect())
    assert [n for n, _, _ in ann].count("host.gc") == 1
    profiling.tracing(False)
    assert gc.callbacks == before
    _, ann = _traced(lambda: gc.collect())
    assert "host.gc" not in [n for n, _, _ in ann]


def test_build_header_and_staging_phases():
    profiling.reset()
    small = build_index(zipf_documents(20_000, seed=1, vocab=300),
                        device="cpu")
    assert "build.header" in {n for n, _, _ in profiling.report()}
    tdi.DeviceIndex.from_index(small, device="cpu")
    names = {n for n, _, _ in profiling.report()}
    assert {"stage.page_of", "stage.small_tables", "stage.copies"} <= names
