"""The full-result slice end to end: docodo_tpu_torch's search_batch_full
against the JAX package's on one seeded Zipf corpus (about 60k tokens),
with the JAX Pallas kernels in interpret mode. The mix is the standard
one plus words chosen by posting count, so every slot kernel (W=2 caps
<= 512, W=1 caps <= 128 and 256-1024) and every chunked branch (W=2 caps
1024, 2048 and 4096-8192, W=1 caps 2048-8192, each with pages carried by
the small tables and, on a second staging without the wide tables,
looked up) serve rows; the plain route serves the same mix without the
kernels.

Tolerances: ranks and doc_ranks within 2 ulp (torch.log and XLA's log
differ by 1 ulp on about 1% of counts on the CPU); every other field
exact."""

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from docodo_tpu.ops.device_index import DeviceIndex as JaxDeviceIndex
from docodo_tpu_torch.mix import standard_mix
from docodo_tpu_torch.ops import device_index as tdi
from docodo_tpu_torch.ops import query_kernels as qk
from docodo_tpu_torch.synthetic import build_index, zipf_documents

TOPK = 64
HIT_CAP = 512
RANK_ULPS = 2
REPO = Path(__file__).resolve().parent.parent
KERNEL_ROUTES = {"sorted_and_locate_full", "single_locate_full",
                 "union_locate_full", "merge_and_locate_topk",
                 "merge_tagged", "and_keep", "locate_runs"}
UNCARRIED_FROM = 1024  # the second staging keeps small tables below this


def mixed_queries(dix, n_standard: int = 24):
    """The standard mix, plus words by posting count alone, paired and
    ordered: the most frequent (caps 8192), 2048-4096 postings (cap
    4096), 1024-2048 (cap 2048), 512-1024 (cap 1024: the union kernel
    for W=1, the fused W=2 kernel) and 256-512 (the W=2 slot kernel at
    cap 512, with hits), and a query with an unknown word."""
    counts = np.diff(dix.offsets_np)
    terms, rs = standard_mix(counts, dix.terms, n_standard)
    queries = [[(dix.terms[t[j]], int(r[j])) for j in range(2) if t[j] >= 0]
               for t, r in zip(terms, rs)]

    def by_count(lo, hi, k=2):
        return [dix.terms[t]
                for t in np.flatnonzero((counts > lo) & (counts <= hi))[:k]]

    top = [dix.terms[t] for t in np.argsort(-counts, kind="stable")[:3]]
    c4k, c2k = by_count(2048, 4096), by_count(1024, 2048)
    mid, low = by_count(512, 1024), by_count(256, 512)
    queries += [
        [(top[0], 260)], [(top[0], -12), (top[1], -10)],
        [(top[0], 262), (top[2], 258)],
        [(c4k[0], 259)], [(c4k[0], -11), (c4k[1], -9)],
        [(c4k[1], 261), (mid[1], 262)],
        [(c2k[0], 263)], [(c2k[0], 260), (mid[0], 258)],
        [(c2k[1], -10), (c2k[0], -12)],
        [(mid[0], 261)], [(mid[0], 259), (mid[1], 263)],
        [(low[0], 260), (low[1], 262)],
        [("nosuchword", 260), (dix.terms[0], 260)],
    ]
    return queries


def uncarried(tdx):
    """The same index staged without the small tables of width
    UNCARRIED_FROM and up: wider buckets fetch by element and the
    kernels look their pages up."""
    state = tdx.state()
    arrays = {k: v for k, v in state.items() if not k.startswith("small")}
    j = 0
    i = 0
    while f"small{i}_w" in state:
        if int(state[f"small{i}_w"]) < UNCARRIED_FROM:
            for f in ("w", "band", "row_map", "tab"):
                arrays[f"small{j}_{f}"] = state[f"small{i}_{f}"]
            j += 1
        i += 1
    return tdi.DeviceIndex.from_state(arrays, tdx.terms, tdx.page_ids,
                                      tdx.doc_names, device="cpu")


@pytest.fixture(scope="module")
def corpus():
    ind = build_index(zipf_documents(480_000, seed=7, vocab=5000,
                                     doc_chars=40_000), device="cpu")
    jdx = JaxDeviceIndex.from_index(ind)
    tdx = tdi.DeviceIndex.from_index(ind, device="cpu")
    queries = mixed_queries(tdx)
    want = jdx.search_batch_full(queries, topk=TOPK, hit_cap=HIT_CAP,
                                 use_pallas=True)
    return tdx, queries, want


def f32_ulps(a, b) -> int:
    a = np.ascontiguousarray(a, dtype=np.float32).view(np.int32)
    b = np.ascontiguousarray(b, dtype=np.float32).view(np.int32)
    return int(np.abs(a.astype(np.int64) - b).max()) if a.size else 0


def assert_results_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].shape == w.shape and got[k].dtype == w.dtype, k
        if k in ("ranks", "doc_ranks"):
            assert f32_ulps(got[k], w) <= RANK_ULPS, k
        else:
            bad = np.argwhere(got[k] != w)
            assert bad.size == 0, f"{k} differs at rows {bad[:5, 0]}"


def _kernel_route(tdx, queries, monkeypatch):
    """search_batch_full on the kernel route, with the wrappers it called
    and the (words, cap, carried) of every chunked bucket."""
    routes = {}
    chunked = set()

    def counting(mod, name):
        fn = getattr(mod, name)

        def wrapped(*a, **k):
            routes[name] = routes.get(name, 0) + 1
            return fn(*a, **k)
        monkeypatch.setattr(mod, name, wrapped)

    for name in KERNEL_ROUTES:
        counting(qk, name)
    counting(tdi, "query_step_full")
    inner = tdi._chunked_bucket_full

    def chunk_seen(term_offsets, coords, bounds, tq, rq, **k):
        out = inner(term_offsets, coords, bounds, tq, rq, **k)
        if out is not None:
            chunked.add((tq.shape[1], min(k["cap"], 4096),
                         tdi._tab_serves(k["small"], k["cap"])))
        return out
    monkeypatch.setattr(tdi, "_chunked_bucket_full", chunk_seen)
    got = tdx.search_batch_full(queries, topk=TOPK, hit_cap=HIT_CAP,
                                use_kernels=True)
    return got, routes, chunked


def test_kernel_route_equals_jax(corpus, monkeypatch):
    tdx, queries, want = corpus
    got, routes, chunked = _kernel_route(tdx, queries, monkeypatch)
    assert_results_equal(got, want)
    assert set(routes) == KERNEL_ROUTES, routes
    assert {(2, 1024, True), (2, 2048, True), (2, 4096, True),
            (1, 2048, True), (1, 4096, True)} <= chunked, chunked
    pairs = np.array([len(q) == 2 for q in queries])
    assert (got["n_hits"][pairs] > 0).sum() >= 5


def test_uncarried_kernel_route_equals_jax(corpus, monkeypatch):
    """Past the page-carrying tables the chunked route merges without
    pages and the locate kernel looks them up; the results do not
    change."""
    tdx, queries, want = corpus
    got, routes, chunked = _kernel_route(uncarried(tdx), queries,
                                         monkeypatch)
    assert_results_equal(got, want)
    # W=1 caps 256-1024 carry no pages here: none takes the union kernel
    assert set(routes) == KERNEL_ROUTES - {"merge_and_locate_topk",
                                           "union_locate_full"}, routes
    assert {(2, 1024, False), (2, 2048, False), (2, 4096, False),
            (1, 1024, False), (1, 2048, False), (1, 4096, False)} \
        <= chunked, chunked


def test_plain_route_equals_jax(corpus):
    tdx, queries, want = corpus
    got = tdx.search_batch_full(queries, topk=TOPK, hit_cap=HIT_CAP,
                                use_kernels=False)
    assert_results_equal(got, want)


def test_port_imports_no_jax():
    """The port's host build (with a vocabulary too), both searches
    (standard and wide rows, the page level, the per-bucket serving
    shape with its deferred finish), chip_smoke's CPU-runnable helpers
    (the mixes, the oracles), the host engine `Index`, the batcher, the
    HTTP server, the sharded layout (parallel/: a ShardedDeviceIndex
    on two CPU shards), the console app and the data sources, an index
    written to disk and loaded back, a build of two threads that
    spills, the standalone builder, SearchOptions, the probes
    (benchmarks/), the packed tokenizer and split parts, the chained
    calls, the page-level variant step, the set operations, Index[term],
    stem_en and the device traces run without loading jax, the JAX
    package or the benchmarks."""
    code = textwrap.dedent("""
        import sys
        import numpy as np
        import chip_smoke
        from docodo_tpu_torch import DeviceIndex
        from docodo_tpu_torch.mix import mix_queries, standard_mix, wide_mix
        from docodo_tpu_torch.oracle import fold_row, group_and
        from docodo_tpu_torch.synthetic import build_index, zipf_documents
        ind = build_index(zipf_documents(60_000, seed=1, vocab=800),
                          device="cpu")
        from docodo_tpu_torch.native.pipeline import (
            parallel_tokenize_intern)
        from docodo_tpu_torch.utils import profiling
        assert "build.sort" in profiling.format_report()
        assert parallel_tokenize_intern(["alpha beta", "beta gamma"],
                                        workers=2)[2] == ["alpha", "beta",
                                                          "gamma"]
        dix = DeviceIndex.from_index(ind, device="cpu")
        words = dix.terms[10:12]
        out = dix.search_batch_full(
            [[(words[0], 260)], [(words[0], 260), (words[1], 260)]],
            use_kernels=True)
        assert out["pages"].shape == (2, 64)
        finish = dix.search_batch_full(
            [[(words[0], 260)], [(words[0], 260), (words[1], 260)]],
            use_kernels=True, cap_ladder=(128, 1024), fused=False,
            deferred=True, clamp_budgets=True, sort_topk=False)
        served = finish()
        assert (served["n_pages"] == out["n_pages"]).all()
        assert served["topk_eff"].tolist() == [64, 64]
        from docodo_tpu_torch.ops.device_index import batched_query_full
        from docodo_tpu_torch.ops.query_kernels import merge_and_locate
        pages, ranks, counts = dix.search_batch(
            [[(words[0], 260)], [(words[0], 260), (words[1], 260)]])
        assert pages.shape == (2, 16) and pages[0, 0] >= 0
        from docodo_tpu_torch.index import word_group
        from docodo_tpu_torch.lang.vocab import Vocab
        from docodo_tpu_torch.synthetic import vocabulary_documents
        voc = Vocab("Dict/ru.voc")
        rus = build_index(vocabulary_documents(voc, n_docs=2), vocs=[voc],
                          device="cpu")
        assert word_group(rus, "князь")[0][0].startswith("#")
        terms, rs = standard_mix(np.diff(dix.offsets_np), dix.terms, 30)
        assert terms.shape == (30, 2)
        a = dix.coords[dix.offsets_np[10]:dix.offsets_np[11]].numpy()
        group_and(a, a, 5, 5)
        wt, wr, _ = wide_mix(np.diff(dix.offsets_np), dix.terms, 21)
        wide = mix_queries(wt, wr, dix.terms)
        out = dix.search_batch_full(wide, use_kernels=True)
        c, off = dix.coords.numpy(), dix.offsets_np
        for i in (0, 4, 5):
            words = [[c[off[t]:off[t + 1]] for t in vs if t >= 0]
                     for vs in wt[i] if vs[0] >= 0]
            assert out["n_hits"][i] == fold_row(words, wr[i]).size
        import json, urllib.request
        from docodo_tpu_torch.index import Index, IndexPagedTextFile
        from docodo_tpu_torch.index import ListDataSource
        from docodo_tpu_torch.query.batcher import BatchExecutor
        from docodo_tpu_torch.server import DocodoServer, result_to_json
        idx = Index(device="cpu")
        idx.add_data_source(ListDataSource("docs", [IndexPagedTextFile(
            "a", "the pickwick club met at noon", "author=dickens")]))
        idx.create()
        ex = BatchExecutor(idx, device="cpu", max_wait_ms=1.0)
        for req in ('"pickwick club"', "club {author=dickens}", "clu?"):
            assert ex.search(req) == idx.search(req)
            assert idx.search(req).found_pages
        assert ex.stats["device_queries"] == 3
        ex.close()
        srv = DocodoServer(idx, port=0, host="127.0.0.1",
                           device_batching=True, device="cpu")
        srv.start()
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/search?req=club") as r:
            body = json.loads(r.read())
        srv.stop()
        assert body == json.loads(json.dumps(result_to_json(
            idx.search("club")))) and body["found"] == 1
        from docodo_tpu_torch import ShardedDeviceIndex
        from docodo_tpu_torch.parallel import distributed, serving, sharding
        sdi = ShardedDeviceIndex.from_index(
            idx, sharding.make_mesh(2, devices=["cpu", "cpu"]))
        from docodo_tpu_torch.query.batcher import compile_request
        [res] = sdi.search_batch([compile_request(idx, "pickwick club")])
        assert res.found_docs[0].name == idx.search("club").found_docs[0].name
        assert distributed.make_global_mesh(["cpu"] * 2, 2).num_local == 1
        import os, tempfile
        import docodo_tpu_torch.cli
        import docodo_tpu_torch.sources
        from docodo_tpu_torch.core import storage, varint
        folder = tempfile.mkdtemp()
        with open(os.path.join(folder, "a.txt"), "w") as f:
            f.write("the pickwick club met at noon")
        disk = Index(os.path.join(folder, "idx"), device="cpu")
        disk.add_data_source(docodo_tpu_torch.sources.DocumentsDataSource(
            "doc", folder + "/"))
        disk.create()
        again = Index(os.path.join(folder, "idx"), device="cpu")
        again.add_data_source(docodo_tpu_torch.sources.DocumentsDataSource(
            "doc", folder + "/"))
        assert again.search("club").found_docs[0].pages[0].text
        assert varint.decode(varint.encode(np.arange(3))).tolist() == [0, 1, 2]
        from docodo_tpu_torch import IndexBuilder, SearchOptions
        from docodo_tpu_torch.benchmarks import (probe_dma_fetch,
                                                 probe_locate, profile_cap64)
        spilled = Index(os.path.join(folder, "spilled"), device="cpu")
        spilled.max_degree_of_parallelism = 2
        spilled.max_tmp_index_items = 4
        spilled.add_data_source(docodo_tpu_torch.sources.DocumentsDataSource(
            "doc", folder + "/"))
        spilled.create()
        assert spilled.search("club", SearchOptions(dist=40)).found_docs
        bldr = IndexBuilder(device="cpu")
        bldr.add_doc("docs", "a")
        bldr.add_word("pickwick", 4)
        bldr.end_page("1", 20)
        assert bldr.build().search("pickwick").found_pages
        fetch = probe_dma_fetch.run("cpu", r=8, n=128, b=5)
        assert fetch["index_select"]["max_abs_err"] == 0
        probe_locate.run_shape("probe", probe_locate.probe_streams(
            np.random.default_rng(0), 16, 64, 60_000, "cpu"),
            dix.bounds, dix.device)
        assert profile_cap64.stages
        import torch
        from docodo_tpu_torch.native import pipeline
        from docodo_tpu_torch.ops import device_index as tdi, seqops
        it = pipeline.make_interner()
        rows = pipeline.tokenize_intern_packed("alpha beta  gamma", it)
        assert it.term_at(1) == "beta" and rows.size == 3
        assert np.array_equal(rows, tdi.pack_tokens(
            *pipeline.tokenize_intern("alpha beta  gamma",
                                      pipeline.make_interner(native=False))))
        assert sum(p.size for p in tdi.split_packed(rows, 2)) >= 3
        assert len(tdi.pack_tokens_split(np.arange(3, dtype=np.int32),
                                         np.array([0, 6, 12]), 2)) == 2
        assert pipeline.varint_decode(pipeline.varint_encode(
            np.arange(3))).tolist() == [0, 1, 2]
        from docodo_tpu_torch.lang.stemmers import stem_en
        assert stem_en("running") == "run"
        t, r, cap = dix.compile_queries([[(dix.terms[10], 260)]])
        args = (dix.term_offsets, dix.coords, dix.bounds, dix.page_doc)
        (step,), s = tdi.multi_bucket_query_step_chained(
            *args, [torch.as_tensor(t)], [torch.as_tensor(r)],
            torch.zeros(()), [cap], 16, use_kernels=True, small=dix.small,
            page_of=dix.page_of)
        assert float(s) == float(step[1].sum()) > 0
        (full,), s = tdi.multi_bucket_query_full_chained(
            *args, dix.header_mask(), [torch.as_tensor(t)],
            [torch.as_tensor(r)], torch.zeros(()), [cap], 64, [512],
            use_kernels=True, small=dix.small, page_of=dix.page_of)
        assert float(s) > 0 and int(full.n_hits[0]) > 0
        pv = tdi.batched_query_step_variants(
            *args, torch.as_tensor(t)[:, :, None], torch.as_tensor(r), cap,
            16, dix.small)
        assert torch.equal(pv[0], step[0])
        a = torch.tensor([3, 9, 40], dtype=torch.int32)
        assert seqops.device_and(a, 3, 5, a + 2, 3, 5)[1] == 6
        assert seqops.batch_or(a[None], torch.tensor([3]), torch.tensor([1]),
                               a[None], torch.tensor([3]),
                               torch.tensor([1]))[1].tolist() == [3]
        pc, pn = seqops.pad_to([5, 8, 120], 8)
        assert seqops.device_locate_rank(torch.from_numpy(pc), pn,
                                         dix.bounds, dix.page_doc,
                                         8)[2].any()
        assert idx["pickwick"].encoded_len == 1
        assert list(idx["pickwick"]) == idx["pickwick"].coords.tolist()
        idx.word_coder.clear_cache()
        with profiling.device_trace("t"), profiling.annotate("t"):
            pass
        loaded = [m for m in sys.modules
                  if m.split(".")[0] in ("jax", "docodo_tpu", "benchmarks")]
        assert not loaded, loaded
        print("no jax")
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "no jax" in proc.stdout
