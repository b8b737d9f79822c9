"""The port's index build against the JAX package's: the packed token
stream (pack_tokens) and the device sort over it (build_postings_packed,
on the CPU), the native build against the pure-Python build and against
docodo_tpu.Index (staged state array for array, with a vocabulary and
stop words too), the CSR sort against numpy, and profiling. Every input
is seeded; every comparison is exact."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import docodo_tpu
from docodo_tpu.lang.vocab import Vocab as JaxVocab
from docodo_tpu.native import pipeline as jpipe
from docodo_tpu.ops import device_index as jdi
from docodo_tpu.sources.base import ListDataSource as JaxListDataSource
from docodo_tpu.utils import profiling as jax_profiling
from docodo_tpu_torch import index as host
from docodo_tpu_torch.index import Index, IndexPage, ListDataSource
from docodo_tpu_torch.lang.vocab import Vocab
from docodo_tpu_torch.ops import device_index as tdi
from docodo_tpu_torch.ops.device_index import DeviceIndex
from docodo_tpu_torch.synthetic import (
    build_index,
    vocabulary_documents,
    zipf_documents,
)
from docodo_tpu_torch.utils import profiling

RU_VOC = Path(__file__).resolve().parent.parent / "Dict" / "ru.voc"
INF32 = 2**31 - 1

# the reference's native tokenizer fills its lazy tables on first use;
# fill them on the collecting thread (tests/test_torch_host_index.py)
jpipe._tables()


def _stream(rng, n: int, num_terms: int, big_gaps: bool = True):
    """A seeded (ids, starts) token stream: ascending starts with repeated
    coordinates and, with big_gaps, gaps of exactly PACK_DELTA_MAX,
    k * PACK_DELTA_MAX + r and just under."""
    gaps = rng.integers(0, 40, n)
    if big_gaps:
        dmax = tdi.PACK_DELTA_MAX
        at = rng.choice(n, 12, replace=False)
        gaps[at] = [dmax, dmax, 2 * dmax, 3 * dmax + 5, dmax - 1, dmax + 1,
                    7 * dmax + 4094, dmax, 4 * dmax, 1, 0, 5 * dmax + 17]
        gaps[0] = int(rng.integers(0, 9000))  # the first start escapes
    ids = rng.integers(0, num_terms, n).astype(np.int32)
    return ids, np.cumsum(gaps).astype(np.int64)


def test_pack_constants_match():
    for name in ("PACK_TERM_BITS", "PACK_SENTINEL", "PACK_DELTA_MAX"):
        assert getattr(tdi, name) == getattr(jdi, name), name
    assert tdi.PACK_PAD_ROW == jdi.PACK_PAD_ROW
    assert tdi.PACK_PAD_ROW.dtype == np.uint32


@pytest.mark.parametrize("big_gaps", [False, True], ids=["deltas", "escapes"])
def test_pack_tokens_matches_jax(big_gaps):
    rng = np.random.default_rng(21)
    ids, starts = _stream(rng, 3000, 500, big_gaps)
    got = tdi.pack_tokens(ids, starts)
    want = jdi.pack_tokens(ids, starts)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, want)
    assert (got.size > ids.size) == big_gaps
    assert tdi.pack_tokens(ids[:0], starts[:0]).size == 0
    with pytest.raises(ValueError, match="does not fit"):
        tdi.pack_tokens(np.array([3, tdi.PACK_SENTINEL], np.int32),
                        np.array([0, 1], np.int64))


@pytest.mark.parametrize("pad", [0, 37], ids=["unpadded", "pad-rows"])
def test_build_postings_packed_matches_jax(pad):
    rng = np.random.default_rng(8)
    num_terms = 400
    ids, starts = _stream(rng, 5000, num_terms)
    packed = np.concatenate([tdi.pack_tokens(ids, starts),
                             np.full(pad, tdi.PACK_PAD_ROW, np.uint32)])
    st, sc, off = tdi.build_postings_packed(
        torch.from_numpy(packed.view(np.int32)), num_terms)
    jst, jsc, joff = jdi.build_postings_packed(jnp.asarray(packed),
                                               num_terms)
    for g, w in ((st, jst), (sc, jsc), (off, joff)):
        w = np.asarray(w)
        assert g.dtype == torch.int32 and w.dtype == np.int32
        np.testing.assert_array_equal(g.numpy(), w)
    # against numpy: the CSR of the stream, every list ascending
    order = np.lexsort((starts, ids))
    np.testing.assert_array_equal(sc[:ids.size].numpy(), starts[order])
    np.testing.assert_array_equal(
        off.numpy(), np.concatenate([[0], np.cumsum(
            np.bincount(ids, minlength=num_terms))]))
    assert (sc[ids.size:] == INF32).all() and (st[ids.size:] == INF32).all()


def _numpy_csr(keys, coords, num_terms):
    order = np.argsort(keys, kind="stable")
    offsets = np.concatenate([[0], np.cumsum(
        np.bincount(keys, minlength=num_terms))]).astype(np.int64)
    return offsets, coords[order]


@pytest.mark.parametrize("case", ["int32-coords", "many-terms",
                                  "int64-coords", "one-term",
                                  "shared-coords"])
def test_sort_postings_branches_match_numpy(case):
    """The CSR sort (a stable sort of the ranks on the device) against
    numpy: coordinates below INF32 (sent as int32), ranks past 2^20,
    coordinates past int32 (sent as int64), one term, and several terms
    at one coordinate (a word and its stem or group keys)."""
    rng = np.random.default_rng(len(case))
    num_terms = {"many-terms": tdi.PACK_SENTINEL + 9, "one-term": 1}.get(
        case, 3000)
    ids, starts = _stream(rng, 20_000, num_terms)
    if case == "shared-coords":
        starts = np.repeat(starts[::3], 3)[:starts.size]
    coords = starts.astype(np.uint64)
    if case == "int64-coords":
        coords[10_000:] += np.uint64(INF32 - 5 - int(starts[10_000]))
    else:
        ids[-1] = num_terms - 1
    got_off, got_coords = host.sort_postings(ids, coords, num_terms, "cpu")
    want_off, want_coords = _numpy_csr(ids, coords, num_terms)
    assert got_off.dtype == np.int64 and got_coords.dtype == np.uint64
    np.testing.assert_array_equal(got_off, want_off)
    np.testing.assert_array_equal(got_coords, want_coords)
    assert (int(got_coords.max()) >= INF32) == (case == "int64-coords")
    off, empty = host.sort_postings(ids[:0], coords[:0], num_terms, "cpu")
    np.testing.assert_array_equal(off, np.zeros(num_terms + 1, np.int64))
    assert empty.size == 0


class Doc:
    def __init__(self, name, pages):
        self.name = name
        self.pages = [IndexPage(pid, text) for pid, text in pages]

    def __iter__(self):
        return iter(self.pages)


def _reference(docs, work, vocs=(), stop_file=None):
    ind = docodo_tpu.Index(path=str(work), in_memory=True, vocs=list(vocs))
    if stop_file:
        ind.load_stop_words(stop_file)
    ind.max_degree_of_parallelism = 1
    ind.add_data_source(JaxListDataSource("synth", docs))
    ind.create()
    return ind


def _assert_same_build(got, want):
    """Staged state array for array, and the host arrays."""
    gd, wd = (DeviceIndex.from_index(x, device="cpu") for x in (got, want))
    gs, ws = gd.state(), wd.state()
    assert sorted(gs) == sorted(ws)
    for k in ws:
        assert gs[k].dtype == ws[k].dtype, k
        np.testing.assert_array_equal(gs[k], ws[k], err_msg=k)
    assert gd.terms == wd.terms
    assert gd.page_ids == wd.page_ids and gd.doc_names == wd.doc_names
    assert got.arr.max_coord == want.arr.max_coord
    for a, b in ((got.arr.offsets, want.arr.offsets),
                 (got.arr.coords, want.arr.coords),
                 (got.pages.bounds, want.pages.bounds),
                 (got.pages.page_doc, want.pages.page_doc)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed,vocab", [(11, 4000), (3, 900)])
def test_native_build_matches_python_build_and_index(tmp_path, seed, vocab):
    docs = zipf_documents(250_000, seed=seed, vocab=vocab, doc_chars=20_000)
    profiling.reset()
    native = build_index(docs, device="cpu")
    assert {"build.tokenize", "build.wordcode+gather", "build.sort"} <= {
        name for name, _, _ in profiling.report()}
    python = build_index(docs, native=False, device="cpu")
    _assert_same_build(native, python)
    _assert_same_build(native, _reference(docs, tmp_path))
    assert len(native.arr.terms) > 500


def test_native_build_with_vocabulary_and_stop_words(tmp_path):
    stop = tmp_path / "stop.txt"
    stop.write_text("это\nкак\nthe\n", encoding="utf-8")
    stop_words = {"это", "как", "the"}
    docs = vocabulary_documents(
        Vocab(RU_VOC), seed=77, extra=("зюзюка", "бармаглот", "running",
                                       "houses", "это", "the", "1812"))
    native = build_index(docs, vocs=[Vocab(RU_VOC)], stop_words=stop_words,
                         device="cpu")
    python = build_index(docs, vocs=[Vocab(RU_VOC)], stop_words=stop_words,
                         native=False, device="cpu")
    _assert_same_build(native, python)
    _assert_same_build(native, _reference(docs, tmp_path / "ref",
                                          [JaxVocab(str(RU_VOC))],
                                          str(stop)))
    assert any(t.startswith("#") for t in native.arr.terms)
    assert "это" not in native.arr.terms


def test_native_build_sorts_header_and_body_postings():
    """Headers, Cyrillic and accented text, numbers, an empty page and a
    term in both a header and a body page: the native build equals the
    pure-Python one, every list ascending."""
    docs = [
        Doc("A", [("0", "Name=Pickwick Papers\nAuthor=Charles Dickens\n"
                        "x=short\n"),
                  ("1", "The Pickwick club met. Мистер Пиквик сказал: да! "
                        "1836 год, running runners ran"),
                  ("2", ""),
                  ("3", "Dickens wrote of Pickwick; ÄÖÜ straße café")]),
        Doc("B", [("0", "Name=Второй том\n"),
                  ("1", "Война и мир, роман Льва Толстого, том второй.")]),
    ]
    native = host.build_index(ListDataSource("s", docs), device="cpu")
    python = host.build_index(ListDataSource("s", docs), native=False,
                              device="cpu")
    _assert_same_build(native, python)
    off, c = native.arr.offsets, native.arr.coords
    assert all((np.diff(c[off[t]:off[t + 1]].astype(np.int64)) > 0).all()
               for t in range(len(native.arr.terms)))
    assert native.arr.get("pickwick").size == 3
    assert native.arr.get("pickwick")[0] == 5  # the header's value


@pytest.mark.parametrize("body_units,flush_tokens",
                         [(1 << 20, 131072), (1, 1), (700, 50)])
def test_native_build_batches_body_pages(monkeypatch, body_units,
                                         flush_tokens):
    """Body pages through one native call, and their tokens through one
    gather, at any batch size: pages that end and begin inside a word,
    astral characters (two UTF-16 units), documents without a header
    page, empty pages; equal to the pure-Python build."""
    monkeypatch.setattr(host, "BODY_UNITS", body_units)
    monkeypatch.setattr(host, "FLUSH_TOKENS", flush_tokens)
    rng = np.random.default_rng(body_units)
    words = ["alpha", "Beta", "гамма", "\U0001F600delta", "epsilon\U0001D518",
             "42abc", "zz", "ΩΩΩ", "naïve"]
    docs = []
    for d in range(7):
        pages = [] if d % 3 == 1 else [("0", f"Name=doc {d}\nTopic=alpha\n")]
        for k in range(1, 6):
            text = "".join(words[i] + (" " if rng.random() < 0.7 else "")
                           for i in rng.integers(0, len(words), 60))
            pages.append((str(k), "" if k == 3 and d == 2 else text))
        docs.append(Doc(f"d{d}", pages))
    native = host.build_index(ListDataSource("s", docs), device="cpu")
    python = host.build_index(ListDataSource("s", docs), native=False,
                              device="cpu")
    _assert_same_build(native, python)
    assert len(native.arr.terms) > 20


def test_build_of_stop_words_only():
    """Pages whose every word is a stop word: no posting, no term."""
    docs = [Doc("A", [("1", "the and the"), ("2", "and")])]
    for native in (True, False):
        ind = host.build_index(ListDataSource("s", docs), native=native,
                               stop_words={"the", "and"}, device="cpu")
        assert ind.arr.terms == [] and ind.arr.coords.size == 0
        assert ind.arr.offsets.tolist() == [0]
        assert ind.pages.bounds.tolist() == [11, 14]


def test_build_needs_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    docs = zipf_documents(20_000, seed=1, vocab=300)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Index()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_index(docs)
    ind = Index(device="cpu")
    ind.add_data_source(ListDataSource("synth", docs))
    ind.create()
    assert ind.can_search and ind.count > 100


def test_profiling_matches_jax():
    profiling.reset()
    jax_profiling.reset()
    for mod in (profiling, jax_profiling):
        mod.record("build.sort", 0.25)
        mod.record("build.tokenize", 1.5)
        mod.record("build.sort", 0.5)
    assert profiling.report() == jax_profiling.report() == [
        ("build.tokenize", 1.5, 1), ("build.sort", 0.75, 2)]
    assert profiling.format_report() == jax_profiling.format_report()
    with profiling.phase("p"):
        with profiling.phase("p"):
            pass
    assert [r for r in profiling.report() if r[0] == "p"][0][2] == 2
    profiling.count("query.batches")
    profiling.count("query.queries", 4096)
    assert profiling.counters() == {"query.batches": 1,
                                    "query.queries": 4096}
    profiling.reset()
    assert profiling.report() == [] and profiling.format_report() == ""
    assert profiling.counters() == {}


def test_device_trace_and_annotate(tmp_path, monkeypatch):
    """device_trace writes a Chrome trace holding the annotate spans under
    out_dir, and, like the JAX package's without DOCODO_PROFILE_DIR,
    does nothing without one; annotate lets an exception through."""
    import json

    import torch

    monkeypatch.delenv("DOCODO_PROFILE_DIR", raising=False)
    for mod, kw in ((profiling, {}), (jax_profiling, {})):
        with mod.device_trace("none", **kw):
            with mod.annotate("span"):
                pass
    assert not list(tmp_path.iterdir())
    with profiling.device_trace("batch", str(tmp_path / "traces")):
        with profiling.annotate("batch.full"):
            torch.arange(10).sum()
    events = json.loads((tmp_path / "traces" / "batch.json").read_text())
    assert any(e.get("name") == "batch.full" for e in events["traceEvents"])
    with pytest.raises(ValueError):
        with profiling.annotate("fails"):
            raise ValueError("through")
