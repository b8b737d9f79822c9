"""The port's memory-bounded build against the JAX package's: the
standalone IndexBuilder, spills past max_tmp_index_items and their merge
(merge_spills, both of its paths, byte for byte on the same spill files),
build threads, the page table from a builder's marks, SearchOptions and
get_close_words (twins of tests/test_index.py's cases).

Tolerance: exact everywhere. The JAX package builds on one thread for
the byte-for-byte comparisons, on corpora whose header words stay out of
the body text (its build leaves a list unsorted for a term in both,
ROADMAP Queue C)."""

import os
import re
import tracemalloc

import numpy as np
import pytest

import docodo_tpu
from docodo_tpu.core import storage as jax_storage
from docodo_tpu.core.pagetable import PageTable as JaxPageTable
from docodo_tpu.index import IndexBuilder as JaxIndexBuilder
from docodo_tpu.index import SearchOptions as JaxSearchOptions
from docodo_tpu.lang.vocab import Vocab as JaxVocab
from docodo_tpu.native import pipeline as npipe
from docodo_tpu.sources.base import ListDataSource as JaxListDataSource
from docodo_tpu_torch import index as tindex
from docodo_tpu_torch.core import storage
from docodo_tpu_torch.core.pagetable import PageTable
from docodo_tpu_torch.index import (
    Index,
    IndexBuilder,
    ListDataSource,
    SearchOptions,
    levenshtein,
)
from docodo_tpu_torch.lang.vocab import Vocab
from docodo_tpu_torch.query.search import result_fields
from docodo_tpu_torch.synthetic import zipf_documents

from fixtures import TEST_TEXT_1, TestDataSource

# fill the reference tokenizer's lazy tables on the collecting thread
# (ROADMAP Queue C: the first build of a process can race them)
npipe._tables()

WORDS = ["and", "tupman", "everybody", "old"]


def make_voc(cls=Vocab):
    """tests/test_index.py:96's vocabulary, of either package."""
    voc = cls()
    voc.name = "en"
    for w, g in [("and", 1), ("end", 3), ("old", 2), ("the", 6),
                 ("them", 5), ("then", 4)]:
        voc.add(w, g)
    voc.range = ("a", "z")
    return voc


def _files(path):
    return tuple((path / n).read_bytes() for n in (".index", ".index.list"))


def _same_arrays(a, b):
    assert a.arr.terms == b.arr.terms
    assert a.arr.max_coord == b.arr.max_coord
    np.testing.assert_array_equal(a.arr.offsets, b.arr.offsets)
    np.testing.assert_array_equal(a.arr.coords, b.arr.coords)
    np.testing.assert_array_equal(a.pages.bounds, b.pages.bounds)
    np.testing.assert_array_equal(a.pages.page_doc, b.pages.page_doc)
    assert a.pages.page_ids == b.pages.page_ids
    assert a.pages.doc_names == b.pages.doc_names


# ---------------------------------------------------------------------------
# the standalone builder (test_index.py:132)
# ---------------------------------------------------------------------------

def _feed(bldr):
    pos = {w: [] for w in WORDS}
    bldr.add_doc("A", "")
    for m in re.finditer(r"\b\w+\b", TEST_TEXT_1.lower()):
        if m.group() in pos:
            pos[m.group()].append(m.start())
        bldr.add_word(m.group(), m.start())
    bldr.end_page("1")
    return pos


def test_builder_standalone(tmp_path):
    """BuilderTest (ref IndexTest.cs:272-319): a builder fed word by word
    builds an index whose words are found at their regex positions; its
    files are the JAX package's standalone builder's byte for byte, and
    the builder without a path builds the same in memory."""
    bldr = IndexBuilder(path=str(tmp_path / "bt"), device="cpu")
    pos = _feed(bldr.add_voc(make_voc()))
    index = bldr.build()
    for w in WORDS:
        res = index.search(w)
        assert len(res.found_pages) == 1
        assert res.found_pages[0].pos == pos[w]
    ref = JaxIndexBuilder(path=str(tmp_path / "jax")).add_voc(
        make_voc(JaxVocab))
    _feed(ref)
    ref = ref.build()
    assert _files(tmp_path / "bt") == _files(tmp_path / "jax")
    assert sorted(os.listdir(tmp_path / "bt")) == [".index", ".index.list"]
    mem = IndexBuilder(device="cpu").add_voc(make_voc())
    _feed(mem)
    mem = mem.build()
    _same_arrays(mem, index)
    for w in WORDS + ["and old", '"old lady"']:
        assert result_fields(mem.search(w)) == result_fields(ref.search(w))


def test_builder_refuses_a_spilled_build_and_builds_an_empty_one(tmp_path):
    ind = Index(str(tmp_path / "idx"), device="cpu")
    ind.max_tmp_index_items = 50
    bldr = ind.get_builder()
    _feed(bldr)
    assert bldr.n_tmp_index > 0
    with pytest.raises(RuntimeError, match="too large"):
        bldr.build()
    empty = IndexBuilder(path=str(tmp_path / "empty"), device="cpu").build()
    JaxIndexBuilder(path=str(tmp_path / "jax")).build()
    assert empty.can_search and empty.count == 0
    # the default marks as the JAX package makes them: add_doc("", "")
    # writes ':', which reads back as a page of id ''
    assert _files(tmp_path / "empty") == _files(tmp_path / "jax")


# ---------------------------------------------------------------------------
# spills and their merge (test_index.py:168, :207)
# ---------------------------------------------------------------------------

def _index(path, source, threads=1, items=None, **kw):
    ind = Index(None if path is None else str(path), device="cpu", **kw)
    ind.max_degree_of_parallelism = threads
    if items:
        ind.max_tmp_index_items = items
    ind.add_data_source(source)
    ind.create()
    return ind


def test_spill_and_merge(tmp_path):
    """MemUseTest analog: a spill threshold of 500 postings forces the
    tmpind / merge path; its results are the unspilled build's, and its
    arrays too, on one thread and on two."""
    a = _index(None, TestDataSource(20))
    for threads in (1, 2):
        b = _index(tmp_path / f"b{threads}", TestDataSource(20), threads,
                   items=500)
        _same_arrays(a, b)
        for req in ["and", "tupman", "old lady", '"old lady"']:
            assert result_fields(a.search(req)) == result_fields(
                b.search(req)), req
        assert not [d for d in os.listdir(tmp_path / f"b{threads}")
                    if d.isdigit() or d.endswith("_")]


@pytest.mark.parametrize("threads", [1, 2])
def test_path_build_times_the_page_cache(tmp_path, threads):
    """A build with a path writes every page into its source's zip cache
    under two spans a page: build.page-cache (the write) and
    build.page-cache-wait (the wait for the source's lock); an in-memory
    build writes no cache and records neither."""
    import zipfile

    from docodo_tpu_torch.utils import profiling

    profiling.reset()
    _index(tmp_path / "idx", TestDataSource(20), threads, items=500)
    calls = {name: n for name, _, n in profiling.report()}
    (zipped,) = [f for f in os.listdir(tmp_path / "idx")
                 if f.endswith(".cache.zip")]
    with zipfile.ZipFile(tmp_path / "idx" / zipped) as z:
        pages = len(z.namelist())
    assert pages > 20
    assert calls["build.page-cache"] == calls["build.page-cache-wait"] == pages
    profiling.reset()
    _index(None, TestDataSource(20), threads)
    assert not {"build.page-cache", "build.page-cache-wait"} & {
        name for name, _, _ in profiling.report()}


def test_mem_use_bounded_by_spill(tmp_path):
    """During a 1000-page build with a threshold of 50,000 postings the
    Python heap's growth stays under 10 MB (test_index.py:207, the
    reference's MemUseTest bound); the index reads lazily after."""
    import gc

    index = Index(str(tmp_path / "idx"), in_memory=False, device="cpu")
    index.max_tmp_index_items = 50_000
    index.add_data_source(TestDataSource(1000))
    gc.collect()
    tracemalloc.start()
    base, _ = tracemalloc.get_traced_memory()
    index.create()
    _, peak = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    growth_mb = (peak - base) / 1e6
    assert growth_mb < 10, f"peak heap growth {growth_mb:.1f} MB"
    assert index.count > 0 and index.arr.coords is None
    assert index.search("pickwick").found_pages


def _zipf_build(tmp_path, threads, items, docs, claim_docs, monkeypatch):
    """The port's build of `docs` into tmp_path / port<threads>, by
    `threads` threads claiming claim_docs documents at a time, spilling
    past `items` postings."""
    monkeypatch.setattr(tindex, "CLAIM_DOCS", claim_docs)
    return _index(tmp_path / f"port{threads}", ListDataSource("synth", docs),
                  threads, items=items)


@pytest.fixture(scope="module")
def zipf_docs():
    """A seeded Zipf corpus of 24 documents."""
    return zipf_documents(700_000, seed=3, vocab=3000, doc_chars=30_000)


def test_one_thread_with_spills_writes_the_jax_packages_files(
        tmp_path, zipf_docs, monkeypatch):
    """One thread, spilled at 10,000 postings: `.index` and `.index.list`
    byte for byte the JAX package's at max_degree_of_parallelism = 1 and
    the same max_tmp_index_items (which spills too), and the port's
    unspilled build's."""
    ref = docodo_tpu.Index(path=str(tmp_path / "jax"), in_memory=True)
    ref.max_degree_of_parallelism = 1
    ref.max_tmp_index_items = 10_000
    ref.add_data_source(JaxListDataSource("synth", zipf_docs))
    ref.create()
    mine = _zipf_build(tmp_path, 1, 10_000, zipf_docs, 4, monkeypatch)
    plain = _index(tmp_path / "unspilled", ListDataSource("synth", zipf_docs))
    assert _files(tmp_path / "port1") == _files(tmp_path / "jax")
    assert _files(tmp_path / "unspilled") == _files(tmp_path / "jax")
    _same_arrays(mine, plain)
    assert mine.arr.coords.size > 8 * 10_000


@pytest.mark.parametrize("threads,claim_docs", [(2, 4), (3, 1), (4, 64)])
def test_threads_build_what_one_thread_builds(tmp_path, zipf_docs,
                                              monkeypatch, threads,
                                              claim_docs):
    """Several build threads, each claiming claim_docs documents at a time
    and spilling: the arrays, the page table and so the results of one
    thread's build, and its files byte for byte."""
    one = _zipf_build(tmp_path, 1, 10_000, zipf_docs, claim_docs, monkeypatch)
    many = _zipf_build(tmp_path, threads, 10_000, zipf_docs, claim_docs,
                      monkeypatch)
    _same_arrays(one, many)
    assert _files(tmp_path / "port1") == _files(tmp_path / f"port{threads}")
    words = one.arr.terms[len(one.arr.terms) // 2::97][:6]
    for req in words + [f'"{words[0]} {words[1]}"', f"{words[2]} {words[3]}"]:
        assert result_fields(one.search(req)) == result_fields(
            many.search(req)), req


def _spill_files(tmp_path, rng, n_files, long_term=False):
    """Spill files of random CSRs over one vocabulary (a list of 3,000
    postings in each, past a block of 4 KB), written as a builder writes
    them."""
    vocab = sorted({"".join(rng.choice(list("abcdefghij"), size=int(k)))
                    for k in rng.integers(3, 9, size=300)})
    if long_term:
        vocab = sorted(vocab + ["x" * 200])
    paths = []
    for q in range(n_files):
        terms = sorted(rng.choice(vocab, size=int(rng.integers(1, 120)),
                                  replace=False).tolist())
        if long_term and "x" * 200 not in terms:
            terms = sorted(terms + ["x" * 200])
        lens = rng.integers(1, 40, size=len(terms))
        lens[terms.index(terms[len(terms) // 2])] = 3000  # past a block
        offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
        coords = np.concatenate([np.sort(rng.choice(10 ** 6, size=int(n),
                                                    replace=False))
                                 for n in lens]).astype(np.uint64)
        path = tmp_path / f"{q + 1}.tmpind"
        with open(path, "wb") as f:
            storage.write_postings_arrays(
                f, int(coords.max()) + int(rng.integers(0, 50)), terms,
                offsets, coords)
        paths.append(str(path))
    return paths


@pytest.mark.parametrize("n_files,long_term", [(1, False), (2, False),
                                               (7, True)])
@pytest.mark.parametrize("shift", [False, True])
@pytest.mark.parametrize("mem_items", [100, 10 ** 7])
def test_merge_spills_writes_the_jax_packages_bytes(tmp_path, n_files,
                                                    long_term, shift,
                                                    mem_items):
    """merge_spills on the same spill files: the JAX package's bytes and
    max_coord, by blocks of whole records (mem_items 100: blocks of
    4 KB, records longer than a block, a term of 200 bytes; 10**7: one
    block a file) and by whole files (_merge_spills_vectorized); the
    arrays it hands back are the file's."""
    rng = np.random.default_rng(n_files + 10 * long_term)
    paths = _spill_files(tmp_path, rng, n_files, long_term)
    want_mc = jax_storage.merge_spills(paths, str(tmp_path / "want"),
                                       shift_coords=shift,
                                       mem_items=mem_items)
    arrays = []
    got_mc = storage.merge_spills(paths, str(tmp_path / "got"),
                                  shift_coords=shift, mem_items=mem_items,
                                  arrays_out=arrays)
    assert got_mc == want_mc
    assert (tmp_path / "got").read_bytes() == (tmp_path / "want").read_bytes()
    back = storage.read_index(str(tmp_path / "got"))
    terms, offsets, coords = arrays[0]
    assert terms == back.terms
    np.testing.assert_array_equal(offsets, back.offsets)
    np.testing.assert_array_equal(coords, back.coords)
    storage._merge_spills_vectorized(paths, str(tmp_path / "whole"), shift)
    assert (tmp_path / "whole").read_bytes() == (tmp_path / "want").read_bytes()
    for p in paths:
        mc, t, lists = storage.read_spill(p)
        jmc, jt, jlists = jax_storage.read_spill(p)
        assert (mc, t) == (jmc, jt)
        assert all(np.array_equal(a, b) for a, b in zip(lists, jlists))


def test_spill_cursor_raises_on_a_truncated_spill(tmp_path):
    rng = np.random.default_rng(0)
    (path,) = _spill_files(tmp_path, rng, 1)
    raw = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(raw[:-3])
    with pytest.raises(ValueError, match="truncated"):
        storage.merge_spills([path], str(tmp_path / "out"), mem_items=100)


def test_page_table_from_marks_matches_the_jax_package():
    marks = [("src:a", 0), (":0", 40), (":1", 3040), ("src:b", 3040),
             ("src:c", 3040), (":1", 5000), (":2", 8000)]
    for shift in (0, 12345):
        got = PageTable.from_marks(marks, shift)
        want = JaxPageTable.from_marks(marks, shift)
        got.extend_from_marks(marks[3:], 9000)
        want.extend_from_marks(marks[3:], 9000)
        np.testing.assert_array_equal(got.bounds, want.bounds)
        np.testing.assert_array_equal(got.page_doc, want.page_doc)
        assert got.bounds.dtype == want.bounds.dtype
        assert (got.page_ids, got.doc_names) == (want.page_ids,
                                                 want.doc_names)


def test_marks_round_trip_as_the_jax_package_writes_them(tmp_path):
    from docodo_tpu.index import _load_marks as jax_load_marks

    marks = [("src:дом", 0), (":0", 12), (":17", 2 ** 40)]
    tindex._save_marks(str(tmp_path / "m"), marks)
    assert jax_load_marks(str(tmp_path / "m")) == marks
    assert tindex._load_marks(str(tmp_path / "m")) == marks


# ---------------------------------------------------------------------------
# the search surface (test_index.py:46-104, :289)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def syntax_pair(tmp_path_factory):
    """tests/test_index.py's make_index(n_pages=50) corpus, stemmers on,
    built by both packages on one thread (the JAX package's in a folder
    of its own: with path=None it works in ./index, which other tests
    share)."""
    ref = docodo_tpu.Index(path=str(tmp_path_factory.mktemp("syntax")))
    ref.max_degree_of_parallelism = 1
    ref.add_data_source(TestDataSource(50))
    ref.create()
    return _index(None, TestDataSource(50)), ref


@pytest.mark.parametrize("req,n_pos", [
    ("lady old", 10), ('"lady" old', 8), ('"old lady"', 8),
    ('"lady old"', None), ("lady (old | young)", 12),
    ('"old ladies were"', 3), ('"old lady were"', None),
    ('"old (lady|ladies) (who|were|looked)"', 9), ("?an?", None),
    ("and (tupman|old)", None)])
def test_request_syntax_with_search_options(syntax_pair, req, n_pos):
    """RequestSyntaxTest's SearchOptions(dist=40) cases (ref
    IndexTest.cs:164-226): the counts it asserts, and results equal to
    the JAX package's with the same options."""
    mine, ref = syntax_pair
    got = mine.search(req, SearchOptions(dist=40))
    assert result_fields(got) == result_fields(
        ref.search(req, JaxSearchOptions(dist=40)))
    if n_pos is not None:
        assert len(got.found_pages[0].pos) == n_pos
    elif req.startswith('"'):
        assert len(got.found_pages) == 0
    if req == "?an?":
        assert len(got.found_pages[0].pos) == len(
            re.findall(r"\w*an\w*", TEST_TEXT_1.lower()))
    assert result_fields(mine.search(req)) == result_fields(ref.search(req))


def test_search_options_window_changes_results(syntax_pair):
    mine, _ = syntax_pair
    near = mine.search("lady old", SearchOptions(dist=40))
    far = mine.search("lady old")
    assert len(near.found_pages[0].pos) < len(far.found_pages[0].pos)
    opt = SearchOptions()
    assert (opt.dist, opt.do_correction, opt.remove_word_breaks) == (
        0, False, True)


def test_close_words_and_group_names(tmp_path):
    """GetCloseWords (Levenshtein top 10, ref Search.cs:169-174) and
    GetWordsGroup (ref Index.cs:270-281), against the JAX package's."""
    index = _index(None, TestDataSource(3), vocs=[make_voc()])
    ref = docodo_tpu.Index(path=str(tmp_path), vocs=[make_voc(JaxVocab)])
    ref.max_degree_of_parallelism = 1
    ref.add_data_source(TestDataSource(3))
    ref.create()
    close = index.get_close_words("tupnan")
    assert close and close[0] == "tupman"
    assert close == ref.get_close_words("tupnan")
    name = index.get_words_group("#1")
    assert isinstance(name, str) and name == ref.get_words_group("#1")
    for s, t in (("", "abc"), ("kitten", "sitting"), ("дом", "дым"),
                 ("same", "same")):
        assert levenshtein(s, t) == docodo_tpu.index.levenshtein(s, t)


def test_lazy_exports():
    import docodo_tpu_torch as t

    assert t.Index is Index and t.IndexBuilder is IndexBuilder
    assert t.SearchOptions is SearchOptions and t.Vocab is Vocab
    for name in ("DeviceIndex", "BatchExecutor", "DocodoServer",
                 "ShardedDeviceIndex"):
        assert getattr(t, name).__name__ == name
    with pytest.raises(AttributeError):
        t.NoSuchThing
