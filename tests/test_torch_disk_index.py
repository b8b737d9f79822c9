"""The port's index on disk against the JAX package's: `Index(path)`'s
`.index` and `.index.list` files byte for byte (a list source, a text
folder with `.dscr` headers, a vocabulary), each package loading the
other's files and answering `search` the same, snippets included (from
the other's `<source>.cache.zip`), an index disposed and reopened (in
memory and lazily), cancel / create_async, and the histogram.

Tolerance: exact everywhere. The JAX package builds on one thread
(max_degree_of_parallelism = 1), and every corpus keeps its header words
out of the body text: the JAX package's build leaves a list unsorted for
a term in both (ROADMAP Queue C), which each fixture checks."""

import os
import time
import zipfile

import numpy as np
import pytest

import docodo_tpu
from docodo_tpu.lang.vocab import Vocab as JaxVocab
from docodo_tpu.native import pipeline as npipe
from docodo_tpu.sources import IndexTextFilesDataSource as JaxFilesSource
from docodo_tpu.sources.base import IndexPagedTextFile as JaxPagedTextFile
from docodo_tpu.sources.base import ListDataSource as JaxListDataSource
from docodo_tpu_torch.index import (
    Index,
    IndexPage,
    IndexPagedTextFile,
    ListDataSource,
)
from docodo_tpu_torch.lang.vocab import Vocab
from docodo_tpu_torch.query.search import result_fields
from docodo_tpu_torch.sources import IndexTextFilesDataSource
from docodo_tpu_torch.synthetic import vocabulary_documents, zipf_documents

# fill the reference tokenizer's lazy tables on the collecting thread
# (ROADMAP Queue C: the first build of a process can race them)
npipe._tables()

RU_VOC = os.path.join(os.path.dirname(__file__), "..", "Dict", "ru.voc")
REQUESTS = ["abc", "{author=dickens}", "{author=dickens} {source=files}",
            "{name=sub}", "-filter:sub.*"]


def _corpus(root):
    """A seeded Zipf text as .txt files, two in a subfolder whose .dscr
    gives them an author. Returns three of its frequent words."""
    docs = zipf_documents(60_000, seed=5, vocab=700, doc_chars=9_000)
    (root / "sub").mkdir(parents=True)
    (root / "sub" / ".dscr").write_text("author=dickens\n;a comment\n")
    for i, d in enumerate(docs):
        folder = root / "sub" if i < 2 else root
        (folder / f"{d.name}.txt").write_text(
            " ".join(p.text for p in d.pages[1:]))
    (root / f"{docs[3].name}.txt.dscr").write_text("year=1836\n")
    words = " ".join(p.text for p in docs[0].pages[1:]).split()
    top = sorted(set(words), key=words.count)[-3:]
    return top


def _build_jax(path, source, vocs=()):
    ind = docodo_tpu.Index(path=str(path), in_memory=True, vocs=list(vocs))
    ind.max_degree_of_parallelism = 1
    ind.add_data_source(source)
    ind.create()
    # the JAX package's fault stays out of the corpus: every list ascends
    arr = ind.arr
    steps = np.diff(arr.coords.astype(np.int64))
    heads = np.zeros(steps.size, dtype=bool)
    inner = arr.offsets[1:-1]
    heads[inner[(inner > 0) & (inner <= steps.size)] - 1] = True
    assert (heads | (steps > 0)).all()
    return ind


@pytest.fixture(scope="module")
def files_pair(tmp_path_factory):
    """The text folder indexed by both packages into folders of their
    own: (corpus, port's index, JAX package's index, requests)."""
    root = tmp_path_factory.mktemp("disk")
    corpus = root / "corpus"
    top = _corpus(corpus)
    ref = _build_jax(root / "jax", JaxFilesSource("files", f"{corpus}/"))
    mine = Index(str(root / "port"), device="cpu")
    mine.add_data_source(IndexTextFilesDataSource("files", f"{corpus}/"))
    mine.create()
    reqs = REQUESTS + top + [f'"{top[0]} {top[1]}"', f"{top[2]} {top[0]}",
                             f"{top[1][:3]}?", f"{top[0]} {{year=1836}}"]
    yield corpus, mine, ref, reqs
    mine.dispose()
    ref.dispose()


def _files_equal(a, b):
    for name in (".index", ".index.list"):
        assert (a / name).read_bytes() == (b / name).read_bytes(), name


def _cache_pages(path):
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


def test_text_folder_files_equal_the_jax_packages(files_pair):
    """The text folder's `.index` and `.index.list` are the JAX
    package's bytes, the page cache holds the same pages, and the
    build's arrays read back from the file unchanged."""
    corpus, mine, ref, _ = files_pair
    root = corpus.parent
    _files_equal(root / "port", root / "jax")
    assert _cache_pages(root / "port" / "files.cache.zip") \
        == _cache_pages(root / "jax" / "files.cache.zip")
    assert not [f for f in os.listdir(root / "port") if f.endswith("_")]
    back = Index(str(root / "port"), device="cpu")
    assert back.arr.terms == mine.arr.terms == ref.arr.terms
    assert back.arr.max_coord == mine.arr.max_coord == ref.arr.max_coord
    np.testing.assert_array_equal(back.arr.offsets, mine.arr.offsets)
    np.testing.assert_array_equal(back.arr.coords, mine.arr.coords)
    assert back.pages.page_ids == mine.pages.page_ids
    assert back.pages.doc_names == mine.pages.doc_names
    np.testing.assert_array_equal(back.pages.bounds, mine.pages.bounds)
    np.testing.assert_array_equal(back.pages.page_doc, mine.pages.page_doc)
    assert back.generation == 1 and mine.generation == 1


@pytest.mark.parametrize("kind", ["list", "vocabulary"])
def test_list_source_files_equal_the_jax_packages(tmp_path, kind):
    """A list source of header and body pages, and a Russian corpus
    keyed by Dict/ru.voc, write the JAX package's bytes; the histogram
    (its group keys as their words) equals the JAX package's."""
    if kind == "list":
        docs = zipf_documents(30_000, seed=8, vocab=500, doc_chars=6_000)
        vocs, jvocs = [], []
    else:
        voc = Vocab(RU_VOC)
        docs = vocabulary_documents(voc, n_docs=3, pages=2, words=120)
        vocs, jvocs = [voc], [JaxVocab(RU_VOC)]
    jax_docs = [JaxPagedTextFile(d.name, d.pages[1].text, d.pages[0].text)
                for d in docs]
    port_docs = [IndexPagedTextFile(d.name, d.pages[1].text, d.pages[0].text)
                 for d in docs]
    ref = _build_jax(tmp_path / "jax", JaxListDataSource("docs", jax_docs),
                     jvocs)
    with Index(str(tmp_path / "port"), vocs=vocs, device="cpu") as mine:
        mine.add_data_source(ListDataSource("docs", port_docs))
        mine.create()
        _files_equal(tmp_path / "port", tmp_path / "jax")
        hist = Index.calc_histogram(mine, 50)
        assert hist == docodo_tpu.Index.calc_histogram(ref, 50)
        if kind == "vocabulary":
            assert any(k.startswith("(") for k in hist)
    ref.dispose()


def test_each_package_loads_the_others_files(files_pair):
    """The port loads the JAX package's folder and the JAX package the
    port's; all four answer every request the same, snippets included."""
    corpus, mine, ref, reqs = files_pair
    root = corpus.parent
    other = Index(str(root / "jax"), device="cpu")
    other.add_data_source(IndexTextFilesDataSource("files", f"{corpus}/"))
    jax_other = docodo_tpu.Index(path=str(root / "port"), in_memory=True)
    jax_other.add_data_source(JaxFilesSource("files", f"{corpus}/"))
    assert other.can_search and jax_other.can_search
    try:
        for req in reqs:
            want = result_fields(ref.search(req))
            assert want["success"]
            assert result_fields(mine.search(req)) == want, req
            assert result_fields(other.search(req)) == want, req
            assert result_fields(jax_other.search(req)) == want, req
        assert sum(bool(ref.search(r).found_docs) for r in reqs) >= 8
        assert any(d.pages[0].text for d in mine.search(reqs[5]).found_docs)
    finally:
        other.dispose()
        jax_other.dispose()


@pytest.mark.parametrize("in_memory", [True, False],
                         ids=["in memory", "lazy"])
def test_reopened_index_answers_the_same(files_pair, in_memory):
    """An index disposed and opened again from its path answers every
    request as before, snippets from its page cache included; lazily it
    reads each list from the file."""
    corpus, mine, _, reqs = files_pair
    root = corpus.parent
    want = [result_fields(mine.search(r)) for r in reqs]
    with Index(str(root / "port"), in_memory=in_memory,
               device="cpu") as again:
        again.add_data_source(IndexTextFilesDataSource("files",
                                                       f"{corpus}/"))
        assert again.can_search and (again.arr.coords is None) != in_memory
        assert [result_fields(again.search(r)) for r in reqs] == want
        assert again.get_suggestions(reqs[5][:2]) \
            == mine.get_suggestions(reqs[5][:2])
    assert again.arr is None and not again.can_search


class _SlowDoc:
    """A document whose pages take a while each to read."""

    def __init__(self, name):
        self.name = name

    def __iter__(self):
        for i, text in enumerate(("Name=" + self.name, "alpha beta words")):
            time.sleep(0.002)
            yield IndexPage(str(i), text)


def test_cancel_and_create_async(tmp_path):
    """create_async runs the build on a thread of its own; cancel stops a
    running build within a document, and leaves the index before it, its
    files and its page cache as they were."""
    path = tmp_path / "idx"
    ind = Index(str(path), device="cpu")
    ind.add_data_source(ListDataSource("docs", [
        IndexPagedTextFile("good", "gamma delta words here", "Name=good")]))
    t = ind.create_async()
    t.join(timeout=60)
    assert not t.is_alive() and ind.can_search and ind.generation == 1
    before = {n: (path / n).read_bytes() for n in os.listdir(path)}
    want = result_fields(ind.search("gamma"))
    assert want["pages"]
    ind.add_data_source(ListDataSource(
        "slow", [_SlowDoc(f"d{i}") for i in range(20_000)]))
    t = ind.create_async()
    time.sleep(0.3)
    assert ind.is_creating and not ind.can_index
    started = time.time()
    ind.cancel()
    t.join(timeout=30)
    assert not t.is_alive() and time.time() - started < 5
    assert ind.status == "Idle" and ind.generation == 1
    assert {n: (path / n).read_bytes() for n in os.listdir(path)} == before
    assert result_fields(ind.search("gamma")) == want
    assert not [n for n in os.listdir(path) if n.endswith("_")]
    # a build that is not cancelled installs
    ind.sources.pop()
    ind.add_data_source(ListDataSource("slow", [_SlowDoc("d0")]))
    ind.create()
    assert ind.generation == 2 and ind.search("alpha").found_docs
    ind.dispose()


def test_cancel_without_a_path_keeps_the_index():
    """Without a path a cancelled build leaves the index in memory as it
    was and writes no file."""
    ind = Index(device="cpu")
    ind.add_data_source(ListDataSource("docs", [
        IndexPagedTextFile("good", "gamma delta words here", "Name=good")]))
    ind.create()
    want = result_fields(ind.search("gamma"))
    assert want["docs"][0][2]  # a snippet
    ind.add_data_source(ListDataSource(
        "slow", [_SlowDoc(f"d{i}") for i in range(20_000)]))
    t = ind.create_async()
    time.sleep(0.3)
    ind.cancel()
    t.join(timeout=30)
    assert not t.is_alive() and ind.generation == 1
    assert result_fields(ind.search("gamma")) == want
