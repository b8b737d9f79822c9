"""PostingSeq's last members (order, shift, __iter__, encode, from_encoded,
encoded_len) and Index[term] of docodo_tpu_torch against the JAX
package's: the members on seeded lists, and Index[term] for every term of
a seeded corpus built in memory, written to a folder and loaded back
(in memory and lazily), present and absent, against docodo_tpu.Index
[term] over the same documents (built on one thread, as its byte-equal
files need). Exact everywhere."""

import numpy as np
import pytest

import docodo_tpu
from docodo_tpu.core.postings import PostingSeq as JaxPostingSeq
from docodo_tpu.native import pipeline as npipe
from docodo_tpu.sources.base import IndexPagedTextFile as JaxPagedTextFile
from docodo_tpu.sources.base import ListDataSource as JaxListDataSource
from docodo_tpu_torch.core.postings import PostingSeq
from docodo_tpu_torch.index import Index, IndexPagedTextFile, ListDataSource
from docodo_tpu_torch.synthetic import zipf_documents

# fill the reference tokenizer's lazy tables on this thread (ROADMAP
# Queue C: the first build of a process can race them)
npipe._tables()


def _lists(rng):
    yield np.zeros(0, dtype=np.uint64)
    yield np.array([0], dtype=np.uint64)
    yield np.array([32767, 32768, 1 << 30, (1 << 45) + 3], dtype=np.uint64)
    for n in (5, 300):
        yield np.cumsum(rng.integers(0, 70_000, n)).astype(np.uint64)


@pytest.mark.parametrize("r", [0, 7, -9])
def test_posting_seq_members_equal_jax(r):
    rng = np.random.default_rng(21)
    for coords in _lists(rng):
        mine, theirs = PostingSeq(coords, r), JaxPostingSeq(coords, r)
        assert mine.order == theirs.order == (r < 0)
        assert list(mine) == list(theirs) == coords.tolist()
        words = mine.encode()
        assert words.dtype == np.uint16
        np.testing.assert_array_equal(words, theirs.encode())
        assert mine.encoded_len == theirs.encoded_len == words.size
        back = PostingSeq.from_encoded(words, r)
        assert back == mine and back.R == r
        assert back.coords.dtype == np.uint64
        assert JaxPostingSeq.from_encoded(words, r).coords.tolist() \
            == back.coords.tolist()
        for delta in (0, 5, 1 << 33):
            a = PostingSeq(coords, r)
            b = JaxPostingSeq(coords, r)
            assert a.shift(delta) is a
            np.testing.assert_array_equal(a.coords, b.shift(delta).coords)
            assert a.coords.dtype == np.uint64


def _docs():
    return zipf_documents(80_000, seed=9, vocab=900, doc_chars=12_000)


@pytest.fixture(scope="module")
def indexes(tmp_path_factory):
    """The corpus indexed by the JAX package (one thread) and by the port
    in memory, into a folder, and loaded back from it in memory and
    lazily."""
    root = tmp_path_factory.mktemp("postings")
    docs = _docs()
    theirs = docodo_tpu.Index(path=str(root / "jax"), in_memory=True)
    theirs.max_degree_of_parallelism = 1
    theirs.add_data_source(JaxListDataSource("docs", [
        JaxPagedTextFile(d.name, " ".join(p.text for p in d.pages[1:]),
                         "author=x") for d in docs]))
    theirs.create()
    built = []
    for path in (None, str(root / "port")):
        ind = Index(path, device="cpu")
        ind.add_data_source(ListDataSource("docs", [
            IndexPagedTextFile(d.name, " ".join(p.text for p in d.pages[1:]),
                               "author=x") for d in docs]))
        ind.create()
        built.append(ind)
    loaded = Index(str(root / "port"), device="cpu")
    lazy = Index(str(root / "port"), in_memory=False, device="cpu")
    assert loaded.can_search and lazy.can_search and lazy.arr.coords is None
    return theirs, {"in memory": built[0], "written": built[1],
                    "loaded": loaded, "lazy": lazy}


@pytest.mark.parametrize("kind", ["in memory", "written", "loaded", "lazy"])
def test_index_getitem_equals_jax(indexes, kind):
    theirs, mine = indexes
    ind = mine[kind]
    terms = theirs.arr.terms
    assert ind.arr.terms == terms and len(terms) > 500
    for term in terms:
        got, want = ind[term], theirs[term]
        assert isinstance(got, PostingSeq) and got.R == 0
        np.testing.assert_array_equal(got.coords, want.coords)
        assert got.coords.dtype == np.uint64
    for absent in ("nosuchword", "", "#FFFFFF", terms[0].upper()):
        with pytest.raises(KeyError):
            theirs[absent]
        with pytest.raises(KeyError):
            ind[absent]


def test_getitem_before_a_build_raises_key_error():
    with pytest.raises(KeyError):
        Index(device="cpu")["abc"]
