"""The port's host build and its copies of the JAX package's host modules
against their originals: the index build against docodo_tpu.Index
(staged state array for array), the tokenizer, the stemmers and the word
coder, the standard and wide query mixes and the group_and / or_merge
oracle. Every input is seeded; every comparison is exact."""

import numpy as np
import pytest

import docodo_tpu
from benchmarks.common import standard_mix as jax_standard_mix
from benchmarks.common import wide_mix as jax_wide_mix
from docodo_tpu.core.postings import group_and as jax_group_and
from docodo_tpu.core.postings import or_merge as jax_or_merge
from docodo_tpu.lang import stemmers as jax_stemmers
from docodo_tpu.lang import tokenizer as jax_tokenizer
from docodo_tpu.lang.wordcodes import WordCoder as JaxWordCoder
from docodo_tpu.native import pipeline as npipe
from docodo_tpu.sources.base import ListDataSource as JaxListDataSource
from docodo_tpu_torch.index import IndexPage, ListDataSource, build_index
from docodo_tpu_torch.lang import stemmers, tokenizer, wordcodes
from docodo_tpu_torch.mix import standard_mix, wide_mix
from docodo_tpu_torch.ops.device_index import DeviceIndex
from docodo_tpu_torch.oracle import fold_row, group_and, or_merge
from docodo_tpu_torch.synthetic import zipf_documents

ALPHABETS = {
    "en": "abcdefghijklmnopqrstuvwxyz",
    "ru": "абвгдеёжзийклмнопрстуфхцчшщъыьэюя",
    "de": "abcdefghijklmnopqrstuvwxyzäöüß",
    "fr": "abcdefghijklmnopqrstuvwxyzéâàêèëçîïôûùüÿ",
}
SUFFIXES = ("ing", "ed", "es", "ly", "ness", "ation", "ться", "ами", "ость",
            "ung", "heit", "ement", "ité", "s", "")

# The reference's native tokenizer fills its two lazy tables one after
# the other, so the first docodo_tpu.Index build of a process can race
# its build threads into dropping a page (ROADMAP Queue C). Every pytest
# worker imports this module while it collects, so filling them here, on
# the collecting thread, keeps every index build of the worker off it.
npipe._tables()


class Doc:
    def __init__(self, name, pages):
        self.name = name
        self.pages = [IndexPage(pid, text) for pid, text in pages]

    def __iter__(self):
        return iter(self.pages)


def _reference_build(docs, work):
    """docodo_tpu.Index over `docs` on one build thread (a second thread
    would take documents in a racy order and its own coordinates)."""
    ind = docodo_tpu.Index(path=str(work), in_memory=True)
    ind.max_degree_of_parallelism = 1
    ind.add_data_source(JaxListDataSource("synth", docs))
    ind.create()
    return ind


def _staged(ind):
    dix = DeviceIndex.from_index(ind, device="cpu")
    return dix, dix.state()


@pytest.mark.parametrize("seed,vocab", [(11, 4000), (3, 900)])
def test_host_build_matches_index(tmp_path, seed, vocab):
    docs = zipf_documents(250_000, seed=seed, vocab=vocab, doc_chars=20_000)
    mine = build_index(ListDataSource("synth", docs), device="cpu")
    ref = _reference_build(docs, tmp_path)
    (got, gs), (want, ws) = _staged(mine), _staged(ref)
    assert sorted(gs) == sorted(ws)
    for k in ws:
        assert gs[k].dtype == ws[k].dtype, k
        np.testing.assert_array_equal(gs[k], ws[k], err_msg=k)
    assert got.terms == want.terms and len(got.terms) > 500
    assert got.page_ids == want.page_ids
    assert got.doc_names == want.doc_names
    assert mine.arr.max_coord == ref.arr.max_coord
    np.testing.assert_array_equal(mine.pages.bounds, ref.pages.bounds)


def test_host_build_sorts_header_and_body_postings(tmp_path):
    """Header fields, Cyrillic and accented text, short words, numbers and
    an empty page. A term in both a header and a body page keeps its
    coordinates ascending here; the reference appends the header's after
    the body's (IndexBuilder._gather_sorted, ROADMAP Queue C), so there
    its list equals ours only once sorted. Everything else is equal."""
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
    mine = build_index(ListDataSource("synth", docs), device="cpu")
    ref = _reference_build(docs, tmp_path)
    assert mine.arr.terms == ref.arr.terms
    np.testing.assert_array_equal(mine.arr.offsets, ref.arr.offsets)
    assert mine.pages.page_ids == ref.pages.page_ids == ["0", "1", "3", "0",
                                                          "1"]
    assert mine.pages.doc_names == ref.pages.doc_names
    np.testing.assert_array_equal(mine.pages.bounds, ref.pages.bounds)
    np.testing.assert_array_equal(mine.pages.page_doc, ref.pages.page_doc)
    unsorted = []
    off = ref.arr.offsets
    for t, term in enumerate(ref.arr.terms):
        want = ref.arr.coords[off[t]:off[t + 1]]
        got = mine.arr.coords[off[t]:off[t + 1]]
        np.testing.assert_array_equal(got, np.sort(want), err_msg=term)
        if not np.array_equal(got, want):
            unsorted.append(term)
    assert sorted(unsorted) == ["$dicken", "$втор", "dickens", "pickwick",
                                "второй", "том"]


def test_tokenizer_copy_matches(rng):
    alphabet = list("abcxyz АБВабв éßÄ 0123 .,;!-\n\t") + ["\U0001F600"]
    text = "".join(rng.choice(alphabet, 5000))
    assert tokenizer.lower_keep_length(text) == \
        jax_tokenizer.lower_keep_length(text)
    words, starts = tokenizer.tokenize(text)
    jwords, jstarts = jax_tokenizer.tokenize(text)
    assert words == jwords and len(words) > 100
    np.testing.assert_array_equal(starts, jstarts)
    assert tokenizer.char_len(text) == jax_tokenizer.char_len(text)


def _words(rng, alphabet, n):
    letters = np.array(list(alphabet))
    out = []
    for _ in range(n):
        stem = "".join(rng.choice(letters, int(rng.integers(1, 10))))
        out.append(stem + SUFFIXES[int(rng.integers(len(SUFFIXES)))])
    return out


@pytest.mark.parametrize("lang", sorted(ALPHABETS))
def test_stemmer_copy_matches(rng, lang):
    mine = stemmers.get_stemmer(lang)
    theirs = {"en": jax_stemmers._stem_en_py}.get(
        lang, jax_stemmers.get_stemmer(lang))
    words = _words(rng, ALPHABETS[lang], 3000)
    got = [mine(w) for w in words]
    assert got == [theirs(w) for w in words]
    assert sum(g != w for g, w in zip(got, words)) > 300


def test_word_codes_copy_match(rng):
    """The port's coder is the reference WordCoder without vocabularies
    or stop words."""
    words = [w for alphabet in ALPHABETS.values()
             for w in _words(rng, alphabet, 500)]
    words += ["1836", "9lives", "mixedязык", "", "the", "café"]
    theirs = JaxWordCoder()
    assert [wordcodes.codes(w) for w in words] == \
        [theirs.codes(w) for w in words]


@pytest.mark.parametrize("n,seed", [(300, 42), (301, 7)])
def test_standard_mix_copy_matches(rng, n, seed):
    counts = rng.integers(0, 50, 2000)
    names = [f"w{i:04d}" + "x" * int(rng.integers(0, 6))
             for i in range(2000)]
    got = standard_mix(counts, names, n, seed=seed)
    want = jax_standard_mix(counts, names, n, seed=seed)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("r1,r2", [(12, 9), (-12, -9), (12, -9), (0, 0)])
def test_group_and_copy_matches(rng, r1, r2):
    for _ in range(20):
        a = np.sort(rng.integers(0, 3000, int(rng.integers(0, 200))))
        b = np.sort(rng.integers(0, 3000, int(rng.integers(0, 200))))
        got, got_r = group_and(a, b, r1, r2)
        want, want_r = jax_group_and(a, b, r1, r2)
        assert got_r == want_r and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,seed", [(300, 77), (40, 5)])
def test_wide_mix_copy_matches(rng, n, seed):
    counts = rng.integers(0, 50, 2000)
    names = [f"w{i:04d}" + "x" * int(rng.integers(0, 6))
             for i in range(2000)]
    got = wide_mix(counts, names, n, seed=seed)
    want = jax_wide_mix(counts, names, n, seed=seed)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_or_merge_copy_matches(rng):
    for _ in range(40):
        a = np.sort(rng.integers(0, 3000, int(rng.integers(0, 200))))
        b = np.sort(rng.integers(0, 3000, int(rng.integers(0, 200))))
        got, got_r = or_merge(a, b, 1, -4)
        want, want_r = jax_or_merge(a, b, 1, -4)
        assert got_r == want_r and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_fold_row_matches_the_wide_row_fold(rng):
    """fold_row against tests/test_wide_mix.py's host fold, written out
    with the JAX package's or_merge and group_and."""
    for _ in range(30):
        w = int(rng.integers(1, 5))
        words = [[np.sort(rng.integers(0, 4000, int(rng.integers(0, 300))))
                  for _ in range(int(rng.integers(1, 4)))] for _ in range(w)]
        rs = rng.choice([-9, 12, 40, 260], w)
        acc, r_acc = None, 0
        for variants, r in zip(words, rs):
            b = variants[0].astype(np.uint64)
            for nxt in variants[1:]:
                b, _ = jax_or_merge(b, nxt, 1, 1)
            if acc is None:
                acc, r_acc = b, int(r)
            else:
                acc, r_acc = jax_group_and(acc, b, r_acc, int(r))
        np.testing.assert_array_equal(fold_row(words, rs), acc)
