"""The bulk corpus generator: its stated shape at a small size, and the
coordinates it keeps equal to what the port's build makes of its text."""

import json
import os

import numpy as np
import pytest

from docodo_tpu_torch.index import IndexPage, ListDataSource, build_index
from perfbench import corpus, harness


def config(name, chars):
    with open(os.path.join(harness.HERE, "configs", f"{name}.json")) as f:
        cfg = json.load(f)
    return dict(cfg, corpus_chars=chars)


@pytest.mark.parametrize("name", ["books-1g", "wiki1k-256m"])
def test_shape(name):
    cfg = config(name, 2_000_000)
    c = corpus.generate(cfg, 2**31 + 3, IndexPage)
    body = ~c.is_header
    lens = np.diff(np.concatenate([[0], c.page_end]))[body]
    # corpus_chars is the body text; header lines come on top of it
    assert abs(lens.sum() - cfg["corpus_chars"]) < 0.02 * cfg["corpus_chars"]
    assert c.chars >= lens.sum()
    # a page holds the words that start in its window of page_chars, so
    # its last word may run past the window by less than a word
    assert lens.max() < cfg["page_chars"] + cfg["word_len_max"]
    assert np.median(lens) > cfg["page_chars"] - 2 * cfg["word_len_max"]
    n_docs = int(c.page_doc[-1]) + 1
    assert abs(n_docs - cfg["corpus_chars"] / cfg["doc_chars"]) \
        <= 0.02 * n_docs + 1
    assert np.all(np.diff(c.page_doc) >= 0)
    assert c.is_header.sum() == (n_docs if cfg["header_field"] else 0)
    assert np.all(np.diff(c.coords) > 0)
    assert c.ids.size == c.coords.size
    words = [len(w) for w in c.words]
    assert min(words) >= cfg["word_len_min"]
    assert max(words) <= cfg["word_len_max"]
    assert len(set(c.words)) == cfg["vocab"]
    # Zipf: the most frequent word far ahead of the median one
    counts = np.sort(c.counts())[::-1]
    assert counts[0] > 100 * max(1, counts[len(counts) // 10])


def test_seed_decides_the_corpus():
    cfg = config("books-1g", 500_000)
    a = corpus.generate(cfg, 5, IndexPage)
    b = corpus.generate(cfg, 5, IndexPage)
    c = corpus.generate(cfg, 6, IndexPage)
    assert np.array_equal(a.ids, b.ids) and np.array_equal(a.coords,
                                                           b.coords)
    assert not np.array_equal(a.ids[:1000], c.ids[:1000])
    # the vocabulary and each word's count are the same for every seed
    assert a.words == c.words
    assert np.array_equal(a.counts(), c.counts())
    assert a.page_end.size == c.page_end.size


@pytest.mark.parametrize("name", ["books-1g", "wiki1k-256m"])
def test_coordinates_match_the_ports_build(name):
    cfg = config(name, 1_500_000)
    c = corpus.generate(cfg, 11, IndexPage)
    ind = build_index(ListDataSource("synth", c.documents), device="cpu")
    pt, arr = ind.pages, ind.arr
    assert np.array_equal(pt.bounds.astype(np.int64), c.page_end)
    assert np.array_equal(pt.page_doc, c.page_doc)
    assert np.array_equal(np.array([p == "0" for p in pt.page_ids]),
                          c.is_header)
    term = {t: i for i, t in enumerate(arr.terms)}
    order = np.argsort(c.ids, kind="stable")
    off = np.concatenate([[0], np.cumsum(c.counts())])
    for w in range(len(c.words)):
        ref = c.coords[order[off[w]:off[w + 1]]]
        if ref.size == 0:
            assert c.words[w] not in term
            continue
        t = term[c.words[w]]
        got = arr.coords[arr.offsets[t]:arr.offsets[t + 1]]
        assert np.array_equal(got.astype(np.int64), ref), c.words[w]
