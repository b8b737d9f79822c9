"""Seeded synthetic corpora for the port's tests and its chip smoke run.

A Zipf text over a random vocabulary: `vocab` distinct lowercase words
of 3-12 letters, drawn with probability proportional to rank**-1.05,
cut into documents of about `doc_chars` characters and those into pages
of about 3000 characters, the page length bench.py uses (pages end at a
word boundary). The same seed gives the same corpus on every machine, so
the JAX package and the port can be held against each other on it.

For vocabularies, a Russian-like text of the surface forms a loaded
.voc file knows (vocabulary_documents). Imports no jax.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from docodo_tpu_torch import index as host_index
from docodo_tpu_torch.index import IndexPage, ListDataSource

_LETTERS = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", dtype=np.uint8)
ZIPF_EXPONENT = 1.05
PAGE_CHARS = 3000


class PagedDocument:
    """One document: header page "0" plus its body pages "1".."k"."""

    def __init__(self, name: str, pages: List[str]):
        self.name = name
        self.pages = [IndexPage("0", f"Name={name}\n")] + [
            IndexPage(str(i + 1), p) for i, p in enumerate(pages)
        ]

    def __iter__(self):
        return iter(self.pages)

    def close(self) -> None:
        pass


def zipf_vocabulary(rng: np.random.Generator, vocab: int) -> List[str]:
    """`vocab` distinct random words of 3-12 lowercase letters."""
    words: List[str] = []
    seen = set()
    while len(words) < vocab:
        lens = rng.integers(3, 13, size=vocab)
        letters = _LETTERS[rng.integers(0, 26, size=int(lens.sum()))]
        cuts = np.cumsum(lens)[:-1]
        for w in np.split(letters, cuts):
            s = w.tobytes().decode("ascii")
            if s not in seen:
                seen.add(s)
                words.append(s)
                if len(words) == vocab:
                    break
    return words


def zipf_documents(total_chars: int, seed: int = 0, vocab: int = 50_000,
                   doc_chars: int = 100_000) -> List[PagedDocument]:
    """Documents of a seeded Zipf text of about `total_chars` chars."""
    rng = np.random.default_rng(seed)
    words = zipf_vocabulary(rng, vocab)
    wlen = np.fromiter((len(w) for w in words), np.int64, len(words))
    p = np.arange(1, vocab + 1, dtype=np.float64) ** -ZIPF_EXPONENT
    p /= p.sum()
    mean_len = float((wlen * p).sum()) + 1.0
    n_tok = max(1, int(total_chars / mean_len))
    ids = rng.choice(vocab, size=n_tok, p=p)
    # character offset of each token in the running text (one space
    # after every word); pages and documents cut at token boundaries
    ends = np.cumsum(wlen[ids] + 1)
    starts = ends - wlen[ids] - 1
    page_of_tok = starts // PAGE_CHARS
    doc_of_page_start = starts // doc_chars
    page_cuts = np.flatnonzero(np.diff(page_of_tok)) + 1
    doc_pages: dict = {}
    for pg in np.split(np.arange(n_tok), page_cuts):
        if pg.size == 0:
            continue
        d = int(doc_of_page_start[pg[0]])
        doc_pages.setdefault(d, []).append(
            " ".join(words[i] for i in ids[pg]))
    return [PagedDocument(f"doc{d:05d}", pages)
            for d, pages in sorted(doc_pages.items())]


RU_ENDINGS = ("", "а", "у", "ом", "е", "ы", "ов", "ами", "ой", "ого", "ая",
              "ые", "ий", "ть", "ла", "ли")


def vocabulary_forms(voc) -> List[str]:
    """Surface forms a vocabulary knows: its stems with Russian endings,
    kept where the form is indexable (3 letters or more) and its stem is
    a key of the vocabulary. In stem order."""
    forms: List[str] = []
    seen = set()
    for stem in sorted(voc.words):
        for end in RU_ENDINGS:
            w = stem + end
            if len(w) >= 3 and w not in seen and voc.search(voc.stem(w)):
                seen.add(w)
                forms.append(w)
    return forms


def vocabulary_documents(voc, n_docs: int = 6, pages: int = 5,
                         words: int = 260, seed: int = 0,
                         extra: Sequence[str] = ()) -> List[PagedDocument]:
    """Seeded paged documents over vocabulary_forms(voc) plus `extra`
    words (unknown words, stop words, numbers), drawn with a shuffled
    power-law weight so that some words are frequent and many rare. The
    header values (document names) are no body tokens."""
    rng = np.random.default_rng(seed)
    pool = vocabulary_forms(voc) + list(extra)
    weights = 1.0 / np.arange(1, len(pool) + 1) ** 0.7
    weights = weights[rng.permutation(len(pool))]
    weights /= weights.sum()
    docs = []
    for d in range(n_docs):
        texts = []
        for _ in range(pages):
            picks = rng.choice(len(pool), size=words, p=weights)
            texts.append(" ".join(pool[i] for i in picks).capitalize() + ".")
        docs.append(PagedDocument(f"doc{d:05d}", texts))
    return docs


def build_index(docs: List[PagedDocument], vocs: Sequence = (),
                stop_words=None, native: bool = True,
                device="cuda") -> host_index.HostIndex:
    """Index `docs` with the port's build (docodo_tpu_torch.index), as the
    source "synth"."""
    return host_index.build_index(ListDataSource("synth", docs), vocs=vocs,
                                  stop_words=stop_words, native=native,
                                  device=device)
