"""Seeded synthetic corpora for the port's tests and its chip smoke run.

A Zipf text over a random vocabulary: `vocab` distinct lowercase words
of 3-12 letters, drawn with probability proportional to rank**-1.05,
cut into documents of about `doc_chars` characters and those into pages
of about 3000 characters, the page length bench.py uses (pages end at a
word boundary). The same seed gives the same corpus on every machine, so
the JAX package and the port can be held against each other on it.
Imports no jax.
"""

from __future__ import annotations

from typing import List

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


def build_index(docs: List[PagedDocument]) -> host_index.HostIndex:
    """Index `docs` with the port's host build (docodo_tpu_torch.index),
    as the source "synth"."""
    return host_index.build_index(ListDataSource("synth", docs))
