"""Seeded corpora made in bulk with NumPy, for the benchmark's cells.

A configuration file (configs/<name>.json) gives the shape: about
`corpus_chars` characters of Zipf text (exponent `zipf_exponent`) over a
vocabulary of `vocab` distinct lowercase words of `word_len_min` to
`word_len_max` letters, cut into documents of about `doc_chars` and those
into pages of about `page_chars` characters (a page or a document ends
at a word), each document opening with a header page "0" of one line,
`header_field=` followed by `title_words` words of the same text.
The vocabulary and each word's Zipf rank come from `vocab_seed`, and each
word's count in the body text and in the titles is its Zipf share of
them, rounded: so every seed's corpus holds the same tokens, and every
posting list (a word's, or a stem key's over its words) the same length,
in another order. The run's seed draws that order, the titles and the
queries; a seed never moves a list across a bucket's power-of-two cap.

The generator keeps what it drew, so that the reference needs nothing
the program made: every token's word id and coordinate as the port's
build numbers them (header fields first, then the body pages, which
follow each other with no separator), each page's end coordinate, its
document and whether it is a header page. The port gets the same text
as documents of IndexPage objects.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import List

import numpy as np

_LETTERS = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", dtype=np.uint8)
_SPACE = np.uint8(ord(" "))
# tokens turned into bytes at a time
_CHUNK = 1 << 22
THREADS = 8


@dataclass
class Corpus:
    """A generated corpus and what the reference reads of it."""

    words: List[str]          # the vocabulary; word id = index
    ids: np.ndarray           # int32 [N] every token's word id, by coordinate
    coords: np.ndarray        # int64 [N] every token's coordinate
    page_end: np.ndarray      # int64 [P] coordinate after each page
    page_doc: np.ndarray      # int32 [P] each page's document ordinal
    is_header: np.ndarray     # bool [P] header page ("0")
    documents: list           # the documents handed to the port's build
    chars: int                # characters of text handed to the build
    seconds: dict             # generation phases, host clock

    def counts(self) -> np.ndarray:
        """Postings of each word, by word id."""
        return np.bincount(self.ids, minlength=len(self.words))


class Document:
    """One document as the port's build reads it: a name and its pages."""

    __slots__ = ("name", "pages")

    def __init__(self, name: str, pages: list):
        self.name = name
        self.pages = pages

    def __iter__(self):
        return iter(self.pages)

    def close(self) -> None:
        pass


def vocabulary(rng: np.random.Generator, n: int, lo: int,
               hi: int) -> List[str]:
    """`n` distinct random words of `lo`..`hi` lowercase letters."""
    words: List[str] = []
    seen = set()
    while len(words) < n:
        lens = rng.integers(lo, hi + 1, size=n)
        letters = _LETTERS[rng.integers(0, 26, size=int(lens.sum()))]
        for w in np.split(letters, np.cumsum(lens)[:-1]):
            s = w.tobytes().decode("ascii")
            if s not in seen:
                seen.add(s)
                words.append(s)
                if len(words) == n:
                    break
    return words


def _chunked(fn, n: int) -> list:
    """fn(lo, hi) over [0, n) in chunks, on threads (NumPy releases the
    interpreter lock in the gathers), results in order."""
    spans = [(lo, min(n, lo + _CHUNK)) for lo in range(0, n, _CHUNK)]
    with ThreadPoolExecutor(THREADS) as pool:
        return list(pool.map(lambda sp: fn(*sp), spans))


def shares(p: np.ndarray, n: int) -> np.ndarray:
    """Counts of each word among `n` tokens: p * n rounded, the largest
    remainders up, so that they sum to n."""
    want = p * n
    c = np.floor(want).astype(np.int64)
    c[np.argsort(-(want - c), kind="stable")[:n - int(c.sum())]] += 1
    return c


def shuffled(rng: np.random.Generator, counts: np.ndarray) -> np.ndarray:
    """Word id i `counts[i]` times, in a uniformly random order: chunks of
    the sequence drawn from what is left (multivariate hypergeometric),
    each shuffled on a thread by its own generator."""
    left = counts.astype(np.int64)
    n = int(left.sum())
    parts = []
    for lo in range(0, n, _CHUNK):
        m = min(_CHUNK, n - lo)
        part = (rng.multivariate_hypergeometric(left, m) if m < left.sum()
                else left.copy())
        left -= part
        parts.append(part)
    seeds = rng.integers(0, 2**63, size=len(parts))
    words = np.arange(counts.size, dtype=np.int32)

    def chunk(j):
        a = np.repeat(words, parts[j])
        np.random.default_rng(int(seeds[j])).shuffle(a)
        return a
    if not parts:
        return words[:0]
    with ThreadPoolExecutor(THREADS) as pool:
        return np.concatenate(list(pool.map(chunk, range(len(parts)))))


def _text_bytes(table: np.ndarray, wlen: np.ndarray,
                ids: np.ndarray) -> bytes:
    """The tokens `ids` as text, each word followed by one space."""
    lane = np.arange(table.shape[1], dtype=np.int64)[None, :]

    def part(lo, hi):
        chunk = ids[lo:hi]
        return table[chunk][lane <= wlen[chunk][:, None]].tobytes()
    return b"".join(_chunked(part, ids.size))


def generate(cfg: dict, seed: int, page_cls) -> Corpus:
    """The corpus of configuration `cfg` for `seed`; `page_cls(id, text)`
    makes a page object for the port (its IndexPage)."""
    clock = [time.perf_counter()]
    seconds = {}

    def lap(name):
        clock.append(time.perf_counter())
        seconds[name] = clock[-1] - clock[-2]

    n_vocab = int(cfg["vocab"])
    words = vocabulary(np.random.default_rng([int(cfg["vocab_seed"]), 4]),
                       n_vocab, int(cfg["word_len_min"]),
                       int(cfg["word_len_max"]))
    rng = np.random.default_rng([int(seed), 0])
    wlen = np.fromiter((len(w) for w in words), np.int64, n_vocab)
    p = np.arange(1, n_vocab + 1, dtype=np.float64) ** -float(
        cfg["zipf_exponent"])
    p /= p.sum()
    mean_len = float((wlen * p).sum()) + 1.0
    n_tok = max(1, int(int(cfg["corpus_chars"]) / mean_len))
    ids = shuffled(rng, shares(p, n_tok))
    page_chars = int(cfg["page_chars"])
    doc_chars = int(cfg["doc_chars"])
    lap("draw")

    # each token's start in the running text (a space after every word);
    # pages and documents cut where a token starts in a new one
    lens = wlen[ids]
    ends = np.cumsum(lens + 1)
    starts = ends - lens - 1
    del lens
    page_first = np.unique(np.searchsorted(
        starts, np.arange(0, int(ends[-1]), page_chars)))
    page_last_end = np.append(starts[page_first[1:]], ends[-1]) - 1
    page_len = page_last_end - starts[page_first]      # no trailing space
    doc_of_page = (starts[page_first] // doc_chars).astype(np.int64)
    doc_first_page = np.flatnonzero(
        np.diff(doc_of_page, prepend=-1) != 0)
    n_docs = doc_first_page.size
    n_body = page_first.size

    # header line per document: `field=` and title words, or none
    field = cfg.get("header_field")
    n_title = int(cfg["title_words"]) if field else 0
    title = shuffled(rng, shares(p, n_docs * n_title)).reshape(n_docs,
                                                                n_title)
    title_len = wlen[title]                            # [D, t]
    # the line's characters, with its newline
    head_len = (len(field) + 1 + title_len.sum(axis=1) + n_title
                if field else np.zeros(n_docs, dtype=np.int64))
    # title word k's offset in the line
    head_off = (len(field or "") + 1 + np.cumsum(title_len + 1, axis=1)
                - title_len - 1)

    # coordinates: per document its header page, then its body pages
    body_pages_of_doc = np.diff(np.append(doc_first_page, n_body))
    # total coordinate length of each document
    body_sum = np.add.reduceat(page_len, doc_first_page)
    doc_start = np.concatenate([[0], np.cumsum(head_len + body_sum)[:-1]])
    # each body page's start coordinate
    page_doc_body = np.repeat(np.arange(n_docs), body_pages_of_doc)
    within = np.cumsum(page_len) - page_len
    within = within - np.repeat(within[doc_first_page], body_pages_of_doc)
    body_page_start = doc_start[page_doc_body] + head_len[page_doc_body] \
        + within
    body_coords = starts + np.repeat(body_page_start - starts[page_first],
                                     np.diff(np.append(page_first, n_tok)))
    head_coords = doc_start[:, None] + head_off

    # the page table: per document the header page, then its pages
    n_head = n_docs if field else 0
    hdr_slot = (doc_first_page + np.arange(n_docs))[:n_head]
    is_header = np.zeros(n_head + n_body, dtype=bool)
    is_header[hdr_slot] = True
    page_end = np.empty(n_head + n_body, dtype=np.int64)
    page_end[hdr_slot] = (doc_start + head_len)[:n_head]
    page_end[~is_header] = body_page_start + page_len
    page_doc = np.empty(n_head + n_body, dtype=np.int32)
    page_doc[hdr_slot] = np.arange(n_head)
    page_doc[~is_header] = page_doc_body

    # every token by coordinate: a document's title words come first
    all_ids, all_coords = ids, body_coords
    if n_title:
        # before each document's first body token (np.insert keeps the
        # order of values inserted at one index)
        at = np.repeat(page_first[doc_first_page], n_title)
        all_ids = np.insert(ids, at, title.reshape(-1))
        all_coords = np.insert(body_coords, at, head_coords.reshape(-1))

    lap("layout")
    # the text: body bytes once, sliced per page; header lines per doc
    width = int(wlen.max()) + 1
    table = np.full((n_vocab, width), _SPACE, dtype=np.uint8)
    for i, w in enumerate(words):
        table[i, :len(w)] = np.frombuffer(w.encode("ascii"), np.uint8)
    text = _text_bytes(table, wlen, ids).decode("ascii")
    lap("text")
    pstart = starts[page_first].tolist()
    plen = page_len.tolist()
    titles = [" ".join(words[i] for i in row) for row in title.tolist()]
    documents = []
    bounds = np.append(doc_first_page, n_body).tolist()
    for d in range(n_docs):
        pages = [page_cls("0", f"{field}={titles[d]}\n")] if field else []
        for k, pg in enumerate(range(bounds[d], bounds[d + 1])):
            s = pstart[pg]
            pages.append(page_cls(str(k + 1), text[s:s + plen[pg]]))
        documents.append(Document(f"doc{d:07d}", pages))
    lap("documents")
    return Corpus(words=words, ids=all_ids, coords=all_coords,
                  page_end=page_end,
                  page_doc=page_doc, is_header=is_header,
                  documents=documents,
                  chars=int(page_len.sum() + head_len.sum()),
                  seconds=seconds)
