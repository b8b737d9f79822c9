"""The port's own host index build: paged documents -> the CSR postings and
the page table that DeviceIndex.from_index stages.

It follows the pure-Python page path of the JAX package's build
(docodo_tpu/index.py: Index._index_task :436-481, _index_header_page
:496-514, IndexBuilder._gather_sorted :1050-1080) on one thread, in
memory, with no spills, varint or storage. Every word is keyed by
itself and, with vocabularies (Dict/*.voc), by the '#HEX' group of its
stem, else by its '$stem' where a stemmer covers it; stop words get no
key (lang/wordcodes.py).

    from docodo_tpu_torch.index import IndexPage, ListDataSource, build_index
    from docodo_tpu_torch.lang.vocab import Vocab, load_stop_words
    ind = build_index(ListDataSource("docs", documents),
                      vocs=[Vocab("Dict/ru.voc")],
                      stop_words=load_stop_words("stop.txt"))
    dix = DeviceIndex.from_index(ind)
    group = word_group(ind, "дома")       # ((variant keys), R) or None
    dix.search_batch_full([[group]])

A document is an iterable of IndexPage(id, text) with a `name`; page
"0" is the header page of 'name=value' lines.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from docodo_tpu_torch import constants as C
from docodo_tpu_torch.lang import tokenizer
from docodo_tpu_torch.lang.wordcodes import WordCoder


@dataclass
class IndexPage:
    id: str
    text: str


class ListDataSource:
    """A named fixed list of documents (docodo_tpu/sources/base.py:135)."""

    def __init__(self, name: str, docs: Iterable):
        self.name = name
        self._docs = list(docs)
        self._pos = 0

    def reset(self) -> None:
        self._pos = 0

    def next_document(self):
        if self._pos >= len(self._docs):
            return None
        doc = self._docs[self._pos]
        self._pos += 1
        return doc


@dataclass
class Postings:
    """CSR postings: term t's coordinates are coords[offsets[t]:
    offsets[t + 1]], ascending; terms in string order. max_coord is the
    last coordinate the build added, as the JAX package's builder keeps
    it."""

    terms: List[str]
    offsets: np.ndarray   # int64 [T + 1]
    coords: np.ndarray    # uint64 [N]
    max_coord: int
    # term -> ordinal; the JAX package's DeviceIndex.from_index reads it,
    # so the parity tests stage one host index in both packages
    _tmap: Dict[str, int] = field(init=False, repr=False)

    def __post_init__(self):
        self._tmap = {t: i for i, t in enumerate(self.terms)}


@dataclass
class PageTable:
    """Page END coordinates (exclusive, ascending), each page's document
    ordinal and id, and the document names (docodo_tpu/core/pagetable.py)."""

    bounds: np.ndarray    # uint64 [P]
    page_doc: np.ndarray  # int64 [P]
    page_ids: List[str]
    doc_names: List[str]


@dataclass
class HostIndex:
    """What the build returns: `arr` and `pages`, as DeviceIndex.from_index
    reads them, and the word coder (vocabularies, stop words) the build
    keyed its words with, which the query side must share."""

    arr: Postings
    pages: PageTable
    coder: WordCoder = field(default_factory=WordCoder)

    def get_like_words(self, word: str) -> List[str]:
        """Wildcard expansion over the term dictionary: '_' matches any
        run of characters (docodo_tpu/index.py:635, ref Search.cs:160-167);
        at most MAX_LIKE_WORDS full-form keys, in term order."""
        if "_" not in word:
            return [word]
        if len(word) < 2:
            return []
        pattern = re.compile(word.replace("_", ".*"))
        out = []
        for key in self.arr.terms:
            if key and key[0].isalpha() and pattern.search(key):
                out.append(key)
                if len(out) >= C.MAX_LIKE_WORDS:
                    break
        return out


def _chosen_codes(index: HostIndex, word: str,
                  b_exact: bool) -> Tuple[str, ...]:
    """The keys one form is searched by: exact mode takes the full form
    only; otherwise the vocabulary and stem keys win over the full form
    (docodo_tpu/query/batcher.py:81, ref Search.cs:226-233)."""
    codes = index.coder.codes(word)
    selfcodes = [c for c in codes if re.match(r"\w", c[0])]
    known = [c for c in codes if c not in selfcodes]
    return tuple(selfcodes[:1] if b_exact else (known or selfcodes[:1]))


def word_group(index: HostIndex,
               word: str) -> Optional[Tuple[Tuple[str, ...], int]]:
    """One query word -> the (variant keys, R) group that
    DeviceIndex.compile_group_query takes, or None when the word matches
    nothing (a stop word, a wildcard with no expansion), by the host
    search's preference rules (docodo_tpu/query/batcher.py:94
    `_word_codes`, ref Search.cs:192-260): an ALL-UPPERCASE word is
    exact (its full form alone, ordered R = -(length + 4)); a '_'
    wildcard expands through get_like_words into an OR of up to 100
    full forms, exact; any other word is searched by its vocabulary
    group or stem key where it has one, with R = 255 + length."""
    b_exact = word.upper() == word
    lw = word.lower()
    if "_" in lw:
        variants: List[str] = []
        for w in index.get_like_words(lw):
            for c in _chosen_codes(index, w, b_exact=True):
                if c not in variants:
                    variants.append(c)
        if not variants:
            return None
        return tuple(variants), -(len(lw) + 4)
    chosen = _chosen_codes(index, lw, b_exact)
    if not chosen:
        return None
    return chosen, -(len(lw) + 4) if b_exact else C.DEFAULT_DIST + len(lw)


class _Stream:
    """The build's posting stream in coordinate order: (term id, coord)
    parts, plus each word's row of term ids."""

    def __init__(self, coder: WordCoder):
        self.coder = coder
        self.terms: List[str] = []
        self.tmap: Dict[str, int] = {}
        self.word_ids: Dict[str, int] = {}
        self.word_rows: List[List[int]] = []
        self.tids: List[np.ndarray] = []
        self.coords: List[np.ndarray] = []
        self.max_coord = 0

    def tid(self, code: str) -> int:
        t = self.tmap.get(code)
        if t is None:
            t = len(self.terms)
            self.tmap[code] = t
            self.terms.append(code)
        return t

    def word_row(self, word: str) -> int:
        w = self.word_ids.get(word)
        if w is None:
            w = len(self.word_rows)
            self.word_ids[word] = w
            self.word_rows.append([self.tid(c)
                                   for c in self.coder.codes(word)])
        return w

    def add(self, code: str, coord: int) -> None:
        """One posting of a term key (IndexBuilder.add)."""
        self.max_coord = int(coord)
        self.tids.append(np.array([self.tid(code)], dtype=np.int64))
        self.coords.append(np.array([coord], dtype=np.uint64))

    def add_word(self, word: str, coord: int) -> None:
        """A word's postings at one coordinate (IndexBuilder.add_word)."""
        for code in self.coder.codes(word):
            self.add(code, coord)

    def add_tokens(self, words: List[str], coords: np.ndarray) -> None:
        """A page's tokens (IndexBuilder.add_tokens): every word fans out
        to its term ids at its coordinate."""
        if not words:
            return
        rows = [self.word_rows[self.word_row(w)] for w in words]
        lens = np.fromiter((len(r) for r in rows), np.int64, len(rows))
        self.tids.append(np.fromiter((t for r in rows for t in r), np.int64,
                                     int(lens.sum())))
        self.coords.append(np.repeat(np.asarray(coords, dtype=np.uint64),
                                     lens))
        self.max_coord = int(coords[-1])

    def postings(self) -> Postings:
        """Term-sorted CSR (IndexBuilder._gather_sorted): the stream is in
        coordinate order, so a stable sort on the term's string rank
        leaves every list ascending."""
        if not self.tids:
            return Postings([], np.zeros(1, dtype=np.int64),
                            np.zeros(0, dtype=np.uint64), self.max_coord)
        tids = np.concatenate(self.tids)
        coords = np.concatenate(self.coords)
        order_terms = sorted(range(len(self.terms)),
                             key=self.terms.__getitem__)
        rank = np.empty(len(self.terms), dtype=np.int32)
        rank[np.array(order_terms, dtype=np.int64)] = np.arange(
            len(order_terms), dtype=np.int32)
        keys = rank[tids]
        perm = np.argsort(keys, kind="stable")
        counts = np.bincount(keys, minlength=len(self.terms))
        offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        return Postings([self.terms[i] for i in order_terms], offsets,
                        coords[perm], self.max_coord)


def _index_header_page(stream: _Stream, text: str, coord: int) -> int:
    """Header page: 'name=value' lines index '&name' at the value start
    and the value words after it (index.py:496-514, ref Build.cs:485-524)."""
    lines = text.split("\n")
    if text.endswith("\n"):
        lines = lines[:-1]
    for line in lines:
        low = line.lower()
        fields = low.split("=")
        if len(fields) > 1 and len(fields[0]) >= C.MIN_WORD_LENGTH:
            pieces = re.split(r"\b", fields[1])
            dc = len(fields[0]) + 1
            for piece in pieces:
                if len(piece) >= 1 and re.match(r"\w", piece[0]):
                    stream.add(C.FIELD_NAME_CHAR + fields[0], coord + dc - 1)
                    stream.add_word(piece, coord + dc)
                dc += len(piece)
        coord += len(line) + 1
    return coord


def build_index(source: ListDataSource, vocs: Sequence = (),
                stop_words: Optional[set] = None) -> HostIndex:
    """Index every page of every document of `source`, in order, into one
    coordinate space: body pages by the tokenizer (tokens of 3-32
    characters at their UTF-16 offsets), header pages by their fields.
    Empty pages are skipped, as the JAX package skips them. `vocs`
    (lang.vocab.Vocab, in the order that numbers their group keys) and
    `stop_words` key the words as docodo_tpu.Index(vocs=...) with
    add_stop_words does; a stop word keeps its coordinate and gets no
    posting."""
    coder = WordCoder(vocs=vocs, stop_words=stop_words)
    stream = _Stream(coder)
    bounds: List[int] = []
    page_doc: List[int] = []
    page_ids: List[str] = []
    doc_names: List[str] = []
    coord = 0
    source.reset()
    while (doc := source.next_document()) is not None:
        doc_names.append(f"{source.name}{C.DOC_SEP}{doc.name}")
        for page in doc:
            if len(page.text) == 0:
                continue
            if page.id == "0":
                coord = _index_header_page(stream, page.text, coord)
            else:
                low = tokenizer.lower_keep_length(page.text)
                words, starts = tokenizer.tokenize(low, lowered=True)
                keep = [k for k, w in enumerate(words)
                        if C.MIN_WORD_LENGTH <= len(w) <= C.MAX_WORD_LENGTH]
                stream.add_tokens([words[k] for k in keep],
                                  starts[keep].astype(np.uint64)
                                  + np.uint64(coord))
                coord += tokenizer.char_len(low)
            bounds.append(coord)
            page_doc.append(len(doc_names) - 1)
            page_ids.append(page.id)
        close = getattr(doc, "close", None)
        if close:
            close()
    pages = PageTable(np.array(bounds, dtype=np.uint64),
                      np.array(page_doc, dtype=np.int64), page_ids,
                      doc_names)
    return HostIndex(stream.postings(), pages, coder)
