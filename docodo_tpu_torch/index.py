"""The port's own index build: paged documents -> the CSR postings and
the page table that DeviceIndex.from_index stages; and the host engine
over it, `Index`, which the batcher and the server serve.

It follows the page path of the JAX package's build (docodo_tpu/index.py:
Index._index_task :390-481, _index_header_page :496-514,
IndexBuilder.add_interned :957-1036, _gather_sorted :1050-1080) on one
thread, in memory, with no spills, varint or storage. Body pages go
through the native tokenizer and interner (native/), whose interned ids
fan out to term ids by one gather, the new words' stems taken in bulk;
header pages, and every page with native=False, through the pure-Python
tokenizer. The (term, coordinate) stream is sorted into the CSR on
`device` (sort_postings: a stable sort of the terms' ranks), the card
by default. Every word is keyed by itself and, with vocabularies
(Dict/*.voc), by the '#HEX' group of its stem, else by its '$stem'
where a stemmer covers it; stop words get no key (lang/wordcodes.py).

    from docodo_tpu_torch.index import IndexPage, ListDataSource, build_index
    from docodo_tpu_torch.lang.vocab import Vocab, load_stop_words
    ind = build_index(ListDataSource("docs", documents),
                      vocs=[Vocab("Dict/ru.voc")],
                      stop_words=load_stop_words("stop.txt"))
    dix = DeviceIndex.from_index(ind)
    group = word_group(ind, "дома")       # ((variant keys), R) or None
    dix.search_batch_full([[group]])

A document is an iterable of IndexPage(id, text) with a `name`; page
"0" is the header page of 'name=value' lines. `device="cpu"` sorts on
the CPU, as the tests do.

The host engine (docodo_tpu/index.py:83 `Index`, trimmed to what the
batcher and the server read): data sources whose page text it keeps in
memory as the build reads it, `create()` (a rebuild bumps `generation`),
and `search(req)`, the request parser and the posting algebra over the
build with snippets and highlights.

    from docodo_tpu_torch.index import Index, IndexPagedTextFile
    ind = Index()
    ind.add_data_source(ListDataSource("docs", [
        IndexPagedTextFile("pick", text, "author=dickens")]))
    ind.create()
    res = ind.search('"pickwick club" {author=dickens}')
"""

from __future__ import annotations

import bisect
import math
import re
import threading
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from docodo_tpu_torch import constants as C
from docodo_tpu_torch.core.postings import PostingSeq
from docodo_tpu_torch.lang import tokenizer
from docodo_tpu_torch.lang.wordcodes import WordCoder
from docodo_tpu_torch.native import pipeline
from docodo_tpu_torch.ops.device_index import INF32
from docodo_tpu_torch.query import parser as qparser
from docodo_tpu_torch.query.search import (
    ErrorSearchResult,
    SearchResult,
    combine_search_results,
    highlight_positions,
    prepare_page_text,
    prepare_search_result,
)
from docodo_tpu_torch.utils import profiling


@dataclass
class IndexPage:
    id: str
    text: str


class IndexPagedTextFile:
    """A pre-paged text document: header page "0" of 'name=value' lines
    and one body page "1" (docodo_tpu/sources/base.py:29)."""

    def __init__(self, name: str, text: str, headers: str):
        self.name = name
        self.pages = [IndexPage("0", headers), IndexPage("1", text)]

    def __iter__(self):
        return iter(self.pages)

    def close(self) -> None:
        pass


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
        self._enc_counts = None

    def __len__(self) -> int:
        return len(self.terms)

    def get(self, term: str) -> Optional[np.ndarray]:
        """A term's coordinates, or None for a term the index lacks."""
        tid = self._tmap.get(term)
        if tid is None:
            return None
        return self.coords[self.offsets[tid]: self.offsets[tid + 1]]

    def enc_count(self, tid: int) -> int:
        """The u16 words a term's list takes in the JAX package's varint
        storage, which ranks its suggestions: per delta from the previous
        coordinate (the first from 0), max(1, ceil(bits / 15))
        (docodo_tpu/core/storage.py:101-113, core/varint.py:46)."""
        if self._enc_counts is None:
            deltas = np.diff(self.coords, prepend=np.uint64(0))
            starts = self.offsets[:-1][self.offsets[:-1] < self.offsets[1:]]
            deltas[starts] = self.coords[starts]
            words = np.ones(deltas.shape, dtype=np.int64)
            for j in (15, 30, 45, 60):
                words += deltas >= (np.uint64(1) << np.uint64(j))
            cs = np.concatenate([[0], np.cumsum(words)])
            self._enc_counts = cs[self.offsets[1:]] - cs[self.offsets[:-1]]
        return int(self._enc_counts[tid])


@dataclass
class PageTable:
    """Page END coordinates (exclusive, ascending), each page's document
    ordinal and id, and the document names (docodo_tpu/core/pagetable.py)."""

    bounds: np.ndarray    # uint64 [P]
    page_doc: np.ndarray  # int64 [P]
    page_ids: List[str]
    doc_names: List[str]

    def __len__(self) -> int:
        return len(self.page_ids)

    def locate(self, coords: np.ndarray):
        """For each coordinate its (page index, position in the page), by
        binary search of the page ends (pagetable.py:77); a coordinate
        past the last bound maps to the last page."""
        coords = np.asarray(coords, dtype=np.uint64)
        page = np.searchsorted(self.bounds, coords, side="right")
        page = np.minimum(page, len(self.bounds) - 1)
        base = np.where(page > 0, self.bounds[np.maximum(page - 1, 0)], 0)
        pos = (coords - base).astype(np.int64)
        return page.astype(np.int64), pos

    def page_base(self, page_idx: int) -> int:
        return int(self.bounds[page_idx - 1]) if page_idx > 0 else 0


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


# body pages pend until this many UTF-16 units, then go through one
# native call; their tokens pend until FLUSH_TOKENS, then go to the
# stream in one gather
BODY_UNITS = 1 << 20
FLUSH_TOKENS = 131072


class _Stream:
    """The build's posting stream in coordinate order: (term id, coord)
    parts, each word's row of term ids, and with `native` the native
    interner of body-page words with each interned id's row."""

    def __init__(self, coder: WordCoder, native: bool):
        self.coder = coder
        self.terms: List[str] = []
        self.tmap: Dict[str, int] = {}
        self.word_ids: Dict[str, int] = {}
        self.word_rows: List[List[int]] = []
        self.tids: List[np.ndarray] = []
        self.coords: List[np.ndarray] = []
        self.max_coord = 0
        self.interner = pipeline.NativeInterner() if native else None
        # interned id -> its word, and the start and length of its row of
        # term ids in code_flat (length -1 until the id is first seen)
        self.id_words: List[str] = []
        self.code_offs = np.zeros(0, dtype=np.int64)
        self.code_lens = np.zeros(0, dtype=np.int64)
        self.code_flat = np.zeros(0, dtype=np.int64)
        self.code_flat_n = 0

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

    def add_interned(self, ids: np.ndarray, coords: np.ndarray) -> None:
        """Tokens as the native interner's ids (IndexBuilder.add_interned):
        each id seen for the first time gets its row of term ids once,
        after one bulk stem of the new words (WordCoder.prime), and the
        tokens fan out to their rows by one gather."""
        if ids.size == 0:
            return
        self.id_words.extend(self.interner.terms_range(len(self.id_words),
                                                       len(self.interner)))
        hi = len(self.id_words)
        if self.code_lens.size < hi:
            grow = max(hi, 2 * self.code_lens.size)
            self.code_lens = np.concatenate(
                [self.code_lens,
                 np.full(grow - self.code_lens.size, -1, dtype=np.int64)])
            self.code_offs = np.concatenate(
                [self.code_offs,
                 np.zeros(grow - self.code_offs.size, dtype=np.int64)])
        unseen = self.code_lens[ids] < 0
        if unseen.any():
            new_ids = np.unique(ids[unseen])
            words = [self.id_words[i] for i in new_ids.tolist()]
            self.coder.prime(words)
            rows = [[self.tid(c) for c in self.coder.codes(w)]
                    for w in words]
            row_lens = np.fromiter((len(r) for r in rows), np.int64,
                                   len(rows))
            pos = self.code_flat_n
            need = pos + int(row_lens.sum())
            if need > self.code_flat.size:
                flat = np.empty(max(need, 2 * self.code_flat.size),
                                dtype=np.int64)
                flat[:pos] = self.code_flat[:pos]
                self.code_flat = flat
            self.code_flat[pos:need] = [t for r in rows for t in r]
            self.code_flat_n = need
            self.code_offs[new_ids] = pos + np.cumsum(row_lens) - row_lens
            self.code_lens[new_ids] = row_lens
        counts = self.code_lens[ids]
        total = int(counts.sum())
        if total:
            first = self.code_offs[ids] - (np.cumsum(counts) - counts)
            gather = np.repeat(first, counts) + np.arange(total)
            self.tids.append(self.code_flat[gather])
            self.coords.append(np.repeat(coords, counts))
        self.max_coord = int(coords[-1])

    def postings(self, device: torch.device) -> Postings:
        """Term-sorted CSR (IndexBuilder._gather_sorted), sorted on
        `device`: each posting's key is its term's rank in string order,
        and the stream is in coordinate order (sort_postings)."""
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
        offsets, coords = sort_postings(rank[tids], coords, len(self.terms),
                                        device)
        return Postings([self.terms[i] for i in order_terms], offsets,
                        coords, self.max_coord)


def sort_postings(keys: np.ndarray, coords: np.ndarray, num_terms: int,
                  device) -> Tuple[np.ndarray, np.ndarray]:
    """The CSR of a (term rank, coordinate) stream in coordinate order,
    sorted on `device`: (offsets int64[T + 1], coords uint64[N]). The
    stream is in coordinate order, so a stable sort of the int32 ranks
    alone leaves every list ascending; the coordinates ride along, as
    int32 below INF32, else int64, and offsets come from the ranks'
    counts."""
    dev = torch.device(device)
    if keys.size == 0:
        return np.zeros(num_terms + 1, dtype=np.int64), coords
    k = torch.from_numpy(keys).to(dev)
    narrow = int(coords[-1]) < INF32
    c = coords.astype(np.int32) if narrow else coords.view(np.int64)
    sc = torch.from_numpy(c).to(dev)[torch.sort(k, stable=True).indices]
    off = torch.zeros(num_terms + 1, dtype=torch.int64, device=dev)
    off[1:] = torch.cumsum(torch.bincount(k, minlength=num_terms), 0)
    sc = sc.cpu().numpy()
    return (off.cpu().numpy(),
            sc.astype(np.uint64) if narrow else sc.view(np.uint64))


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


def _device(device) -> torch.device:
    """The build's device; a CUDA one raises without CUDA."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("index build on a CUDA device, but CUDA is not "
                           "available; pass device=\"cpu\" to build on "
                           "the CPU")
    return dev


def build_index(source: ListDataSource, vocs: Sequence = (),
                stop_words: Optional[set] = None, native: bool = True,
                device="cuda") -> HostIndex:
    """Index every page of every document of `source`, in order, into one
    coordinate space: body pages by the tokenizer (tokens of 3-32
    characters at their UTF-16 offsets), header pages by their fields.
    Empty pages are skipped, as the JAX package skips them. `vocs`
    (lang.vocab.Vocab, in the order that numbers their group keys) and
    `stop_words` key the words as docodo_tpu.Index(vocs=...) with
    add_stop_words does; a stop word keeps its coordinate and gets no
    posting. `native=False` tokenizes body pages in pure Python; the CSR
    is sorted on `device`."""
    return _build([source], WordCoder(vocs=vocs, stop_words=stop_words),
                  native, device)


def _build(sources: Sequence, coder: WordCoder, native: bool,
           device) -> HostIndex:
    """build_index over several sources, one after the other in one
    coordinate space."""
    dev = _device(device)
    stream = _Stream(coder, native)
    bounds: List[int] = []
    page_doc: List[int] = []
    page_ids: List[str] = []
    doc_names: List[str] = []
    coord = 0
    try:
        for source in sources:
            coord = _build_source(source, stream, coord, bounds, page_doc,
                                  page_ids, doc_names)
    finally:
        if stream.interner is not None:
            stream.interner.close()
    pages = PageTable(np.array(bounds, dtype=np.uint64),
                      np.array(page_doc, dtype=np.int64), page_ids,
                      doc_names)
    with profiling.phase("build.sort"):
        arr = stream.postings(dev)
    return HostIndex(arr, pages, coder)


def _build_source(source, stream: _Stream, coord: int, bounds, page_doc,
                  page_ids, doc_names) -> int:
    """One source's pages into the stream. With the native interner, body
    pages pend and go through one tokenizer call BODY_UNITS at a time
    (a call a page would wait on the interpreter lock once a page while
    other threads run, as a server's do during a rebuild), and their
    tokens go to the stream FLUSH_TOKENS at a time; both flush before
    every header page, so that the stream stays in coordinate order."""
    body: List[str] = []        # body pages not tokenized yet, in order
    body_units: List[int] = []  # their lengths in UTF-16 units
    body_at = 0                 # the coordinate of the first of them
    pend_ids: List[np.ndarray] = []
    pend_coords: List[np.ndarray] = []
    pend_n = 0

    def tokenize_body():
        # the pages joined by newlines, which no token crosses: a token's
        # coordinate is its offset in the joined text less the newlines
        # before it
        nonlocal pend_n
        if not body:
            return
        with profiling.phase("build.tokenize"):
            ids, starts = pipeline.tokenize_intern_native(
                "\n".join(body), stream.interner, C.MIN_WORD_LENGTH,
                C.MAX_WORD_LENGTH)
        seps = np.searchsorted(np.cumsum(np.array(body_units) + 1), starts,
                               side="right")
        pend_ids.append(ids)
        pend_coords.append((starts - seps).astype(np.uint64)
                           + np.uint64(body_at))
        pend_n += ids.size
        body.clear()
        body_units.clear()

    def flush():
        nonlocal pend_n
        tokenize_body()
        if pend_ids:
            with profiling.phase("build.wordcode+gather"):
                stream.add_interned(np.concatenate(pend_ids),
                                    np.concatenate(pend_coords))
            pend_ids.clear()
            pend_coords.clear()
            pend_n = 0

    source.reset()
    while (doc := source.next_document()) is not None:
        doc_names.append(f"{source.name}{C.DOC_SEP}{doc.name}")
        for page in doc:
            if len(page.text) == 0:
                continue
            if page.id == "0":
                flush()
                coord = _index_header_page(stream, page.text, coord)
            elif stream.interner is not None:
                if not body:
                    body_at = coord
                body.append(page.text)
                body_units.append(tokenizer.char_len(page.text))
                coord += body_units[-1]
                if coord - body_at >= BODY_UNITS:
                    tokenize_body()
                if pend_n >= FLUSH_TOKENS:
                    flush()
            else:
                with profiling.phase("build.tokenize"):
                    low = tokenizer.lower_keep_length(page.text)
                    words, starts = tokenizer.tokenize(low, lowered=True)
                with profiling.phase("build.wordcode+gather"):
                    keep = [k for k, w in enumerate(words)
                            if C.MIN_WORD_LENGTH <= len(w)
                            <= C.MAX_WORD_LENGTH]
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
    flush()
    return coord


# --------------------------------------------------------------------------
# the host engine
# --------------------------------------------------------------------------

class _CachedDoc:
    """A live document whose pages' text goes into `pages` as the build
    iterates it."""

    def __init__(self, doc, pages: Dict[str, str]):
        self._doc = doc
        self._pages = pages
        self.name = doc.name

    def __iter__(self):
        for page in self._doc:
            self._pages[page.id] = page.text
            yield page

    def close(self) -> None:
        close = getattr(self._doc, "close", None)
        if close:
            close()


class _StoredDoc:
    """A built document's pages by id; a page the build did not see reads
    as empty text, as the JAX package's zip cache reads it."""

    def __init__(self, pages: Dict[str, str]):
        self._pages = pages

    def __getitem__(self, page_id: str) -> IndexPage:
        return IndexPage(page_id, self._pages.get(page_id, ""))

    def close(self) -> None:
        pass


class TextCacheDataSource:
    """A data source wrapper that keeps every page's text as the build
    reads it and serves it back at result time, source[doc][page].text,
    for snippets and highlights (docodo_tpu/sources/cache.py:56
    IndexTextCacheDataSource, in memory where that one keeps a zip file).
    A build reads into a new table, which publish() swaps in when the
    index it belongs to is installed."""

    def __init__(self, source):
        self.source = source
        self._built: Optional[Dict[str, Dict[str, str]]] = None
        self._reading: Dict[str, Dict[str, str]] = {}

    @property
    def name(self) -> str:
        return self.source.name

    def reset(self) -> None:
        self.source.reset()
        self._reading = {}

    def next_document(self):
        doc = self.source.next_document()
        if doc is None:
            return None
        return _CachedDoc(doc, self._reading.setdefault(doc.name, {}))

    def publish(self) -> None:
        self._built, self._reading = self._reading, {}

    def __getitem__(self, doc_name: str):
        if self._built is None:
            return None
        return _StoredDoc(self._built.get(doc_name, {}))


_FILTER_RE = re.compile(r"\B-filter:((?:[\w*?\\.()+{}/]+,?)+)")


class Index:
    """The host engine over the port's build (docodo_tpu/index.py:83):
    what the batcher and the server read of docodo_tpu.Index. Always
    indexes full forms (the JAX package's b_keep_forms = True), in
    memory, on one build thread; `native` and `device` as build_index
    takes them (a CUDA device raises here without CUDA)."""

    def __init__(self, vocs: Sequence = (), stop_words=None,
                 native: bool = True, device="cuda"):
        self.native = native
        self.device = _device(device)
        self.vocs = list(vocs)
        self.stop_words: set = set(stop_words) if stop_words else set()
        self.sources: List[TextCacheDataSource] = []
        self.host: Optional[HostIndex] = None
        self.can_search = False
        self.status = "Idle"
        # bumped whenever a build installs: a device index restages then
        self.generation = 0
        self._search_lock = threading.RLock()

    def add_data_source(self, source) -> None:
        self.sources.append(TextCacheDataSource(source))

    @property
    def arr(self) -> Optional[Postings]:
        return self.host.arr if self.host is not None else None

    @property
    def pages(self) -> Optional[PageTable]:
        return self.host.pages if self.host is not None else None

    @property
    def word_coder(self) -> WordCoder:
        return self.host.coder

    @property
    def count(self) -> int:
        return len(self.arr) if self.arr is not None else 0

    @property
    def max_coord(self) -> int:
        return self.arr.max_coord if self.arr is not None else 0

    def create(self) -> None:
        """Rebuild from the data sources (index.py:219) and install the
        build, its page text and a new generation at once."""
        if not self.sources or self.status != "Idle":
            return
        self.status = "Index"
        try:
            host = _build(self.sources,
                          WordCoder(vocs=self.vocs,
                                    stop_words=set(self.stop_words)),
                          self.native, self.device)
            with self._search_lock:
                for source in self.sources:
                    source.publish()
                self.host = host
                self.generation += 1
                self.can_search = True
        except Exception:
            self.can_search = False
            raise
        finally:
            self.status = "Idle"

    # ---- lookup ---------------------------------------------------------
    def get_like_words(self, word: str) -> List[str]:
        return self.host.get_like_words(word)

    def search_word(self, word: str) -> PostingSeq:
        """Single-word lookup with exact / wildcard handling (index.py:589,
        ref Search.cs:192-260): an all-uppercase word is exact (its full
        form only), a '_' wildcard ORs up to 100 full forms, exact; any
        other word is searched by its vocabulary or stem keys where it
        has them, else its full form."""
        b_exact = word.upper() == word
        word = word.lower()
        words = [word]
        if "_" in word:
            b_exact = True
            words = self.get_like_words(word)
        total: Optional[PostingSeq] = None
        for wword in words:
            for code in _chosen_codes(self.host, wword, b_exact):
                coords = self.arr.get(code)
                if coords is not None:
                    res = PostingSeq(coords)
                    total = res if total is None else total + res
        if total is None:
            total = PostingSeq()
        if b_exact:
            total.R = -1
        return total

    def search_field(self, field_name: str, value: str) -> PostingSeq:
        """{field=value} lookup (index.py:622, ref Search.cs:126-155): the
        field's key, exact, proximity-AND the value's lookup."""
        coords = self.arr.get(C.FIELD_NAME_CHAR + field_name.lower())
        if coords is None:
            return PostingSeq()
        return PostingSeq(coords, R=-1) * self.search_word(value.lower())

    def get_suggestions(self, req: str, n: int = 10) -> List[str]:
        """Prefix completions of the request's last word, by posting
        volume (index.py:654, ref Search.cs:176-188)."""
        if len(req) < 2 or self.arr is None:
            return []
        parts = [s for s in re.split(r"\b", req) if len(s) > 0]
        if not parts:
            return []
        lastword = parts[-1].lower()
        if len(lastword) < 2:
            return []
        terms = self.arr.terms
        cands = []
        for tid in range(bisect.bisect_left(terms, lastword), len(terms)):
            key = terms[tid]
            if not key.startswith(lastword):
                break
            if key[0] >= "A" and len(key) > len(lastword):
                cands.append((-self.arr.enc_count(tid), tid, key))
        cands.sort(key=lambda c: c[0])
        return [key[len(lastword):] for _, _, key in cands[:n]]

    # ---- search ---------------------------------------------------------
    def search(self, req: str) -> SearchResult:
        """One request (index.py:714, ref Search.cs:440-601): `-filter:`
        doc-name regexes out, the request sanitized and parsed, its
        expression and its {field=value} part evaluated over the
        postings, the two doc-intersected, the docs materialized and
        sorted by rank (ascending, as the reference does)."""
        if not self.can_search:
            return ErrorSearchResult("Index is not built")
        try:
            with self._search_lock:
                req = req.lower()
                filters: List[str] = []
                m = _FILTER_RE.search(req)
                if m:
                    filters = [f for f in m.group(1).split(",") if f]
                req = _FILTER_RE.sub(" ", req)

                thunks: List[qparser.WordThunk] = []
                main_expr, fields_expr = qparser.prepare_search_request(
                    req, thunks, search_word=self.search_word,
                    search_field=self.search_field,
                    stop_words=self.stop_words)
                for t in thunks:
                    t.dist = C.DEFAULT_DIST
                res: Optional[PostingSeq] = None
                resf: Optional[PostingSeq] = None
                try:
                    if main_expr.strip():
                        ast = qparser.parse_expression(main_expr, thunks)
                        if ast is not None:
                            res = qparser.eval_ast(ast)
                    if fields_expr.strip():
                        astf = qparser.parse_expression(fields_expr, thunks)
                        if astf is not None:
                            resf = qparser.eval_ast(astf)
                except qparser.QuerySyntaxError:
                    return ErrorSearchResult("Syntax Error in search request")
                if res is None:
                    res = resf
                if res is None:
                    return SearchResult()
                result = prepare_search_result(res.coords, self.pages,
                                               filters)
                if resf is not None:
                    result = combine_search_results(
                        result, prepare_search_result(resf.coords,
                                                      self.pages, []))
                self._materialize_docs(result)
                result.found_docs.sort(key=lambda d: d.rank)
                result.words = [t.info for t in thunks]
                return result
        except Exception as e:  # noqa: BLE001 — an error result, as
            # the JAX package's engine returns one
            return ErrorSearchResult(f"Error: {e}")

    def _materialize_docs(self, result: SearchResult) -> None:
        """Doc ranks, headers, snippets (index.py:774, ref
        Search.cs:552-597): doc rank 1 + ln(sum of page ranks), x10 when
        the header page leads; the header page's fields, highlighted when
        it matched; each body page's snippet; the summary of the three
        lowest-ranked pages in page-id order."""
        for doc in result.found_docs:
            total = sum(p.rank for p in doc.pages)
            doc.rank = 1 + math.log(total) if total > 0 else 1.0
            first_is_header = bool(doc.pages) and doc.pages[0].id == "0"
            if first_is_header:
                doc.rank *= C.DOC_RANK_MULTIPLY
            doc.found_words = []
            srcname = doc.name.split(C.DOC_SEP)[0]
            source = next((s for s in self.sources if s.name == srcname),
                          None)
            document = (source[doc.name[len(srcname) + 1:]]
                        if source is not None else None)
            if document is not None:
                headers_text = document["0"].text
                if first_is_header:
                    headers_text = highlight_positions(headers_text,
                                                       doc.pages[0].pos)
                doc.make_headers(headers_text)
                doc.pages = [p for p in doc.pages if p.id != "0"]
                for page in doc.pages:
                    text, matched = prepare_page_text(
                        page, document[page.id].text, C.MAX_FOUND_PAGE_TEXT)
                    page.text = text
                    doc.found_words.extend(matched)
                if doc.pages:
                    top = sorted(doc.pages, key=lambda p: p.rank)[:3]
                    top = sorted(top, key=lambda p: p.id)
                    doc.summary = " ... ".join(p.text or "" for p in top)
                document.close()
            seen = set()
            doc.found_words = [w for w in doc.found_words
                               if not (w in seen or seen.add(w))]
