"""The port's own index build: paged documents -> the CSR postings and
the page table that DeviceIndex.from_index stages; and the host engine
over it, `Index`, which the batcher and the server serve.

It follows the page path of the JAX package's build (docodo_tpu/index.py:
Index._index_task :390-481, _index_header_page :496-514,
IndexBuilder.add_interned :957-1036, _gather_sorted :1050-1080) on one
thread, in memory, with no spills. Body pages go
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

The host engine (docodo_tpu/index.py:83 `Index`): data sources, whose
page text it keeps for snippets, `create()` (a rebuild bumps
`generation`), and `search(req)`, the request parser and the posting
algebra over the build with snippets and highlights. With a path the
index lives on disk as the JAX package's does, in the same files byte
for byte: `.index` (core/storage.py) and `.index.list`
(core/pagetable.py), the page text in `<source>.cache.zip`
(sources/cache.py); `Index(path)` loads what is there, and `create()`
writes the files and installs the build. Without a path it writes no
file and keeps the page text in memory.

    from docodo_tpu_torch.index import Index, IndexPagedTextFile
    ind = Index("./idx")                 # loads ./idx/.index if there
    ind.add_data_source(ListDataSource("docs", [
        IndexPagedTextFile("pick", text, "author=dickens")]))
    ind.create()
    res = ind.search('"pickwick club" {author=dickens}')
"""

from __future__ import annotations

import bisect
import math
import os
import re
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from docodo_tpu_torch import constants as C
from docodo_tpu_torch.core import storage
from docodo_tpu_torch.core.pagetable import PageTable
from docodo_tpu_torch.core.postings import PostingSeq
from docodo_tpu_torch.core.storage import ArrayIndex
from docodo_tpu_torch.lang import tokenizer
from docodo_tpu_torch.lang.vocab import load_stop_words
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
from docodo_tpu_torch.sources.base import (  # noqa: F401 (re-exported)
    IndexPage,
    IndexPagedTextFile,
    ListDataSource,
)
from docodo_tpu_torch.sources.cache import IndexTextCacheDataSource
from docodo_tpu_torch.utils import profiling

CACHE_END = ".cache.zip"


@dataclass
class HostIndex:
    """What the build returns: `arr` and `pages`, as DeviceIndex.from_index
    reads them, and the word coder (vocabularies, stop words) the build
    keyed its words with, which the query side must share."""

    arr: ArrayIndex
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

    def postings(self, device: torch.device) -> ArrayIndex:
        """Term-sorted CSR (IndexBuilder._gather_sorted), sorted on
        `device`: each posting's key is its term's rank in string order,
        and the stream is in coordinate order (sort_postings)."""
        if not self.tids:
            return ArrayIndex.from_postings(
                [], np.zeros(1, dtype=np.int64),
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
        return ArrayIndex.from_postings([self.terms[i] for i in order_terms],
                                        offsets, coords, self.max_coord)


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
           device, cancel: Optional[threading.Event] = None
           ) -> Optional[HostIndex]:
    """build_index over several sources, one after the other in one
    coordinate space; None when `cancel` was set before the build ended,
    which it reads before every document and page."""
    dev = _device(device)
    cancel = cancel or threading.Event()
    stream = _Stream(coder, native)
    bounds: List[int] = []
    page_doc: List[int] = []
    page_ids: List[str] = []
    doc_names: List[str] = []
    coord = 0
    try:
        for source in sources:
            coord = _build_source(source, stream, coord, bounds, page_doc,
                                  page_ids, doc_names, cancel)
    finally:
        if stream.interner is not None:
            stream.interner.close()
    if cancel.is_set():
        return None
    pages = PageTable(np.array(bounds, dtype=np.uint64),
                      np.array(page_doc, dtype=np.int64), page_ids,
                      doc_names)
    with profiling.phase("build.sort"):
        arr = stream.postings(dev)
    return HostIndex(arr, pages, coder)


def _build_source(source, stream: _Stream, coord: int, bounds, page_doc,
                  page_ids, doc_names, cancel: threading.Event) -> int:
    """One source's pages into the stream. With the native interner, body
    pages pend and go through one tokenizer call BODY_UNITS at a time
    (a call a page would wait on the interpreter lock once a page while
    other threads run, as a server's do during a rebuild), and their
    tokens go to the stream FLUSH_TOKENS at a time; both flush before
    every header page, so that the stream stays in coordinate order. A
    document that fails while its pages are read keeps the pages read
    before, and the build goes on (index.py:482-489)."""
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
    while not cancel.is_set() and (doc := source.next_document()) is not None:
        doc_names.append(f"{source.name}{C.DOC_SEP}{doc.name}")
        try:
            for page in doc:
                if cancel.is_set():
                    break
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
        except Exception as e:  # noqa: BLE001 — a bad document, as the
            # JAX package's build logs and skips it
            print(f"Error in doc {doc.name}: {e}")
        finally:
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
    """The host engine over the port's build (docodo_tpu/index.py:83).
    Always indexes full forms (the JAX package's b_keep_forms = True), on
    one build thread; `native` and `device` as build_index takes them (a
    CUDA device raises here without CUDA).

    With `path` the index lives in that folder in the JAX package's files,
    and `Index(path)` loads what is there. `in_memory=False` keeps the
    postings on disk and reads a term's at each lookup, as the JAX
    package's lazy mode does; a device index needs them in memory.
    Without a path (the default) nothing is written, the page text stays
    in memory, and the index lives until the process ends."""

    def __init__(self, path: Optional[str] = None, in_memory: bool = True,
                 vocs: Sequence = (), stop_words=None, native: bool = True,
                 device="cuda"):
        self.native = native
        self.device = _device(device)
        self.work_path = path
        self.in_memory = in_memory
        self.vocs = list(vocs)
        self.stop_words: set = set(stop_words) if stop_words else set()
        self.sources: List = []
        self.host: Optional[HostIndex] = None
        self.can_search = False
        self.status = "Idle"
        # bumped whenever a build or a load installs: a device index
        # restages then
        self.generation = 0
        self._search_lock = threading.RLock()
        self._cancel = threading.Event()
        if path is not None:
            self.load()

    # ---- configuration ---------------------------------------------------
    def load_stop_words(self, path: str) -> None:
        self.stop_words = load_stop_words(path)
        self._recode()

    def add_stop_words(self, words) -> None:
        self.stop_words.update(words)
        self._recode()

    def _coder(self) -> WordCoder:
        return WordCoder(vocs=self.vocs, stop_words=set(self.stop_words))

    def _recode(self) -> None:
        """Requests are keyed by the stop words of now, as the JAX
        package's word_coder keys them (index.py:124), also over an index
        built or loaded before."""
        with self._search_lock:
            if self.host is not None:
                self.host = HostIndex(self.host.arr, self.host.pages,
                                      self._coder())

    def add_data_source(self, source) -> None:
        """A source the next create() reads; its page text is kept for
        snippets, in `<path>/<source name>.cache.zip` with a path."""
        if self.work_path is None:
            self.sources.append(TextCacheDataSource(source))
        else:
            self.sources.append(IndexTextCacheDataSource(
                source, os.path.join(self.work_path,
                                     source.name + CACHE_END)))

    # ---- state -----------------------------------------------------------
    @property
    def arr(self) -> Optional[ArrayIndex]:
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

    @property
    def is_creating(self) -> bool:
        return self.status != "Idle"

    @property
    def can_index(self) -> bool:
        return bool(self.sources) and not self.is_creating

    def _install(self, arr: ArrayIndex, pages: PageTable) -> None:
        """A new index for the requests, under the search lock."""
        with self._search_lock:
            if self.host is not None:
                self.host.arr.close()
            self.host = HostIndex(arr, pages, self._coder())
            self.generation += 1
            self.can_search = True

    # ---- storage ---------------------------------------------------------
    def load(self) -> bool:
        """The `.index` and `.index.list` files of the path, installed
        (index.py:175). A missing file returns False; a damaged one is
        reported and returns False with the index unsearchable."""
        if self.work_path is None:
            return False
        index_file = os.path.join(self.work_path, storage.INDEX_FILE)
        pages_file = os.path.join(self.work_path, storage.PAGES_FILE)
        if not (os.path.exists(index_file) and os.path.exists(pages_file)):
            return False
        self.can_search = False
        try:
            arr = storage.read_index(index_file, in_memory=self.in_memory)
            try:
                with open(pages_file, "rb") as f:
                    pages = PageTable.load(f)
            except BaseException:
                arr.close()
                raise
        except (OSError, ValueError) as e:
            print(f"Can't load: {e}")
            return False
        self._install(arr, pages)
        return True

    def close(self) -> None:
        self.can_search = False
        if self.arr is not None:
            self.arr.close()

    def dispose(self) -> None:
        """Closes the index file and the page caches; the index is empty
        after."""
        self.close()
        for s in self.sources:
            if isinstance(s, IndexTextCacheDataSource):
                s.close()
        self.sources = []
        self.host = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.dispose()
        return False

    # ---- build -----------------------------------------------------------
    def cancel(self) -> None:
        """Stops a running create() at the next document or page; the
        index before it stays."""
        self._cancel.set()

    def create(self) -> None:
        """Rebuild from the data sources (index.py:219) and install the
        build, its page text and a new generation at once; with a path,
        write `.index` and `.index.list` first."""
        self._create(threading.Event())

    def create_async(self) -> threading.Thread:
        """create() on a thread of its own, which it returns started."""
        cancel = threading.Event()
        t = threading.Thread(target=self._create, args=(cancel,),
                             daemon=True)
        t.start()
        return t

    def _create(self, cancel: threading.Event) -> None:
        if not self.sources or self.status != "Idle":
            return
        start = time.time()
        self.status = "Index"
        self._cancel = cancel
        try:
            if self.work_path is None:
                host = _build(self.sources, self._coder(), self.native,
                              self.device, cancel)
                if host is not None:
                    with self._search_lock:
                        for source in self.sources:
                            source.publish()
                        self.host = host
                        self.generation += 1
                        self.can_search = True
            else:
                host = self._create_files(cancel)
            if host is None:
                print("Indexing was cancelled.")
                return
            print(f"Time elapsed: {time.time() - start:.1f} s")
        except Exception as e:
            print(f"Error: {e}")
            self.can_search = False
            raise
        finally:
            self.status = "Idle"

    def _create_files(self, cancel: threading.Event) -> Optional[HostIndex]:
        """The build of a path (index.py:229-376): the page text into
        `<source>.cache.zip_`, the postings into `.index_`; then, under
        the search lock, `.index.list` written, `.index` and the caches
        renamed into place, and the build installed (read back lazily
        with in_memory=False). A cancelled build leaves the files as
        they were and returns None."""
        os.makedirs(self.work_path, exist_ok=True)
        tmp_caches = [IndexTextCacheDataSource(s.source, s.filename + "_")
                      for s in self.sources]
        try:
            host = _build(tmp_caches, self._coder(), self.native,
                          self.device, cancel)
        finally:
            for tmp in tmp_caches:
                tmp.close()
        if host is None:
            for tmp in tmp_caches:
                if os.path.exists(tmp.filename):
                    os.remove(tmp.filename)
            return None
        index_file = os.path.join(self.work_path, storage.INDEX_FILE)
        self.status = "Merge"
        arr = host.arr
        with open(index_file + "_", "wb") as f:
            storage.write_postings_arrays(f, arr.max_coord, arr.terms,
                                          arr.offsets, arr.coords)
        with self._search_lock:
            self.can_search = False
            with open(os.path.join(self.work_path, storage.PAGES_FILE),
                      "wb") as f:
                host.pages.save(f)
            if self.arr is not None:
                self.arr.close()
            os.replace(index_file + "_", index_file)
            sources = []
            for source, tmp in zip(self.sources, tmp_caches):
                source.close()
                if os.path.exists(tmp.filename):
                    os.replace(tmp.filename, source.filename)
                sources.append(IndexTextCacheDataSource(source.source,
                                                        source.filename))
            self.sources = sources
            if self.in_memory:
                self._install(host.arr, host.pages)
            else:
                self.load()
        return host

    # ---- histogram -------------------------------------------------------
    def get_words_group(self, code) -> str:
        """The words of a vocabulary group key '#HEX', at most 20
        (index.py:681, ref Index.cs:270-281)."""
        if isinstance(code, str):
            if code.startswith(C.KNOWN_WORD_CHAR):
                code = code[1:]
            code = int(code, 16)
        voc = self.vocs[code >> 24]
        masked = code & C.GROUP_NUMBER_MASK
        return ",".join([w for w, g in voc.words.items() if g == masked][:20])

    @staticmethod
    def calc_histogram(index: "Index", n: int = 1000) -> Dict[str, int]:
        """The n terms of most stored words, with their counts; a
        vocabulary group's key as its words in parentheses (index.py:694,
        ref Index.cs:284-307)."""
        out: Dict[str, int] = {}
        if index.arr is None:
            return out
        arr = index.arr
        for tid in np.argsort(-arr.enc_counts, kind="stable")[:n].tolist():
            key = arr.terms[tid]
            val = int(arr.enc_counts[tid])
            try:
                if key.startswith(C.KNOWN_WORD_CHAR):
                    out["(" + index.get_words_group(key[1:]) + ")"] = val
                else:
                    out[key] = val
            except (IndexError, ValueError) as e:
                print(f"Error in Histogram: {e}")
        return out

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
