"""The port's own index build: paged documents -> the CSR postings and
the page table that DeviceIndex.from_index stages; and the host engine
over it, `Index`, which the batcher and the server serve.

It follows the page path of the JAX package's build (docodo_tpu/index.py:
Index._index_task :390-481, _index_header_page :496-514, IndexBuilder
:837-1129, _merge_indexes :516). Without a path it builds in memory, on
one thread, with no spills. With a path (Index(path).create()) each of
max_degree_of_parallelism threads feeds an IndexBuilder that spills its
postings past max_tmp_index_items into a folder of its own, and the
spills merge on the host into the `.index` (core/storage.merge_spills);
the threads claim consecutive documents, so any number of them builds
the one-thread index. Body pages go
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
import itertools
import math
import os
import re
import shutil
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from docodo_tpu_torch import constants as C
from docodo_tpu_torch.core import storage
from docodo_tpu_torch.core.pagetable import PageTable, _read_str, _write_str
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


def levenshtein(s: str, t: str) -> int:
    """Edit distance (index.py:55, ref Index.cs:46-89)."""
    n, m = len(s), len(t)
    if n == 0:
        return m
    if m == 0:
        return n
    prev = list(range(m + 1))
    for i in range(1, n + 1):
        cur = [i] + [0] * m
        for j in range(1, m + 1):
            cost = 0 if t[j - 1] == s[i - 1] else 1
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
        prev = cur
    return prev[m]


class SearchOptions:
    """A request's options (index.py:72): `dist`, the window of each
    word; `do_correction` and `remove_word_breaks` are kept and read by
    nothing, as in the JAX package."""

    def __init__(self, dist: int = 0, do_correction: bool = False,
                 remove_word_breaks: bool = True):
        self.dist = dist
        self.do_correction = do_correction
        self.remove_word_breaks = remove_word_breaks


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
        self.count = 0        # postings held
        self.max_coord = 0    # the last coordinate added
        self.seen = False     # whether a coordinate was added
        self.interner = pipeline.NativeInterner() if native else None
        # interned id -> its word, and the start and length of its row of
        # term ids in code_flat (length -1 until the id is first seen)
        self.id_words: List[str] = []
        self.code_offs = np.zeros(0, dtype=np.int64)
        self.code_lens = np.zeros(0, dtype=np.int64)
        self.code_flat = np.zeros(0, dtype=np.int64)
        self.code_flat_n = 0

    def drop_postings(self) -> None:
        """Drop the postings held, after a spill (IndexBuilder.
        _reset_buffers). The term dictionary and the interned words' rows
        stay, where the JAX package numbers its terms afresh: a spill
        holds the terms it has postings of (postings())."""
        self.tids = []
        self.coords = []
        self.count = 0

    def _append(self, tids: np.ndarray, coords: np.ndarray) -> None:
        self.tids.append(tids)
        self.coords.append(coords)
        self.count += tids.size

    def _saw(self, coord) -> None:
        self.max_coord = int(coord)
        self.seen = True

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
        self._saw(coord)
        self._append(np.array([self.tid(code)], dtype=np.int64),
                     np.array([coord], dtype=np.uint64))

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
        self._append(np.fromiter((t for r in rows for t in r), np.int64,
                                 int(lens.sum())),
                     np.repeat(np.asarray(coords, dtype=np.uint64), lens))
        self._saw(coords[-1])

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
            self._append(self.code_flat[gather], np.repeat(coords, counts))
        self._saw(coords[-1])

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
        # the terms with postings here (after a spill, not every term of
        # the dictionary), ranked in string order
        held = np.flatnonzero(np.bincount(tids, minlength=len(self.terms)))
        order_terms = sorted(held.tolist(), key=self.terms.__getitem__)
        rank = np.empty(len(self.terms), dtype=np.int32)
        rank[np.array(order_terms, dtype=np.int64)] = np.arange(
            len(order_terms), dtype=np.int32)
        offsets, coords = sort_postings(rank[tids], coords, len(order_terms),
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


def _load_marks(path: str) -> List[Tuple[str, int]]:
    """A builder's marks from its `index.tmplist` (index.py:816)."""
    marks = []
    with open(path, "rb") as f:
        while True:
            s = _read_str(f)
            if s is None:
                break
            raw = f.read(8)
            if len(raw) < 8:
                break
            marks.append((s, int.from_bytes(raw, "little")))
    return marks


def _save_marks(path: str, marks: List[Tuple[str, int]]) -> None:
    """A builder's marks to `index.tmplist` (index.py:830): each a 7-bit
    length + UTF-8 key and a u64-LE coordinate."""
    with open(path, "wb") as f:
        for key, coord in marks:
            _write_str(f, key)
            f.write(int(coord).to_bytes(8, "little"))


SPILL_END = ".tmpind"
MARKS_FILE = "index.tmplist"


class IndexBuilder:
    """A posting accumulator that spills to disk (docodo_tpu/index.py:837,
    ref Build.cs:258-437): one a build thread of Index.create(), and the
    standalone API.

        bldr = IndexBuilder(path="idx", device="cpu").add_voc(voc)
        bldr.add_doc("A", ""); bldr.add_word(w, coord); bldr.end_page("1")
        index = bldr.build()

    Postings arrive in coordinate order. With a folder (the parent's
    path) the builder holds at most max_tmp_index_items of them: past
    that it saves them, sorted into a CSR on the parent's device
    (sort_postings: the card sorts one spill at a time), as the next
    `<n>.tmpind` of its folder `<path>/<n>`, and starts afresh. Without a
    path it never spills and the build stays in memory. `add_interned`
    takes ids of the builder's own native `interner`. Marks: add_doc
    opens a document, end_page ends a page at a coordinate (by default
    the last one added); save() writes them to `index.tmplist`."""

    def __init__(self, parent: Optional["Index"] = None,
                 path: Optional[str] = None, in_memory: bool = True,
                 vocs=None, stop_words_file: Optional[str] = None, *,
                 device="cuda", native: bool = True):
        if parent is None:
            parent = Index(path, in_memory, vocs=vocs or (), native=native,
                           device=device)
            if stop_words_file:
                parent.load_stop_words(stop_words_file)
        self.parent = parent
        folder = None
        if parent.work_path is not None:
            folder = os.path.join(parent.work_path,
                                  str(next(parent._builder_numbers)))
        self._start(parent._coder(), parent.native, parent.device, folder,
                    parent.max_tmp_index_items)

    @classmethod
    def _detached(cls, coder: WordCoder, native: bool,
                  device) -> "IndexBuilder":
        """A builder of no Index, in memory (build_index's)."""
        b = cls.__new__(cls)
        b.parent = None
        b._start(coder, native, device, None, C.MAX_TMP_INDEX_ITEMS)
        return b

    def _start(self, coder, native, device, folder, max_items) -> None:
        self.device = torch.device(device)
        self.path = folder
        self.max_items = max_items
        if folder is not None:
            os.makedirs(folder, exist_ok=True)
        self.n_tmp_index = 0
        self.marks: List[Tuple[str, int]] = []
        # build threads: where the builder's next document starts
        self.coord = 0
        self._stream = _Stream(coder, native)

    @property
    def max_coord(self) -> int:
        return self._stream.max_coord

    @property
    def seen(self) -> bool:
        """Whether any coordinate was added."""
        return self._stream.seen

    @property
    def interner(self):
        return self._stream.interner

    def close(self) -> None:
        """Frees the native interner."""
        if self._stream is not None and self._stream.interner is not None:
            self._stream.interner.close()
            self._stream.interner = None

    def _take_stream(self, other: "IndexBuilder") -> None:
        """Go on with `other`'s term dictionary and interner, whose
        postings are saved (a build thread's next segment): the
        coordinates start again from 0."""
        self.close()
        self._stream, other._stream = other._stream, None
        self._stream.drop_postings()
        self._stream.max_coord = 0
        self._stream.seen = False

    # fluent configuration (the standalone path), before any posting
    def add_voc(self, voc) -> "IndexBuilder":
        self.parent.add_voc(voc)
        self._stream.coder = self.parent._coder()
        return self

    def stop_words(self, path: str) -> "IndexBuilder":
        self.parent.load_stop_words(path)
        self._stream.coder = self.parent._coder()
        return self

    # ---- feed ------------------------------------------------------------
    def add(self, code: str, coord: int) -> None:
        """One posting of a term key (index.py:894)."""
        self._stream.add(code, coord)
        self._spill_if_full()

    def add_word(self, word: str, coord: int) -> None:
        """A word's postings at one coordinate, a key each."""
        self._stream.add_word(word, coord)
        self._spill_if_full()

    def add_tokens(self, words: List[str], coords: np.ndarray) -> None:
        """A page's tokens, each word fanned out to its keys."""
        self._stream.add_tokens(words, coords)
        self._spill_if_full()

    def add_interned(self, ids: np.ndarray, coords: np.ndarray) -> None:
        """Tokens as ids of `interner` at their coordinates."""
        self._stream.add_interned(ids, coords)
        self._spill_if_full()

    def add_doc(self, sourceid: str, name: str,
                maxcoord: Optional[int] = None) -> None:
        self.marks.append((f"{sourceid}{C.DOC_SEP}{name}",
                           self.max_coord if maxcoord is None else maxcoord))

    def end_page(self, page_id: str, maxcoord: Optional[int] = None) -> None:
        self.marks.append((C.DOC_SEP + page_id,
                           self.max_coord if maxcoord is None else maxcoord))

    def _spill_if_full(self) -> None:
        if self.path is not None and self._stream.count > self.max_items:
            self.save(save_pages=False)
            self._stream.drop_postings()

    # ---- output ----------------------------------------------------------
    def arrays(self) -> ArrayIndex:
        """The postings held, as a CSR sorted on the device."""
        return self._stream.postings(self.device)

    def spills(self) -> List[str]:
        """The builder's spill files, in order."""
        return [os.path.join(self.path, f"{k}{SPILL_END}")
                for k in range(1, self.n_tmp_index + 1)]

    def save(self, save_pages: bool = True) -> None:
        """The postings held to the next `<n>.tmpind` (ref
        Build.cs:370-404), and with save_pages the marks."""
        if self.path is None:
            raise RuntimeError("a builder without a folder keeps its "
                               "postings in memory")
        self.n_tmp_index += 1
        with profiling.phase("build.spill-save"):
            arr = self.arrays()
            with open(self.spills()[-1], "wb") as f:
                storage.write_postings_arrays(f, self.max_coord, arr.terms,
                                              arr.offsets, arr.coords)
            if save_pages:
                _save_marks(os.path.join(self.path, MARKS_FILE), self.marks)

    def build(self) -> "Index":
        """The standalone build (ref Build.cs:407-434): the parent index
        from the postings and marks, which must not have spilled. With a
        path the `.index` and `.index.list` files are written and
        loaded; without one the build is installed in memory."""
        if self.n_tmp_index != 0:
            raise RuntimeError("Can't build, index is too large")
        if not self.marks:
            self.add_doc("", "", 0)
            self.end_page("1")
        parent = self.parent
        table = PageTable.from_marks(self.marks)
        try:
            if parent.work_path is None:
                parent._install(self.arrays(), table)
                return parent
            with parent._search_lock:
                self.save()
                parent.close()
                index_path = os.path.join(parent.work_path,
                                          storage.INDEX_FILE)
                with open(os.path.join(parent.work_path,
                                       storage.PAGES_FILE), "wb") as f:
                    table.save(f)
                os.replace(self.spills()[-1], index_path)
                shutil.rmtree(self.path, ignore_errors=True)
                parent.load()
            return parent
        finally:
            self.close()


def _index_header_page(builder: "IndexBuilder", text: str, coord: int) -> int:
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
                    builder.add(C.FIELD_NAME_CHAR + fields[0],
                                coord + dc - 1)
                    builder.add_word(piece, coord + dc)
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
    coordinate space, in memory (one builder, no spills); None when
    `cancel` was set before the build ended, which it reads before every
    document and page."""
    dev = _device(device)
    cancel = cancel or threading.Event()
    builder = IndexBuilder._detached(coder, native, dev)
    coord = 0
    try:
        for source in sources:
            source.reset()
            coord = _build_docs(source.name, _documents(source, cancel),
                                builder, coord, cancel)
    finally:
        builder.close()
    if cancel.is_set():
        return None
    with profiling.phase("build.sort"):
        arr = builder.arrays()
    return HostIndex(arr, PageTable.from_marks(builder.marks), coder)


def _documents(source, cancel: threading.Event):
    """A source's documents in order, until `cancel` is set."""
    while not cancel.is_set():
        doc = source.next_document()
        if doc is None:
            return
        yield doc


def _build_docs(source_name: str, docs, builder: "IndexBuilder", coord: int,
                cancel: threading.Event) -> int:
    """Documents of one source into the builder from `coord` on; returns
    the coordinate after them. Each document opens with its mark and each
    non-empty page ends with one (the page table's). With the native
    interner, body pages pend and go through one tokenizer call
    BODY_UNITS at a time (a call a page would wait on the interpreter
    lock once a page while other threads run, as a server's do during a
    rebuild), and their tokens go to the builder FLUSH_TOKENS at a time;
    both flush before every header page and at the end, so that postings
    arrive in coordinate order. A builder that spills tokenizes and
    flushes within its budget. A document that fails while its pages
    are read keeps the pages read before, and the build goes on
    (index.py:482-489)."""
    # a builder that spills keeps its pending tokens within its budget
    # too (index.py:408): at most half of it, from at most 4 UTF-16 units
    # a posting of text
    flush_at = max(4096, min(FLUSH_TOKENS, builder.max_items // 2))
    units_at = max(65536, min(BODY_UNITS, 4 * builder.max_items))
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
                "\n".join(body), builder.interner, C.MIN_WORD_LENGTH,
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
                builder.add_interned(np.concatenate(pend_ids),
                                     np.concatenate(pend_coords))
            pend_ids.clear()
            pend_coords.clear()
            pend_n = 0

    for doc in docs:
        builder.add_doc(source_name, doc.name, coord)
        try:
            for page in doc:
                if cancel.is_set():
                    break
                if len(page.text) == 0:
                    continue
                if page.id == "0":
                    with profiling.phase("build.header"):
                        flush()
                        coord = _index_header_page(builder, page.text,
                                                   coord)
                elif builder.interner is not None:
                    if not body:
                        body_at = coord
                    body.append(page.text)
                    body_units.append(tokenizer.char_len(page.text))
                    coord += body_units[-1]
                    if coord - body_at >= units_at:
                        tokenize_body()
                    if pend_n >= flush_at:
                        flush()
                else:
                    with profiling.phase("build.tokenize"):
                        low = tokenizer.lower_keep_length(page.text)
                        words, starts = tokenizer.tokenize(low, lowered=True)
                    with profiling.phase("build.wordcode+gather"):
                        keep = [k for k, w in enumerate(words)
                                if C.MIN_WORD_LENGTH <= len(w)
                                <= C.MAX_WORD_LENGTH]
                        builder.add_tokens([words[k] for k in keep],
                                           starts[keep].astype(np.uint64)
                                           + np.uint64(coord))
                    coord += tokenizer.char_len(low)
                builder.end_page(page.id, coord)
        except Exception as e:  # noqa: BLE001 — a bad document, as the
            # JAX package's build logs and skips it
            print(f"Error in doc {doc.name}: {e}")
        finally:
            close = getattr(doc, "close", None)
            if close:
                close()
    flush()
    return coord


# documents a build thread claims at a time (Index._build_segments)
CLAIM_DOCS = 64


class _Segment(NamedTuple):
    """Consecutive documents one build thread indexed from coordinate 0:
    the first claim's number, the builder's folder and spills, where its
    coordinates end (the end of its last page), the last coordinate added
    and whether any was."""

    claim: int
    folder: str
    spills: List[str]
    extent: int
    max_coord: int
    seen: bool


class _Dealer:
    """The sources' documents in order, handed to build threads a claim
    of at most CLAIM_DOCS consecutive documents of one source at a time,
    the claims numbered from 0; none once `cancel` is set."""

    def __init__(self, sources, cancel: threading.Event):
        self._sources = list(sources)
        self._cancel = cancel
        self._at = 0
        self._next = 0
        self._lock = threading.Lock()

    def claim(self):
        """(claim number, source name, documents), or None at the end."""
        with self._lock:
            while self._at < len(self._sources):
                source = self._sources[self._at]
                docs = []
                while len(docs) < CLAIM_DOCS and not self._cancel.is_set():
                    doc = source.next_document()
                    if doc is None:
                        break
                    docs.append(doc)
                if self._cancel.is_set():
                    return None
                if docs:
                    self._next += 1
                    return self._next - 1, source.name, docs
                self._at += 1
            return None


def _remove_builder_folders(work_path: str) -> None:
    """A path's builder folders (named by number) and what they hold."""
    for d in os.listdir(work_path):
        full = os.path.join(work_path, d)
        if d.isdigit() and os.path.isdir(full):
            shutil.rmtree(full, ignore_errors=True)


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
    Always indexes full forms (the JAX package's b_keep_forms = True);
    `native` and `device` as build_index takes them (a CUDA device raises
    here without CUDA).

    With `path` the index lives in that folder in the JAX package's files,
    and `Index(path)` loads what is there; its build runs on
    max_degree_of_parallelism threads (1 by default), each builder
    spilling past max_tmp_index_items postings. `in_memory=False` keeps the
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
        # the build of a path (create() with work_path): its threads,
        # and the postings a thread's builder holds before it spills
        self.max_degree_of_parallelism = 1
        self.max_tmp_index_items = C.MAX_TMP_INDEX_ITEMS
        self._builder_numbers = itertools.count()
        self._search_lock = threading.RLock()
        self._cancel = threading.Event()
        if path is not None:
            self.load()

    # ---- configuration ---------------------------------------------------
    def add_voc(self, voc) -> None:
        self.vocs.append(voc)
        self._recode()

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

    def __getitem__(self, term: str) -> PostingSeq:
        """The posting list of an index key (index.py:158): a PostingSeq
        of its coordinates, read from disk per lookup in lazy mode.
        KeyError for a key the index lacks."""
        coords = self.arr.get(term) if self.arr is not None else None
        if coords is None:
            raise KeyError(term)
        return PostingSeq(coords)

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
    def get_builder(self) -> IndexBuilder:
        """A standalone builder of this index (index.py:216)."""
        return IndexBuilder(parent=self)

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
        """The build of a path (index.py:219-376): the page text into
        `<source>.cache.zip_`, the postings by max_degree_of_parallelism
        threads, each spilling past max_tmp_index_items into its
        builder's folder, merged into `.index_`; then, under the search
        lock, `.index.list` written, `.index` and the caches renamed into
        place, and the build installed (read back lazily with
        in_memory=False). A cancelled build leaves the files as they were
        and returns None."""
        os.makedirs(self.work_path, exist_ok=True)
        _remove_builder_folders(self.work_path)
        tmp_caches = [IndexTextCacheDataSource(s.source, s.filename + "_")
                      for s in self.sources]
        try:
            segments = self._build_segments(tmp_caches, cancel)
        finally:
            for tmp in tmp_caches:
                tmp.close()
        if segments is None:
            for tmp in tmp_caches:
                if os.path.exists(tmp.filename):
                    os.remove(tmp.filename)
            _remove_builder_folders(self.work_path)
            return None
        index_file = os.path.join(self.work_path, storage.INDEX_FILE)
        self.status = "Merge"
        with profiling.phase("build.merge"):
            arr, pages = self._merge_segments(segments, index_file + "_")
        with self._search_lock:
            self.can_search = False
            with open(os.path.join(self.work_path, storage.PAGES_FILE),
                      "wb") as f:
                pages.save(f)
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
                self._install(arr, pages)
            else:
                self.load()
        return self.host

    def _build_segments(self, sources, cancel: threading.Event):
        """The documents of `sources`, in order, by
        max_degree_of_parallelism threads (index.py:253-265, _index_task
        :390). A thread claims CLAIM_DOCS consecutive documents at a time;
        a run of claims one thread takes one after the other is a segment,
        indexed from coordinate 0 by one builder with a folder of its own,
        which spills past max_tmp_index_items and saves its last postings
        and its marks when the run ends; the thread's next builder goes on
        with its term dictionary and interner. Returns the segments in
        document order, or None when cancelled; a thread's error is raised
        once every thread has ended."""
        for source in sources:
            source.reset()
        dealer = _Dealer(sources, cancel)
        segments: List[_Segment] = []
        errors: List[BaseException] = []
        lock = threading.Lock()

        def work():
            builder: Optional[IndexBuilder] = None
            first = last = -2

            def end_segment():
                builder.save()
                with lock:
                    segments.append(_Segment(
                        first, builder.path, builder.spills(),
                        builder.coord, builder.max_coord, builder.seen))

            try:
                while (claim := dealer.claim()) is not None:
                    k, name, docs = claim
                    if k != last + 1:
                        prev = builder
                        if prev is not None:
                            end_segment()
                        builder = IndexBuilder(parent=self)
                        if prev is not None:
                            builder._take_stream(prev)
                        first = k
                    last = k
                    builder.coord = _build_docs(name, docs, builder,
                                                builder.coord, cancel)
                if builder is not None:
                    end_segment()
            except BaseException as e:  # noqa: BLE001 — raised after join
                with lock:
                    errors.append(e)
            finally:
                if builder is not None:
                    builder.close()

        threads = [threading.Thread(target=work, daemon=True)
                   for _ in range(max(1, self.max_degree_of_parallelism))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        if cancel.is_set():
            return None
        return sorted(segments)

    def _merge_segments(self, segments: List["_Segment"], out: str):
        """The segments' spills into one stream at `out` and their marks
        into one page table (index.py:516 _merge_indexes). A segment's
        spills merge first (merge_spills, no shift); then the segments'
        files merge with their coordinates moved to where each segment
        starts in one coordinate space over all documents in order: a
        file's max_coord header is set to its segment's extent (the end
        of its last page), the last segment with postings keeps its own,
        so the merged max_coord is the last coordinate added, and the
        files after it (no postings) get 0. One segment's file is the
        index as it is. Returns (the in-memory ArrayIndex or None with
        in_memory=False, the PageTable); the folders are removed."""
        files = []
        for seg in segments:
            merged = os.path.join(seg.folder, f"1{SPILL_END}")
            if len(seg.spills) > 1:
                storage.merge_spills(seg.spills, merged + "_",
                                     mem_items=self.max_tmp_index_items)
                for p in seg.spills:
                    os.remove(p)
                os.replace(merged + "_", merged)
            files.append(merged)
        table = PageTable()
        shift = 0
        for seg in segments:
            table.extend_from_marks(
                _load_marks(os.path.join(seg.folder, MARKS_FILE)), shift)
            shift += seg.extent
        arrays: Optional[list] = [] if self.in_memory else None
        if len(files) == 1:
            os.replace(files[0], out)
            max_coord = segments[0].max_coord
        else:
            last = max((i for i, seg in enumerate(segments) if seg.seen),
                       default=-1)
            for i, (path, seg) in enumerate(zip(files, segments)):
                head = seg.extent if i < last else (
                    seg.max_coord if i == last else 0)
                with open(path, "r+b") as f:
                    f.write(int(head).to_bytes(8, "little"))
            max_coord = storage.merge_spills(
                files, out, shift_coords=True,
                mem_items=self.max_tmp_index_items, arrays_out=arrays)
        _remove_builder_folders(self.work_path)
        if not self.in_memory:
            return None, table
        if not arrays:
            return storage.read_index(out), table
        terms, offsets, coords = arrays[0]
        return ArrayIndex.from_postings(terms, offsets, coords,
                                        max_coord), table

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

    def get_close_words(self, word: str) -> List[str]:
        """The ten terms nearest `word` by edit distance, ties in term
        order (index.py:650, ref Search.cs:169-174)."""
        terms = self.arr.terms if self.arr is not None else []
        return sorted(terms, key=lambda s: levenshtein(s, word))[:10]

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
    def search(self, req: str,
               opt: Optional[SearchOptions] = None) -> SearchResult:
        """One request (index.py:714, ref Search.cs:440-601): `-filter:`
        doc-name regexes out, the request sanitized and parsed, its
        expression and its {field=value} part evaluated over the
        postings with each word's window opt.dist (DEFAULT_DIST without
        options), the two doc-intersected, the docs materialized and
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
                dist = C.DEFAULT_DIST if opt is None else opt.dist
                for t in thunks:
                    t.dist = dist
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
