"""The index's postings in memory and on disk, and the spills of a build
and their merge (a copy of docodo_tpu/core/storage.py).

The `.index` file is the reference's byte for byte (ref
Docodo.NET/Index.cs:312-380, Build.cs:370-404), and so the JAX
package's:

    [max_coord: u64-LE]
    repeat, in term order: [term: 7-bit length + UTF-8]
                           [n: i32-LE][n x u16-LE varint words]

In memory the index is one uint64 coordinate vector with CSR term
offsets, the layout DeviceIndex.from_index stages. A load parses the
record framing and decodes every posting in two native calls; the lazy
mode (in_memory=False) keeps the file open and decodes a term's
postings at each lookup.

    write_postings_arrays(f, max_coord, terms, offsets, coords)
    arr = read_index(path)                    # or in_memory=False
    arr.get("pickwick")                       # uint64 coordinates

A build's spill (`<n>.tmpind`) is the same stream. merge_spills unites
spill files term by term, a term's lists concatenated in file order,
into one stream byte for byte as the JAX package's merge_spills writes
it, reading each file a block of whole records at a time.
"""

from __future__ import annotations

import bisect
import ctypes
import io
import os
import threading
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from docodo_tpu_torch.core import varint
from docodo_tpu_torch.lang.vocab import _write_7bit_len
from docodo_tpu_torch.native import get_lib

INDEX_FILE = ".index"
PAGES_FILE = ".index.list"


class ArrayIndex:
    """The postings as arrays (docodo_tpu/core/storage.py:33):

    terms        the term strings, in ordinal order
    offsets      int64[T + 1], CSR into coords
    coords       uint64[N], each term's coordinates ascending; None in
                 the lazy mode, which reads them from the file
    max_coord    the last coordinate the build added
    enc_counts   int64[T], the u16 words each term's list takes in the
                 file (the reference's IndexSequence.Count, which ranks
                 suggestions); computed at first use for a build, read
                 from the file for a load

    In the lazy mode offsets count each term's stored words, so
    posting_count is the stored word count, as the reference's lazy
    stubs count (ref Index.cs:346-348)."""

    def __init__(self):
        self.terms: List[str] = []
        self.offsets = np.zeros(1, dtype=np.int64)
        self.coords: Optional[np.ndarray] = np.zeros(0, dtype=np.uint64)
        self.max_coord: int = 0
        self._tmap: Dict[str, int] = {}
        self._enc_counts: Optional[np.ndarray] = np.zeros(0, dtype=np.int64)
        # the lazy mode: the open file, each term's (byte offset, words)
        self._file = None
        self._spans: Optional[np.ndarray] = None
        self._file_lock = threading.Lock()

    # ---- lookup --------------------------------------------------------
    def __contains__(self, term: str) -> bool:
        return term in self._tmap

    def __len__(self) -> int:
        return len(self.terms)

    def term_id(self, term: str) -> int:
        return self._tmap.get(term, -1)

    def posting_count(self, tid: int) -> int:
        return int(self.offsets[tid + 1] - self.offsets[tid])

    def get_by_id(self, tid: int) -> np.ndarray:
        if self.coords is not None:
            return self.coords[self.offsets[tid]: self.offsets[tid + 1]]
        off, nwords = self._spans[tid]
        with self._file_lock:
            self._file.seek(int(off))
            raw = self._file.read(int(nwords) * 2)
        return varint.decode(np.frombuffer(raw, dtype=np.uint16))

    def get(self, term: str) -> Optional[np.ndarray]:
        """A term's coordinates, or None for a term the index lacks."""
        tid = self._tmap.get(term)
        if tid is None:
            return None
        return self.get_by_id(tid)

    @property
    def enc_counts(self) -> np.ndarray:
        if self._enc_counts is None:
            # a chunk count a delta, each list's first delta from 0,
            # summed a list
            deltas = np.diff(self.coords, prepend=np.uint64(0))
            starts = self.offsets[:-1][self.offsets[:-1] < self.offsets[1:]]
            deltas[starts] = self.coords[starts]
            cs = np.concatenate([[0], np.cumsum(
                varint.chunks_per_delta(deltas))])
            self._enc_counts = cs[self.offsets[1:]] - cs[self.offsets[:-1]]
        return self._enc_counts

    def enc_count(self, tid: int) -> int:
        return int(self.enc_counts[tid])

    def close(self) -> None:
        with self._file_lock:
            if self._file is not None:
                self._file.close()
                self._file = None

    # ---- construction --------------------------------------------------
    @classmethod
    def from_postings(cls, terms: List[str], offsets: np.ndarray,
                      coords: np.ndarray, max_coord: int) -> "ArrayIndex":
        """A built index's arrays, taken without a copy where their dtypes
        are already int64 / uint64."""
        idx = cls()
        idx.terms = terms
        idx.offsets = np.asarray(offsets, dtype=np.int64)
        idx.coords = np.asarray(coords, dtype=np.uint64)
        idx.max_coord = int(max_coord)
        idx._tmap = {t: i for i, t in enumerate(terms)}
        idx._enc_counts = None if idx.coords.size else np.zeros(
            len(terms), dtype=np.int64)
        return idx


def write_index(path: str, index: ArrayIndex) -> None:
    """The `.index` file of `index`, a record a term."""
    with open(path, "wb") as f:
        write_postings_stream(f, index.max_coord, (
            (term, index.get_by_id(tid))
            for tid, term in enumerate(index.terms)))


def write_postings_stream(
        f, max_coord: int,
        records: Iterable[Tuple[str, np.ndarray]]) -> None:
    """An index stream from (term, coordinates) records, in order."""
    f.write(int(max_coord).to_bytes(8, "little"))
    for term, coords in records:
        data = term.encode("utf-8")
        _write_7bit_len(f, len(data))
        f.write(data)
        varint.write_block(f, coords)


def write_postings_arrays(f, max_coord: int, terms: List[str],
                          offsets: np.ndarray, coords: np.ndarray) -> None:
    """The index stream of CSR arrays, the bytes write_postings_stream
    writes."""
    f.write(int(max_coord).to_bytes(8, "little"))
    f.write(_records_bytes(terms, offsets, coords))


def _records_bytes(terms: List[str], offsets: np.ndarray,
                   coords: np.ndarray) -> bytes:
    """The records of CSR arrays as an index stream holds them after its
    header: one varint pass over every list (varint.encode_blocks), and
    where every term is shorter than 128 bytes (a one-byte length) the
    framing assembled in vectorized scatters, else a record at a time."""
    stream, wstarts = varint.encode_blocks(coords, offsets)
    terms_b = [t.encode("utf-8") for t in terms]
    tlens = np.fromiter((len(b) for b in terms_b), np.int64, len(terms_b))
    if tlens.size == 0:
        return b""
    if tlens.max() < 0x80:
        wcounts = np.diff(wstarts)
        sizes = 1 + tlens + 4 + 2 * wcounts
        starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        out = np.empty(int(sizes.sum()), dtype=np.uint8)
        out[starts] = tlens
        tpos = (np.repeat(starts + 1, tlens) + np.arange(int(tlens.sum()))
                - np.repeat(np.cumsum(tlens) - tlens, tlens))
        out[tpos] = np.frombuffer(b"".join(terms_b), dtype=np.uint8)
        cpos = starts + 1 + tlens
        out[cpos[:, None] + np.arange(4)] = (
            wcounts.astype("<i4").view(np.uint8).reshape(-1, 4))
        # word k of the stream, in record r, lands at byte
        # cpos[r] + 4 + 2 * (k - wstarts[r])
        wpos = (np.repeat(cpos + 4 - 2 * wstarts[:-1], wcounts)
                + 2 * np.arange(stream.size, dtype=np.int64))
        out[wpos] = (stream & 0xFF).astype(np.uint8)
        out[wpos + 1] = (stream >> 8).astype(np.uint8)
        return out.tobytes()
    sbytes = stream.tobytes()
    frags: List[bytes] = []
    for i, data in enumerate(terms_b):
        head = io.BytesIO()
        _write_7bit_len(head, len(data))
        frags.append(head.getvalue())
        frags.append(data)
        a, b = int(wstarts[i]), int(wstarts[i + 1])
        frags.append(int(b - a).to_bytes(4, "little"))
        frags.append(sbytes[2 * a: 2 * b])
    return b"".join(frags)


# records a native parse call takes at most: its four output arrays take
# 24 bytes a record, allocated for this many
PARSE_RECORDS = 1 << 16


def _parse_from(buf: bytes, start: int, max_records: int):
    """The whole records of an index stream from byte `start` on, at most
    max_records, in one native call: (terms, span_off int64, span_words
    int32, the byte after the last of them). A stream no writer makes
    raises ValueError."""
    cap = max(0, min(max_records, (len(buf) - start) // 5 + 1))
    term_off = np.empty(cap, np.int64)
    term_len = np.empty(cap, np.int32)
    span_off = np.empty(cap, np.int64)
    span_words = np.empty(cap, np.int32)
    end = ctypes.c_int64(start)
    cnt = int(get_lib().docodo_parse_records_from(
        buf, len(buf), start, cap, term_off.ctypes.data,
        term_len.ctypes.data, span_off.ctypes.data, span_words.ctypes.data,
        ctypes.addressof(end)))
    if cnt < 0:
        raise ValueError("corrupt index record stream")
    mv = memoryview(buf)
    terms = [str(mv[o: o + n], "utf-8") for o, n in
             zip(term_off[:cnt].tolist(), term_len[:cnt].tolist())]
    return terms, span_off[:cnt].copy(), span_words[:cnt].copy(), end.value


def _parse_records(buf: bytes):
    """The record framing of an index stream, in native calls of
    PARSE_RECORDS records: (max_coord, terms, span_off int64[T],
    span_words int32[T]), the byte offset and word count of each term's
    u16 words. A truncated or corrupt stream raises ValueError; one of 8
    bytes or fewer holds no record."""
    max_coord = int.from_bytes(memoryview(buf)[:8], "little")
    terms: List[str] = []
    offs, words = [np.zeros(0, np.int64)], [np.zeros(0, np.int32)]
    at = 8
    while at < len(buf):
        t, o, w, end = _parse_from(buf, at, PARSE_RECORDS)
        if not t:
            raise ValueError("truncated index record stream")
        terms += t
        offs.append(o)
        words.append(w)
        at = end
    return max_coord, terms, np.concatenate(offs), np.concatenate(words)


def _bulk_decode(buf: bytes, span_off: np.ndarray,
                 span_words: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Every record's postings in one native call: (offsets int64[T + 1],
    coords uint64[N]), each list decoded from 0."""
    out = np.empty(int(span_words.sum()), dtype=np.uint64)
    counts = np.empty(span_off.size, dtype=np.int64)
    n = get_lib().docodo_varint_decode_spans(
        buf, span_off.ctypes.data, span_words.ctypes.data, span_off.size,
        out.ctypes.data, counts.ctypes.data)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    return offsets, out[:n]


def read_index(path: str, in_memory: bool = True) -> ArrayIndex:
    """An `.index` file: every posting decoded, or with in_memory=False
    the file kept open for the lookups. Raises ValueError on a damaged
    file."""
    idx = ArrayIndex()
    with open(path, "rb") as f:
        buf = f.read()
    max_coord, terms, span_off, span_words = _parse_records(buf)
    idx.max_coord = max_coord
    idx.terms = terms
    idx._tmap = {t: i for i, t in enumerate(terms)}
    nwords = span_words.astype(np.int64)
    idx._enc_counts = nwords
    if in_memory:
        idx.offsets, idx.coords = _bulk_decode(buf, span_off, span_words)
    else:
        idx.coords = None
        idx._spans = np.stack([span_off, nwords], axis=1)
        idx.offsets = np.concatenate([np.zeros(1, dtype=np.int64),
                                      np.cumsum(nwords)])
        idx._file = open(path, "rb")
    return idx


# ---------------------------------------------------------------------------
# spills and their merge (docodo_tpu/core/storage.py:328-535)
# ---------------------------------------------------------------------------

def read_spill(path: str):
    """A spill file whole: (max_coord, terms, a coordinate array a term)."""
    with open(path, "rb") as f:
        buf = f.read()
    max_coord, terms, span_off, span_words = _parse_records(buf)
    offsets, coords = _bulk_decode(buf, span_off, span_words)
    return max_coord, terms, [coords[offsets[i]: offsets[i + 1]]
                              for i in range(len(terms))]


class _SpillCursor:
    """A sequential reader of one spill file's records, a block of whole
    records at a time (the JAX package's cursor holds one record): the
    block's terms and their lists, decoded in one native call a block.
    Nothing but the block is resident, and no file stays open between
    blocks. `block_bytes` None reads the whole file as one block."""

    def __init__(self, path: str, block_bytes: Optional[int]):
        self.path = path
        self.block_bytes = block_bytes
        self._size = os.path.getsize(path)
        with open(path, "rb") as f:
            self.max_coord = int.from_bytes(f.read(8), "little")
        self._at = 8         # the file offset of the next block
        self.eof = False     # no record past the block
        self.terms: List[str] = []
        self.offsets = np.zeros(1, np.int64)
        self.coords = np.zeros(0, np.uint64)
        self.pos = 0         # the block's first record not yet merged
        self.refill()

    @property
    def term(self) -> Optional[str]:
        """The next record's term, or None past the file's end."""
        return self.terms[self.pos] if self.pos < len(self.terms) else None

    def refill(self) -> None:
        """The block after the current one, which is merged whole: at
        least one whole record where the file has one left."""
        left = self._size - self._at
        want = left if self.block_bytes is None else min(self.block_bytes,
                                                         left)
        while True:
            with open(self.path, "rb") as f:
                f.seek(self._at)
                buf = f.read(want)
            terms, span_off, span_words, end = _parse_from(buf, 0, len(buf))
            if terms or want == left:
                break
            want = min(2 * want, left)  # a record longer than the block
        if want == left and end != len(buf):
            raise ValueError(f"{self.path}: a truncated spill")
        self._at += end
        self.eof = self._at >= self._size
        self.terms = terms
        self.offsets, self.coords = _bulk_decode(buf, span_off, span_words)
        self.pos = 0

    def take(self, k: int) -> Tuple[List[str], np.ndarray, np.ndarray]:
        """Records pos..k-1: (terms, each list's length, their coords
        uint64); the position moves past them, and to the next block when
        this one is merged whole."""
        a, b = self.offsets[self.pos], self.offsets[k]
        out = (self.terms[self.pos: k],
               np.diff(self.offsets[self.pos: k + 1]), self.coords[a: b])
        self.pos = k
        if k == len(self.terms) and not self.eof:
            self.refill()
        return out


# the blocks a spill merge holds, over all its files, in bytes per
# posting of the caller's budget (mem_items)
MERGE_BYTES_PER_ITEM = 8


def merge_spills(paths: List[str], out_path: str, shift_coords: bool = False,
                 mem_items: Optional[int] = None,
                 arrays_out: Optional[list] = None) -> int:
    """Unite spill or index files into one stream at out_path, byte for
    byte the JAX package's merge_spills (storage.py:370, ref
    Index.cs:577-689): terms in string order; a term's lists concatenated
    in file order (files hold ascending coordinate ranges); with
    shift_coords each file's coordinates moved by the summed max_coord of
    the files before it, and the output's max_coord that sum, else the
    largest max_coord. Returns the output's max_coord; with `arrays_out`
    (a list) appends the merged (terms, offsets, coords).

    The files are read a block of whole records at a time, the blocks of
    all files holding about MERGE_BYTES_PER_ITEM * mem_items bytes
    (mem_items: the caller's posting budget, the builder's spill
    threshold; 1,000,001 by default). Each step merges every record up to
    the smallest last term of a block whose file goes on, in one native
    decode a file and one stable sort by term rank, and writes them."""
    if mem_items is None:
        mem_items = 1_000_001
    block = max(4096, MERGE_BYTES_PER_ITEM * mem_items // max(len(paths), 1))
    return _merge_blocks(paths, out_path, shift_coords, block, arrays_out)


def _merge_spills_vectorized(paths: List[str], out_path: str,
                             shift_coords: bool,
                             arrays_out: Optional[list] = None) -> int:
    """merge_spills with every file read whole: one native decode a file
    and one stable sort by term rank for the whole merge (the JAX
    package's storage.py:459, held against it by the tests)."""
    return _merge_blocks(paths, out_path, shift_coords, None, arrays_out)


def _merge_blocks(paths, out_path, shift_coords, block, arrays_out) -> int:
    cursors = [_SpillCursor(p, block) for p in paths]
    shifts = np.zeros(len(cursors), dtype=np.uint64)
    total = 0
    for q, c in enumerate(cursors):
        shifts[q] = total
        total += c.max_coord
    out_max = total if shift_coords else max(
        (c.max_coord for c in cursors), default=0)
    parts = [] if arrays_out is not None else None
    with open(out_path, "wb") as f:
        f.write(int(out_max).to_bytes(8, "little"))
        while any(c.term is not None for c in cursors):
            going = [c.terms[-1] for c in cursors
                     if c.term is not None and not c.eof]
            bound = min(going) if going else None
            terms, counts, coords = [], [], []
            for q, c in enumerate(cursors):
                if c.term is None:
                    continue
                k = (len(c.terms) if bound is None
                     else bisect.bisect_right(c.terms, bound, c.pos))
                if k == c.pos:
                    continue
                t, n, co = c.take(k)
                if shift_coords and shifts[q]:
                    co = co + shifts[q]
                terms.append(t)
                counts.append(n)
                coords.append(co)
            union, offsets, merged = _unite(terms, counts, coords)
            f.write(_records_bytes(union, offsets, merged))
            if parts is not None:
                parts.append((union, offsets, merged))
    if parts is not None:
        arrays_out.append(_concat_parts(parts))
    return int(out_max)


def _unite(terms, counts, coords):
    """Records of several files (each in term order) as one CSR in term
    order, a term's lists in file order: one stable sort by term rank."""
    union = sorted({t for ts in terms for t in ts})
    rank_of = {t: i for i, t in enumerate(union)}
    ranks = np.concatenate([
        np.repeat(np.fromiter((rank_of[t] for t in ts), np.int32, len(ts)),
                  n) for ts, n in zip(terms, counts)]) if terms else \
        np.zeros(0, np.int32)
    flat = (np.concatenate(coords) if coords
            else np.zeros(0, dtype=np.uint64))
    perm = np.argsort(ranks, kind="stable")
    per = np.bincount(ranks, minlength=len(union))
    offsets = np.concatenate([[0], np.cumsum(per)]).astype(np.int64)
    return union, offsets, flat[perm]


def _concat_parts(parts):
    """(terms, offsets, coords) of merge steps in order, as one CSR."""
    terms = [t for u, _, _ in parts for t in u]
    lens = np.concatenate([np.diff(o) for _, o, _ in parts]) if parts \
        else np.zeros(0, np.int64)
    offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    coords = (np.concatenate([c for _, _, c in parts]) if parts
              else np.zeros(0, dtype=np.uint64))
    return terms, offsets, coords
