"""The index's postings in memory and on disk (a copy of
docodo_tpu/core/storage.py without its spill readers and merges).

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
"""

from __future__ import annotations

import io
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
    writes: one varint pass over every list (varint.encode_blocks), and
    where every term is shorter than 128 bytes (a one-byte length) the
    framing assembled in vectorized scatters, else a record at a
    time."""
    stream, wstarts = varint.encode_blocks(coords, offsets)
    terms_b = [t.encode("utf-8") for t in terms]
    tlens = np.fromiter((len(b) for b in terms_b), np.int64, len(terms_b))
    if tlens.size == 0:
        f.write(int(max_coord).to_bytes(8, "little"))
        return
    if tlens.max() < 0x80:
        wcounts = np.diff(wstarts)
        sizes = 1 + tlens + 4 + 2 * wcounts
        starts = 8 + np.concatenate([[0], np.cumsum(sizes)[:-1]])
        out = np.empty(8 + int(sizes.sum()), dtype=np.uint8)
        out[:8] = np.frombuffer(int(max_coord).to_bytes(8, "little"),
                                dtype=np.uint8)
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
        f.write(out.tobytes())
        return
    sbytes = stream.tobytes()
    frags: List[bytes] = [int(max_coord).to_bytes(8, "little")]
    for i, data in enumerate(terms_b):
        head = io.BytesIO()
        _write_7bit_len(head, len(data))
        frags.append(head.getvalue())
        frags.append(data)
        a, b = int(wstarts[i]), int(wstarts[i + 1])
        frags.append(int(b - a).to_bytes(4, "little"))
        frags.append(sbytes[2 * a: 2 * b])
    f.write(b"".join(frags))


def _parse_records(buf: bytes):
    """The record framing of an index stream, in one native call:
    (max_coord, terms, span_off int64[T], span_words int32[T]), the byte
    offset and word count of each term's u16 words. A truncated or
    corrupt stream raises ValueError; one of 8 bytes or fewer holds no
    record."""
    mv = memoryview(buf)
    max_coord = int.from_bytes(mv[:8], "little")
    if len(buf) <= 8:
        return (max_coord, [], np.zeros(0, np.int64),
                np.zeros(0, np.int32))
    cap = (len(buf) - 8) // 5 + 2
    term_off = np.empty(cap, np.int64)
    term_len = np.empty(cap, np.int32)
    span_off = np.empty(cap, np.int64)
    span_words = np.empty(cap, np.int32)
    cnt = int(get_lib().docodo_parse_records(
        buf, len(buf), term_off.ctypes.data, term_len.ctypes.data,
        span_off.ctypes.data, span_words.ctypes.data))
    if cnt < 0:
        raise ValueError("truncated index record stream")
    terms = [str(mv[o: o + n], "utf-8") for o, n in
             zip(term_off[:cnt].tolist(), term_len[:cnt].tolist())]
    return max_coord, terms, span_off[:cnt].copy(), span_words[:cnt].copy()


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
