"""Tokenize and intern through the native host library: the port's copy of
docodo_tpu/native/pipeline.py (NativeInterner, the pure-Python
_PyInterner, make_interner, tokenize_intern_native, tokenize_intern,
tokenize_intern_packed, parallel_tokenize_intern, and varint_encode /
varint_decode, which are core/varint's native codec under the JAX
package's names).

`tokenize_intern_native` is the host front of the index build: one C++
pass over the raw text produces (term ids, starts) and grows an
incremental term dictionary. `tokenize_intern_packed` is the same pass
emitting the device build's packed rows (ops/device_index.pack_tokens's
layout) from the C loop.

    it = make_interner()                            # NativeInterner
    ids, starts = tokenize_intern(text, it)         # int32 ids, UTF-16 starts
    packed = tokenize_intern_packed(more_text, it)  # uint32 rows
    words = it.terms()                              # id -> term

The pure-Python interner is taken only when the caller asks for it
(`make_interner(native=False)`); the native library raises if it cannot
be built, and nothing falls back.
"""

from __future__ import annotations

import concurrent.futures as cf
import ctypes
import os
import threading
import weakref
from typing import List, Optional, Tuple

import numpy as np

from docodo_tpu_torch.core import varint
from docodo_tpu_torch.lang import tokenizer
from docodo_tpu_torch.native import get_lib

_TABLES: Optional[Tuple[np.ndarray, np.ndarray]] = None
_TABLES_LOCK = threading.Lock()


def _tables() -> Tuple[np.ndarray, np.ndarray]:
    """Per-unit case-fold and class tables matching lang/tokenizer
    semantics (fold keeps units whose lower() is not a single BMP char).
    The class table IS the tokenizer's own table. Both are built before
    either is published, as one tuple, so a thread never sees one
    without the other."""
    global _TABLES
    tables = _TABLES
    if tables is None:
        with _TABLES_LOCK:
            if _TABLES is None:
                fold = np.arange(0x10000, dtype=np.uint16)
                for cp in range(0x10000):
                    if 0xD800 <= cp <= 0xDFFF:
                        continue
                    low = chr(cp).lower()
                    if len(low) == 1 and ord(low) < 0x10000:
                        fold[cp] = ord(low)
                _TABLES = (fold, tokenizer._unit_table())
            tables = _TABLES
    return tables


def _addr(a: np.ndarray) -> int:
    """The address of a contiguous array, for a c_void_p argument (the
    caller holds the array for the call)."""
    return a.ctypes.data


class NativeInterner:
    """Incremental term dictionary living in C++ (term -> dense id)."""

    def __init__(self):
        self._lib = get_lib()
        self._ptr = ctypes.c_void_p(self._lib.docodo_interner_new())
        self._free = weakref.finalize(self, self._lib.docodo_interner_free,
                                      self._ptr)

    def __len__(self) -> int:
        return int(self._lib.docodo_interner_count(self._ptr))

    def term_at(self, idx: int) -> str:
        """The term of dense id `idx` (IndexError past the dictionary)."""
        buf = np.empty(64, dtype=np.uint16)  # MAX_WORD_LENGTH is 32
        n = int(self._lib.docodo_interner_get(self._ptr, idx, _addr(buf),
                                              buf.size))
        if n < 0:
            raise IndexError(idx)
        if n > buf.size:
            buf = np.empty(n, dtype=np.uint16)
            self._lib.docodo_interner_get(self._ptr, idx, _addr(buf),
                                          buf.size)
        return buf[:n].tobytes().decode("utf-16-le")

    def terms_range(self, lo: int, hi: int) -> List[str]:
        """Terms [lo, hi) in one export call: incremental consumers pull
        only the ids minted since their last call. A term holds no
        surrogate (they are no letters), so a unit is a character."""
        if hi <= lo:
            return []
        n_units = int(self._lib.docodo_interner_export_range(
            self._ptr, lo, hi, None, None))
        units = np.empty(max(n_units, 1), dtype=np.uint16)
        lens = np.empty(hi - lo, dtype=np.int32)
        self._lib.docodo_interner_export_range(self._ptr, lo, hi,
                                               _addr(units), _addr(lens))
        blob = units[:n_units].tobytes().decode("utf-16-le")
        out: List[str] = []
        pos = 0
        for ln in lens.tolist():
            out.append(blob[pos: pos + ln])
            pos += ln
        return out

    def terms(self) -> List[str]:
        return self.terms_range(0, len(self))

    def close(self) -> None:
        self._free()


def tokenize_intern_native(
    text: str, interner: NativeInterner,
    min_len: int = 3, max_len: int = 32,
) -> Tuple[np.ndarray, np.ndarray]:
    """One native pass of tokenize+intern of `text` into `interner`.
    Returns (term ids int32[N], starts int32[N]), starts in UTF-16 code
    units (the engine's coordinate unit)."""
    fold, cls = _tables()
    units = np.frombuffer(text.encode("utf-16-le"), dtype="<u2")
    n = units.size
    # an emitted token takes >= min_len units of the input
    cap = n if min_len < 2 else n // min_len + 1
    out_ids = np.empty(cap, dtype=np.int32)
    out_starts = np.empty(cap, dtype=np.int32)
    cnt = interner._lib.docodo_tokenize_intern(
        interner._ptr, _addr(units), n, _addr(fold), _addr(cls),
        min_len, max_len, _addr(out_ids), _addr(out_starts), cap)
    return out_ids[:cnt].copy(), out_starts[:cnt].copy()


class _PyInterner:
    """The term dictionary in a Python dict, with NativeInterner's surface
    (the pure-Python path, taken only on request)."""

    def __init__(self):
        self._map: dict = {}

    def __len__(self) -> int:
        return len(self._map)

    def terms_range(self, lo: int, hi: int) -> List[str]:
        """Terms [lo, hi): the dict's insertion order is the id order."""
        return list(self._map)[lo:hi]

    def terms(self) -> List[str]:
        return list(self._map)

    def close(self) -> None:
        pass


def make_interner(native: bool = True):
    """A NativeInterner, or with native=False the pure-Python one."""
    return NativeInterner() if native else _PyInterner()


def tokenize_intern(text: str, interner, min_len: int = 3,
                    max_len: int = 32) -> Tuple[np.ndarray, np.ndarray]:
    """Tokenize+intern through either interner make_interner gives:
    (term ids int32[N], starts int32[N]), the same arrays from both."""
    if isinstance(interner, NativeInterner):
        return tokenize_intern_native(text, interner, min_len, max_len)
    words, starts = tokenizer.tokenize(text)
    ids = np.empty(len(words), dtype=np.int32)
    keep = np.zeros(len(words), dtype=bool)
    m = interner._map
    for i, w in enumerate(words):
        if min_len and not min_len <= len(w) <= max_len:
            continue
        ids[i] = m.setdefault(w, len(m))
        keep[i] = True
    return ids[keep], starts[keep].astype(np.int32)


def tokenize_intern_packed(text: str, interner, min_len: int = 3,
                           max_len: int = 32) -> np.ndarray:
    """One pass of tokenize+intern emitting the packed token rows of the
    device build (uint32: 12-bit coordinate delta | 20-bit term id,
    escape rows for gaps of 4095 units or more; ops/device_index
    .pack_tokens's layout) from the C loop, with no packing pass over
    the arrays. Raises ValueError once the vocabulary reaches the
    2^20 - 1 sentinel id, as pack_tokens does. A _PyInterner's stream is
    pack_tokens of tokenize_intern."""
    from docodo_tpu_torch.ops.device_index import pack_tokens

    if not isinstance(interner, NativeInterner):
        return pack_tokens(*tokenize_intern(text, interner, min_len,
                                            max_len))
    fold, cls = _tables()
    units = np.frombuffer(text.encode("utf-16-le"), dtype="<u2")
    n = units.size
    # tokens: at most n // min_len; escape rows: a gap's units / 4095
    cap = (n if min_len < 2 else n // min_len + 1) + n // 4095 + 2
    out = np.empty(cap, dtype=np.uint32)
    cnt = interner._lib.docodo_tokenize_intern_packed(
        interner._ptr, _addr(units), n, _addr(fold), _addr(cls),
        min_len, max_len, _addr(out), cap)
    if cnt < 0:
        raise ValueError(f"the vocabulary reached {len(interner)} terms: "
                         f"term ids must stay below 2^20 - 1 to fit a "
                         f"packed row")
    return out[:cnt].copy()


def parallel_tokenize_intern(texts, workers: int = 0, min_len: int = 3,
                             max_len: int = 32):
    """Tokenize+intern many texts on threads (the native call releases
    the interpreter lock, so the threads scale on cores). Each worker
    owns an interner; afterwards the term dictionaries are unified in
    worker order and every id array is remapped by one gather.

    Returns (ids: List[int32[Ni]], starts: List[int32[Ni]], terms:
    List[str]), the same as one interner over the texts in order would
    give up to the numbering of the terms."""
    texts = list(texts)
    if workers <= 0:
        workers = min(os.cpu_count() or 1, 8)
    if workers == 1 or len(texts) <= 1:
        it = NativeInterner()
        try:
            out = [tokenize_intern_native(t, it, min_len, max_len)
                   for t in texts]
            return [o[0] for o in out], [o[1] for o in out], it.terms()
        finally:
            it.close()

    shards = [list(range(w, len(texts), workers)) for w in range(workers)]

    def run(idxs):
        it = NativeInterner()
        try:
            res = {i: tokenize_intern_native(texts[i], it, min_len, max_len)
                   for i in idxs}
            return res, it.terms()
        finally:
            it.close()

    with cf.ThreadPoolExecutor(workers) as ex:
        parts = list(ex.map(run, shards))

    global_map: dict = {}
    terms: List[str] = []
    doc_ids: List[Optional[np.ndarray]] = [None] * len(texts)
    doc_starts: List[Optional[np.ndarray]] = [None] * len(texts)
    for res, local_terms in parts:
        remap = np.empty(len(local_terms), dtype=np.int32)
        for lid, w in enumerate(local_terms):
            gid = global_map.get(w)
            if gid is None:
                gid = len(terms)
                global_map[w] = gid
                terms.append(w)
            remap[lid] = gid
        for i, (ids, starts) in res.items():
            doc_ids[i] = remap[ids]
            doc_starts[i] = starts
    return doc_ids, doc_starts, terms


def varint_encode(coords: np.ndarray) -> np.ndarray:
    """Ascending coordinates -> their 15-bit varint u16 stream
    (core/varint.encode, the native codec)."""
    return varint.encode(coords)


def varint_decode(words: np.ndarray) -> np.ndarray:
    """A 15-bit varint u16 stream -> its uint64 coordinates
    (core/varint.decode)."""
    return varint.decode(words)
