"""The 15-bit varint delta codec of posting lists in the .index file (a
copy of docodo_tpu/core/varint.py).

The wire format is the reference's (ref Docodo.NET/IndexSequence.cs:
13-16, 63-84): an ascending u64 coordinate list is delta-coded, the
first delta from 0, and each delta is split into little-endian 15-bit
chunks stored in u16 words, the top bit set on every chunk but a
delta's last. A delta under 2^15 takes 2 bytes.

encode, encode_blocks, decode and encoded_len run in the port's native
library (native/docodo_native.cpp), which is built at first use and
raises if it cannot be: the index save and the lazy lookups call them
once a file or once a term (storage.read_index decodes a whole file in
one native call of its own). The NumPy codec beside them (encode_numpy,
encode_blocks_numpy, decode_numpy with decode_deltas) is their plain
version, which the tests hold them against.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from docodo_tpu_torch.native import get_lib

BITS = 15
OVERFLOW = np.uint16(1 << BITS)     # continuation flag
MASK = np.uint16(OVERFLOW - 1)      # 15-bit payload mask
MAX_WORDS = 5                       # u16 words of the largest u64 delta


def chunks_per_delta(deltas: np.ndarray) -> np.ndarray:
    """The u16 words each delta takes: max(1, ceil(bit length / 15))."""
    deltas = deltas.astype(np.uint64, copy=False)
    n = np.ones(deltas.shape, dtype=np.int64)
    for j in (15, 30, 45, 60):
        n += deltas >= (np.uint64(1) << np.uint64(j))
    return n


def encode(coords: np.ndarray) -> np.ndarray:
    """Ascending uint64 coordinates -> their u16 varint stream."""
    coords = np.ascontiguousarray(coords, dtype=np.uint64)
    if coords.size == 0:
        return np.zeros(0, dtype=np.uint16)
    out = np.empty(coords.size * MAX_WORDS, dtype=np.uint16)
    w = get_lib().docodo_varint_encode(coords.ctypes.data, coords.size,
                                       out.ctypes.data)
    return out[:w].copy()


def encode_blocks(coords: np.ndarray, offsets: np.ndarray):
    """Many posting blocks in one pass: coords[offsets[i]:offsets[i + 1]]
    is block i, each delta-coded from 0 as `encode` codes it. Returns
    (stream u16, word_starts int64[B + 1]): block i's words are
    stream[word_starts[i]:word_starts[i + 1]]."""
    coords = np.ascontiguousarray(coords, dtype=np.uint64)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    if coords.size == 0:
        return (np.zeros(0, dtype=np.uint16),
                np.zeros(offsets.size, dtype=np.int64))
    out = np.empty(coords.size * MAX_WORDS, dtype=np.uint16)
    wstarts = np.empty(offsets.size, dtype=np.int64)
    w = get_lib().docodo_varint_encode_blocks(
        coords.ctypes.data, offsets.ctypes.data, offsets.size - 1,
        out.ctypes.data, wstarts.ctypes.data)
    return out[:w].copy(), wstarts


def decode(stream: np.ndarray) -> np.ndarray:
    """A u16 varint stream -> its ascending uint64 coordinates."""
    stream = np.ascontiguousarray(stream, dtype=np.uint16)
    if stream.size == 0:
        return np.zeros(0, dtype=np.uint64)
    out = np.empty(stream.size, dtype=np.uint64)  # a word a coordinate at most
    n = get_lib().docodo_varint_decode(stream.ctypes.data, stream.size,
                                       out.ctypes.data)
    return out[:n].copy()


def encoded_len(coords: np.ndarray) -> int:
    """The u16 words `encode` makes of `coords` (the reference's
    IndexSequence.Count, which orders suggestions)."""
    coords = np.ascontiguousarray(coords, dtype=np.uint64)
    if coords.size == 0:
        return 0
    return int(get_lib().docodo_varint_encode(coords.ctypes.data,
                                              coords.size, None))


def write_block(f, coords: np.ndarray) -> None:
    """A posting block: the i32 count of its u16 words, then the words
    (ref IndexSequence.cs:167-173)."""
    enc = encode(coords)
    f.write(np.int32(enc.size).tobytes())
    f.write(enc.tobytes())


def read_block(f) -> np.ndarray:
    """One posting block written by `write_block`."""
    raw = f.read(4)
    if len(raw) < 4:
        raise EOFError
    n = int(np.frombuffer(raw, dtype=np.int32)[0])
    return decode(np.frombuffer(f.read(2 * n), dtype=np.uint16))


# ---- the plain NumPy codec ---------------------------------------------

def _encode_deltas(deltas: np.ndarray,
                   nchunks: Optional[np.ndarray] = None) -> np.ndarray:
    """Deltas -> the u16 stream: every delta's first chunk scattered in
    one pass, then the rare continuation chunks."""
    if deltas.size == 0:
        return np.zeros(0, dtype=np.uint16)
    if nchunks is None:
        if deltas.max() <= np.uint64(MASK):
            return deltas.astype(np.uint16)
        nchunks = chunks_per_delta(deltas)
    out = np.zeros(int(nchunks.sum()), dtype=np.uint16)
    starts = np.cumsum(nchunks) - nchunks
    word0 = (deltas & np.uint64(MASK)).astype(np.uint16)
    word0[nchunks > 1] |= OVERFLOW
    out[starts] = word0
    for j in range(1, int(nchunks.max())):
        idx = np.flatnonzero(nchunks > j)
        word = ((deltas[idx] >> np.uint64(j * BITS))
                & np.uint64(MASK)).astype(np.uint16)
        word[j < nchunks[idx] - 1] |= OVERFLOW
        out[starts[idx] + j] = word
    return out


def encode_numpy(coords: np.ndarray) -> np.ndarray:
    """`encode` in NumPy."""
    coords = np.asarray(coords, dtype=np.uint64)
    if coords.size == 0:
        return np.zeros(0, dtype=np.uint16)
    return _encode_deltas(np.diff(coords, prepend=np.uint64(0)))


def encode_blocks_numpy(coords: np.ndarray, offsets: np.ndarray):
    """`encode_blocks` in NumPy."""
    coords = np.asarray(coords, dtype=np.uint64)
    offsets = np.asarray(offsets, dtype=np.int64)
    if coords.size == 0:
        return (np.zeros(0, dtype=np.uint16),
                np.zeros(offsets.size, dtype=np.int64))
    deltas = np.diff(coords, prepend=np.uint64(0))
    starts = offsets[:-1][offsets[:-1] < offsets[1:]]
    deltas[starts] = coords[starts]  # every block from 0
    if deltas.max() <= np.uint64(MASK):
        return deltas.astype(np.uint16), offsets.copy()
    nchunks = chunks_per_delta(deltas)
    cum = np.concatenate([[0], np.cumsum(nchunks)])
    return _encode_deltas(deltas, nchunks), cum[offsets]


def decode_deltas(stream: np.ndarray) -> np.ndarray:
    """A u16 varint stream -> its deltas (no prefix sum), in NumPy."""
    stream = np.asarray(stream, dtype=np.uint16)
    if stream.size == 0:
        return np.zeros(0, dtype=np.uint64)
    cont = (stream & OVERFLOW) != 0
    if not cont.any():
        return stream.astype(np.uint64)
    # a chunk starts a delta when it is the first or the one before it
    # was a delta's last
    starts = np.empty(stream.shape, dtype=bool)
    starts[0] = True
    np.logical_not(cont[:-1], out=starts[1:])
    start_idx = np.flatnonzero(starts)
    glen = np.diff(np.append(start_idx, stream.size))
    payload = (stream & MASK).astype(np.uint64)
    deltas = payload[start_idx]
    for j in range(1, int(glen.max())):
        sel = glen > j
        deltas[sel] |= payload[start_idx[sel] + j] << np.uint64(j * BITS)
    return deltas


def decode_numpy(stream: np.ndarray) -> np.ndarray:
    """`decode` in NumPy."""
    return np.cumsum(decode_deltas(stream), dtype=np.uint64)
