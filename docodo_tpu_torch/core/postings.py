"""Posting-list algebra: the proximity-AND and OR-merge of ascending
coordinate arrays and PostingSeq, the host engine's operand (copies of
docodo_tpu/core/postings.py :35-210, ref Docodo.NET/IndexSequence.cs
:205-322), with the varint wire format of the .index file over
core/varint.

AND (`*`, proximity with grouping window): the window is max(|R1|,
|R2|), ordered (R < 0) iff both operands are; the merged coordinates cut
into groups at gaps wider than the window, in ordered mode also at the
first left-operand coordinate of each gap segment; a group is emitted,
all of its coordinates, iff it holds a coordinate of each operand; equal
coordinates across operands merge into one (per distinct value
max(count_a, count_b) copies).

OR (`+`): ascending merge where values equal across the operands are
emitted once (per distinct value max(count_a, count_b) copies).
"""

from __future__ import annotations

import numpy as np

from docodo_tpu_torch.core import varint

__all__ = ["PostingSeq", "group_and", "or_merge"]


def _rle(arr: np.ndarray):
    """Run-length encode a sorted array -> (distinct values, counts)."""
    n = arr.size
    if n == 0:
        return arr, np.zeros(0, dtype=np.int64)
    change = np.empty(n, dtype=bool)
    change[0] = True
    np.not_equal(arr[1:], arr[:-1], out=change[1:])
    idx = np.flatnonzero(change)
    vals = arr[idx]
    counts = np.diff(np.append(idx, n))
    return vals, counts


def _aligned_counts(vals, side_vals, side_counts):
    """Counts of each of `vals` inside (side_vals, side_counts) RLE."""
    if side_vals.size == 0:
        return np.zeros(vals.size, dtype=np.int64)
    pos = np.searchsorted(side_vals, vals)
    pos_c = np.minimum(pos, side_vals.size - 1)
    hit = side_vals[pos_c] == vals
    out = np.where(hit, side_counts[pos_c], 0)
    return out


def _combine_r(r1: int, r2: int) -> int:
    abs_r = max(abs(r1), abs(r2))
    return -abs_r if (r1 < 0 and r2 < 0) else abs_r


def group_and(a: np.ndarray, b: np.ndarray, r1: int, r2: int):
    """Proximity-AND of two ascending coordinate arrays.

    Returns (coords, R) where coords contains every coordinate of every
    qualifying group (both operands' positions are kept — phrase results
    report the positions of all matched words).
    """
    r = _combine_r(r1, r2)
    abs_r = abs(r)
    a = np.asarray(a, dtype=np.uint64)
    b = np.asarray(b, dtype=np.uint64)
    if a.size == 0 or b.size == 0:
        return np.zeros(0, dtype=np.uint64), r

    av, ac = _rle(a)
    bv, bc = _rle(b)
    vals = np.unique(np.concatenate([av, bv]))
    ca = _aligned_counts(vals, av, ac)
    cb = _aligned_counts(vals, bv, bc)
    mult = np.maximum(ca, cb)
    has_a = ca > 0
    has_b = cb > 0

    k = vals.size
    start = np.empty(k, dtype=bool)
    start[0] = True
    if abs_r != 0:
        np.greater(vals[1:] - vals[:-1], np.uint64(abs_r), out=start[1:])
    else:
        start[1:] = False

    if r < 0:
        # ordered mode: additionally cut before the first left-operand value
        # of each gap segment when it does not already start the segment.
        seg_id = np.cumsum(start) - 1
        seg_start_idx = np.flatnonzero(start)
        c_a = np.cumsum(has_a)
        before = c_a - has_a  # number of A strictly before position i
        before_seg = before[seg_start_idx]  # A strictly before segment start
        prev_a_in_seg = before - before_seg[seg_id]
        is_seg_start = start
        ordered_cut = has_a & (prev_a_in_seg == 0) & ~is_seg_start
        start = start | ordered_cut

    seg_id = np.cumsum(start) - 1
    nseg = int(seg_id[-1]) + 1
    seg_a = np.zeros(nseg, dtype=bool)
    seg_b = np.zeros(nseg, dtype=bool)
    np.logical_or.at(seg_a, seg_id, has_a)
    np.logical_or.at(seg_b, seg_id, has_b)
    keep = (seg_a & seg_b)[seg_id]
    out = np.repeat(vals[keep], mult[keep])
    return out.astype(np.uint64), r


def or_merge(a: np.ndarray, b: np.ndarray, r1: int, r2: int):
    """OR-merge of two ascending coordinate arrays (dedupe across operands)."""
    r = _combine_r(r1, r2)
    a = np.asarray(a, dtype=np.uint64)
    b = np.asarray(b, dtype=np.uint64)
    if a.size == 0:
        return b.copy(), r
    if b.size == 0:
        return a.copy(), r
    av, ac = _rle(a)
    bv, bc = _rle(b)
    vals = np.unique(np.concatenate([av, bv]))
    ca = _aligned_counts(vals, av, ac)
    cb = _aligned_counts(vals, bv, bc)
    out = np.repeat(vals, np.maximum(ca, cb))
    return out.astype(np.uint64), r


class PostingSeq:
    """An ascending coordinate list with a proximity window: `R`, negative
    for an exact / ordered sequence (ref IndexSequence.cs:161-164)."""

    __slots__ = ("coords", "R")

    def __init__(self, coords=None, R: int = 0):
        if coords is None:
            coords = np.zeros(0, dtype=np.uint64)
        self.coords = np.asarray(coords, dtype=np.uint64)
        self.R = int(R)

    def __mul__(self, other: "PostingSeq") -> "PostingSeq":
        coords, r = group_and(self.coords, other.coords, self.R, other.R)
        return PostingSeq(coords, r)

    def __and__(self, other: "PostingSeq") -> "PostingSeq":
        # ref operator& delegates to operator* (IndexSequence.cs:205-215)
        return self * other

    def __add__(self, other: "PostingSeq") -> "PostingSeq":
        coords, r = or_merge(self.coords, other.coords, self.R, other.R)
        return PostingSeq(coords, r)

    @property
    def order(self) -> bool:
        """Whether the sequence is exact / ordered (R < 0)."""
        return self.R < 0

    def shift(self, delta: int) -> "PostingSeq":
        """Every coordinate moved by `delta`, in place; returns self (ref
        IndexSequence.cs:191-202)."""
        if delta == 0 or self.coords.size == 0:
            return self
        self.coords = self.coords + np.uint64(delta)
        return self

    def __len__(self) -> int:
        return int(self.coords.size)

    def __iter__(self):
        return iter(self.coords.tolist())

    def __eq__(self, other) -> bool:
        return (isinstance(other, PostingSeq)
                and self.coords.size == other.coords.size
                and bool(np.all(self.coords == other.coords)))

    def __repr__(self) -> str:
        return f"PostingSeq(n={self.coords.size}, R={self.R})"

    # the .index wire format: core/varint's 15-bit delta codec
    def encode(self) -> np.ndarray:
        return varint.encode(self.coords)

    @classmethod
    def from_encoded(cls, stream: np.ndarray, R: int = 0) -> "PostingSeq":
        return cls(varint.decode(stream), R)

    @property
    def encoded_len(self) -> int:
        """The u16 words of encode() (the reference's
        IndexSequence.Count)."""
        return varint.encoded_len(self.coords)
