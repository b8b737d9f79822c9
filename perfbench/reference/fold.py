"""The posting algebra, frozen: a NumPy rewrite of the proximity-AND
(`group_and`), the OR-merge (`or_merge`) and the left fold of a query row
(`fold_row`) with the semantics of docodo_tpu_torch/core/postings.py and
docodo_tpu_torch/oracle.py as of the port's revision 75513271 (checked
there on the CPU by perfbench/tests/test_perfbench_reference.py), which
follow the reference engine (Docodo.NET IndexSequence.cs:205-322,
Search.cs:501). Nothing here imports the port.

AND: the window is max(|R1|, |R2|), ordered (R < 0) iff both operands
are; the merged distinct coordinates cut into groups at gaps wider than
the window, in ordered mode also before the first left-operand
coordinate of each gap segment that does not open it; a group is kept,
all of its coordinates, iff it holds a coordinate of each operand. A
value in both operands appears max(count_a, count_b) times.

OR: the ascending merge, a value in both operands max(count_a, count_b)
times.

Coordinates are int64 here; merges take the two runs' stable sort, which
merges them in linear time.
"""

from __future__ import annotations

import numpy as np


def _rle(arr: np.ndarray):
    """Distinct values of a sorted array and their counts."""
    if arr.size == 0:
        return arr, np.zeros(0, dtype=np.int64)
    start = np.empty(arr.size, dtype=bool)
    start[0] = True
    np.not_equal(arr[1:], arr[:-1], out=start[1:])
    idx = np.flatnonzero(start)
    return arr[idx], np.diff(np.append(idx, arr.size))


def _merge_counts(a: np.ndarray, b: np.ndarray):
    """The distinct values of two sorted arrays, with each one's count in
    a and in b."""
    av, ac = _rle(a)
    bv, bc = _rle(b)
    vals = np.sort(np.concatenate([av, bv]), kind="stable")
    vals, _ = _rle(vals)
    ca = np.zeros(vals.size, dtype=np.int64)
    cb = np.zeros(vals.size, dtype=np.int64)
    ca[np.searchsorted(vals, av)] = ac
    cb[np.searchsorted(vals, bv)] = bc
    return vals, ca, cb


def combine_r(r1: int, r2: int) -> int:
    abs_r = max(abs(r1), abs(r2))
    return -abs_r if (r1 < 0 and r2 < 0) else abs_r


def group_and(a: np.ndarray, b: np.ndarray, r1: int, r2: int):
    """Proximity-AND of two ascending coordinate arrays: (coords, R)."""
    r = combine_r(r1, r2)
    a = np.asarray(a, dtype=np.int64)
    b = np.asarray(b, dtype=np.int64)
    if a.size == 0 or b.size == 0:
        return np.zeros(0, dtype=np.int64), r
    vals, ca, cb = _merge_counts(a, b)
    has_a = ca > 0
    start = np.empty(vals.size, dtype=bool)
    start[0] = True
    if r != 0:
        np.greater(np.diff(vals), abs(r), out=start[1:])
    else:
        start[1:] = False
    if r < 0:
        seg = np.cumsum(start) - 1
        before = np.cumsum(has_a) - has_a
        first_a = has_a & (before == before[np.flatnonzero(start)][seg])
        start = start | first_a
    seg = np.cumsum(start) - 1
    n_seg = int(seg[-1]) + 1
    seg_a = np.bincount(seg, weights=has_a, minlength=n_seg) > 0
    seg_b = np.bincount(seg, weights=cb > 0, minlength=n_seg) > 0
    keep = (seg_a & seg_b)[seg]
    return np.repeat(vals[keep], np.maximum(ca, cb)[keep]), r


def or_merge(a: np.ndarray, b: np.ndarray, r1: int, r2: int):
    """OR-merge of two ascending coordinate arrays: (coords, R)."""
    r = combine_r(r1, r2)
    a = np.asarray(a, dtype=np.int64)
    b = np.asarray(b, dtype=np.int64)
    if a.size == 0:
        return b.copy(), r
    if b.size == 0:
        return a.copy(), r
    vals, ca, cb = _merge_counts(a, b)
    return np.repeat(vals, np.maximum(ca, cb)), r


def or_all(variants) -> np.ndarray:
    """The OR-merge of a word's variants, left to right. A value's count
    is the largest of its counts in the variants whatever the order, so
    when no variant repeats a value (a word's postings never do) this is
    their union, taken in one sort."""
    arrs = [np.asarray(v, dtype=np.int64) for v in variants]
    if len(arrs) == 1:
        return arrs[0]
    if all(a.size < 2 or bool((np.diff(a) > 0).all()) for a in arrs):
        vals, _ = _rle(np.sort(np.concatenate(arrs), kind="stable"))
        return vals
    b = arrs[0]
    for nxt in arrs[1:]:
        b, _ = or_merge(b, nxt, 1, 1)
    return b


def fold_row(words, rs) -> np.ndarray:
    """One query row: each word's variants OR-merged in order, then the
    proximity-AND left fold of the words. words: per word the list of
    its variants' ascending coordinate arrays; rs: the words' windows.
    Returns the kept coordinates, ascending."""
    acc, r_acc = None, 0
    for variants, r in zip(words, rs):
        b = or_all(variants)
        if acc is None:
            acc, r_acc = b, int(r)
        else:
            acc, r_acc = group_and(acc, b, r_acc, int(r))
    return acc
