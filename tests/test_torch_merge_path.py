"""The merge-path partition of the port's merge_tagged kernel, modelled in
numpy and held against the port's plain version.

csrc/chunked.cu merges a row's k = va + vb sorted blocks in a pairwise
tree of ceil(log2 k) passes: pass p merges runs 2q and 2q + 1 of level p
(run r holds blocks r << p .. ((r + 1) << p) - 1), ties to the left, and
copies a run without a partner. Each block of a pass owns one output tile
of its pair: two warps find the tile's first and last co-ranks by a
32-way search over the runs, the tile's two input segments are staged,
and each thread merges a few lanes from its own co-rank, found by a
binary search in the staged segments. Lanes past the real elements are
the fill (INF32, tag 2, page 0). A row of at most 32 blocks and 2048
lanes runs every level in one block instead, in shared memory: the same
merges with the tile as wide as the pair. Here the tile and the lanes a
thread merges are drawn small, so that tiles split runs of equal coordinates
and segments come out empty; the result must equal merge_tagged_plain
exactly (pages at the real lanes). For two blocks the model is also held
against the JAX package's pallas_bitonic_merge in interpret mode. The
model is not part of the package: the kernel runs only on a card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

from docodo_tpu.ops import pallas_query as pq
from docodo_tpu_torch.ops import query_kernels as qk
from docodo_tpu_torch.ops.seqops import INF32

T = torch.as_tensor


def warp_corank(lv, rv, d, stats):
    """chunked.cu's warp_corank: how many of the first d outputs of the
    merge of lv and rv (ties to lv) come from lv, 32 probes a round. The
    probes' answers must fall as a prefix of trues."""
    la, lb = len(lv), len(rv)
    lo, hi = max(0, d - lb), min(d, la)
    while lo < hi:
        stats["rounds"] += 1
        n = hi - lo
        step = -(-n // 32)
        probes = [lo + min(n, (i + 1) * step) - 1 for i in range(32)]
        flags = [bool(lv[p] <= rv[d - 1 - p]) for p in probes]
        assert flags == sorted(flags, reverse=True)
        c = sum(flags)
        if c == 32:
            return hi
        hi = lo + min(n, (c + 1) * step) - 1
        lo += c * step
    return lo


def thread_corank(sv, ca, cb, d):
    """A thread's co-rank in the staged tile: sv[:ca] from the left run,
    sv[ca:ca + cb] from the right."""
    lo, hi = max(0, d - cb), min(d, ca)
    while lo < hi:
        mid = (lo + hi) // 2
        if sv[mid] <= sv[ca + d - 1 - mid]:
            lo = mid + 1
        else:
            hi = mid
    return lo


def merge_pair(left, right, tile, ipt, stats):
    """One pair of a pass, tile by tile: (vals, tags, pages) of the real
    elements."""
    lv, rv = left[0], right[0]
    total = len(lv) + len(rv)
    out = np.zeros((3, total), np.int64)
    for d0 in range(0, total, tile):
        d1 = min(d0 + tile, total)
        i0 = warp_corank(lv, rv, d0, stats)
        i1 = warp_corank(lv, rv, d1, stats)
        ca, j0 = i1 - i0, d0 - i0
        cb = d1 - d0 - ca
        assert ca >= 0 and cb >= 0
        stats["empty_segments"] += (ca == 0) + (cb == 0)
        staged = np.concatenate([left[:, i0:i1], right[:, j0:j0 + cb]],
                                axis=1)
        sv = staged[0]
        cnt = d1 - d0
        for d in range(0, cnt, ipt):  # one thread each
            i = thread_corank(sv, ca, cb, d)
            j = d - i
            for k in range(d, min(d + ipt, cnt)):
                take_left = j >= cb or (i < ca and sv[i] <= sv[ca + j])
                x = i if take_left else ca + j
                i, j = (i + 1, j) if take_left else (i, j + 1)
                out[:, d0 + k] = staged[:, x]
        if d0 > 0:  # a tile edge, perhaps inside a run of equal coords
            stats["edges"] += 1
            stats["split_runs"] += int(out[0, d0 - 1] == out[0, d0])
    return out


def model_merge(a, na, b, nb, apg, bpg, tile, ipt, stats):
    """The kernel's pairwise tree over one batch: [B, Va, cap_a] and
    [B, Vb, cap_b] blocks to (vals, tag, pages) [B, n]."""
    rows, va, cap_a = a.shape
    vb, cap_b = b.shape[1], b.shape[2]
    n = va * cap_a + vb * cap_b
    vals = np.full((rows, n), INF32, np.int64)
    tag = np.full((rows, n), 2, np.int64)
    pg = np.zeros((rows, n), np.int64)
    for row in range(rows):
        runs = []
        for j in range(va + vb):
            word_a = j < va
            x, p, cap = ((a[row, j], apg[row, j], cap_a) if word_a
                         else (b[row, j - va], bpg[row, j - va], cap_b))
            ln = int(np.clip((na if word_a else nb)[row, j if word_a
                                                    else j - va], 0, cap))
            runs.append(np.stack([x[:ln], np.full(ln, 0 if word_a else 1),
                                  p[:ln]]).astype(np.int64))
        passes = max(1, int(np.ceil(np.log2(max(len(runs), 1)))))
        for _ in range(passes):
            empty = np.zeros((3, 0), np.int64)
            runs = [merge_pair(runs[q], runs[q + 1] if q + 1 < len(runs)
                               else empty, tile, ipt, stats)
                    for q in range(0, len(runs), 2)]
        if runs:
            (merged,) = runs
            total = merged.shape[1]
            vals[row, :total], tag[row, :total], pg[row, :total] = merged
    return vals, tag, pg


def blocks(rng, rows, v, cap, *, pool, lengths=None):
    """v ascending blocks a row from the row's pool, INF32 past their
    lengths; lengths drawn in [0, cap + 3] (past the cap is clamped)."""
    x = np.full((rows, v, cap), INF32, np.int64)
    n = (rng.integers(0, cap + 4, (rows, v)) if lengths is None
         else np.broadcast_to(lengths, (rows, v)).copy())
    for i in range(rows):
        for j in range(v):
            k = min(int(n[i, j]), cap)
            x[i, j, :k] = np.sort(rng.choice(pool[i], k, replace=False))
    return x.astype(np.int32), n.astype(np.int32)


def pools(rng, rows, size, spread):
    return [np.sort(rng.choice(spread, size, replace=False)) + 1
            for _ in range(rows)]


def run_case(rng, rows, va, cap_a, vb, cap_b, tile, ipt, spread=None,
             equal=False):
    """Model and plain version on one seeded batch; returns the model's
    stats."""
    size = max(va * cap_a, vb * cap_b, 1)
    if equal:  # every block holds the same few coordinates
        pool = [np.arange(1, 4) * 10 for _ in range(rows)]
        cap_a, cap_b = max(cap_a, 3), max(cap_b, 3)
        a, na = blocks(rng, rows, va, cap_a, pool=pool, lengths=3)
        b, nb = blocks(rng, rows, vb, cap_b, pool=pool, lengths=3)
    else:
        pool = pools(rng, rows, size, spread or 3 * size)
        a, na = blocks(rng, rows, va, cap_a, pool=pool)
        b, nb = blocks(rng, rows, vb, cap_b, pool=pool)
    apg = (a // 7).astype(np.int32)
    bpg = (b // 7).astype(np.int32) + 1000
    stats = dict(rounds=0, empty_segments=0, edges=0, split_runs=0)
    mv, mt, mp = model_merge(a, na, b, nb, apg, bpg, tile, ipt, stats)
    wv, wt, wp = qk.merge_tagged_plain(T(a), T(na), T(b), T(nb), T(apg),
                                       T(bpg))
    np.testing.assert_array_equal(mv, wv.numpy())
    np.testing.assert_array_equal(mt, wt.numpy())
    live = mv < INF32
    np.testing.assert_array_equal(mp[live], wp.numpy()[live])
    assert (mp[~live] == 0).all()
    stats["live"] = int(live.sum())
    return stats


@pytest.mark.parametrize("va,vb", [(1, 1), (1, 0), (0, 1), (2, 1), (1, 2),
                                   (2, 2), (3, 2), (4, 4), (5, 3), (7, 1),
                                   (8, 0), (0, 5)])
def test_pairwise_tree_matches_plain(va, vb):
    """k = 1..8 blocks, ragged and empty blocks, lengths past the cap,
    small tiles: the tree of passes gives the plain stream."""
    rng = np.random.default_rng(100 * va + vb)
    stats = run_case(rng, 6, va, 24, vb, 24, tile=8, ipt=3)
    assert stats["live"] > 0 and stats["edges"] > 0


@pytest.mark.parametrize("va,vb", [(4, 4), (8, 0), (16, 16), (3, 2)])
def test_one_block_rows_match_plain(va, vb):
    """The one-block form: each level's pair merged whole, 8 lanes a
    thread, caps of 8 and 16 lanes (up to 32 blocks, 5 levels)."""
    rng = np.random.default_rng(va * 3 + vb)
    stats = run_case(rng, 4, va, 16, vb, 8, tile=1 << 30, ipt=8)
    assert stats["live"] > 0 and stats["edges"] == 0


@pytest.mark.parametrize("cap_a,cap_b,va,vb", [(40, 12, 1, 1), (12, 40, 1, 1),
                                               (36, 8, 1, 2), (8, 20, 4, 4)])
def test_unequal_caps_match_plain(cap_a, cap_b, va, vb):
    """A fold step's running stream against the next word's block, and
    variant blocks of two widths: offsets and widths per word."""
    rng = np.random.default_rng(cap_a * 7 + cap_b + va)
    stats = run_case(rng, 5, va, cap_a, vb, cap_b, tile=8, ipt=2)
    assert stats["live"] > 0


@pytest.mark.parametrize("va,vb,tile", [(1, 1, 3), (2, 2, 3), (4, 4, 5),
                                        (3, 1, 1)])
def test_equal_coords_split_by_tiles(va, vb, tile):
    """Every block holds the same three coordinates: each run of equal
    coordinates spans both words and every block, and tiles of 1-5
    lanes cut it; block order must hold across the cuts."""
    rng = np.random.default_rng(tile + va)
    stats = run_case(rng, 3, va, 4, vb, 4, tile=tile, ipt=2, equal=True)
    assert stats["split_runs"] > 0


@settings(max_examples=30, deadline=None)
@given(st.integers(0, 4), st.integers(0, 4), st.integers(1, 33),
       st.integers(1, 33), st.integers(1, 40), st.integers(1, 9),
       st.integers(0, 2**31 - 1))
def test_random_partitions_match_plain(va, vb, cap_a, cap_b, tile, ipt,
                                       seed):
    """Random block counts, caps, tiles and lanes a thread, over dense
    pools (many equal coordinates across blocks)."""
    rng = np.random.default_rng(seed)
    size = max(va * cap_a, vb * cap_b, 1)
    run_case(rng, 3, va, cap_a, vb, cap_b, tile=tile, ipt=min(ipt, tile),
             spread=size + 4)


def test_warp_corank_at_kernel_widths():
    """The 32-way search at the kernel's widths: tiles of 2048 over runs
    of 2^18 lanes take at most 4 rounds a diagonal and match a merge."""
    rng = np.random.default_rng(7)
    lv = np.sort(rng.integers(0, 1 << 20, 1 << 18))
    rv = np.sort(rng.integers(0, 1 << 20, 3 << 16))
    merged_from_left = np.concatenate([
        np.ones(lv.size, np.int64), np.zeros(rv.size, np.int64)])
    order = np.argsort(np.concatenate([lv, rv]), kind="stable")
    from_left = np.cumsum(merged_from_left[order])
    stats = dict(rounds=0)
    for d in range(0, lv.size + rv.size, 2048 * 37):
        before = stats["rounds"]
        c = warp_corank(lv, rv, d, stats)
        assert c == (from_left[d - 1] if d else 0)
        assert stats["rounds"] - before <= 4


@pytest.mark.parametrize("cap", [16, 64])
def test_two_block_model_matches_bitonic_merge(cap):
    """For two blocks the model against the JAX package's
    pallas_bitonic_merge (interpret mode): values and tags everywhere,
    pages at the real lanes."""
    rng = np.random.default_rng(cap)
    rows = 6
    pool = pools(rng, rows, 2 * cap, 3 * cap)
    a, na = blocks(rng, rows, 1, cap, pool=pool)
    b, nb = blocks(rng, rows, 1, cap, pool=pool)
    na[0, 0], nb[1, 0] = 0, 0
    na, nb = np.minimum(na, cap), np.minimum(nb, cap)
    apg, bpg = (a // 5).astype(np.int32), (b // 5).astype(np.int32)
    stats = dict(rounds=0, empty_segments=0, edges=0, split_runs=0)
    mv, mt, mp = model_merge(a, na, b, nb, apg, bpg, tile=cap // 4, ipt=3,
                             stats=stats)
    J = jnp.asarray
    vj, tj, pj = pq.pallas_bitonic_merge(
        J(a[:, 0]), J(na[:, 0]), J(b[:, 0]), J(nb[:, 0]), J(apg[:, 0]),
        J(bpg[:, 0]), cap=cap, interpret=True)
    vj, tj, pj = np.asarray(vj), np.asarray(tj), np.asarray(pj)
    np.testing.assert_array_equal(mv, vj)
    np.testing.assert_array_equal(mt, tj)
    live = vj < INF32
    np.testing.assert_array_equal(mp[live], pj[live])
    assert stats["edges"] > 0
