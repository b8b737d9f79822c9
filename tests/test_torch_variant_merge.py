"""The pairwise merge tree of the port's variant slot kernels
(csrc/variants.cu, merge_blocks), modelled in numpy and held against the
port's plain merge of the same blocks.

A row's nblk = va + vb sorted blocks (cap lanes each, ragged lengths,
anything past a block's length) merge in ceil(log2 nblk) levels: at level
j the runs of 2^j blocks pair up (run r holds blocks r << j ..
((r + 1) << j) - 1, its values first in its lanes), each value's slot in
the merged run is its place in its own run plus its rank in the partner
run (strictly below for a left run, at or below for a right one: ties to
the left, so the row ends in (coord, block) order), found by a binary
search of the partner's values, and a run without a partner is copied.
Values and their source lanes go from one buffer to the other; the last
level writes the row: value, the source lane's page, tag 0 for word A's
blocks and 1 for word B's, and the padding (INF32, page 0, tag 2) after
the row's values. A thread owns Q consecutive lanes at every level (Q = 4,
or 1), and its binary searches run side by side, stepping down from the
largest power of two within its partners' lengths. The model is not part
of the package: the kernel runs only on a card (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import numpy as np
import pytest
import torch

from docodo_tpu_torch.ops import query_kernels as qk
from docodo_tpu_torch.ops.seqops import INF32

T = torch.as_tensor


def model_merge(vals, pages, lens, va, q_lanes):
    """One row of merge_blocks: vals / pages [nblk * cap] by lane (block k
    at k * cap, garbage past lens[k]); returns the row's (val, page, tag)
    and the largest number of search steps a lane took at one level."""
    nblk = len(lens)
    cap = vals.size // nblk
    n = nblk * cap
    wa = va * cap
    off = np.concatenate([[0], np.cumsum(lens)])
    total = int(off[-1])
    threads = -(-n // q_lanes)
    last = (nblk - 1).bit_length() - 1 if nblk > 1 else 0
    vin, sin = vals.copy(), np.arange(n)
    out_val = np.full(n, -7, np.int64)
    out_page = np.full(n, -7, np.int64)
    out_tag = np.full(n, 9, np.int64)
    steps = 0
    for j in range(last + 1):
        vout = np.full(n, -5, np.int64)  # what no lane writes stays junk
        sout = np.full(n, -5, np.int64)
        for t in range(threads):
            lanes = [t * q_lanes + q for q in range(q_lanes)]
            m, base, dst, up, v, src = [], [], [], [], [], []
            for l in lanes:
                blk = l // cap
                k0 = (blk >> j) << j
                k1 = min(k0 + (1 << j), nblk)
                i = l % cap + (blk - k0) * cap
                live = l < n and i < off[k1] - off[k0]
                left = ((blk >> j) & 1) == 0
                pk0 = k1 if left else k0 - (1 << j)
                pk1 = min(k1 + (1 << j), nblk) if left else k0
                m.append(int(off[pk1] - off[pk0]) if live else 0)
                base.append(pk0 * cap - 1)
                up.append(not left)
                dst.append(((blk >> (j + 1)) << (j + 1)) * cap + i
                           if live else -1)
                v.append(int(vin[l]) if l < n else 0)
                src.append(int(sin[l]) if l < n else 0)
            pos = [0] * q_lanes
            most = max(m)
            step = 1 << (most.bit_length() - 1) if most else 0
            n_steps = 0
            while step:
                n_steps += 1
                for q in range(q_lanes):
                    c = pos[q] + step
                    if c <= m[q]:
                        w = vin[base[q] + c]
                        if w < v[q] or (up[q] and w == v[q]):
                            pos[q] = c
                step >>= 1
            steps = max(steps, n_steps)
            for q in range(q_lanes):
                if dst[q] < 0:
                    continue
                p = dst[q] + pos[q]
                if j == last:
                    out_val[p] = v[q]
                    out_page[p] = pages[src[q]]
                    out_tag[p] = 0 if src[q] < wa else 1
                else:
                    assert vout[p] == -5, "two values in one slot"
                    vout[p], sout[p] = v[q], src[q]
        vin, sin = vout, sout
    out_val[total:], out_page[total:], out_tag[total:] = INF32, 0, 2
    return out_val, out_page, out_tag, steps


def blocks(rng, rows, v, cap, pool):
    """v ascending blocks a row drawn from the row's pool (shared
    coordinates within and across words), ragged lengths with empty and
    full blocks, and garbage past each length."""
    lens = rng.integers(0, cap + 1, size=(rows, v))
    lens[0, 0] = 0
    lens[1 % rows] = cap
    x = rng.integers(-(1 << 30), 1 << 30, size=(rows, v, cap))
    for r in range(rows):
        for k in range(v):
            pick = np.sort(rng.choice(pool.shape[1], lens[r, k],
                                      replace=False))
            x[r, k, : lens[r, k]] = pool[r, pick]
    return x.astype(np.int32), lens.astype(np.int32)


@pytest.mark.parametrize("va,vb,cap,q_lanes", [
    (1, 0, 64, 4),     # one block: the last level is the first
    (2, 0, 512, 4),    # V = 2
    (8, 0, 128, 4),    # the serving shape, 1024 lanes
    (8, 0, 128, 1),    # one lane a thread
    (4, 4, 128, 4),    # W = 2, V 4 + 4
    (2, 2, 32, 4),     # n = 128
    (8, 8, 64, 4),     # 16 blocks
    (32, 0, 32, 4),    # 32 blocks
    (3, 2, 37, 4),     # quads across blocks, runs without a partner
    (5, 0, 6, 1),
])
def test_merge_tree_matches_plain(va, vb, cap, q_lanes):
    rng = np.random.default_rng(va * 100 + vb * 10 + cap)
    rows = 6
    pool = np.cumsum(rng.integers(1, 4, size=(rows, 2 * cap)), axis=1)
    a, na = blocks(rng, rows, va, cap, pool)
    b, nb = blocks(rng, rows, max(vb, 1), cap, pool)
    a_pg = rng.integers(0, 1000, size=a.shape).astype(np.int32)
    b_pg = rng.integers(0, 1000, size=b.shape).astype(np.int32)
    args = (T(a), T(na), T(b), T(nb), T(a_pg), T(b_pg)) if vb else (
        T(a), T(na), None, None, T(a_pg), None)
    want_v, want_t, want_p = (x.numpy() for x in qk.merge_tagged_plain(
        *args))
    most = 0
    for r in range(rows):
        vals = np.concatenate([a[r].ravel()] + ([b[r].ravel()] if vb else []))
        pages = np.concatenate([a_pg[r].ravel()]
                               + ([b_pg[r].ravel()] if vb else []))
        lens = np.concatenate([na[r]] + ([nb[r]] if vb else []))
        got_v, got_p, got_t, steps = model_merge(vals, pages, lens, va,
                                                 q_lanes)
        most = max(most, steps)
        np.testing.assert_array_equal(got_v, want_v[r])
        np.testing.assert_array_equal(got_t, want_t[r])
        live = want_v[r] < INF32
        np.testing.assert_array_equal(got_p[live], want_p[r][live])
        assert (got_p[~live] == 0).all()
    # the chain: a search of each level's partner run, not of every block
    nblk = va + vb
    levels = (nblk - 1).bit_length()
    assert most <= (cap * (1 << max(levels - 1, 0))).bit_length()
