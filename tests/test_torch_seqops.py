"""The port's posting set operations on their own (docodo_tpu_torch.ops
.seqops: pad_to, compact_mask, device_and / device_or, batch_and /
batch_or, device_locate_rank) against the JAX package's
(docodo_tpu/ops/seqops.py) and the host algebra (core/postings), as
tests/test_seqops.py:36-103 holds the JAX ones, on seeded inputs.

Tolerances: coordinates, counts, windows, pages and positions exact;
page ranks within 2 ulp (torch.log and XLA's log differ by 1 ulp on
about 1% of counts on the CPU)."""

import numpy as np
import pytest
import torch

from docodo_tpu.core.postings import group_and, or_merge
from docodo_tpu.ops import seqops as jseq
from docodo_tpu_torch.ops import seqops

from test_torch_slice import f32_ulps


def strict_ascending(rng, n, max_delta=50):
    return np.cumsum(rng.integers(1, max_delta, size=n, dtype=np.int64))


def _run(op, a, b, r1, r2, cap=64, out_cap=None):
    """One pair through the port's op and the JAX package's; both must
    agree on every lane. Returns the port's (kept coords, r)."""
    pa, na = seqops.pad_to(a, cap)
    pb, nb = seqops.pad_to(b, cap)
    out, n, r = getattr(seqops, op)(torch.from_numpy(pa), na, r1,
                                    torch.from_numpy(pb), nb, r2,
                                    out_cap=out_cap)
    jout, jn, jr = getattr(jseq, op)(pa, na, np.int32(r1), pb, nb,
                                     np.int32(r2), out_cap=out_cap)
    assert out.dtype == torch.int32 and n.dim() == 0
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    assert int(n) == int(jn) and int(r) == int(jr)
    return out.numpy()[: int(n)].astype(np.int64), int(r)


def test_pad_to_equals_jax(rng):
    for n, cap in ((0, 8), (5, 8), (8, 8), (13, 8)):
        a = strict_ascending(rng, n)
        got, gn = seqops.pad_to(a, cap)
        want, wn = jseq.pad_to(a, cap)
        assert got.dtype == want.dtype == np.int32 and gn.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        assert gn == wn == min(n, cap)


@pytest.mark.parametrize("ordered", [False, True])
def test_device_and_matches_host(rng, ordered):
    for _ in range(40):
        na, nb = rng.integers(0, 40, size=2)
        a = strict_ascending(rng, int(na))
        b = strict_ascending(rng, int(nb))
        r1 = int(rng.integers(0, 25))
        r2 = int(rng.integers(0, 25))
        if ordered:
            r1, r2 = -max(r1, 1), -max(r2, 1)
        want, wr = group_and(a.astype(np.uint64), b.astype(np.uint64), r1, r2)
        got, gr = _run("device_and", a, b, r1, r2)
        assert gr == wr
        np.testing.assert_array_equal(got, want.astype(np.int64))


def test_device_or_matches_host(rng):
    for _ in range(40):
        na, nb = rng.integers(0, 40, size=2)
        a = strict_ascending(rng, int(na))
        b = strict_ascending(rng, int(nb))
        want, wr = or_merge(a.astype(np.uint64), b.astype(np.uint64), 3, -4)
        got, gr = _run("device_or", a, b, 3, -4)
        assert gr == wr
        np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("op", ["device_and", "device_or"])
@pytest.mark.parametrize("out_cap", [1, 16, 64, 200])
def test_out_cap_truncates_to_the_lowest(rng, op, out_cap):
    """out_cap narrower than the merged stream keeps its out_cap lowest
    coordinates and caps the count; a wider one changes nothing."""
    base = np.cumsum(rng.integers(1, 6, size=60, dtype=np.int64))
    a, b = base[::2], base[1::2]
    full, _ = _run(op, a, b, 10, 10)
    got, _ = _run(op, a, b, 10, 10, out_cap=out_cap)
    np.testing.assert_array_equal(got, full[:out_cap])


@pytest.mark.parametrize("op", ["batch_and", "batch_or"])
def test_batch_forms_equal_jax(rng, op):
    """tests/test_seqops.py:64 twinned (batch_and), and batch_or: rows of
    every length, both window signs, against the JAX package's vmap and
    the host algebra row by row."""
    bsz, cap = 8, 32
    lens = rng.integers(0, cap + 1, size=(2, bsz))
    lens[:, 0] = 20
    pa = np.stack([seqops.pad_to(strict_ascending(rng, n), cap)[0]
                   for n in lens[0]])
    pb = np.stack([seqops.pad_to(strict_ascending(rng, n), cap)[0]
                   for n in lens[1]])
    na, nb = lens.astype(np.int32)
    ra = np.where(np.arange(bsz) % 3 == 0, -10, 10).astype(np.int32)
    rb = np.full(bsz, 10, dtype=np.int32)
    out, n, r = getattr(seqops, op)(*map(torch.from_numpy,
                                         (pa, na, ra, pb, nb, rb)))
    jout, jn, jr = getattr(jseq, op)(pa, na, ra, pb, nb, rb)
    assert out.shape == (bsz, 2 * cap)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
    host = group_and if op == "batch_and" else or_merge
    for q in range(bsz):
        want, wr = host(pa[q, : na[q]].astype(np.uint64),
                        pb[q, : nb[q]].astype(np.uint64), int(ra[q]),
                        int(rb[q]))
        np.testing.assert_array_equal(out[q, : int(n[q])].numpy(),
                                      want.astype(np.int64))
        assert int(r[q]) == wr


@pytest.mark.parametrize("ordered", [False, True])
def test_device_and_cross_operand_collisions(rng, ordered):
    """tests/test_seqops.py:103 twinned: coordinates shared by both
    operands."""
    for _ in range(25):
        base = np.cumsum(rng.integers(1, 30, size=40, dtype=np.int64))
        a = base[rng.random(40) < 0.7]
        b = base[rng.random(40) < 0.7]
        if a.size == 0 or b.size == 0:
            continue
        r1, r2 = int(rng.integers(1, 25)), int(rng.integers(1, 25))
        if ordered:
            r1, r2 = -r1, -r2
        want, wr = group_and(a.astype(np.uint64), b.astype(np.uint64), r1, r2)
        got, gr = _run("device_and", a, b, r1, r2)
        assert gr == wr
        np.testing.assert_array_equal(got, want.astype(np.int64))


def test_device_locate_rank_equals_jax():
    """tests/test_seqops.py:81 twinned, then seeded streams against the
    JAX package's: every lane's page, position and first-hit mark exact,
    ranks within 2 ulp; max_pages under the number of runs drops the
    later runs as the JAX package's segment_sum does."""
    from docodo_tpu.query.search import ResultDocPage

    bounds = np.array([100, 250, 400, 900], dtype=np.int32)
    page_doc = np.array([0, 0, 1, 1], dtype=np.int32)
    coords = np.array([5, 8, 40, 120, 260, 270, 300], dtype=np.int32)
    pc, n = seqops.pad_to(coords, 16)
    page, pos, first, rank = seqops.device_locate_rank(
        torch.from_numpy(pc), n, torch.from_numpy(bounds),
        torch.from_numpy(page_doc), max_pages=16)
    np.testing.assert_array_equal(page[:7].numpy(), [0, 0, 0, 1, 2, 2, 2])
    np.testing.assert_array_equal(pos[:7].numpy(), [5, 8, 40, 20, 10, 20, 50])
    assert abs(float(rank[0]) - ResultDocPage("1", [5, 8, 40]).rank) < 1e-4

    rng = np.random.default_rng(17)
    bounds = np.cumsum(rng.integers(20, 400, size=60)).astype(np.int32)
    page_doc = np.repeat(np.arange(20), 3).astype(np.int32)
    for n, cap, max_pages in ((0, 64, 8), (1, 64, 8), (50, 64, 64),
                              (64, 64, 64), (200, 256, 16), (256, 256, 7)):
        c = np.sort(rng.choice(int(bounds[-1]) + 50, size=n, replace=False))
        pc, pn = seqops.pad_to(c, cap)
        got = seqops.device_locate_rank(
            torch.from_numpy(pc), pn, torch.from_numpy(bounds),
            torch.from_numpy(page_doc), max_pages=max_pages)
        want = jseq.device_locate_rank(pc, pn, bounds, page_doc,
                                       max_pages=max_pages)
        for name, g, w in zip(("page", "pos", "first"), got[:3], want[:3]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=name)
        assert got[0].dtype == got[1].dtype == torch.int32
        assert got[3].dtype == torch.float32
        assert f32_ulps(got[3].numpy(), np.asarray(want[3])) <= 2


def test_compact_mask_equals_jax(rng):
    """compact_mask against the JAX package's (its sort branch and, past
    2 x the compare-all bound, the same): out_cap under, at and over the
    stream's width, with rows of none, some and every lane masked."""
    p = 48
    vals = np.sort(rng.choice(10_000, size=p, replace=False)).astype(np.int32)
    for frac in (0.0, 0.4, 1.0):
        mask = rng.random(p) < frac
        for out_cap in (1, 17, p, p + 9):
            got = seqops.compact_mask(torch.from_numpy(vals),
                                      torch.from_numpy(mask), out_cap)
            want = jseq.compact_mask(vals, mask, out_cap)
            assert got.shape == (out_cap,)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    rows = np.sort(rng.integers(0, 500, size=(5, p)), axis=1).astype(np.int32)
    masks = rng.random((5, p)) < 0.5
    got = seqops.compact_mask(torch.from_numpy(rows),
                              torch.from_numpy(masks), 20)
    for q in range(5):
        np.testing.assert_array_equal(
            got[q].numpy(), np.asarray(jseq.compact_mask(rows[q], masks[q],
                                                         20)))
