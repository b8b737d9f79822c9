"""The port's page-level kernel wrappers (sorted_and_locate,
batched_single_locate, batched_and_locate) against the JAX package's
Pallas kernels in interpret mode and its XLA locate_topk_masked, on the
CPU, where the wrappers take their plain PyTorch versions. The CUDA
kernels against their plain versions are in test_torch_cuda.py.

Every batch holds empty rows, a row with one operand only, a
cross-operand duplicate, rows from one shared pool (shared coordinates),
ordered and unordered windows, and rows where more runs than topk tie at
one rank. Tolerances: pages and counts exact; ranks within 2 ulp,
because torch.log and XLA's log differ by 1 ulp on about 1% of counts on
the CPU."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from docodo_tpu.ops import device_index as jdi
from docodo_tpu.ops import pallas_query as pq
from docodo_tpu.ops.seqops import and_masked as jax_and_masked
from docodo_tpu_torch.ops import device_index as tdi
from docodo_tpu_torch.ops import query_kernels as qk

INF32 = 2**31 - 1
RANK_ULPS = 2
BSZ = 16
BOUNDS = np.arange(1, 80, dtype=np.int32) * 60
T = torch.as_tensor
J = jnp.asarray


def f32_ulps(a, b) -> int:
    a = np.ascontiguousarray(a, dtype=np.float32).view(np.int32)
    b = np.ascontiguousarray(b, dtype=np.float32).view(np.int32)
    return int(np.abs(a.astype(np.int64) - b).max()) if a.size else 0


def assert_topk_equal(got, want, what=""):
    """(pages, ranks, counts): ranks within RANK_ULPS, the rest exact,
    dtypes as the JAX package's (counts int32)."""
    for field, g, w in zip(("pages", "ranks", "counts"), got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, (what, field)
        if field == "ranks":
            assert f32_ulps(g, w) <= RANK_ULPS, (what, field)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {field}")


def _pad(x, cap):
    out = np.full(cap, INF32, np.int32)
    out[: len(x)] = x
    return out, len(x)


def page_batch(rng, cap):
    """[BSZ, cap] posting blocks a / b with lengths and windows. Rows 0-2
    are test_pallas_query's degenerate rows (empty; word A only; one
    shared coordinate), rows 3-4 hold one two-hit run on every page, so
    that every run ties (row 4 ordered), and the rest draw both operands
    from one pool per row (cross-operand duplicates), ordered on every
    second row, full on every fifth."""
    a = np.full((BSZ, cap), INF32, np.int32)
    b = np.full((BSZ, cap), INF32, np.int32)
    na = np.zeros(BSZ, np.int32)
    nb = np.zeros(BSZ, np.int32)
    a[1, 0], na[1] = 5, 1
    a[2, 0] = b[2, 0] = 7
    na[2] = nb[2] = 1
    k = np.arange(min(cap, BOUNDS.size - 1))
    for row in (3, 4):
        a[row], na[row] = _pad(60 * k + 5, cap)
        b[row], nb[row] = _pad(60 * k + 7, cap)
    for i in range(5, BSZ):
        pool = np.cumsum(rng.integers(1, 30, size=2 * cap))
        la = cap if i % 5 == 2 else int(rng.integers(1, cap))
        lb = cap if i % 5 == 2 else int(rng.integers(1, cap))
        a[i], na[i] = _pad(np.sort(rng.choice(pool, la, replace=False)), cap)
        b[i], nb[i] = _pad(np.sort(rng.choice(pool, lb, replace=False)), cap)
    ordered = np.arange(BSZ) % 2 == 0
    ra = np.where(ordered, -25, 25).astype(np.int32)
    rb = np.where(ordered, -20, 20).astype(np.int32)
    return a, na, ra, b, nb, rb


def _pages(x):
    return np.minimum(np.searchsorted(BOUNDS, x, side="right"),
                      BOUNDS.size - 1).astype(np.int32)


def _tied_at_cut(ranks, pages, topk) -> bool:
    """Some row's last served rank equals its next-to-last: a tie at the
    cut of a full row."""
    r = np.asarray(ranks)
    full = np.asarray(pages)[:, -1] >= 0
    return bool((full & (r[:, -1] == r[:, -2])).any()) if topk > 1 else False


@pytest.mark.parametrize("cap,topk,pages", [
    (64, 8, "carried"), (64, 8, "shared"), (64, 8, "bounds"),
    (128, 16, "carried"), (16, 64, "bounds"),
    # every stream width the kernel dispatches on (N = 512 and 1024)
    (256, 16, "carried"), (256, 16, "bounds"), (512, 16, "carried"),
    (512, 16, "bounds"),
])
def test_sorted_and_locate_matches_pallas(rng, cap, topk, pages):
    a, na, ra, b, nb, rb = page_batch(rng, cap)
    carried = pages == "carried"
    want = pq.pallas_sorted_and_locate(
        J(a), J(na), J(ra), J(b), J(nb), J(rb), J(BOUNDS), cap=cap,
        topk=topk, interpret=True,
        a_pg=J(_pages(a)) if carried else None,
        b_pg=J(_pages(b)) if carried else None, shared_pg=pages == "shared")
    got = qk.sorted_and_locate(
        T(a), T(na), T(ra), T(b), T(nb), T(rb), T(BOUNDS), topk=topk,
        a_pg=T(_pages(a)) if carried else None,
        b_pg=T(_pages(b)) if carried else None)
    assert_topk_equal(got, want, f"cap {cap} {pages}")
    pg = np.asarray(got[0])
    assert (pg[0] == -1).all() and (pg[1] == -1).all() and pg[2, 0] == 0
    if topk < 2 * cap:
        assert _tied_at_cut(got[1], got[0], topk)
    else:  # topk past the stream: padded, never an error
        assert pg.shape == (BSZ, topk) and (pg[:, 2 * cap:] == -1).all()


@pytest.mark.parametrize("cap,topk,pages", [
    (64, 8, "carried"), (64, 8, "shared"), (128, 16, "bounds"),
    (32, 64, "carried"),
])
def test_batched_single_locate_matches_pallas(rng, cap, topk, pages):
    a, na, *_ = page_batch(rng, cap)
    carried = pages == "carried"
    want = pq.pallas_batched_single_locate(
        J(a), J(na), J(BOUNDS), cap=cap, topk=topk, interpret=True,
        a_pg=J(_pages(a)) if carried else None, shared_pg=pages == "shared")
    got = qk.batched_single_locate(T(a), T(na), T(BOUNDS), topk=topk,
                                   a_pg=T(_pages(a)) if carried else None)
    assert_topk_equal(got, want, f"cap {cap} {pages}")
    pg, ct = np.asarray(got[0]), np.asarray(got[2])
    assert (pg[0] == -1).all() and pg[1, 0] == 0 and ct[1, 0] == 1
    if topk < cap:
        # row 3 holds one hit on each of cap pages: all tie at rank 1.0,
        # and the lowest lanes (pages) win
        np.testing.assert_array_equal(pg[3], np.arange(topk))
        assert (np.asarray(got[1])[3] == 1.0).all()
    else:
        assert (pg[:, cap:] == -1).all()


@pytest.mark.parametrize("cap,topk", [(32, 8), (64, 16)])
def test_batched_and_locate_matches_pallas(rng, cap, topk):
    """The compare-all merge kernel (row 17 of PERF.md's table) computes
    sorted_and_locate's function from bounds; one CUDA kernel serves
    both."""
    a, na, ra, b, nb, rb = page_batch(rng, cap)
    want = pq.pallas_batched_and_locate(
        J(a), J(na), J(ra), J(b), J(nb), J(rb), J(BOUNDS), cap=cap,
        topk=topk, interpret=True)
    args = (T(a), T(na), T(ra), T(b), T(nb), T(rb), T(BOUNDS))
    got = qk.batched_and_locate(*args, topk=topk)
    assert_topk_equal(got, want, f"cap {cap}")
    assert_topk_equal(qk.batched_and_locate_plain(*args, topk=topk), want)
    assert _tied_at_cut(got[1], got[0], topk)


@pytest.mark.parametrize("cap,topk", [(64, 8), (32, 16)])
def test_plain_versions_match_locate_topk_masked(rng, cap, topk):
    """The plain versions against the JAX package's XLA route: and_masked
    and locate_topk_masked, row by row under vmap."""
    a, na, ra, b, nb, rb = page_batch(rng, cap)

    def one(a_, na_, ra_, b_, nb_, rb_):
        vals, keep, _ = jax_and_masked(a_, na_, ra_, b_, nb_, rb_)
        return jdi.locate_topk_masked(vals, keep, J(BOUNDS), topk)

    want = jax.vmap(one)(J(a), J(na), J(ra), J(b), J(nb), J(rb))
    got = qk.sorted_and_locate_plain(
        T(a), T(na), T(ra), T(b), T(nb), T(rb), T(BOUNDS), topk=topk,
        a_pg=T(_pages(a)), b_pg=T(_pages(b)))
    assert_topk_equal(got, want, "W=2")

    def single(a_, na_):
        keep = jnp.arange(cap) < na_
        return jdi.locate_topk_masked(jnp.where(keep, a_, INF32), keep,
                                      J(BOUNDS), topk)

    want = jax.vmap(single)(J(a), J(na))
    got = qk.batched_single_locate_plain(T(a), T(na), T(BOUNDS), topk=topk)
    assert_topk_equal(got, want, "W=1")


def test_locate_topk_masked_matches_jax(rng):
    """The torch route's locate_topk_masked and locate_topk on masked
    streams with holes, against the JAX package's."""
    n, topk = 96, 8
    vals = np.sort(rng.integers(0, 4000, size=(BSZ, n)), axis=1) \
        .astype(np.int32)
    keep = rng.random((BSZ, n)) < 0.6
    keep[0] = False
    keep[1] = True
    want = jax.vmap(lambda v, k: jdi.locate_topk_masked(
        v, k, J(BOUNDS), topk))(J(vals), J(keep))
    got = tdi.locate_topk_masked(T(vals), T(keep), T(BOUNDS), topk)
    assert_topk_equal(got, want, "masked")
    lens = rng.integers(0, n + 1, BSZ).astype(np.int32)
    want = jax.vmap(lambda v, m: jdi.locate_topk(
        v, m, J(BOUNDS), None, topk))(J(vals), J(lens))
    got = tdi.locate_topk(T(vals), T(lens), T(BOUNDS), None, topk)
    assert_topk_equal(got, want, "dense")
    # topk past the stream pads where lax.top_k would refuse
    pg, rk, ct = tdi.locate_topk_masked(T(vals), T(keep), T(BOUNDS), 2 * n)
    assert pg.shape == (BSZ, 2 * n) and bool((pg[:, n:] == -1).all())
    assert bool((rk[:, n:] == 0).all()) and ct.dtype == torch.int32


def test_page_wrappers_refuse_what_they_cannot_take():
    """Caps past admission raise, and a tensor on another device than
    the CPU or a card gets no plain version."""
    z = lambda *s: torch.zeros(s, dtype=torch.int32)
    with pytest.raises(ValueError, match="caps <= 512"):
        qk.sorted_and_locate(z(8, 1024), z(8), z(8), z(8, 1024), z(8), z(8),
                             z(4), topk=8)
    with pytest.raises(ValueError, match="caps <= 128"):
        qk.batched_single_locate(z(8, 256), z(8), z(4), topk=8)
    with pytest.raises(ValueError, match="both page streams"):
        qk.sorted_and_locate(z(8, 64), z(8), z(8), z(8, 64), z(8), z(8),
                             z(4), topk=8, a_pg=z(8, 64))
    m = lambda *s: torch.zeros(s, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        qk.batched_single_locate(m(8, 64), m(8), m(4), topk=8)
