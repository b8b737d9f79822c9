"""The port's three full-result kernel wrappers against the JAX package's
Pallas kernels (interpret mode on the CPU), where the wrappers take their
plain PyTorch versions. The CUDA kernels against their plain versions
are in test_torch_cuda.py.

Tolerances: int fields and hits exact; ranks within 2 ulp, because
torch.log and XLA's log differ by 1 ulp on about 1% of counts on the
CPU."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from docodo_tpu.ops import pallas_query as pq
from docodo_tpu.ops.seqops import pad_to
from docodo_tpu_torch.ops import query_kernels as qk

FIELDS = ("pages", "ranks", "counts", "n_pages", "n_hits", "hits")
RANK_ULPS = 2


def f32_ulps(a, b) -> int:
    a = np.ascontiguousarray(a, dtype=np.float32).view(np.int32)
    b = np.ascontiguousarray(b, dtype=np.float32).view(np.int32)
    return int(np.abs(a.astype(np.int64) - b).max()) if a.size else 0


def assert_outputs_equal(got, want, what=""):
    """Six-field kernel outputs: ranks within RANK_ULPS, the rest exact
    (counts are exact integers in either dtype)."""
    for field, g, w in zip(FIELDS, got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, (what, field, g.shape, w.shape)
        if field == "ranks":
            assert f32_ulps(g, w) <= RANK_ULPS, (what, field)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {field}")


def _random_batch(rng, bsz, cap):
    """Posting blocks with shared coordinates, empty and full rows, and
    ordered and unordered windows."""
    a = np.zeros((bsz, cap), np.int32)
    b = np.zeros((bsz, cap), np.int32)
    na = np.zeros(bsz, np.int32)
    nb = np.zeros(bsz, np.int32)
    for i in range(bsz):
        pool = np.cumsum(rng.integers(1, 30, size=2 * cap))
        la = cap if i % 5 == 2 else (0 if i % 7 == 0 else
                                     int(rng.integers(1, cap)))
        lb = cap if i % 5 == 2 else (0 if i % 7 == 1 else
                                     int(rng.integers(1, cap)))
        xa = np.sort(rng.choice(pool, size=la, replace=False))
        xb = np.sort(rng.choice(pool, size=lb, replace=False))
        a[i], na[i] = pad_to(xa, cap)
        b[i], nb[i] = pad_to(xb, cap)
    ra = np.where(np.arange(bsz) % 2 == 0, 25, -25).astype(np.int32)
    rb = np.where(np.arange(bsz) % 2 == 0, 20, -20).astype(np.int32)
    return a, na, ra, b, nb, rb


def _pages(x, bounds):
    return np.minimum(np.searchsorted(bounds, x, side="right"),
                      bounds.size - 1).astype(np.int32)


BOUNDS = np.arange(1, 80, dtype=np.int32) * 60
T = torch.as_tensor
J = jnp.asarray


@pytest.mark.parametrize("cap,hit_cap,tail,pages", [
    (64, 100, False, "carried"),
    (64, 100, True, "shared"),
    (128, 512, False, "shared"),
    (128, 512, True, "carried"),
    (64, 100, False, "none"),
    (256, 512, True, "carried"),
    (512, 1024, False, "shared"),
])
def test_sorted_and_locate_full_matches_pallas(rng, cap, hit_cap, tail,
                                               pages):
    bsz, topk = 16, 8
    a, na, ra, b, nb, rb = _random_batch(rng, bsz, cap)
    carried = pages == "carried"
    apg = _pages(a, BOUNDS) if carried else None
    bpg = _pages(b, BOUNDS) if carried else None
    want = pq.pallas_sorted_and_locate_full(
        J(a), J(na), J(ra), J(b), J(nb), J(rb), J(BOUNDS), cap=cap,
        topk=topk, hit_cap=hit_cap, interpret=True, sort_topk=True,
        a_pg=None if apg is None else J(apg),
        b_pg=None if bpg is None else J(bpg),
        shared_pg=pages == "shared", tail=tail)
    got = qk.sorted_and_locate_full(
        T(a), T(na), T(ra), T(b), T(nb), T(rb), T(BOUNDS), topk=topk,
        hit_cap=hit_cap, a_pg=None if apg is None else T(apg),
        b_pg=None if bpg is None else T(bpg), tail=tail)
    assert_outputs_equal(got, want, f"cap {cap}")
    # the runs past kpad and both window signs were exercised
    assert (np.asarray(got[3]) > topk).any()
    assert (np.asarray(got[4]) > 0).any()


# (cap, hit_cap, tail, pages, lengths): "mixed" is _random_batch's; "ends"
# a batch of only empty and full rows (the keep's two ends)
@pytest.mark.parametrize("cap,hit_cap,tail,pages,lengths", [
    (64, 32, False, "carried", "mixed"),
    (128, 512, True, "shared", "mixed"),
    (64, 64, False, "carried", "ends"),
    (128, 100, True, "carried", "ends"),
])
def test_single_locate_full_matches_pallas(rng, cap, hit_cap, tail, pages,
                                           lengths):
    bsz, topk = 16, 8
    a, na, *_ = _random_batch(rng, bsz, cap)
    if lengths == "ends":
        na = np.where(np.arange(bsz) % 2 == 0, 0, cap).astype(np.int32)
    apg = _pages(a, BOUNDS) if pages == "carried" else None
    want = pq.pallas_single_locate_full(
        J(a), J(na), J(BOUNDS), cap=cap, topk=topk, hit_cap=hit_cap,
        interpret=True, sort_topk=True,
        a_pg=None if apg is None else J(apg),
        shared_pg=pages == "shared", tail=tail)
    got = qk.single_locate_full(
        T(a), T(na), T(BOUNDS), topk=topk, hit_cap=hit_cap,
        a_pg=None if apg is None else T(apg), tail=tail)
    assert_outputs_equal(got, want, f"cap {cap}")
    if lengths == "ends":
        np.testing.assert_array_equal(np.asarray(got[4]), na)


@pytest.mark.parametrize("cap,hit_cap,tail,pages", [
    (256, 128, False, "carried"),
    (256, 512, True, "shared"),
    (512, 512, False, "carried"),
    (1024, 1024, True, "carried"),
])
def test_union_locate_full_matches_pallas(rng, cap, hit_cap, tail, pages):
    bsz, topk = 8, 8
    a, na, *_ = _random_batch(rng, bsz, cap)
    apg = _pages(a, BOUNDS)[:, None] if pages == "carried" else None
    want = pq.pallas_union_locate_full(
        J(a)[:, None], J(na)[:, None], J(BOUNDS), topk=topk,
        hit_cap=hit_cap, interpret=True, sort_topk=True,
        a_pg=None if apg is None else J(apg),
        shared_pg=pages == "shared", tail=tail)
    got = qk.union_locate_full(
        T(a)[:, None], T(na)[:, None], T(BOUNDS), topk=topk,
        hit_cap=hit_cap, a_pg=None if apg is None else T(apg), tail=tail)
    assert_outputs_equal(got, want, f"cap {cap}")


def test_union_rejects_variants(rng):
    """union_locate_full once refused V > 1; it now serves V = 2 (the
    carried in-kernel merge route of pallas_union_locate_full) and V = 4
    (its sort route) equal to the Pallas function."""
    bsz, topk, hit_cap = 16, 8, 200
    for v, cap in ((2, 256), (4, 128)):
        pairs = [_random_batch(rng, bsz, cap) for _ in range(v // 2)]
        a = np.stack([x for p in pairs for x in (p[0], p[3])], axis=1)
        na = np.stack([x for p in pairs for x in (p[1], p[4])], axis=1)
        apg = _pages(a, BOUNDS)
        want = pq.pallas_union_locate_full(
            J(a), J(na), J(BOUNDS), topk=topk, hit_cap=hit_cap,
            interpret=True, sort_topk=True, a_pg=J(apg), tail=False)
        got = qk.union_locate_full(T(a), T(na), T(BOUNDS), topk=topk,
                                   hit_cap=hit_cap, a_pg=T(apg), tail=False)
        assert_outputs_equal(got, want, f"V {v}")
        assert (np.asarray(got[3]) > topk).any()


def test_wrappers_refuse_other_devices():
    """The plain version serves CPU tensors only: a tensor elsewhere
    gets its kernel or an error, never the plain version."""
    a = torch.zeros((8, 64), dtype=torch.int32, device="meta")
    n = torch.zeros(8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        qk.single_locate_full(a, n, torch.zeros(4, dtype=torch.int32,
                                                device="meta"),
                              topk=8, hit_cap=64, a_pg=a)
