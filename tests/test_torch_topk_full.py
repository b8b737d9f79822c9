"""The port's top-k-mode full-result wrappers (sort_topk=False),
merge_and_locate and the stream tails against the JAX package's Pallas
functions in interpret mode on the CPU, where the wrappers take their
plain PyTorch versions. The CUDA kernels against these plain versions
are in test_torch_cuda.py.

The top-k mode returns the true top k over every page run of a row,
where the slot mode ranks a row's first topk runs: the two differ only
on rows with n_pages > topk, and both are held here.

Tolerances: int fields and hits exact; ranks within 2 ulp, because
torch.log and XLA's log differ by 1 ulp on about 1% of counts on the
CPU."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from docodo_tpu.ops import pallas_query as pq
from docodo_tpu.ops.seqops import INF32
from docodo_tpu_torch.ops import query_kernels as qk

from test_torch_kernels import (
    BOUNDS,
    _pages,
    _random_batch,
    assert_outputs_equal,
    f32_ulps,
)

T = torch.as_tensor
J = jnp.asarray


def _topks(n: int, pages: str):
    """topk 8 cuts most rows; with carried pages also 64, which cuts
    some, and for a stream of up to 128 lanes a topk past its width (the
    Pallas kernel unrolls topk passes: a wide one compiles slowly)."""
    if pages != "carried":
        return (8,)
    return (8, 64, n + 8) if n <= 128 else (8, 64)


def _spread_batch(rng, bsz, cap):
    """_random_batch with every third row stepping about a page a hit, so
    most of its runs hold one hit and tie at rank 1.0, and an all-padding
    row at the end (a bucket's bpad row)."""
    a, na, ra, b, nb, rb = _random_batch(rng, bsz, cap)
    for i in range(1, bsz, 3):
        pool = np.cumsum(rng.integers(50, 70, size=2 * cap))
        a[i, : na[i]] = np.sort(rng.choice(pool, size=na[i], replace=False))
        b[i, : nb[i]] = np.sort(rng.choice(pool, size=nb[i], replace=False))
    na[-1] = nb[-1] = 0
    return a, na, ra, b, nb, rb


def _page_args(pages, *blocks):
    if pages != "carried":
        return [None] * len(blocks)
    return [_pages(x, BOUNDS) for x in blocks]


def _opt(f, x):
    return None if x is None else f(x)


def _check_modes(got, slot, topk, what):
    """The top-k mode equals the slot mode on every row it serves whole,
    and the batch holds rows where they must differ."""
    n_pages = np.asarray(got[3])
    served = n_pages <= topk
    for g, s in zip(got[:3], slot[:3]):
        np.testing.assert_array_equal(np.asarray(g)[served],
                                      np.asarray(s)[served], err_msg=what)
    for g, s in zip(got[3:], slot[3:]):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(s),
                                      err_msg=what)
    return int((~served).sum())


@pytest.mark.parametrize("cap,hit_cap,pages", [
    (64, 100, "carried"),
    (64, 1024, "shared"),
    (128, 64, "carried"),
    (128, 512, "none"),
])
def test_sorted_and_topk_mode_matches_pallas(rng, cap, hit_cap, pages):
    bsz = 16
    a, na, ra, b, nb, rb = _spread_batch(rng, bsz, cap)
    apg, bpg = _page_args(pages, a, b)
    cut = 0
    for topk in _topks(2 * cap, pages):
        want = pq.pallas_sorted_and_locate_full(
            J(a), J(na), J(ra), J(b), J(nb), J(rb), J(BOUNDS), cap=cap,
            topk=topk, hit_cap=hit_cap, interpret=True, sort_topk=False,
            a_pg=_opt(J, apg), b_pg=_opt(J, bpg),
            shared_pg=pages == "shared")
        kw = dict(topk=topk, hit_cap=hit_cap, a_pg=_opt(T, apg),
                  b_pg=_opt(T, bpg))
        args = (T(a), T(na), T(ra), T(b), T(nb), T(rb), T(BOUNDS))
        got = qk.sorted_and_locate_full(*args, sort_topk=False, **kw)
        assert_outputs_equal(got, want, f"cap {cap} topk {topk}")
        assert got[2].dtype == torch.int32
        cut += _check_modes(got, qk.sorted_and_locate_full(*args, **kw),
                            topk, f"cap {cap} topk {topk}")
    assert cut > 0 and (np.asarray(got[3]) == 0).any()


@pytest.mark.parametrize("cap,hit_cap,pages", [
    (64, 32, "carried"),
    (128, 512, "shared"),
    (128, 128, "none"),
])
def test_single_topk_mode_matches_pallas(rng, cap, hit_cap, pages):
    bsz = 16
    a, na, *_ = _spread_batch(rng, bsz, cap)
    (apg,) = _page_args(pages, a)
    cut = 0
    for topk in _topks(cap, pages):
        want = pq.pallas_single_locate_full(
            J(a), J(na), J(BOUNDS), cap=cap, topk=topk, hit_cap=hit_cap,
            interpret=True, sort_topk=False, a_pg=_opt(J, apg),
            shared_pg=pages == "shared")
        kw = dict(topk=topk, hit_cap=hit_cap, a_pg=_opt(T, apg))
        got = qk.single_locate_full(T(a), T(na), T(BOUNDS), sort_topk=False,
                                    **kw)
        assert_outputs_equal(got, want, f"cap {cap} topk {topk}")
        cut += _check_modes(got, qk.single_locate_full(T(a), T(na), T(BOUNDS),
                                                       **kw),
                            topk, f"cap {cap} topk {topk}")
    assert cut > 0


def _variant_blocks(rng, bsz, v, cap):
    pairs = [_spread_batch(rng, bsz, cap) for _ in range((v + 1) // 2)]
    a = np.stack([x for p in pairs for x in (p[0], p[3])][:v], axis=1)
    na = np.stack([x for p in pairs for x in (p[1], p[4])][:v], axis=1)
    return a, na


@pytest.mark.parametrize("v,cap,hit_cap,pages", [
    (1, 128, 64, "carried"),
    (1, 256, 128, "carried"),
    (1, 512, 1024, "shared"),
    (1, 1024, 1024, "none"),
    (2, 128, 200, "carried"),
    (4, 64, 512, "none"),
    (8, 64, 300, "carried"),
])
def test_union_topk_mode_matches_pallas(rng, v, cap, hit_cap, pages):
    bsz = 8
    a, na = _variant_blocks(rng, bsz, v, cap)
    (apg,) = _page_args(pages, a)
    cut = 0
    for topk in _topks(v * cap, pages):
        want = pq.pallas_union_locate_full(
            J(a), J(na), J(BOUNDS), topk=topk, hit_cap=hit_cap,
            interpret=True, sort_topk=False, a_pg=_opt(J, apg),
            shared_pg=pages == "shared")
        kw = dict(topk=topk, hit_cap=hit_cap, a_pg=_opt(T, apg))
        got = qk.union_locate_full(T(a), T(na), T(BOUNDS), sort_topk=False,
                                   **kw)
        assert_outputs_equal(got, want, f"V {v} topk {topk}")
        cut += _check_modes(got, qk.union_locate_full(T(a), T(na), T(BOUNDS),
                                                      **kw),
                            topk, f"V {v} topk {topk}")
    assert cut > 0


@pytest.mark.parametrize("va,vb,cap,hit_cap,pages", [
    (1, 1, 64, 300, "carried"),
    (2, 2, 64, 100, "carried"),
    (2, 2, 128, 1024, "shared"),
    (4, 4, 64, 512, "carried"),
    (1, 2, 128, 64, "none"),
])
def test_variants_and_topk_mode_matches_pallas(rng, va, vb, cap, hit_cap,
                                               pages):
    bsz = 16
    a, na = _variant_blocks(rng, bsz, va, cap)
    b, nb = _variant_blocks(rng, bsz, vb, cap)
    bpad = np.arange(bsz) % 5 == 3
    nb[bpad] = 0
    ra = np.where(np.arange(bsz) % 2 == 0, 25, -25).astype(np.int32)
    rb = np.where(np.arange(bsz) % 2 == 0, 20, -20).astype(np.int32)
    apg, bpg = _page_args(pages, a, b)
    cut = 0
    for topk in _topks((va + vb) * cap, pages):
        want = pq.pallas_variants_and_locate_full(
            J(a), J(na), J(ra), J(b), J(nb), J(rb), J(bpad), J(BOUNDS),
            topk=topk, hit_cap=hit_cap, interpret=True, sort_topk=False,
            a_pg=_opt(J, apg), b_pg=_opt(J, bpg),
            shared_pg=pages == "shared")
        args = (T(a), T(na), T(ra), T(b), T(nb), T(rb), T(bpad), T(BOUNDS))
        kw = dict(topk=topk, hit_cap=hit_cap, a_pg=_opt(T, apg),
                  b_pg=_opt(T, bpg))
        got = qk.variants_and_locate_full(*args, sort_topk=False, **kw)
        assert_outputs_equal(got, want, f"V {va}+{vb} topk {topk}")
        cut += _check_modes(got, qk.variants_and_locate_full(*args, **kw),
                            topk, f"V {va}+{vb} topk {topk}")
    assert cut > 0 and (np.asarray(got[4]) > 0).any()


def test_topk_mode_ties_go_to_the_lowest_lane(rng):
    """A row of one hit a page: every run ranks 1.0, and the top k are
    the first k pages in lane order in both packages."""
    cap, topk = 128, 8
    a = (np.arange(cap, dtype=np.int32) * 60 + 5)[None, :].repeat(8, axis=0)
    na = np.full(8, 70, np.int32)
    want = pq.pallas_single_locate_full(
        J(a), J(na), J(BOUNDS), cap=cap, topk=topk, hit_cap=64,
        interpret=True, sort_topk=False)
    got = qk.single_locate_full(T(a), T(na), T(BOUNDS), topk=topk,
                                hit_cap=64, sort_topk=False)
    assert_outputs_equal(got, want, "tied row")
    pages = np.asarray(got[0])
    assert (np.asarray(got[1]) == 1.0).all() and (got[3] > topk).all()
    np.testing.assert_array_equal(pages[0], np.sort(pages[0]))


@pytest.mark.parametrize("wrapper,args", [
    ("sorted_and_locate_full", 7), ("single_locate_full", 3),
    ("union_locate_full", 3), ("union_merge_locate_full", 3),
    ("variants_and_locate_full", 8),
])
def test_topk_mode_refuses_tail_false(wrapper, args):
    with pytest.raises(ValueError, match="tail=False"):
        getattr(qk, wrapper)(*[None] * args, topk=8, hit_cap=8, tail=False,
                             sort_topk=False)


def _fused_inputs(rng, cap, bsz=12):
    """The inputs of tests/test_pallas_query.py's
    test_merge_and_locate_matches_three_stage."""
    bounds = np.concatenate([
        [0], np.sort(rng.choice(np.arange(1, 30 * cap), size=40,
                                replace=False))]).astype(np.int32)
    a = np.full((bsz, cap), INF32, np.int32)
    b = np.full((bsz, cap), INF32, np.int32)
    na = rng.integers(0, cap + 1, bsz).astype(np.int32)
    nb = rng.integers(0, cap + 1, bsz).astype(np.int32)
    na[0] = 0
    nb[1] = 0
    na[2] = nb[2] = cap
    pool = np.arange(0, 8 * cap) * 3  # duplicates across operands
    for i in range(bsz):
        a[i, : na[i]] = np.sort(rng.choice(pool, na[i], replace=False))
        b[i, : nb[i]] = np.sort(rng.choice(pool, nb[i], replace=False))

    def pg_of(x):
        return np.where(
            x < INF32,
            np.maximum(np.searchsorted(bounds, x, side="right") - 1, 0),
            INF32).astype(np.int32)

    ra = rng.integers(1, 40, (bsz, 1)).astype(np.int32)
    rb = rng.integers(1, 40, (bsz, 1)).astype(np.int32)
    ra[3:5] = -ra[3:5]  # ordered rows
    rb[3:5] = -np.abs(rb[3:5])
    return a, na, ra, b, nb, rb, pg_of(a), pg_of(b)


@pytest.mark.parametrize("cap", [64, 256, 1024])
def test_merge_and_locate_matches_pallas(rng, cap):
    a, na, ra, b, nb, rb, apg, bpg = _fused_inputs(rng, cap)
    want = pq.pallas_merge_and_locate(
        J(a), J(na), J(b), J(nb), J(apg), J(bpg), J(ra), J(rb), cap=cap,
        interpret=True)
    got = qk.merge_and_locate(T(a), T(na), T(ra[:, 0]), T(b), T(nb),
                              T(rb[:, 0]), T(apg), T(bpg))
    for name, g, w in zip(("hits", "page_s", "rank_s", "cnt_s"), got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if name == "rank_s":
            assert f32_ulps(g, w) <= 2
            np.testing.assert_array_equal(g > 0, w > 0)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    assert (got[0][3:5] < INF32).any() and (got[0][0] == INF32).all()

    # the tails over the streams: torch ops in both packages
    for topk in (16, 4 * cap):
        ws = pq.compact_streams_topk(*want[1:], topk)
        gs = qk.compact_streams_topk(*got[1:], topk)
        wl = pq.locate_streams_topk(*want[1:], topk, a.shape[0])
        gl = qk.locate_streams_topk(*got[1:], topk)
        for k, (g, w) in enumerate(zip(gs + gl, ws + wl)):
            g, w = g.numpy(), np.asarray(w)
            assert g.shape == w.shape and g.dtype == w.dtype, k
            if g.dtype == np.float32:
                assert f32_ulps(g, w) <= 2
            else:
                np.testing.assert_array_equal(g, w)
    assert (gs[3].numpy() > 16).any()


def test_merge_and_locate_refuses_wide_blocks():
    x = torch.zeros((8, 4096), dtype=torch.int32)
    n = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="2 cap <= 4096"):
        qk.merge_and_locate(x, n, n, x, n, n, x, x)
