"""The port's chunked kernel wrappers (on the CPU, their plain versions)
against the JAX package's Pallas functions in interpret mode, and the
port's chunked bucket route against JAX's batched_query_full on its
forced chunked route. Inputs are seeded numpy arrays handed to both
packages.

Tolerances: ranks and doc ranks within 2 ulp, because torch.log and
XLA's log differ by 1 ulp on about 1% of counts on the CPU; every other
field exact."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from docodo_tpu.ops import device_index as jdi
from docodo_tpu.ops import pallas_query as pq
from docodo_tpu_torch.ops import device_index as tdi
from docodo_tpu_torch.ops import query_kernels as qk
from docodo_tpu_torch.ops.seqops import INF32

RANK_ULPS = 2
T = torch.as_tensor
J = jnp.asarray


def f32_ulps(a, b) -> int:
    a = np.ascontiguousarray(a, dtype=np.float32).view(np.int32)
    b = np.ascontiguousarray(b, dtype=np.float32).view(np.int32)
    return int(np.abs(a.astype(np.int64) - b).max()) if a.size else 0


def _blocks(rng, bsz, cap, dense=False):
    """Two ragged ascending blocks per row from one pool (shared
    coordinates), INF32 past their lengths: an empty operand on rows 0
    and 1, full rows 2 and 5, ordered windows on rows 3 and 4, and with
    `dense` a pool so tight that rows keep more runs than a small topk."""
    pool = np.arange(0, 8 * cap) * (2 if dense else 3)
    a = np.full((bsz, cap), INF32, np.int32)
    b = np.full((bsz, cap), INF32, np.int32)
    na = rng.integers(cap // 4, cap + 1, bsz).astype(np.int32)
    nb = rng.integers(cap // 4, cap + 1, bsz).astype(np.int32)
    na[0], nb[1] = 0, 0
    na[2] = nb[2] = na[5] = nb[5] = cap
    for i in range(bsz):
        a[i, : na[i]] = np.sort(rng.choice(pool, na[i], replace=False))
        b[i, : nb[i]] = np.sort(rng.choice(pool, nb[i], replace=False))
    ra = rng.integers(1, 40, bsz).astype(np.int32)
    rb = rng.integers(1, 40, bsz).astype(np.int32)
    ra[2] = rb[2] = 3 * int(pool[-1])  # keep everything on row 2
    ra[3:5], rb[3:5] = -ra[3:5], -rb[3:5]
    bounds = np.concatenate([
        np.sort(rng.choice(np.arange(1, 24 * cap), 60, replace=False)),
        [30 * cap]]).astype(np.int32)
    return a, na, ra, b, nb, rb, bounds


def _pages(x, bounds):
    """Each coordinate's page (#bounds <= coord, clamped), INF32 at
    padding, as the posting fetch carries them."""
    pg = np.minimum(np.searchsorted(bounds, x, side="right"),
                    bounds.size - 1)
    return np.where(x < INF32, pg, INF32).astype(np.int32)


def _assert_runs_equal(got, want_pg, want_rk, want_ct, want_np, topk):
    """First-topk runs: ranks within RANK_ULPS, pages and counts exact at
    every served run. Past n_pages the port pads pages with -1."""
    pg_c, rk_c, ct_c, n_pages = (np.asarray(x) for x in got[:4])
    want_pg, want_rk, want_ct = (np.asarray(x)[:, :topk]
                                 for x in (want_pg, want_rk, want_ct))
    np.testing.assert_array_equal(n_pages, np.asarray(want_np))
    assert f32_ulps(rk_c, want_rk) <= RANK_ULPS
    np.testing.assert_array_equal(ct_c, want_ct)
    served = want_rk > 0
    np.testing.assert_array_equal(pg_c[served], want_pg[served])
    assert (pg_c[~served] == -1).all()


@pytest.mark.parametrize("cap,hit_cap,topk,bsz", [
    (64, 128, 16, 12), (256, 64, 16, 12), (128, 2048, 16, 12),
    (256, 512, 512, 12), (256, 512, 2048, 12),
    # the kernel's two stream widths, N = 2048 and 4096
    (1024, 1024, 64, 6), (2048, 1024, 64, 6),
])
def test_merge_and_locate_topk_matches_pallas(rng, cap, hit_cap, topk, bsz):
    """Kernel A's plain version against pallas_merge_and_locate_topk,
    at topk 16 and escalated past 128 and past the stream width, and at
    the fused batches' caps."""
    a, na, ra, b, nb, rb, bounds = _blocks(rng, bsz, cap, dense=True)
    apg, bpg = _pages(a, bounds), _pages(b, bounds)
    hits_j, pg_j, rk_j, ct_j, np_j, nh_j = pq.pallas_merge_and_locate_topk(
        J(a), J(na), J(b), J(nb), J(apg), J(bpg), J(ra[:, None]),
        J(rb[:, None]), cap=cap, hit_cap=hit_cap, topk=topk,
        interpret=True)
    got = qk.merge_and_locate_topk(T(a), T(na), T(ra), T(b), T(nb), T(rb),
                                   T(apg), T(bpg), topk=topk,
                                   hit_cap=hit_cap)
    _assert_runs_equal(got, pg_j, rk_j, ct_j, np_j, topk)
    np.testing.assert_array_equal(np.asarray(got[4]), np.asarray(nh_j))
    hits, hits_j = np.asarray(got[5]), np.asarray(hits_j)[:, :hit_cap]
    width = hits_j.shape[1]
    np.testing.assert_array_equal(hits[:, :width], hits_j)
    assert (hits[:, width:] == INF32).all()
    assert np.asarray(np_j).max() > min(topk, 16)


@pytest.mark.parametrize("cap", [64, 1024])
def test_merge_tagged_matches_bitonic_merge(rng, cap):
    """Kernel B's plain version against pallas_bitonic_merge: values and
    tags everywhere, pages at every valid lane (padding pages are
    unspecified)."""
    a, na, _, b, nb, _, bounds = _blocks(rng, 8, cap)
    apg, bpg = _pages(a, bounds), _pages(b, bounds)
    vj, tj, pj = pq.pallas_bitonic_merge(J(a), J(na), J(b), J(nb), J(apg),
                                         J(bpg), cap=cap, interpret=True)
    vals, tag, pg = qk.merge_tagged(T(a), T(na), T(b), T(nb), T(apg),
                                    T(bpg))
    vj, tj, pj = np.asarray(vj), np.asarray(tj), np.asarray(pj)
    np.testing.assert_array_equal(vals.numpy(), vj)
    np.testing.assert_array_equal(tag.numpy(), tj)
    live = vj < INF32
    np.testing.assert_array_equal(pg.numpy()[live], pj[live])
    # without pages: the same stream
    v2, t2, p2 = qk.merge_tagged(T(a), T(na), T(b), T(nb))
    assert p2 is None and torch.equal(v2, vals) and torch.equal(t2, tag)


@pytest.mark.parametrize("cap", [1024, 4096])
def test_and_keep_matches_chunked_and(rng, cap):
    """Kernel C's plain version against pallas_chunked_and: the one-pass
    resident kernel at n = 2048, the two chunk-streamed passes at
    n = 8192."""
    a, na, ra, b, nb, rb, _ = _blocks(rng, 8, cap)
    vals, tag, _ = qk.merge_tagged(T(a), T(na), T(b), T(nb))
    want = pq.pallas_chunked_and(J(vals.numpy()), J(tag.numpy()),
                                 J(ra[:, None]), J(rb[:, None]),
                                 interpret=True)
    got = qk.and_keep(vals, tag, T(ra), T(rb))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    kept = (got < INF32).sum(dim=1)
    assert int(kept.max()) > 0 and int(kept.min()) == 0


@pytest.mark.parametrize("cap,pages", [(1024, "carried"), (1024, "shared"),
                                       (4096, "carried"), (4096, "shared")])
def test_locate_runs_matches_chunked_locate(rng, cap, pages):
    """Kernel D's plain version against pallas_chunked_locate with
    tail=False (the resident kernel at n = 2048, the chunked one at
    n = 8192), and its hits against _locate_full_chunked's sort."""
    topk, hit_cap = 16, 300
    a, na, ra, b, nb, rb, bounds = _blocks(rng, 8, cap, dense=True)
    apg, bpg = _pages(a, bounds), _pages(b, bounds)
    vals, tag, pg = qk.merge_tagged(T(a), T(na), T(b), T(nb), T(apg),
                                    T(bpg))
    hv = qk.and_keep(vals, tag, T(ra), T(rb))
    carried = pages == "carried"
    want = pq.pallas_chunked_locate(
        J(hv.numpy()), J(bounds), topk=topk, interpret=True,
        pg=J(pg.numpy()) if carried else None, tail=False)
    got = qk.locate_runs(hv, T(bounds), topk=topk, hit_cap=hit_cap,
                         pg=pg if carried else None)
    _assert_runs_equal(got, *want, topk)
    hv_np = hv.numpy()
    np.testing.assert_array_equal(got[4].numpy(), (hv_np < INF32).sum(1))
    np.testing.assert_array_equal(
        got[5].numpy(), np.asarray(jax.lax.sort(J(hv_np)))[:, :hit_cap])
    assert int(got[3].max()) > topk


def _route_inputs():
    """The inputs of tests/test_pallas_query.py's chunked routing test:
    10 terms of 600-1000 postings plus two small ones, 3000-char pages,
    8 two-word rows with alternating window signs."""
    nprng = np.random.default_rng(31)
    t = 10
    counts = nprng.integers(600, 1000, size=t)
    counts[8], counts[9] = 40, 90
    tids = np.repeat(np.arange(t), counts).astype(np.int32)
    coords = np.sort(nprng.choice(500_000, size=int(counts.sum()),
                                  replace=False)).astype(np.int32)
    nprng.shuffle(tids)
    tq = nprng.integers(0, t - 2, (8, 2)).astype(np.int32)
    rq = np.broadcast_to(np.where(np.arange(8)[:, None] % 2, 300, -300),
                         (8, 2)).astype(np.int32)
    bounds = np.arange(3000, 503_000, 3000, dtype=np.int32)
    return tids, coords, t, tq, rq, bounds


@pytest.fixture(scope="module")
def route_index():
    tids, coords, t, tq, rq, bounds = _route_inputs()
    st, sc, off = jdi.build_postings(J(tids), J(coords), t)
    sc_np, off_np = np.array(sc), np.array(off)
    pages = jdi.build_page_of(bounds, sc_np)
    small = jdi.build_small_tables(off_np.astype(np.int64), sc_np,
                                   pages_np=pages)
    tsmall = tdi.build_small_tables(off_np.astype(np.int64), sc_np,
                                    pages_np=pages)
    return dict(off=off_np, sc=sc_np, bounds=bounds, pages=pages,
                small=small, tsmall=tuple(st.to("cpu") for st in tsmall),
                tq=tq, rq=rq)


@pytest.mark.parametrize("words,cap,leg", [
    (2, 1024, "uncarried"), (2, 1024, "paged"), (2, 1024, "fused"),
    (2, 4096, "carried"), (1, 2048, "paged"), (1, 2048, "carried"),
])
def test_chunked_bucket_route_matches_jax(route_index, words, cap, leg):
    """One bucket through the port's chunked route against JAX's
    batched_query_full on its chunked route (chunked="force", the
    interpret-mode Pallas kernels): the legs of tests/test_pallas_query.py
    :448-522 (uncarried, page_of without the tables, the fused carried
    kernel, the W=1 block) plus the carried three-kernel W=2 pipeline."""
    x = route_index
    tq, rq = x["tq"][:, :words], x["rq"][:, :words]
    with_pages = leg != "uncarried"
    with_small = leg in ("fused", "carried")
    kw = dict(cap=cap, topk=16, hit_cap=256, with_docs=True)
    pd = np.zeros(x["bounds"].shape[0], np.int32)
    hdr = np.zeros(x["bounds"].shape[0], bool)
    want = jdi.batched_query_full(
        J(x["off"]), J(x["sc"]), J(x["bounds"]), J(pd), J(hdr), J(tq),
        J(rq), use_pallas=True, chunked="force",
        page_of=J(x["pages"]) if with_pages else None,
        small=x["small"] if with_small else None, **kw)
    small = x["tsmall"] if with_small else None
    assert tdi._tab_serves(small, cap) == with_small
    routes = []
    inner = tdi._chunked_bucket_full

    def seen(*a, **k):
        out = inner(*a, **k)
        routes.append(out is not None)
        return out

    tdi._chunked_bucket_full = seen
    try:
        (got,) = tdi.multi_bucket_query_full(
            T(x["off"]), T(x["sc"]), T(x["bounds"]), T(pd), T(hdr),
            [T(tq)], [T(rq)], [cap], 16, [256], with_docs=True,
            use_kernels=True, small=small,
            page_of=T(x["pages"]) if with_pages else None)
    finally:
        tdi._chunked_bucket_full = inner
    assert routes == [True]
    for name in ("pages", "counts", "n_pages", "n_hits", "hits", "docs"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    for name in ("ranks", "doc_ranks"):
        assert f32_ulps(getattr(got, name).numpy(),
                        np.asarray(getattr(want, name))) <= RANK_ULPS, name
    assert int(got.n_hits.max()) > 0
