"""The port's variant kernels (on the CPU, their plain versions) against
the JAX package's Pallas functions in interpret mode: E,
variants_and_locate_full, against pallas_variants_and_locate_full; F,
union_merge_locate_full, against pallas_union_locate_full at V > 1; G,
variants_keep, against pallas_chunked_variants_and; and the merges and
the fold step's compaction that feed them. Inputs are seeded numpy
arrays handed to both packages.

Tolerances: ranks within 2 ulp, because torch.log and XLA's log differ
by 1 ulp on about 1% of counts on the CPU; every other field exact."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from docodo_tpu.ops import pallas_query as pq
from docodo_tpu_torch.ops import query_kernels as qk
from docodo_tpu_torch.ops.seqops import INF32

FIELDS = ("pages", "ranks", "counts", "n_pages", "n_hits", "hits")
RANK_ULPS = 2
T = torch.as_tensor
J = jnp.asarray


def f32_ulps(a, b) -> int:
    a = np.ascontiguousarray(a, dtype=np.float32).view(np.int32)
    b = np.ascontiguousarray(b, dtype=np.float32).view(np.int32)
    return int(np.abs(a.astype(np.int64) - b).max()) if a.size else 0


def assert_outputs_equal(got, want, what=""):
    for field, g, w in zip(FIELDS, got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, (what, field, g.shape, w.shape)
        if field == "ranks":
            assert f32_ulps(g, w) <= RANK_ULPS, (what, field)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {field}")


def variant_batch(rng, bsz, va, vb, cap, spacing=12):
    """Two words' variant blocks per row, all drawn from one per-row pool
    so that variants and words share coordinates (runs of up to
    va + vb lanes): ragged lengths, an empty variant on row 1, full
    blocks on row 2, word B empty and flagged bpad on rows 3 and 9,
    ordered windows on every third row. Returns numpy arrays and the
    page bounds."""
    pool_n = 2 * cap
    pool = np.cumsum(rng.integers(1, spacing, size=(bsz, pool_n)), axis=1)

    def blocks(v):
        x = np.full((bsz, v, cap), INF32, np.int32)
        n = rng.integers(0, cap + 1, size=(bsz, v)).astype(np.int32)
        n[2] = cap
        n[1, 0] = 0
        for i in range(bsz):
            for j in range(v):
                pick = np.sort(rng.choice(pool_n, n[i, j], replace=False))
                x[i, j, : n[i, j]] = pool[i, pick]
        return x, n

    a, na = blocks(va)
    b, nb = blocks(vb)
    bpad = np.zeros(bsz, bool)
    bpad[[3, 9 % bsz]] = True
    nb[bpad] = 0
    b[bpad] = INF32
    ordered = np.arange(bsz) % 3 == 1
    ra = np.where(ordered, -9, 60).astype(np.int32)
    rb = np.where(ordered, -10, 45).astype(np.int32)
    top = int(pool.max()) + 1
    bounds = np.arange(37, top + 37, 37, dtype=np.int32)
    return dict(a=a, na=na, ra=ra, b=b, nb=nb, rb=rb, bpad=bpad,
                bounds=bounds)


def pages(x, bounds):
    pg = np.minimum(np.searchsorted(bounds, x, side="right"),
                    bounds.size - 1)
    return np.where(x < INF32, pg, INF32).astype(np.int32)


@pytest.mark.parametrize("va,vb,cap,pg_mode,tail", [
    (2, 2, 128, "carried", False),   # test_pallas_query.py:352's shape
    (2, 2, 128, "shared", True),
    (1, 4, 64, "none", False),       # nested OR: w1 (a|b|c) padded to 4
    (4, 4, 128, "carried", True),    # 1024 lanes
    (2, 2, 32, "carried", False),    # n 128: the narrowest stream width
    (2, 2, 64, "shared", False),     # n 256
    (8, 8, 64, "carried", False),    # 16 blocks
])
def test_variants_and_locate_full_matches_pallas(rng, va, vb, cap, pg_mode,
                                                 tail):
    """Kernel E's plain version against pallas_variants_and_locate_full:
    cross-variant and cross-word duplicate coordinates, empty variants,
    bpad rows, ordered and proximity windows, pages carried, looked up
    from the merged stream, or found by the kernel's compare-all."""
    bsz, topk, hit_cap = 16, 8, 300
    x = variant_batch(rng, bsz, va, vb, cap)
    apg = pages(x["a"], x["bounds"]) if pg_mode == "carried" else None
    bpg = pages(x["b"], x["bounds"]) if pg_mode == "carried" else None
    want = pq.pallas_variants_and_locate_full(
        J(x["a"]), J(x["na"]), J(x["ra"]), J(x["b"]), J(x["nb"]),
        J(x["rb"]), J(x["bpad"]), J(x["bounds"]), topk=topk,
        hit_cap=hit_cap, interpret=True, sort_topk=True,
        a_pg=None if apg is None else J(apg),
        b_pg=None if bpg is None else J(bpg),
        shared_pg=pg_mode == "shared", tail=tail)
    got = qk.variants_and_locate_full(
        T(x["a"]), T(x["na"]), T(x["ra"]), T(x["b"]), T(x["nb"]),
        T(x["rb"]), T(x["bpad"]), T(x["bounds"]), topk=topk,
        hit_cap=hit_cap, a_pg=None if apg is None else T(apg),
        b_pg=None if bpg is None else T(bpg), tail=tail)
    assert_outputs_equal(got, want, f"V {va}+{vb} cap {cap}")
    assert (np.asarray(got[4]) > 0).sum() > bsz // 2
    assert (np.asarray(got[3]) > topk).any()


@pytest.mark.parametrize("v,cap,pg_mode,tail", [
    (2, 256, "carried", False),   # the in-kernel bitonic merge route
    (2, 128, "shared", True),
    (4, 128, "carried", True),    # sort, then the union kernel
    (8, 64, "none", False),       # the wide mix's wildcard union
    (8, 128, "carried", False),   # the serving shape, 1024 lanes
])
def test_union_merge_locate_full_matches_pallas(rng, v, cap, pg_mode, tail):
    """Kernel F's plain version against pallas_union_locate_full at
    V > 1, with cross-variant duplicate coordinates and empty
    variants."""
    bsz, topk, hit_cap = 16, 8, 200
    x = variant_batch(rng, bsz, v, 1, cap)
    apg = pages(x["a"], x["bounds"]) if pg_mode == "carried" else None
    want = pq.pallas_union_locate_full(
        J(x["a"]), J(x["na"]), J(x["bounds"]), topk=topk, hit_cap=hit_cap,
        interpret=True, sort_topk=True,
        a_pg=None if apg is None else J(apg),
        shared_pg=pg_mode == "shared", tail=tail)
    got = qk.union_locate_full(
        T(x["a"]), T(x["na"]), T(x["bounds"]), topk=topk, hit_cap=hit_cap,
        a_pg=None if apg is None else T(apg), tail=tail)
    assert_outputs_equal(got, want, f"V {v} cap {cap}")
    merged = qk.union_merge_locate_full_plain(
        T(x["a"]), T(x["na"]), T(x["bounds"]), topk=topk, hit_cap=hit_cap,
        a_pg=None if apg is None else T(apg), tail=tail)
    assert all(torch.equal(g, m) for g, m in zip(got, merged))


def merged_stream(x, with_pages=False):
    """Both words' variant blocks through merge_tagged, as the chunked
    variant route merges them."""
    apg = T(pages(x["a"], x["bounds"])) if with_pages else None
    bpg = T(pages(x["b"], x["bounds"])) if with_pages else None
    return qk.merge_tagged(T(x["a"]), T(x["na"]), T(x["b"]), T(x["nb"]),
                           apg, bpg)


@pytest.mark.parametrize("va,vb,cap", [
    (2, 2, 512),     # n 2048: the resident one-pass kernel
    (4, 4, 512),     # n 4096
    (1, 4, 2048),    # n 10240: two chunked passes, runs across chunks
])
def test_variants_keep_matches_pallas(rng, va, vb, cap):
    """Kernel G's plain version against pallas_chunked_variants_and on
    merged variant streams: runs of up to va + vb lanes, some crossing
    the 1024-lane chunks, bpad rows, ordered and proximity windows."""
    x = variant_batch(rng, 10, va, vb, cap, spacing=4)
    vals, tag, _ = merged_stream(x)
    n = vals.shape[1]
    v_np = vals.numpy()
    crossing = (v_np[:, 1024::1024] == v_np[:, 1023:-1:1024]) \
        & (v_np[:, 1024::1024] < INF32)
    assert n <= 4096 or crossing.any()
    want = pq.pallas_chunked_variants_and(
        J(v_np), J(tag.numpy()), J(x["ra"][:, None]), J(x["rb"][:, None]),
        J(x["bpad"].astype(np.int32)[:, None]), interpret=True)
    got = qk.variants_keep(vals, tag, T(x["ra"]), T(x["rb"]), T(x["bpad"]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want)[:, :n])
    kept = (got < INF32).sum(dim=1)
    assert int(kept.max()) > 0


@pytest.mark.parametrize("va,vb,with_pages", [(1, 1, True), (3, 2, True),
                                              (4, 0, False)])
def test_merge_tagged_blocks_match_the_tagged_sort(rng, va, vb, with_pages):
    """merge_tagged over variant blocks against the JAX package's merge
    of them (device_index.py:1288): one two-key lax.sort of the
    word-tagged concatenation, the pages riding along."""
    x = variant_batch(rng, 12, va, max(vb, 1), 256)
    if vb == 0:
        vals, tag, pg = qk.merge_tagged(T(x["a"]), T(x["na"]), None, None)
        b = np.zeros((12, 0), np.int32)
    else:
        vals, tag, pg = merged_stream(x, with_pages)
        b = np.where(np.arange(256)[None, None] < x["nb"][:, :, None],
                     x["b"], INF32).reshape(12, -1)
    a = np.where(np.arange(256)[None, None] < x["na"][:, :, None], x["a"],
                 INF32).reshape(12, -1)
    cat = np.concatenate([a, b], axis=1)
    tags = np.concatenate([np.where(a < INF32, 0, 2),
                           np.where(b < INF32, 1, 2)], axis=1)
    pcat = pages(cat, x["bounds"])
    wv, wt, wp = jax.vmap(lambda v, t, p: jax.lax.sort((v, t, p),
                                                       num_keys=2))(
        J(cat), J(tags.astype(np.int32)), J(pcat))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(tag.numpy(), np.asarray(wt))
    if with_pages:
        live = np.asarray(wv) < INF32
        np.testing.assert_array_equal(pg.numpy()[live], np.asarray(wp)[live])
    else:
        assert pg is None


def test_and_keep_compact_is_the_kept_stream_compacted(rng):
    """A W >= 3 fold step's operand: and_keep's kept values and their
    pages, in order, at the front, INF32 after them."""
    x = variant_batch(rng, 12, 1, 1, 512)
    vals, tag, pg = merged_stream(x, with_pages=True)
    ra, rb = T(x["ra"]), T(x["rb"])
    hv = qk.and_keep(vals, tag, ra, rb).numpy()
    cv, cp, count = qk.and_keep_compact(vals, tag, ra, rb, pg)
    for i in range(hv.shape[0]):
        keep = hv[i] < INF32
        k = int(keep.sum())
        assert int(count[i]) == k
        np.testing.assert_array_equal(cv[i, :k].numpy(), hv[i][keep])
        np.testing.assert_array_equal(cp[i, :k].numpy(), pg[i].numpy()[keep])
        assert (cv[i, k:] == INF32).all() and (cp[i, k:] == INF32).all()
    assert int(count.max()) > 0
    cv2, cp2, _ = qk.and_keep_compact(vals, tag, ra, rb)
    assert cp2 is None and torch.equal(cv2, cv)
