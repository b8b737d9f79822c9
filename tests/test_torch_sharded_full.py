"""ShardedDeviceIndex.search_batch_full (docodo_tpu_torch/parallel/
serving.py) on CPU meshes of 2 and 4 document shards, against one
DeviceIndex.search_batch_full over the same build and against the
benchmark's plain reference (perfbench/reference/search.py: fold_rows and
answers), field for field.

The corpus is seeded Zipf text with a header page a document
(synthetic.zipf_documents). The batches hold W1, W2 proximity, W2 and W3
ordered rows, V2 and V8 ORs, unknown words, and rows built to straddle
every shard boundary in both directions of the window; some cases cut
the rows by topk and by hit_cap. Also: the merge of made-up shard
outputs whose coordinates pass 2^31, the host path of a row whose window
chain passes the halo, boundary_status on made-up postings, the
counters, once a batch, and each entry point staging its own shards.

Tolerance: exact (ranks bit for bit)."""

import numpy as np
import pytest
import torch

from docodo_tpu_torch.ops.device_index import DeviceIndex
from docodo_tpu_torch.ops.seqops import INF32
from docodo_tpu_torch.parallel import serving
from docodo_tpu_torch.parallel.serving import (HIT_PAD, ShardedDeviceIndex,
                                               boundary_status, merge_hits,
                                               merge_runs)
from docodo_tpu_torch.parallel.sharding import make_mesh
from docodo_tpu_torch.query.search import result_fields
from docodo_tpu_torch.synthetic import build_index, zipf_documents
from docodo_tpu_torch.utils import profiling
from perfbench.reference.search import FIELDS, answers, fold_rows

TOPK, HIT_CAP = 16, 256


def prox(w):
    return 255 + len(w)


def ordered(w):
    return -(len(w) + 4)


@pytest.fixture(scope="module")
def built():
    docs = zipf_documents(900_000, seed=11, vocab=3000, doc_chars=100_000)
    ind = build_index(docs, device="cpu")
    one = DeviceIndex.from_index(ind, device="cpu")
    sdis = {s: ShardedDeviceIndex.from_index(
        ind, make_mesh(s, devices=["cpu"] * s)) for s in (2, 4)}
    return ind, one, sdis


def words_by_count(ind):
    """The index's words (no stem keys), most postings first."""
    cnt = np.diff(ind.arr.offsets)
    order = np.argsort(-cnt, kind="stable")
    return [ind.arr.terms[i] for i in order
            if not ind.arr.terms[i].startswith("$")]


def straddling_rows(ind, sdi):
    """Rows whose words meet across each shard boundary: the word of the
    last posting before it and the word of the first at or past it (and
    of the second), proximity both ways, ordered both ways."""
    arr = ind.arr
    keep = [i for i, t in enumerate(arr.terms) if not t.startswith("$")]
    tid = np.concatenate([np.full(arr.offsets[i + 1] - arr.offsets[i], i)
                          for i in keep])
    coords = np.concatenate([arr.coords[arr.offsets[i]:arr.offsets[i + 1]]
                             for i in keep]).astype(np.int64)
    order = np.argsort(coords, kind="stable")
    tid, coords = tid[order], coords[order]
    rows = []
    for f in sdi.full[1:]:
        b = f.base + f.keep[0]  # where the shard's own postings start
        at = int(np.searchsorted(coords, b))
        for i, j in ((at - 1, at), (at - 1, at + 1), (at - 2, at)):
            a, c = arr.terms[tid[i]], arr.terms[tid[j]]
            if a == c:
                continue
            r = int(coords[j] - coords[i]) + 4
            rows += [[(a, r), (c, r)], [(c, r), (a, r)],
                     [(a, -r), (c, -r)], [(c, -r), (a, -r)]]
    return rows


def batch(ind, sdi, seed: int):
    """A mixed batch: every row kind of the module doc."""
    rng = np.random.default_rng(seed)
    words = words_by_count(ind)
    high, med = words[3:60], words[60:400]

    def pick(pool, k):
        return [pool[i] for i in rng.choice(len(pool), size=k,
                                            replace=False)]
    rows = []
    for _ in range(6):
        a, b, c = pick(high, 3)
        d, e = pick(med, 2)
        vs = pick(high + med, 8)
        rows += [
            [(a, prox(a))],
            [(d, prox(d))],
            [(a, prox(a)), (b, prox(b))],
            [(a, prox(a)), (d, prox(d))],
            [(a, ordered(a)), (b, ordered(b))],
            [(a, ordered(a)), (b, ordered(b)), (c, ordered(c))],
            [(a, prox(a)), (b, prox(b)), (e, prox(e))],
            [((a, d), prox(d)), (b, prox(b))],
            [((a, e), prox(e))],
            [(tuple(vs), 267)],
            [(tuple(vs[:4]), 267), (tuple(vs[4:]), 267)],
            [((a, d), prox(d)), (b, prox(b)), (c, prox(c))],
            [("qqqqzzzz", 267)],
            [(a, prox(a)), ("qqqqzzzz", 267)],
            [((a, "qqqqzzzz"), prox(a)), (b, prox(b))],
        ]
    rows += straddling_rows(ind, sdi)
    order = rng.permutation(len(rows))
    return [rows[i] for i in order]


def same(one_out, got):
    """Rows differing, field by field (one index's int32 hits padded
    with INF32; the shards' int64, padded with HIT_PAD)."""
    assert set(one_out) == set(got)
    assert got["hits"].dtype == np.int64
    bad = {}
    for f, a in one_out.items():
        b = got[f]
        if f == "hits":
            a = np.where(a == INF32, HIT_PAD, a.astype(np.int64))
        assert a.dtype == b.dtype or f == "hits", f
        if a.dtype.kind == "f":
            a, b = a.view(np.int32), b.view(np.int32)
        d = (a != b).reshape(len(a), -1).any(axis=1)
        if d.any():
            bad[f] = np.flatnonzero(d).tolist()
    return bad


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("deferred", [False, True])
def test_shards_answer_as_one_index(built, shards, kernels, deferred):
    """Every field of every row as one DeviceIndex answers it, the
    kernels' route (their plain versions on the CPU) or the plain one."""
    ind, one, sdis = built
    sdi = sdis[shards]
    b = batch(ind, sdi, seed=shards)
    want = one.search_batch_full(b, topk=TOPK, hit_cap=HIT_CAP,
                                 use_kernels=kernels)
    got = sdi.search_batch_full(b, topk=TOPK, hit_cap=HIT_CAP,
                                deferred=deferred, use_kernels=kernels)
    if deferred:
        got = got()
    assert same(want, got) == {}
    assert (got["n_pages"] > 0).sum() > len(b) // 2


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("topk,hit_cap", [(2, 256), (16, 8)])
def test_truncated_rows_flag_as_one_index(built, shards, topk, hit_cap):
    """Rows cut by topk (n_pages > topk) and by hit_cap (n_hits past the
    row's tier): the same first runs, totals and first hits."""
    ind, one, sdis = built
    sdi = sdis[shards]
    b = batch(ind, sdi, seed=10 + shards)
    want = one.search_batch_full(b, topk=topk, hit_cap=hit_cap)
    got = sdi.search_batch_full(b, topk=topk, hit_cap=hit_cap,
                                deferred=True)()
    assert same(want, got) == {}
    assert (got["n_pages"] > topk).any() or (got["n_hits"] > hit_cap).any()


class _Postings:
    """The index's lists by term id, as perfbench's Postings gives them."""

    def __init__(self, arr):
        self.arr = arr

    def of(self, t):
        a = self.arr
        return a.coords[a.offsets[t]:a.offsets[t + 1]].astype(np.int64)


@pytest.mark.parametrize("shards", [2, 4])
def test_shards_answer_as_the_reference(built, shards):
    """The rows with every word known against the plain reference's fold
    and answers, over the index's own postings and page table."""
    ind, _, sdis = built
    sdi = sdis[shards]
    tmap = {t: i for i, t in enumerate(ind.arr.terms)}
    rows, grids, rs = [], [], []
    for q in batch(ind, sdi, seed=20 + shards):
        ids = [[tmap.get(c, -1) for c in ((g,) if isinstance(g, str) else g)]
               for g, _ in q]
        if any(max(x) < 0 for x in ids):
            continue
        v = max(len(x) for x in ids)
        grids.append(np.array([x + [-1] * (v - len(x)) for x in ids]))
        rs.append([r for _, r in q])
        rows.append(q)
    got = sdi.search_batch_full(rows, topk=TOPK, hit_cap=HIT_CAP,
                                deferred=True, use_kernels=True)()
    pt = ind.pages
    runs = fold_rows(grids, rs, _Postings(ind.arr),
                     pt.bounds.astype(np.int64), TOPK, HIT_CAP)
    header = np.array([p == "0" for p in pt.page_ids])
    ref = answers(runs, pt.page_doc.astype(np.int64), header,
                  lambda a: torch.log(torch.from_numpy(
                      np.ascontiguousarray(a, dtype=np.float32))).numpy())
    for f in FIELDS:
        a, b = got[f], ref[f]
        if a.dtype.kind == "f":
            a, b = a.view(np.int32), b.astype(np.float32).view(np.int32)
        assert np.array_equal(a, b.astype(a.dtype)), f


@pytest.mark.parametrize("shards", [2, 4])
def test_boundary_rows_fold_on_the_cards(built, shards):
    """Rows whose windows cross each boundary, both ways: counted as
    boundary rows, none sent to the host, each as one index answers it,
    and the crossing proximity rows match across the boundary."""
    ind, one, sdis = built
    sdi = sdis[shards]
    rows = straddling_rows(ind, sdi)
    assert len(rows) >= 4 * (shards - 1)
    profiling.reset()
    got = sdi.search_batch_full(rows, topk=TOPK, hit_cap=HIT_CAP,
                                deferred=True)()
    c = profiling.counters()
    assert c["mesh.reserve_rows"] == 0
    assert c["mesh.boundary_rows"] >= 2 * (shards - 1)
    assert same(one.search_batch_full(rows, topk=TOPK, hit_cap=HIT_CAP),
                got) == {}
    bases = [f.base + f.keep[0] for f in sdi.full[1:]]
    for q, n, h in zip(rows, got["n_hits"], got["hits"]):
        if q[0][1] > 0 and n:
            hit = h[h != HIT_PAD]
            assert any((hit < b).any() and (hit >= b).any() for b in bases)


def test_counters_count_each_batch_and_query_once(built):
    ind, one, sdis = built
    sdi = sdis[4]
    b = batch(ind, sdi, seed=31)
    profiling.reset()
    sdi.search_batch_full(b, topk=TOPK, hit_cap=HIT_CAP)
    first = profiling.counters()
    sdi.search_batch_full(b, topk=TOPK, hit_cap=HIT_CAP, deferred=True)()
    c = profiling.counters()
    assert c["query.batches"] == c["mesh.batches"] == 2
    assert c["query.queries"] == c["mesh.rows"] == 2 * len(b)
    # the second batch finds every query in the compile cache
    assert c["query.compile_miss"] == first["query.compile_miss"] <= len(b)
    assert c["query.uploads"] == 2 * len(sdi.full)
    assert c["mesh.boundary_rows"] == 2 * first["mesh.boundary_rows"] > 0
    assert c["mesh.reserve_rows"] == 0
    assert "mesh.halo_postings" not in c  # counted at staging only
    phases = {name: calls for name, _, calls in profiling.report()}
    assert phases["mesh.merge"] == 2


def test_merge_lays_shards_out_past_2_31():
    """merge_runs and merge_hits on made-up outputs of three shards whose
    coordinates start past 2^31: runs shard after shard, cut at topk;
    hits moved by each shard's base into int64, the first hb kept, the
    pad after them."""
    base = torch.tensor([2**31 + 5, 3 * 2**31, 5 * 2**31 + 1])
    # row 0: shards hold 2, 3, 1 runs; row 1: 0, 5 (past topk 4), 2
    n_pages = torch.tensor([[2, 0], [3, 5], [1, 2]], dtype=torch.int32)
    pg = torch.full((3, 2, 4), -1, dtype=torch.int32)
    rk = torch.zeros((3, 2, 4))
    for s in range(3):
        for r in range(2):
            k = min(int(n_pages[s, r]), 4)
            pg[s, r, :k] = torch.arange(k) + 100 * s + 10 * r
            rk[s, r, :k] = torch.arange(k) + 1.0 + s
    ct = (rk > 0).float() * 2
    p, k, c, n = merge_runs(pg, rk, ct, n_pages, 4)
    assert n.tolist() == [6, 7] and n.dtype == torch.int32
    assert p.tolist() == [[0, 1, 100, 101], [110, 111, 112, 113]]
    assert k.tolist() == [[1.0, 2.0, 2.0, 3.0], [2.0, 3.0, 4.0, 5.0]]
    assert c.tolist() == [[2.0] * 4, [2.0] * 4]
    # hits: row 0 holds 1, 0, 3 of them; row 1 4 (past hb 3), 2, 0
    n_hits = torch.tensor([[1, 4], [0, 2], [3, 0]], dtype=torch.int32)
    hits = torch.full((3, 2, 3), INF32, dtype=torch.int32)
    for s in range(3):
        for r in range(2):
            k = min(int(n_hits[s, r]), 3)
            hits[s, r, :k] = torch.arange(k, dtype=torch.int32) * 7 + r
    h, nh = merge_hits(hits, n_hits, base)
    assert h.dtype == torch.int64 and nh.tolist() == [4, 6]
    b = base.tolist()
    assert h.tolist() == [[b[0], b[2], b[2] + 7], [b[0] + 1, b[0] + 8,
                                                   b[0] + 15]]
    assert all(x > 2**31 for x in h.flatten().tolist())
    # a row with no hits anywhere is all pad
    h0, n0 = merge_hits(hits[:, :1] * 0 + INF32,
                        torch.zeros((3, 1), dtype=torch.int32), base)
    assert n0.tolist() == [0] and h0.tolist() == [[HIT_PAD] * 3]


@pytest.mark.parametrize("case,want", [
    # one word folds no window
    (([[1]], [30], [{1: [-5, 5]}]), 0),
    # no posting of the row near the boundary
    (([[1], [2]], [30, 30], [{3: [1]}]), 0),
    # the union parts at the boundary: a gap of 40 > 30 across it
    (([[1], [2]], [30, 30], [{1: [-20], 2: [20]}]), 0),
    # a chain across it (gap 10), parted within the halo of 100 both ways
    (([[1], [2]], [30, 30], [{1: [-5, -150], 2: [5, 150]}]), 1),
    # a chain across it that runs past the halo on the right: every gap
    # <= 30 from -5 up to 120
    (([[1], [2]], [30, 30], [{1: [-5] + list(range(20, 121, 25)),
                              2: [5]}]), 2),
    # the same on the left
    (([[1], [2]], [-30, -30], [{1: [-130, -100, -75, -50, -25],
                                2: [-5, 5]}]), 2),
    # a window wider than the halo, postings near: the host path
    (([[1], [2]], [300, 300], [{1: [-1]}]), 2),
    # the second boundary decides
    (([[1, 4], [2]], [30, 30], [{}, {4: [-3], 2: [3]}]), 1),
])
def test_boundary_status(case, want):
    rows, rvals, near = case
    assert boundary_status(rows, rvals, near, halo=100) == want


@pytest.mark.parametrize("shards", [2, 4])
def test_chain_past_the_halo_folds_on_the_host(built, shards, monkeypatch):
    """With a halo narrower than the rows' windows, every row with a
    posting near a boundary goes to the host's exact fold: counted as a
    reserve row, answered as one index answers it."""
    ind, one, _ = built
    monkeypatch.setattr(serving, "HALO", 100)
    sdi = ShardedDeviceIndex.from_index(
        ind, make_mesh(shards, devices=["cpu"] * shards))
    assert sdi.halo == 100
    b = batch(ind, sdi, seed=40 + shards)
    profiling.reset()
    got = sdi.search_batch_full(b, topk=TOPK, hit_cap=HIT_CAP,
                                deferred=True)()
    assert profiling.counters()["mesh.reserve_rows"] > 0
    assert same(one.search_batch_full(b, topk=TOPK, hit_cap=HIT_CAP),
                got) == {}


def test_halo_postings_counted_at_staging(built):
    ind, _, _ = built
    profiling.reset()
    sdi = ShardedDeviceIndex.from_index(ind, make_mesh(
        3, devices=["cpu"] * 3))
    n = profiling.counters()["mesh.halo_postings"]
    own = sum(int(f.dix.offsets_np[-1]) for f in sdi.full)
    assert n > 0 and own - n == ind.arr.coords.size
    assert [f.keep[0] for f in sdi.full] == [0, sdi.halo, sdi.halo]
    assert sdi.full[-1].keep[1] == INF32
    assert "mesh.halo" in {name for name, _, _ in profiling.report()}



STAGED_PHASES = {"full": {"mesh.halo"},
                 "served": {"mesh.reshard", "mesh.build", "mesh.tables"}}


@pytest.mark.parametrize("first,other", [("full", "served"),
                                         ("served", "full")])
def test_each_entry_point_stages_its_own_shards(built, first, other):
    """from_index(stage=...) stages one entry point's shards and not the
    other's; the other's first call stages its own, once, and answers as
    an index that staged it up front."""
    ind, one, sdis = built
    b = batch(ind, sdis[2], seed=70)
    if other == "full":
        want = one.search_batch_full(b, topk=TOPK, hit_cap=HIT_CAP)
    else:
        want = [None if r is None else result_fields(r) for r in
                sdis[2].search_batch(b, topk=TOPK, hit_cap=HIT_CAP,
                                     materialize=False)]
    profiling.reset()
    sdi = ShardedDeviceIndex.from_index(
        ind, make_mesh(2, devices=["cpu"] * 2), stage=first)
    staged = {name for name, _, _ in profiling.report()}
    assert STAGED_PHASES[first] <= staged
    assert not STAGED_PHASES[other] & staged
    before = sdi.device_bytes()
    assert all(n > 0 for n in before)
    for _ in range(2):
        if other == "full":
            got = sdi.search_batch_full(b, topk=TOPK, hit_cap=HIT_CAP)
            assert same(want, got) == {}
        else:
            got = sdi.search_batch(b, topk=TOPK, hit_cap=HIT_CAP,
                                   materialize=False)
            assert [None if r is None else result_fields(r)
                    for r in got] == want
    calls = {name: n for name, _, n in profiling.report()}
    assert all(calls[p] == 1 for p in STAGED_PHASES[other])
    assert all(a > b for a, b in zip(sdi.device_bytes(), before))


def test_one_hit_tier_without_fused(built):
    """fused=False: one hit tier (hit_cap) and rows padded to powers of
    four, as one index's per-bucket shape; the same answers."""
    ind, one, sdis = built
    b = batch(ind, sdis[2], seed=60)
    want = one.search_batch_full(b, topk=TOPK, hit_cap=HIT_CAP, fused=False)
    got = sdis[2].search_batch_full(b, topk=TOPK, hit_cap=HIT_CAP,
                                    fused=False, deferred=True)()
    assert same(want, got) == {}
