"""The port's layout over several processes (docodo_tpu_torch.parallel
.distributed) against the JAX package's (docodo_tpu.parallel
.distributed) on the CPU: process-local staging array for array; one
process simulating 2 hosts x 4 devices, the build and both query legs
against the JAX package's ("h", "d") mesh and against the port's own
one-process (1-D) leg; ShardedDeviceIndex over that layout against the
host engine; then a real run of two processes joined by a gloo process
group over the loopback (spawn), each staging only its own documents,
whose results must equal the one-process leg's; and a failing or hung
process must fail the run within seconds.

Tolerances: ranks and doc ranks within 2 float32 ulp of the JAX
package's (torch.log and XLA's log differ by 1 ulp on the CPU), exact
against the port's own one-process leg; every other field exact."""

import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from docodo_tpu.parallel import distributed as jdd
from docodo_tpu_torch.index import Index, IndexPagedTextFile, ListDataSource
from docodo_tpu_torch.parallel import distributed as dd
from docodo_tpu_torch.parallel import sharding as sh
from docodo_tpu_torch.parallel.serving import ShardedDeviceIndex
from docodo_tpu_torch.query.batcher import compile_request
from docodo_tpu_torch.query.search import result_fields

from test_torch_slice import f32_ulps
from test_torch_sharded_serving import REQS, TEXTS

H, D = 2, 4
FIELDS = ("pages", "ranks", "counts", "n_pages", "docs", "doc_ranks", "hits",
          "n_hits")


def _corpus(n_docs=16, seed=3):
    """Documents over a 49-word vocabulary (tests/test_distributed.py's)."""
    rng = np.random.default_rng(seed)
    vocab = [f"w{chr(97 + i)}{chr(97 + j)}" for i in range(7)
             for j in range(7)]
    term_to_id = {}
    doc_tids, doc_coords, doc_pages = [], [], []
    for _ in range(n_docs):
        words = rng.choice(vocab, size=int(rng.integers(20, 60)))
        tids, cs = [], []
        pos = 0
        for w in words:
            tids.append(term_to_id.setdefault(w, len(term_to_id)))
            cs.append(pos)
            pos += len(w) + 1
        doc_tids.append(np.asarray(tids, dtype=np.int32))
        doc_coords.append(np.asarray(cs, dtype=np.int32))
        doc_pages.append([pos // 2, pos])
    return term_to_id, doc_tids, doc_coords, doc_pages


def _plan(doc_tids, doc_pages, shards):
    assign = dd.plan_document_assignment(
        [t.size for t in doc_tids], [p[-1] for p in doc_pages], shards)
    nloc = max(sum(doc_tids[i].size for i in a) for a in assign)
    ploc = max(sum(len(doc_pages[i]) for i in a) for a in assign)
    return assign, nloc, ploc


def _own(arrays, assign, p, d=D):
    """`arrays` with None for the documents of other processes."""
    mine = {i for s in range(p * d, (p + 1) * d) for i in assign[s]}
    return [a if i in mine else None for i, a in enumerate(arrays)]


def test_process_local_staging_equals_jax():
    _, doc_tids, doc_coords, doc_pages = _corpus()
    assign, nloc, ploc = _plan(doc_tids, doc_pages, H * D)
    assert assign == jdd.plan_document_assignment(
        [t.size for t in doc_tids], [p[-1] for p in doc_pages], H * D)
    rows, jrows = [], []
    for p in range(H):
        args = (_own(doc_tids, assign, p), _own(doc_coords, assign, p),
                doc_pages, assign, H, D, p)
        rows.append(dd.stage_for_process(*args, nloc=nloc, ploc=ploc))
        jrows.append(jdd.stage_for_process(*args, nloc=nloc, ploc=ploc))
        own = dd.stage_for_process(*args)  # this process's own widths
        want = jdd.stage_for_process(*args)
        for f in ("term_ids", "coords", "bounds", "page_doc", "page_base",
                  "n_tokens"):
            assert np.array_equal(getattr(own, f), getattr(want, f)), f
            assert np.array_equal(getattr(rows[p], f), getattr(jrows[p], f))
    got, want = dd.assemble_global(rows), jdd.assemble_global(jrows)
    for f in ("term_ids", "coords", "bounds", "page_doc", "page_base",
              "n_tokens"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert (np.diff(got.page_base) > 0).all()
    assert int(got.n_tokens.sum()) == sum(t.size for t in doc_tids)
    with pytest.raises(ValueError, match="not loaded"):
        dd.stage_for_process(_own(doc_tids, assign, 0),
                             _own(doc_coords, assign, 0), doc_pages, assign,
                             H, D, 1, nloc=nloc, ploc=ploc)


def _staged(n_docs=16, seed=3):
    term_to_id, doc_tids, doc_coords, doc_pages = _corpus(n_docs, seed)
    assign, nloc, ploc = _plan(doc_tids, doc_pages, H * D)
    corpus = dd.assemble_global([
        dd.stage_for_process(doc_tids, doc_coords, doc_pages, assign, H, D,
                             p, nloc=nloc, ploc=ploc) for p in range(H)])
    return len(term_to_id), corpus


def test_distributed_build_query_equals_jax():
    T, corpus = _staged()
    mesh = dd.make_global_mesh(["cpu"] * (H * D), num_hosts=H)
    assert mesh.num_local == D and mesh.num_shards == H * D
    assert list(mesh.own) == list(range(H * D))
    jmesh = jdd.make_global_mesh(jax.devices()[:8], num_hosts=H)
    st, sc, off = dd.distributed_build(mesh, corpus.term_ids, corpus.coords,
                                       T)
    want = jdd.distributed_build(jmesh, jnp.asarray(corpus.term_ids),
                                 jnp.asarray(corpus.coords), T)
    for g, w in zip((st, sc, off), want):
        assert np.array_equal(np.stack([x.numpy() for x in g]),
                              np.asarray(w))
    rng = np.random.default_rng(9)
    terms = rng.integers(0, T, size=(12, 2)).astype(np.int32)
    terms[::2, 1] = -1
    rs = np.full((12, 2), 40, dtype=np.int32)
    got = dd.distributed_query(mesh, off, sc, corpus.bounds, corpus.page_doc,
                               corpus.page_base, terms, rs, cap=64, topk=16)
    want = jdd.distributed_query(
        jmesh, want[2], want[1], jnp.asarray(corpus.bounds),
        jnp.asarray(corpus.page_doc), jnp.asarray(corpus.page_base),
        jnp.asarray(terms), jnp.asarray(rs), cap=64, topk=16)
    for f, (g, w) in enumerate(zip(got, want)):
        g, w = g.numpy(), np.asarray(w)
        assert (f32_ulps(g, w) <= 2) if f == 1 else np.array_equal(g, w), f
    assert (np.asarray(want[0]) >= 0).sum() > 20
    # one level of top k over the 8 shards gives the same
    one = sh.sharded_query(mesh.devices, off, sc, corpus.bounds,
                           corpus.page_doc, corpus.page_base, terms, rs,
                           cap=64, topk=16)
    for g, w in zip(got, one):
        assert np.array_equal(g.numpy(), w.numpy())


def _buckets(T, rng, b=6):
    """Buckets of full words: W = 2, W = 1 and W = 1 of two variants."""
    w2 = rng.integers(0, T, size=(b, 2)).astype(np.int32)
    w1 = rng.integers(0, T, size=(b, 1)).astype(np.int32)
    v2 = rng.integers(0, T, size=(b, 1, 2)).astype(np.int32)
    return [(64, w2, np.full((b, 2), 60, np.int32)),
            (64, w1, np.full((b, 1), 60, np.int32)),
            (64, v2, np.full((b, 1), 60, np.int32))]


def test_distributed_query_full_equals_1d_leg():
    """The full-result leg over 2 simulated hosts x 4 devices returns the
    [S, B, ...] fields of the 8-shard one-process leg (shard s = h D + d)
    and of the JAX package's distributed_query_full."""
    term_to_id, doc_tids, doc_coords, doc_pages = _corpus(n_docs=12, seed=7)
    T = len(term_to_id)
    corpus = sh.stage_shards_arrays(doc_tids, doc_coords, doc_pages, 8)
    mesh1 = sh.make_mesh(8, devices=["cpu"] * 8)
    mesh2 = dd.make_global_mesh(mesh1, num_hosts=H)
    _, sc1, off1 = sh.sharded_build(mesh1, corpus.term_ids, corpus.coords, T)
    _, sc2, off2 = dd.distributed_build(mesh2, corpus.term_ids,
                                        corpus.coords, T)
    jmesh = jdd.make_global_mesh(jax.devices()[:8], num_hosts=H)
    _, jsc, joff = jdd.distributed_build(jmesh, jnp.asarray(corpus.term_ids),
                                         jnp.asarray(corpus.coords), T)
    hd = np.zeros(corpus.bounds.shape, dtype=bool)
    for cap, terms, rs in _buckets(T, np.random.default_rng(11)):
        kw = dict(cap=cap, topk=16, hit_cap=128)
        one = sh.sharded_query_full(mesh1, off1, sc1, corpus.bounds,
                                    corpus.page_doc, hd, terms, rs, **kw)
        two = dd.distributed_query_full(mesh2, off2, sc2, corpus.bounds,
                                        corpus.page_doc, hd, terms, rs, **kw)
        want = jdd.distributed_query_full(
            jmesh, joff, jsc, jnp.asarray(corpus.bounds),
            jnp.asarray(corpus.page_doc), jnp.asarray(hd),
            jnp.asarray(terms), jnp.asarray(rs), use_pallas=False, **kw)
        for name, a, b, w in zip(FIELDS, one, two, want):
            assert np.array_equal(a.numpy(), b.numpy()), name
            w = np.asarray(w)
            if name in ("ranks", "doc_ranks"):
                assert f32_ulps(a.numpy(), w) <= 2, name
            else:
                assert np.array_equal(a.numpy(), w), name
        assert (one[7].numpy() > 0).any()


@pytest.fixture(scope="module")
def index():
    ind = Index(device="cpu")
    ind.add_data_source(ListDataSource("docs", [
        IndexPagedTextFile(f"d{i}", t, "") for i, t in enumerate(TEXTS)]))
    ind.create()
    return ind


def _fields(res):
    out = result_fields(res)
    del out["words"]
    return out


def test_distributed_full_result_serving_matches_host(index):
    """ShardedDeviceIndex over 2 simulated hosts x 4 devices: docs,
    pages, positions and ranks equal to the host engine's."""
    sdi = ShardedDeviceIndex.from_index(
        index, dd.make_global_mesh(["cpu"] * (H * D), num_hosts=H))
    assert sdi._is2d and len(sdi.shard_tables) == H * D
    reqs = ["club", "pickwick club", '"pickwick club"', "dinner noon",
            "adventures abroad", '"the club"']
    got = sdi.search_batch([compile_request(index, r) for r in reqs],
                           topk=64, hit_cap=1024)
    for req, res in zip(reqs, got):
        assert _fields(res) == _fields(index.search(req)), req


def _process_leg(rank, world, doc_tids, doc_coords, doc_pages, assign, nloc,
                 ploc, T, buckets, page_terms, page_rs):
    """One process of the two-process run: its own shards staged, built
    and queried over the process group; a ShardedDeviceIndex over the
    group serving REQS. Returns numpy results."""
    mesh = dd.make_global_mesh(devices=["cpu"] * D)
    assert mesh.num_hosts == world and list(mesh.own) == list(
        range(rank * D, (rank + 1) * D))
    rows = dd.stage_for_process(doc_tids, doc_coords, doc_pages, assign,
                                world, D, rank, nloc=nloc, ploc=ploc)
    _, sc, off = dd.distributed_build(mesh, rows.term_ids, rows.coords, T)
    hd = np.zeros(rows.bounds.shape, dtype=bool)
    full = []
    for cap, terms, rs in buckets:
        out = dd.distributed_query_full(mesh, off, sc, rows.bounds,
                                        rows.page_doc, hd, terms, rs,
                                        cap=cap, topk=16, hit_cap=128)
        full.append([x.numpy() for x in out])
    page = [x.numpy() for x in dd.distributed_query(
        mesh, off, sc, rows.bounds, rows.page_doc, rows.page_base,
        page_terms, page_rs, cap=64, topk=16)]
    ind = Index(device="cpu")
    ind.add_data_source(ListDataSource("docs", [
        IndexPagedTextFile(f"d{i}", t, "") for i, t in enumerate(TEXTS)]))
    ind.create()
    sdi = ShardedDeviceIndex.from_index(ind, mesh)
    served = sdi.search_batch([compile_request(ind, r) for r in REQS],
                              topk=32, hit_cap=256)
    return full, page, [_fields(r) for r in served]


def test_two_processes_over_gloo(index):
    term_to_id, doc_tids, doc_coords, doc_pages = _corpus()
    T = len(term_to_id)
    assign, nloc, ploc = _plan(doc_tids, doc_pages, H * D)
    rng = np.random.default_rng(5)
    buckets = _buckets(T, rng)
    page_terms = rng.integers(0, T, size=(8, 2)).astype(np.int32)
    page_rs = np.full((8, 2), 40, dtype=np.int32)
    t0 = time.perf_counter()
    out = dd.spawn(_process_leg, H, "gloo", timeout=120, args=(
        doc_tids, doc_coords, doc_pages, assign, nloc, ploc, T, buckets,
        page_terms, page_rs))
    assert time.perf_counter() - t0 < 100
    # the one-process 1-D leg over the same 8-shard plan
    corpus = dd.assemble_global([
        dd.stage_for_process(doc_tids, doc_coords, doc_pages, assign, H, D,
                             p, nloc=nloc, ploc=ploc) for p in range(H)])
    mesh = sh.make_mesh(H * D, devices=["cpu"] * (H * D))
    _, sc, off = sh.sharded_build(mesh, corpus.term_ids, corpus.coords, T)
    hd = np.zeros(corpus.bounds.shape, dtype=bool)
    for k, (cap, terms, rs) in enumerate(buckets):
        want = sh.sharded_query_full(mesh, off, sc, corpus.bounds,
                                     corpus.page_doc, hd, terms, rs, cap=cap,
                                     topk=16, hit_cap=128)
        for f, name in enumerate(FIELDS):
            w = want[f].numpy()
            if name in ("n_pages", "n_hits"):  # every process: all shards
                for p in range(H):
                    assert np.array_equal(out[p][0][k][f], w), name
            else:  # each process: its own shards
                got = np.concatenate([out[p][0][k][f] for p in range(H)])
                assert np.array_equal(got, w), name
    want = sh.sharded_query(mesh, off, sc, corpus.bounds, corpus.page_doc,
                            corpus.page_base, page_terms, page_rs, cap=64,
                            topk=16)
    for p in range(H):
        for g, w in zip(out[p][1], want):
            assert np.array_equal(g, w.numpy())
        assert out[p][2] == [_fields(index.search(r)) for r in REQS]


def _fails_on_rank_one(rank, world):
    import torch.distributed as dist

    if rank == 1:
        raise ValueError("rank 1 gives up")
    dist.barrier()  # never completes: rank 1 does not come


def _sleeps(rank, world):
    time.sleep(600)


def test_spawn_fails_fast():
    """A process that raises fails the run at once (its partner, stuck
    in a collective, is stopped); processes past the timeout fail it
    when the timeout is up."""
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="rank 1 gives up"):
        dd.spawn(_fails_on_rank_one, 2, "gloo", timeout=60)
    assert time.perf_counter() - t0 < 45
    t0 = time.perf_counter()
    with pytest.raises(TimeoutError):
        dd.spawn(_sleeps, 2, "gloo", timeout=8)
    assert time.perf_counter() - t0 < 30
