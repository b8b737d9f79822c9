"""Document-sharded full-result serving: twin of
docodo_tpu/parallel/serving.py.

A built Index is re-sharded by document over a mesh (parallel/sharding
make_mesh, or a distributed.GlobalMesh over several processes): every
shard evaluates the replicated query batch against its own CSR with the
single-device routing (ops/device_index._bucket_full: the hand kernels
on a card), the host reads back each shard's hit streams, moves them to
the index's coordinates and prepares each row once against the index's
own page table, as the host engine prepares its results. Documents never
span shards, so a row's hits are the union of its shards' hits. (The
JAX package materializes each shard against the shard's page table and
merges the documents; the results are the same.)

A query whose per-shard result overflows the topk / hit_cap budget
comes back None, and the caller re-serves it on the host engine.

search_batch_full answers full-result batches with
DeviceIndex.search_batch_full's contract, hits as int64 coordinates of
the whole index: each shard is staged as a DeviceIndex on its card
(FullShard; each entry point stages its own shards, stage()) that
holds its neighbours' postings within `halo` characters of its ends,
so a proximity window across a shard boundary is folded on a card;
the locate keeps only the shard's own range, and one card merges the
shards' first runs, totals and hits into the one index's answer
(merge_runs, merge_hits) before the rank top k and the document
grouping. A row whose window chain could pass a halo is folded
exactly on the host (boundary_status).

Boundary contract: coordinates are corpus-global, so the reference's
proximity windows can span documents. Documents go to shards in
CONTIGUOUS ranges (assign_docs_contiguous), so cross-document windows
match the host within every shard; only a window across one of the S-1
shard boundaries could differ. A query whose window could touch a
boundary (boundary_risk) is evaluated exactly on the host under the
default boundary="reserve", so every result equals the host engine's;
boundary="flag" serves it from the shards and flags it instead.

    sdi = ShardedDeviceIndex.from_index(index, make_mesh(4))
    results = sdi.search_batch([compile_request(index, "pickwick club")])
"""

from __future__ import annotations

import bisect
import contextlib
import itertools
import threading
import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from docodo_tpu_torch.core.postings import PostingSeq
from docodo_tpu_torch.index import PageTable
from docodo_tpu_torch.ops import device_index as di
from docodo_tpu_torch.ops import query_kernels as qk
from docodo_tpu_torch.ops.device_index import (
    _bucket,
    _bucket4,
    build_page_of,
    build_small_tables,
)
from docodo_tpu_torch.ops.seqops import INF32, page_runs
from docodo_tpu_torch.oracle import fold_row
from docodo_tpu_torch.parallel import distributed as dd
from docodo_tpu_torch.parallel import sharding as sh
from docodo_tpu_torch.query.search import (
    SearchResult,
    finalize_doc_ranks,
    prepare_search_result,
)
from docodo_tpu_torch.utils import profiling


def _doc_bases(bounds: np.ndarray, page_doc: np.ndarray, n_docs: int):
    """Each document's base coordinate, the end of the page before its
    first (serving.py:218-223): the last page of the document before
    it, as the reference's pages run in document order."""
    has = np.bincount(page_doc, minlength=n_docs) > 0
    last = np.searchsorted(page_doc, np.arange(n_docs), side="right") - 1
    doc_last = np.where(has, last, 0)
    base = np.zeros(n_docs, dtype=np.uint64)
    if n_docs > 1:
        base[1:] = bounds[doc_last[:-1]]
    return base


def doc_streams(arr, pages):
    """An in-memory index's postings cut by document, each document in
    its own coordinate space (serving.py:204-247, the inverse of the
    reference's coordinate-shift merge): per document its term ids and
    local coordinates (ascending; equal coordinates in the CSR's term
    order), its page ends (local) and its rows of the page table."""
    if arr.coords is None:
        raise ValueError("sharded staging requires an in-memory index")
    counts = np.diff(arr.offsets).astype(np.int64)
    g_tids = np.repeat(np.arange(len(arr.terms), dtype=np.int32), counts)
    bounds = pages.bounds.astype(np.uint64)
    page_doc = pages.page_doc.astype(np.int64)
    n_docs = len(pages.doc_names)
    doc_base = _doc_bases(bounds, page_doc, n_docs).astype(np.int64)
    # a document holds the coordinates [its base, the next one's), so
    # one stable sort by coordinate orders the stream by (document,
    # local coordinate), ties in the CSR's term order, as the JAX
    # package's per-document stable argsorts do (torch's sort runs on
    # every core; a numpy lexsort by (document, local coordinate) took
    # ~10x as long at 256 MB, PERF.md section 6)
    srt = torch.sort(torch.from_numpy(arr.coords.astype(np.int64)),
                     stable=True)
    coords, order = srt.values.numpy(), srt.indices.numpy()
    cuts = np.searchsorted(coords, doc_base[1:], side="left")
    local = coords - np.repeat(doc_base, np.diff(cuts, prepend=0,
                                                 append=coords.size))
    order_p = np.argsort(page_doc, kind="stable")
    psplit = np.searchsorted(page_doc[order_p], np.arange(n_docs + 1))
    page_rows = [order_p[psplit[d]: psplit[d + 1]] for d in range(n_docs)]
    local_b = (bounds.astype(np.int64) - doc_base[page_doc])
    return (np.split(g_tids[order], cuts),
            np.split(local.astype(np.int32), cuts),
            [local_b[r].tolist() for r in page_rows], page_rows)


# characters of each neighbour's text a shard of the full-result path
# holds at its ends: a window chain across a shard boundary folds on a
# card when it has a gap wider than its window within this reach of the
# boundary (boundary_status); the rest go to the host's exact fold
HALO = 8192
# a (term, coordinate) posting as one ascending int64: term << 40 | coord
_KEY_SHIFT = 40
# the full-result path's pad of a hit (int64 coordinates of the index)
HIT_PAD = np.iinfo(np.int64).max


@dataclass
class FullShard:
    """A shard as the full-result path stages it: a DeviceIndex on its
    card over its own documents' postings and its neighbours' within the
    halo, its coordinates the index's less `base`; `keep`, the range of
    its own postings in those coordinates; `page_base`, its first page
    in the index's page table."""

    dix: di.DeviceIndex
    base: int
    keep: tuple
    page_base: int
    shard: int  # its index in the mesh


def _on_card(dev):
    """`dev` as the current device (its current stream the one launches
    and events take), or nothing on the CPU."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


def _ragged_index(cnt, width: int, out_width: int):
    """Where each shard's first `width` items of a row go in the row laid
    out shard after shard ([S, N] counts): [N, S width] positions, past
    the first out_width (or the shard's count) the spare slot out_width."""
    s, n = cnt.shape
    before = torch.cumsum(cnt, 0) - cnt
    lane = torch.arange(width, device=cnt.device)
    pos = before[:, :, None] + lane
    ok = (lane < cnt[:, :, None]) & (pos < out_width)
    return torch.where(ok, pos, out_width).permute(1, 0, 2).reshape(
        n, s * width)


def merge_runs(pg_c, rk_c, ct_c, n_pages, topk: int):
    """The shards' first runs of a batch's rows ([S, N, topk]: pages of
    the index in run order, -1 / 0 / 0 past each shard's count, n_pages
    [S, N]) as one index's first `topk` runs: every shard's after the
    runs of the shards before it, as documents, so runs, lie in shard
    order. Returns (pg_c, rk_c, ct_c [N, topk], n_pages int32 [N]), what
    streams_topk_tail takes."""
    s, n, k = pg_c.shape
    cnt = n_pages.to(torch.int64)
    idx = _ragged_index(cnt, k, topk)

    def lay(x, fill):
        out = x.new_full((n, topk + 1), fill)
        return out.scatter_(1, idx, x.permute(1, 0, 2).reshape(n, s * k))[
            :, :topk]
    return (lay(pg_c, -1), lay(rk_c, 0.0), lay(ct_c, 0.0),
            cnt.sum(0).to(torch.int32))


def merge_hits(hits, n_hits, base):
    """The shards' first hits of a batch's rows ([S, N, hb], each shard's
    coordinates, INF32 past them; n_hits [S, N]) as one index's first hb
    hits: int64 coordinates of the index (a shard's plus base[s]), shard
    after shard, HIT_PAD past them. Returns (hits int64 [N, hb], n_hits
    int32 [N], the exact totals)."""
    s, n, hb = hits.shape
    cnt = n_hits.to(torch.int64)
    idx = _ragged_index(cnt, hb, hb)
    vals = hits.to(torch.int64) + base.to(hits.device)[:, None, None]
    out = torch.full((n, hb + 1), HIT_PAD, dtype=torch.int64,
                     device=hits.device)
    out.scatter_(1, idx, vals.permute(1, 0, 2).reshape(n, s * hb))
    return out[:, :hb], cnt.sum(0).to(torch.int32)


def _cut_after(u, i: int, reach: int, r: int) -> bool:
    """Whether the postings u (sorted, a boundary at 0, u[i] the first at
    or past it) part at a gap wider than r between two neighbours, the
    later at or past 0 and the earlier before `reach`: the left shard's
    fold then ends inside its halo. A neighbour u does not hold lies past
    twice the reach."""
    j = i
    while True:
        if j == 0 or j >= len(u) or u[j] - u[j - 1] > r:
            return True
        if u[j] >= reach:
            return False
        j += 1


def _cut_before(u, i: int, reach: int, r: int) -> bool:
    """_cut_after's mirror: a gap wider than r between neighbours, the
    earlier before 0 and the later at or past -reach."""
    j = i
    while True:
        if j == 0 or j >= len(u) or u[j] - u[j - 1] > r:
            return True
        if u[j - 1] < -reach:
            return False
        j -= 1


def boundary_status(rows, rvals, near, halo: int) -> int:
    """How a compiled row meets the shard boundaries: 0 no window chain
    crosses one, 1 one crosses and each shard's halo holds it, 2 a chain
    may pass a halo (the row is folded exactly on the host).

    A fold's every stream is a subset of the union U of its words'
    postings, and each AND step cuts its groups at gaps wider than its
    window, at most the row's widest R: so the fold parts wherever U has
    such a gap, and a shard's fold over its own postings and a halo of
    its neighbours' is exact on its own range when U parts within the
    halo on each side. near: per boundary, term id -> U's postings of
    that term within twice the halo of it (relative coordinates). A row
    of one word folds no window."""
    if len(rows) < 2:
        return 0
    r = max(abs(int(x)) for x in rvals)
    status = 0
    for nb in near:
        parts = [nb[t] for ids in rows for t in ids if t in nb]
        if not parts:
            continue
        if r > halo:
            return 2
        u = sorted(set(itertools.chain.from_iterable(parts)))
        i = bisect.bisect_left(u, 0)
        if not (_cut_after(u, i, halo, r) and _cut_before(u, i, halo, r)):
            return 2
        if 0 < i < len(u) and u[i] - u[i - 1] <= r:
            status = 1
    return status


def _arrays(compiled, buckets):
    for (cap, w, v), idxs in sorted(buckets.items()):
        terms = np.full((_bucket4(len(idxs)), w, v), -1, dtype=np.int32)
        rs = np.ones(terms.shape[:2], dtype=np.int32)
        for row, qi in enumerate(idxs):
            for j, (ids, r) in enumerate(zip(*compiled[qi][:2])):
                terms[row, j, : len(ids)] = ids
                rs[row, j] = r
        yield idxs, cap, terms[:, :, 0] if v == 1 else terms, rs


class ShardedDeviceIndex:
    """A built host Index staged onto a mesh for serving."""

    # the serving cap ladder (query/batcher.py): a bucket's cap is the
    # first rung that holds its longest list, past the last a power of 2
    CAP_LADDER = (128, 1024, 16384, 1 << 17)

    def __init__(self, index, mesh, assign: List[List[int]], host=None,
                 stage: str = "full"):
        """`index` materializes results (its page text); `host` is the
        build (arr, pages) to stage, the index's own by default; `assign`
        each shard's documents, contiguous ranges. `stage`: the entry
        point whose shards are staged now (see stage()); over several
        processes search_batch's are, whatever it says."""
        src = index if host is None else host
        self.index = index
        self.arr, self.pages = src.arr, src.pages
        self.mesh = mesh
        self.assign = assign
        self.terms = list(self.arr.terms)
        self._tmap = {t: i for i, t in enumerate(self.terms)}
        self._counts = np.diff(self.arr.offsets).astype(np.int64)
        # processes x devices (parallel/distributed): each process holds
        # the shards `own` of one plan; the counts cross processes
        self._is2d = isinstance(mesh, dd.GlobalMesh)
        self.devices = mesh.devices if self._is2d else tuple(mesh)
        self.own = mesh.own if self._is2d else range(len(assign))
        pt = self.pages
        self._doc_base = _doc_bases(pt.bounds.astype(np.uint64),
                                    pt.page_doc.astype(np.int64),
                                    len(pt.doc_names)).astype(np.int64)
        # GLOBAL coordinates where shards 1..S-1 begin: a proximity
        # window across one of them is lost by the sharding
        self.boundaries = np.array(
            [int(self._doc_base[a[0]]) for a in assign[1:] if a],
            dtype=np.uint64)
        self.halo = HALO
        self._batch_seq = itertools.count()
        self._cgq_cache: dict = {}
        self._cgq_lock = threading.Lock()
        self._stage_lock = threading.Lock()
        self._staged: set = set()
        # over several processes every process stages its shards at once
        self.stage("served" if self._is2d else stage)

    # the attributes stage("served") and stage("full") set: reading one
    # before its entry point has run stages it (__getattr__)
    _STAGED_BY = dict.fromkeys(
        ("corpus", "shard_tables", "_sc", "_off", "_bounds", "_page_doc",
         "_is_header", "_page_of", "_small", "_starts", "_shift"),
        "served")
    _STAGED_BY.update(dict.fromkeys(
        ("full", "_cap_counts", "_near", "_base", "_page_doc_g",
         "_is_header_g", "_bounds_g"), "full"))

    def __getattr__(self, name):
        path = ShardedDeviceIndex._STAGED_BY.get(name)
        if path is None or name.startswith("__"):
            raise AttributeError(name)
        self.stage(path)
        return self.__dict__[name]

    def stage(self, path: str) -> None:
        """Stage one entry point's shards on their cards, once: "served"
        (search_batch: the shards re-based by document, their CSRs,
        page_of and small tables; phases mesh.reshard, mesh.build,
        mesh.tables) or "full" (search_batch_full: a FullShard a card;
        phase mesh.halo). An entry point stages its own at its first
        call otherwise, so each pays only for its own copy."""
        if path not in ("served", "full"):
            raise ValueError(f"stage: {path!r} is not 'served' or 'full'")
        if path in self._staged:
            return
        with self._stage_lock:
            if path in self._staged:
                return
            if path == "served":
                self._stage_served()
            else:
                with profiling.phase("mesh.halo"):
                    self._stage_full()
            self._staged.add(path)

    def _stage_served(self) -> None:
        """search_batch's shards (stage("served"))."""
        arr, pt, assign = self.arr, self.pages, self.assign
        with profiling.phase("mesh.reshard"):
            doc_tids, doc_coords, doc_pages, page_rows = doc_streams(arr, pt)
            extents = np.array([(p[-1] if p else 0) for p in doc_pages],
                               dtype=np.int64)
            corpus = sh.stage_shards_arrays(
                doc_tids, doc_coords, doc_pages, num_shards=len(assign),
                terms=list(arr.terms), assign=assign)
            tables = []
            for docs in assign:
                sizes = [page_rows[d].size for d in docs]
                per_page = np.repeat(np.arange(len(docs)), sizes)
                base = np.concatenate([[0], np.cumsum(extents[docs])[:-1]]
                                      ).astype(np.int64)[per_page]
                local = np.concatenate(
                    [np.zeros(0, np.int64)]
                    + [np.asarray(doc_pages[d], np.int64) for d in docs])
                pidx = np.concatenate([np.zeros(0, np.int64)]
                                      + [page_rows[d] for d in docs])
                tables.append(PageTable(
                    bounds=(base + local).astype(np.uint64),
                    page_doc=per_page.astype(np.int64),
                    page_ids=[pt.page_ids[p] for p in pidx],
                    doc_names=[pt.doc_names[d] for d in docs]))
        self.corpus, self.shard_tables = corpus, tables
        # unpadded rows: the real tokens and pages of each own shard
        # (one INF32 slot where a shard has none)
        n_tok = [max(int(corpus.n_tokens[s]), 1) for s in self.own]
        n_pg = [max(len(tables[s].page_ids), 1) for s in self.own]
        rows_t = [corpus.term_ids[s, :n] for s, n in zip(self.own, n_tok)]
        rows_c = [corpus.coords[s, :n] for s, n in zip(self.own, n_tok)]
        build = dd.distributed_build if self._is2d else sh.sharded_build
        with profiling.phase("mesh.build"):  # the rows' copies and sorts
            _, self._sc, self._off = build(self.mesh, rows_t, rows_c,
                                           len(self.terms))
        self._bounds, self._page_doc, self._is_header = [], [], []
        for s, p, dev in zip(self.own, n_pg, self.devices):
            header = np.zeros(p, dtype=bool)
            header[:len(tables[s].page_ids)] = [
                pid == "0" for pid in tables[s].page_ids]
            self._bounds.append(sh._on(corpus.bounds[s, :p], dev))
            self._page_doc.append(sh._on(corpus.page_doc[s, :p], dev))
            self._is_header.append(sh._on(header, dev))
        with profiling.phase("mesh.tables"):
            self._page_of, self._small = self._stage_paged_tables()
        # per shard, where each of its documents starts in the shard's
        # coordinates and what moves it to the index's
        self._starts, self._shift = [], []
        for docs, table in zip(assign, tables):
            local = _doc_bases(table.bounds, table.page_doc,
                               len(docs)).astype(np.int64)
            self._starts.append(local)
            self._shift.append(self._doc_base[docs] - local)

    def _stage_paged_tables(self):
        """Each own shard's page_of (the page of every posting) and its
        combined coords || pages small tables, built by the
        single-device builder from the shard's sorted coordinates as the
        build left them on its device (serving.py:118). Shard counts are
        subsets of the global ones, so the single-device contract (every
        real term of a bucket has count <= cap) holds per shard."""
        page_of, small = [], []
        for k, (s, dev) in enumerate(zip(self.own, self.devices)):
            n = int(self.corpus.n_tokens[s])
            sc = self._sc[k].cpu().numpy()[:n]
            offs = self._off[k].cpu().numpy().astype(np.int64)
            pg = np.zeros(self._sc[k].shape[0], dtype=np.int32)
            breal = self.shard_tables[s].bounds.astype(np.int64)
            if breal.size and n:
                pg[:n] = build_page_of(breal, sc)
            page_of.append(sh._on(pg, dev))
            tabs = build_small_tables(offs, sc, pages_np=pg[:n])
            small.append(tuple(st.to(dev) for st in tabs)
                         if tabs else None)
        return page_of, small

    def _stage_full(self) -> None:
        """The full-result path's shards (FullShard), one on each shard's
        card, cut from the build's CSR on the first card: shard s holds
        the postings in [its start - halo, its end + halo) (no halo past
        the corpus's ends), its pages and the index's term ids. Also
        the per-term cap of a bucket (the most postings any shard holds
        of it), the postings within twice the halo of each boundary
        (boundary_status' `near`), and the index's page_doc / is_header
        on the first card for the document grouping."""
        arr, pt, doc_base = self.arr, self.pages, self._doc_base
        dev0 = self.devices[0]
        n_terms = len(self.terms)
        bounds = pt.bounds.astype(np.int64)
        page_doc = pt.page_doc.astype(np.int64)
        header = np.fromiter((pid == "0" for pid in pt.page_ids),
                             dtype=bool, count=len(pt.page_ids))
        counts = torch.from_numpy(self._counts)
        coords = torch.from_numpy(arr.coords.view(np.int64)).to(dev0)
        if coords.numel() and int(coords.max()) >= (1 << _KEY_SHIFT):
            raise sh.ShardCoordinateOverflow(
                f"corpus spans {int(coords.max())} chars >= 2^{_KEY_SHIFT}")
        # one ascending key a posting: the CSR is by term, then coordinate
        keys = torch.repeat_interleave(
            torch.arange(n_terms, device=dev0), counts.to(dev0),
            output_size=coords.numel())
        keys.bitwise_left_shift_(_KEY_SHIFT).bitwise_or_(coords)
        del coords
        first = (torch.arange(n_terms, device=dev0, dtype=torch.int64)
                 << _KEY_SHIFT)
        end_all = (1 << _KEY_SHIFT) - 1

        def n_in(lo: int, hi: int) -> int:
            """Postings in [lo, hi)."""
            return int((torch.searchsorted(keys, first + min(hi, end_all))
                        - torch.searchsorted(keys, first + lo)).sum())

        def cut(lo: int, hi: int):
            """Each term's postings in [lo, hi): (offsets int64 [T + 1],
            their keys), on dev0."""
            start = torch.searchsorted(keys, first + lo)
            stop = torch.searchsorted(keys, first + min(hi, end_all))
            cnt = stop - start
            off = torch.zeros(n_terms + 1, dtype=torch.int64, device=dev0)
            torch.cumsum(cnt, 0, out=off[1:])
            n = int(off[-1])
            at = torch.arange(n, device=dev0) + torch.repeat_interleave(
                start - off[:-1], cnt, output_size=n)
            return off, keys[at]

        shards = [(k, a) for k, a in enumerate(self.assign) if a]
        starts = [int(doc_base[a[0]]) for _, a in shards]
        cap = torch.zeros(n_terms, dtype=torch.int64)
        halo_postings = 0
        full = []
        for k, (shard, docs) in enumerate(shards):
            own_lo = starts[k]
            own_hi = starts[k + 1] if k + 1 < len(shards) else None
            lo = max(own_lo - self.halo, 0) if k else 0
            hi = end_all if own_hi is None else own_hi + self.halo
            p0 = int(np.searchsorted(page_doc, docs[0], side="left"))
            p1 = int(np.searchsorted(page_doc, docs[-1], side="right"))
            top = (int(bounds[p1 - 1]) if own_hi is None else hi) - lo
            if top >= INF32:
                raise sh.ShardCoordinateOverflow(
                    f"shard {k} spans {top} chars with its halo >= 2^31-1:"
                    f" stage more shards")
            off, got = cut(lo, hi)
            cnt = off.diff()
            cap = torch.maximum(cap, cnt.cpu())
            halo_postings += int(off[-1]) - n_in(
                own_lo, end_all if own_hi is None else own_hi)
            dev = self.devices[shard]
            dix = di.DeviceIndex(
                term_offsets=off.to(torch.int32).to(dev),
                coords=((got & end_all) - lo).to(torch.int32).to(dev),
                bounds=torch.from_numpy(
                    (bounds[p0:p1] - lo).astype(np.int32)).to(dev),
                page_doc=torch.from_numpy(
                    page_doc[p0:p1].astype(np.int32)).to(dev),
                is_header=torch.from_numpy(header[p0:p1]).to(dev),
                page_of=torch.zeros(0, dtype=torch.int32, device=dev),
                small=None, terms=self.terms,
                page_ids=pt.page_ids[p0:p1], doc_names=pt.doc_names,
                _tmap=self._tmap, offsets_np=off.cpu().numpy(),
                page_doc_np=page_doc[p0:p1].astype(np.int32),
                bounds_np=bounds[p0:p1] - lo)
            keep = (own_lo - lo, INF32 if own_hi is None else own_hi - lo)
            full.append(FullShard(dix, lo, keep, p0, shard))
        self._cap_counts = cap.numpy()
        # each boundary's postings within twice the halo, by term
        near = []
        for b in starts[1:]:
            _, got = cut(max(b - 2 * self.halo, 0), b + 2 * self.halo)
            by_term: dict = {}
            for tid, x in zip((got >> _KEY_SHIFT).tolist(),
                              ((got & end_all) - b).tolist()):
                by_term.setdefault(tid, []).append(x)
            near.append(by_term)
        self._near = near
        self._base = torch.tensor([f.base for f in full],
                                  dtype=torch.int64, device=dev0)
        self._page_doc_g = torch.from_numpy(page_doc.astype(np.int32)).to(
            dev0)
        self._is_header_g = torch.from_numpy(header).to(dev0)
        self._bounds_g = torch.from_numpy(bounds).to(dev0)
        self.full = full
        profiling.count("mesh.halo_postings", halo_postings)

    def _global(self, s: int, hits: np.ndarray) -> np.ndarray:
        """Shard s's hit coordinates in the index's coordinates."""
        doc = np.searchsorted(self._starts[s], hits, side="right") - 1
        return (hits + self._shift[s][doc]).astype(np.uint64)

    def device_bytes(self) -> List[int]:
        """Bytes each own shard holds on its device, of the entry points
        staged so far."""
        out = [0] * len(self.devices)
        if "served" in self._staged:
            for k in range(len(self.devices)):
                ts = [self._off[k], self._sc[k], self._bounds[k],
                      self._page_doc[k], self._is_header[k],
                      self._page_of[k]]
                for st in self._small[k] or ():
                    ts += [st.row_map, st.tab]
                out[k] = sum(t.numel() * t.element_size() for t in ts)
        if "full" in self._staged:
            for f in self.full:  # the full-result path's copy
                out[f.shard] += f.dix.device_bytes()
        return out

    # ---- staging -----------------------------------------------------------
    @classmethod
    def from_index(cls, index, mesh, host=None,
                   stage: str = "full") -> "ShardedDeviceIndex":
        """Shard a built in-memory index by document (serving.py:194):
        documents assigned to shards in contiguous ranges balanced by
        postings (each document's postings counted on the mesh's first
        device). `stage`: the entry point whose shards are staged now,
        "full" (search_batch_full) or "served" (search_batch); the
        other's are staged at its first call (stage()). search_batch's
        shards re-base the CSR's (term, coord) stream into per-document
        coordinate spaces, with per-shard page tables that keep the
        original page ids and doc names, so that snippets and headers
        resolve through the parent index. `host`: the build to stage
        (arr, pages), the index's own by default. With a GlobalMesh over
        several processes every process stages the same plan and uploads
        its own shards."""
        src = index if host is None else host
        arr, pt = src.arr, src.pages
        if arr.coords is None:
            raise ValueError("sharded staging requires an in-memory index")
        is2d = isinstance(mesh, dd.GlobalMesh)
        num_shards = mesh.num_shards if is2d else len(mesh)
        dev = (mesh.devices if is2d else tuple(mesh))[0]
        with profiling.phase("mesh.assign"):
            n_docs = len(pt.doc_names)
            page_doc = pt.page_doc.astype(np.int64)
            doc_base = _doc_bases(pt.bounds.astype(np.uint64), page_doc,
                                  n_docs).astype(np.int64)
            # a document holds the coordinates [its base, the next one's)
            doc = torch.bucketize(
                torch.from_numpy(arr.coords.view(np.int64)).to(dev),
                torch.from_numpy(doc_base[1:]).to(dev), right=True)
            sizes = torch.bincount(doc, minlength=n_docs).tolist()
            del doc
            # a document's extent: the end of its last page, in its own
            # coordinates (0 without pages)
            last = np.searchsorted(page_doc, np.arange(n_docs),
                                   side="right") - 1
            has = np.bincount(page_doc, minlength=n_docs) > 0
            extents = np.where(has, pt.bounds.astype(np.int64)[
                np.maximum(last, 0)] - doc_base, 0)
            assign = sh.assign_docs_contiguous(sizes, extents, num_shards)
        return cls(index, mesh, assign, host=host, stage=stage)

    # ---- query compilation -------------------------------------------------
    def term_id(self, term: str) -> int:
        return self._tmap.get(term, -1)

    def posting_count(self, term: str) -> int:
        tid = self.term_id(term)
        return int(self._counts[tid]) if tid >= 0 else 0

    def _round_cap(self, need: int) -> int:
        for c in self.CAP_LADDER:
            if need <= c:
                return c
        return _bucket(need)

    def _compile_one(self, q):
        """One group query -> (rows of variant ids, rvals, cap need), or
        None when some group has no known term (matches nothing)."""
        rows, rvals = [], []
        need = 1
        for codes, r in q:
            if isinstance(codes, str):
                codes = (codes,)
            ids = [i for i in (self.term_id(c) for c in codes) if i >= 0]
            if not ids:
                return None
            for c in codes:
                need = max(need, self.posting_count(c))
            rows.append(ids)
            rvals.append(r)
        return rows, rvals, need

    def _bucketize(self, queries):
        """Queries into (cap, W, V) shape buckets (serving.py:326): the
        cap a rung of CAP_LADDER, V rounded up to a power of two, W
        exact. (The JAX package rounds W up too; the kernel routes fold
        a padded word as an empty operand, so every row of a bucket here
        has all its words.) Returns (compiled, {key: [query idx]})."""
        compiled = [self._compile_one(q) for q in queries]
        buckets = {}
        for i, cg in enumerate(compiled):
            if cg is None:
                continue
            rows, _, need = cg
            v = _bucket(max(len(x) for x in rows), lo=1)
            buckets.setdefault((self._round_cap(need), len(rows), v),
                               []).append(i)
        return compiled, buckets

    def bucket_arrays(self, queries):
        """The batch's buckets as search_batch launches them: (query
        indices, cap, terms int32[R, W] or [R, W, V], rs int32[R, W]),
        R the rows rounded up to a power of four (-1 padded rows)."""
        return list(_arrays(*self._bucketize(queries)))

    def boundary_risk(self, q, max_r: int) -> bool:
        """Whether this query's proximity window could cross one of the
        S-1 shard boundaries: a posting of a query term within max_r of
        a boundary coordinate (conservative: a flagged result MAY miss a
        cross-boundary match, an unflagged one cannot)."""
        if self.boundaries.size == 0:
            return False
        r = np.uint64(max(max_r, 1))
        for codes, _ in q:
            if isinstance(codes, str):
                codes = (codes,)
            for c in codes:
                p = self.arr.get(c)
                if p is None or p.size == 0:
                    continue
                for b in self.boundaries:
                    lo = np.searchsorted(p, b - min(r, b), side="left")
                    hi = np.searchsorted(p, b + r, side="left")
                    if hi > lo:
                        return True
        return False

    def _host_reserve(self, q, filters) -> SearchResult:
        """One group query evaluated EXACTLY on the host: the global
        postings folded by the posting algebra (each group's codes
        OR-merged, then a left proximity-AND fold), the result prepared
        against the global page table."""
        seq: Optional[PostingSeq] = None
        for codes, r in q:
            if isinstance(codes, str):
                codes = (codes,)
            cur: Optional[PostingSeq] = None
            for c in codes:
                p = self.arr.get(c)
                ps = PostingSeq(p if p is not None else np.zeros(0, np.uint64),
                                r)
                cur = ps if cur is None else cur + ps
            seq = cur if seq is None else seq * cur
        coords = seq.coords if seq is not None else np.zeros(0, np.uint64)
        res = prepare_search_result(coords, self.pages, filters or [])
        res.boundary_reserved = True
        return res

    # ---- serving -----------------------------------------------------------
    def _launch(self, terms, rs, cap: int, topk: int, hit_cap: int):
        """One bucket on every own shard: (hits [B, hit_cap] per own
        shard, n_pages, n_hits [S, B]) as device tensors, not waited
        for."""
        kw = dict(cap=cap, topk=topk, hit_cap=hit_cap, with_docs=False,
                  small=self._small, page_of=self._page_of)
        args = (self._off, self._sc, self._bounds, self._page_doc,
                self._is_header, terms, rs)
        if self._is2d:
            out = dd.distributed_query_full(self.mesh, *args, **kw)
            return list(out[6]), out[3], out[7]
        outs = sh.shard_outputs(self.mesh, *args, **kw)
        dev = self.devices[0]
        return ([o.hits for o in outs],
                torch.stack([o.n_pages.to(dev) for o in outs]),
                torch.stack([o.n_hits.to(dev) for o in outs]))

    def search_batch(self, queries, topk: int = 64, hit_cap: int = 1024,
                     materialize=True,
                     filters: Optional[List[Optional[list]]] = None,
                     boundary: str = "reserve") -> List[SearchResult]:
        """Evaluate group queries ([(codes, R), ...] each, as
        compile_request emits them) over the shards and materialize full
        SearchResults equal to the host engine's (serving.py:396).

        A query over any shard's topk / hit_cap budget comes back None:
        the caller re-serves it on the host engine. boundary="reserve"
        evaluates queries whose window could cross a shard boundary
        exactly on the host (boundary_reserved=True); "flag" serves them
        from the shards with boundary_risk=True.

        materialize: True = full (snippets, headers); False = brief
        (finalize_doc_ranks only); "defer" = raw results (doc.rank the
        sum of page ranks), for callers that combine rows first.
        filters: per query, `-filter:` doc-name regexes, applied as each
        shard's docs are assembled (shard doc names are the index's).

        Every bucket is launched on every shard before one readback;
        every row's hits are located in one page-table pass. With
        several processes every process serves the same batch and the
        shards' hit rows are exchanged, so each returns every result.
        The steps report into utils.profiling as mesh.bucket, .risk
        (boundary checks), .reserve (host folds), .launch, .fetch,
        .assemble and .materialize."""
        self.stage("served")
        with profiling.phase("mesh.bucket"):
            compiled, buckets = self._bucketize(queries)
        B = len(queries)
        results: List[Optional[SearchResult]] = [None] * B
        for i, cg in enumerate(compiled):
            if cg is None:
                results[i] = SearchResult()  # matches nothing
        reserved: set = set()
        if boundary == "reserve" and self.boundaries.size:
            for i, cg in enumerate(compiled):
                if cg is None or len(queries[i]) < 2:
                    # one group folds no window: the shards' union is exact
                    continue
                max_r = max((abs(r) for _, r in queries[i]), default=0)
                with profiling.phase("mesh.risk"):
                    risky = self.boundary_risk(queries[i], max_r)
                if risky:
                    reserved.add(i)
                    with profiling.phase("mesh.reserve"):
                        results[i] = self._host_reserve(
                            queries[i], filters[i] if filters is not None
                            else None)
            for key in list(buckets):
                kept = [i for i in buckets[key] if i not in reserved]
                if kept:
                    buckets[key] = kept
                else:
                    del buckets[key]

        with profiling.phase("mesh.launch"):
            launched = [(idxs, self._launch(terms, rs, cap, topk, hit_cap))
                        for idxs, cap, terms, rs in _arrays(compiled,
                                                            buckets)]
        with profiling.phase("mesh.fetch"):
            host = iter(sh.fetch([t for _, (hits, n_pages, n_hits) in
                                  launched for t in (*hits, n_pages,
                                                     n_hits)]))
        t0 = time.perf_counter()
        per_query = {}  # qi -> [(shard, global hits)] of the own shards
        for idxs, (hits, _, _) in launched:
            hv = [next(host) for _ in hits]
            n_pages, n_hits = next(host), next(host)
            for row, qi in enumerate(idxs):
                if (n_pages[:, row] > topk).any() or \
                        (n_hits[:, row] > hit_cap).any():
                    continue  # stays None: the caller re-serves it
                parts = per_query.setdefault(qi, [])
                for s, h in zip(self.own, hv):
                    h = h[row]
                    h = h[h < INF32]
                    if h.size:
                        parts.append((s, self._global(s, h)))
        if self._is2d and self.mesh.group is not None:
            gathered = [None] * self.mesh.num_hosts
            torch.distributed.all_gather_object(gathered, per_query,
                                                group=self.mesh.group)
            per_query = {qi: [p for g in gathered for p in g.get(qi, ())]
                         for qi in per_query}
        # each row's hits in global coordinates, prepared against the
        # index's page table as the host engine prepares its own, all
        # rows located in one pass
        served = sorted(per_query)
        coords = [np.sort(np.concatenate([h for _, h in per_query[qi]]))
                  if per_query[qi] else np.zeros(0, np.uint64)
                  for qi in served]
        page_idx, pos = self.pages.locate(
            np.concatenate(coords) if coords else np.zeros(0, np.uint64))
        off = 0
        for qi, c in zip(served, coords):
            results[qi] = prepare_search_result(
                c, self.pages,
                (filters[qi] or []) if filters is not None else [],
                located=(page_idx[off: off + c.size],
                         pos[off: off + c.size]))
            off += c.size
        t1 = time.perf_counter()
        profiling.record("mesh.assemble", t1 - t0)
        for qi, q in enumerate(queries):
            combined = results[qi]
            if combined is None or compiled[qi] is None:
                continue
            if boundary == "flag" and qi not in reserved:
                combined.boundary_risk = self.boundary_risk(
                    q, max((abs(r) for _, r in q), default=0))
            if materialize == "defer":
                continue  # the caller combines rows, then materializes
            if materialize:
                self.index._materialize_docs(combined)
                combined.found_docs.sort(key=lambda d: d.rank)
            else:
                finalize_doc_ranks(combined)
        profiling.record("mesh.materialize", time.perf_counter() - t1)
        return results


    # ---- the full-result path ----------------------------------------------
    def _compile_full(self, query):
        """One group query -> (id rows, rvals, w, v, cap need, min_need,
        boundary status), or None when some group has no known term,
        with how the cache served it (device_index.compile_cached). The
        cap need is the most postings a shard holds of a term (its
        halo's included); min_need, the smallest group's postings over
        the whole index (the hit tier, as one index picks it)."""
        return di.compile_cached(self._cgq_cache, self._cgq_lock, query,
                                 self._compile_full_uncached)

    def _compile_full_uncached(self, query):
        rows, rvals = [], []
        need = 1
        min_need = None
        for codes, r in query:
            if isinstance(codes, str):
                codes = (codes,)
            ids = [t for t in (self.term_id(c) for c in codes) if t >= 0]
            if not ids:
                return None
            need = max([need] + [int(self._cap_counts[t]) for t in ids])
            vol = int(sum(self._counts[t] for t in ids))
            min_need = vol if min_need is None else min(min_need, vol)
            rows.append(ids)
            rvals.append(r)
        return (rows, rvals, len(rows), max(len(x) for x in rows), need,
                min_need or 1,
                boundary_status(rows, rvals, self._near, self.halo))

    def _exact_rows(self, compiled, qis, tiers, topk: int, hit_cap: int):
        """The rows `qis` folded exactly on the host from the index's
        postings (oracle.fold_row) and located on the first card as the
        plain locate locates a stream (seqops.page_runs, over int64
        coordinates of the index): (pg_c, rk_c, ct_c [n, topk] of the
        first runs, n_pages, n_hits (flagged past the row's tier), hits
        int64 [n, hit_cap], HIT_PAD past them), on that card."""
        dev0 = self.devices[0]
        offs, coords = self.arr.offsets, self.arr.coords
        kept = [fold_row([[coords[offs[t]:offs[t + 1]] for t in ids]
                          for ids in compiled[qi][0]], compiled[qi][1])
                for qi in qis]
        vals = np.full((len(qis), max([hit_cap] + [k.size for k in kept])),
                       HIT_PAD, dtype=np.int64)
        for i, k in enumerate(kept):
            vals[i, :k.size] = k
        with _on_card(dev0):
            vals = torch.from_numpy(vals).to(dev0)
            keep = vals < HIT_PAD
            pg_c, rk_c, ct_c, n_pages = page_runs(
                vals, keep, qk.shared_pg(vals, self._bounds_g), topk)
            tier = torch.tensor(tiers, device=dev0)
            n_hits = keep.sum(dim=1, dtype=torch.int32)
            lane = torch.arange(hit_cap, device=dev0)
            hits = torch.where(lane < tier[:, None], vals[:, :hit_cap],
                               HIT_PAD)
            n_hits = torch.where((tier < hit_cap) & (n_hits > tier),
                                 hit_cap + 1, n_hits)
        return pg_c, rk_c, ct_c.to(torch.float32), n_pages, n_hits, hits

    def _launch_full(self, f: FullShard, flat, keys, shapes, topk: int,
                     use_kernels: bool, seq: int):
        """One card's share of a batch: the bucket arrays copied in, each
        bucket up to its first runs (bucket_pre, hits in the shard's own
        range), and the buckets' outputs joined: (pg_c with the index's
        pages, rk_c, ct_c, n_pages, {hit tier: (hits, n_hits)}), on the
        card, nothing waited for."""
        dx = f.dix
        with _on_card(dx.device), profiling.span("mesh.launch", seq):
            with profiling.span("query.upload", seq):
                buf = flat.to(dx.device, non_blocking=True)
            outs, at = [], 0
            with profiling.span("query.launch", seq):
                for ((cap, w, vb, hb), _), (ts, rs) in zip(keys, shapes):
                    nt, nr = int(np.prod(ts)), int(np.prod(rs))
                    tq = buf[at:at + nt].view(ts)
                    rq = buf[at + nt:at + nt + nr].view(rs)
                    at += nt + nr
                    outs.append(di.bucket_pre(
                        dx.term_offsets, dx.coords, dx.bounds, tq, rq,
                        cap=cap, topk=topk, hit_cap=hb,
                        use_kernels=use_kernels, keep=f.keep))
                pg_c = torch.cat([o.pg_c for o in outs])
                tiers = {}
                for o, k in zip(outs, keys):
                    tiers.setdefault(k[0][3], []).append(o)
                return (torch.where(pg_c >= 0, pg_c + f.page_base, -1),
                        torch.cat([o.rk_c for o in outs]),
                        torch.cat([o.ct_c for o in outs]),
                        torch.cat([o.n_pages for o in outs]),
                        {hb: (torch.cat([o.hits for o in os_]),
                              torch.cat([o.n_hits for o in os_]))
                         for hb, os_ in tiers.items()})

    def search_batch_full(self, queries, topk: int = 64,
                          hit_cap: int = 512, want_docs: bool = True,
                          fused: bool = True, deferred: bool = False,
                          use_kernels: Optional[bool] = None):
        """Full-result batch evaluation over the shards, with
        DeviceIndex.search_batch_full's contract (the same queries,
        buckets by (cap, W, V, hit tier), fused / deferred, the dict of
        numpy arrays) and one index's answers over the whole corpus,
        field for field: pages and docs are the index's, hits int64
        coordinates of the index, HIT_PAD past them.

        The batch is compiled and bucketed once, each bucket's cap the
        most postings a shard holds of its terms. Every shard's card
        takes the batch's bucket arrays in one copy and runs each bucket
        up to its first runs (device_index.bucket_pre: the chunked
        kernels, hits kept in the shard's own range); the first card
        then lays the shards' runs and hits out as one index's
        (merge_runs, merge_hits), ends them as one index does
        (streams_topk_tail, doc_group_topk), puts every field in the
        batch's order and copies it to pinned memory, whose arrays are
        the answer. Nothing is waited for before finish(). Rows whose
        window chain may pass a halo (boundary_status 2) are folded on
        the host and located on the first card (_exact_rows), and share
        its tail.

        use_kernels: the CUDA kernels (default on CUDA cards; on the CPU
        their plain versions) or, with False, the plain route. Spans:
        query.dispatch and mesh.dispatch (the call), mesh.launch (a
        card's uploads and launches, query.upload and query.launch
        inside), mesh.merge (tail.merge, tail.topk, tail.docs),
        mesh.readback, mesh.finish; counters mesh.batches, mesh.rows,
        mesh.boundary_rows (rows a halo served: a window chain across a
        boundary), mesh.reserve_rows (rows folded on the host), and the
        query.* counters once a batch; mesh.merge and mesh.reserve also
        report into the phase registry (profiling.record)."""
        if self._is2d:
            raise NotImplementedError(
                "search_batch_full serves the shards of one process")
        self.stage("full")
        if use_kernels is None:
            use_kernels = self.devices[0].type == "cuda"
        b = len(queries)
        seq = next(self._batch_seq)
        dev0 = self.devices[0]
        with profiling.span("query.dispatch", seq), \
                profiling.span("mesh.dispatch", seq):
            tiers = di.hit_tiers(hit_cap, fused)

            compiled, buckets, reserve = [], {}, []
            misses = full = crossing = 0
            with profiling.span("query.compile", seq):
                for i, q in enumerate(queries):
                    cg, how = self._compile_full(q)
                    compiled.append(cg)
                    if how:
                        misses += 1
                        full += how == 2
                    if cg is None:
                        continue
                    _, _, w, v, need, min_need, status = cg
                    crossing += status == 1
                    if status == 2:
                        reserve.append(i)
                        continue
                    buckets.setdefault(
                        (_bucket(need), w, _bucket(v, lo=1),
                         di.hit_tier(tiers, min_need, hit_cap)),
                        []).append(i)

            # every bucket's terms and rs in one flat int32 buffer
            with profiling.span("query.pack", seq):
                keys = sorted(buckets.items(), key=di._bucket_sort_key)
                order, parts, shapes = [], [], []
                for (cap, w, vb, hb), idxs in keys:
                    rows = _bucket(len(idxs), lo=8) if fused else _bucket4(
                        len(idxs))
                    terms, rs = di.bucket_arrays(compiled, idxs, rows, w, vb)
                    parts += [terms.ravel(), rs.ravel()]
                    shapes.append((terms.shape, rs.shape))
                    order.append(np.concatenate(
                        [idxs, np.full(rows - len(idxs), -1)]).astype(
                            np.int64))
                flat = torch.from_numpy(np.concatenate(parts)) if parts \
                    else None
                if flat is not None and dev0.type == "cuda":
                    flat = flat.pin_memory()

            if not keys and not reserve:
                out = {
                    "pages": np.full((b, topk), -1, dtype=np.int32),
                    "ranks": np.zeros((b, topk), dtype=np.float32),
                    "counts": np.zeros((b, topk), dtype=np.int32),
                    "n_pages": np.zeros(b, dtype=np.int32),
                    "n_hits": np.zeros(b, dtype=np.int32),
                    "hits": np.full((b, hit_cap), HIT_PAD, dtype=np.int64),
                }
                if want_docs:
                    out["docs"] = np.full((b, topk), -1, dtype=np.int32)
                    out["doc_ranks"] = np.zeros((b, topk), dtype=np.float32)
                _count_full(b, misses, full, 0, 0, 0, 0, 0)
                return (lambda: out) if deferred else out

            # each card's batch up to its first runs, every card's
            # launches queued before anything is waited for
            pre = [self._launch_full(f, flat, keys, shapes, topk,
                                     use_kernels, seq)
                   for f in (self.full if keys else ())]

            if reserve:
                t0 = time.perf_counter()
                exact = self._exact_rows(
                    compiled, reserve, [di.hit_tier(tiers, compiled[i][5],
                                                    hit_cap)
                                        for i in reserve], topk, hit_cap)
                profiling.record("mesh.reserve", time.perf_counter() - t0)

            # the merged rows: every bucket's rows (padding rows among
            # them), then the host's; at[i] is query i's row, or the empty
            # row after them for a query with an unknown word
            n_buckets = sum(len(o) for o in order)
            n_rows = n_buckets + len(reserve)
            tier_rows, row = {}, 0
            for o, k in zip(order, keys):
                tier_rows.setdefault(k[0][3], []).append(
                    np.arange(row, row + len(o)))
                row += len(o)
            order = np.concatenate(order) if order else np.zeros(0, np.int64)
            at = np.full(b, n_rows, dtype=np.int64)
            real = order >= 0
            at[order[real]] = np.flatnonzero(real)
            at[reserve] = n_buckets + np.arange(len(reserve))
            # those indices on card 0 in one copy from pinned memory: a
            # copy from pageable memory would wait for the card's queue
            tier_at = {hb: np.concatenate(r) for hb, r in tier_rows.items()}
            index = torch.from_numpy(np.concatenate([at] + list(
                tier_at.values())))
            if dev0.type == "cuda":
                index = index.pin_memory()
            index = index.to(dev0, non_blocking=True)
            sel, at_tier, start = index[:b], {}, b
            for hb, r in tier_at.items():
                at_tier[hb] = index[start:start + r.size]
                start += r.size

            t0 = time.perf_counter()
            with _on_card(dev0), profiling.span("mesh.merge", seq):
                with profiling.span("tail.merge", seq):
                    runs = []
                    hits = torch.full((n_rows + 1, hit_cap), HIT_PAD,
                                      dtype=torch.int64, device=dev0)
                    n_hits = torch.zeros(n_rows + 1, dtype=torch.int32,
                                         device=dev0)
                    if pre:
                        def gather(x):
                            return torch.stack([
                                p[x].to(dev0, non_blocking=True)
                                for p in pre])
                        runs.append(merge_runs(gather(0), gather(1),
                                               gather(2), gather(3), topk))
                        for hb, idx in at_tier.items():
                            h, n = merge_hits(
                                torch.stack([p[4][hb][0].to(
                                    dev0, non_blocking=True) for p in pre]),
                                torch.stack([p[4][hb][1].to(
                                    dev0, non_blocking=True) for p in pre]),
                                self._base)
                            hits[idx, :hb] = h
                            # a row past its tier flags truncation
                            n_hits[idx] = torch.where(
                                n > hb, hit_cap + 1, n) if hb < hit_cap \
                                else n
                    if reserve:
                        runs.append(exact[:4])
                        hits[n_buckets:n_rows] = exact[5]
                        n_hits[n_buckets:n_rows] = exact[4]
                    pg_c, rk_c, ct_c, n_pages = (
                        torch.cat([r[f] for r in runs]) for f in range(4))
                with profiling.span("tail.topk", seq):
                    pages, ranks, counts, _ = qk.streams_topk_tail(
                        pg_c, rk_c, ct_c, None, topk)
                fields = dict(pages=pages, ranks=ranks, counts=counts,
                              n_pages=n_pages)
                if want_docs:
                    with profiling.span("tail.docs", seq):
                        fields["docs"], fields["doc_ranks"] = \
                            di.doc_group_topk(pages, ranks, self._page_doc_g,
                                              self._is_header_g)
                # every field in the batch's order, the empty row
                # (-1 / 0 pads) for a query that reached no bucket
                fields = {f: torch.cat([x, x.new_full(
                    (1,) + tuple(x.shape[1:]),
                    -1 if f in ("pages", "docs") else 0)])[sel]
                    for f, x in fields.items()}
                fields.update(n_hits=n_hits[sel], hits=hits[sel])
                with profiling.span("mesh.readback", seq):
                    host, ready = di._to_host(
                        {f: [x] for f, x in fields.items()})
            profiling.record("mesh.merge", time.perf_counter() - t0)
            _count_full(b, misses, full, len(keys), len(pre),
                        sum(x[0].nbytes for x in host.values()), crossing,
                        len(reserve))

        def finish():
            with profiling.span("mesh.finish", seq):
                with profiling.span("query.finish.wait", seq):
                    if ready is not None:
                        ready.synchronize()
            return {f: x[0] for f, x in host.items()}

        return finish if deferred else finish()


def _count_full(queries: int, misses: int, full: int, buckets: int,
                uploads: int, readback_bytes: int, crossing: int,
                reserved: int) -> None:
    """ShardedDeviceIndex.search_batch_full's counters, once a batch: the
    query.* counters as DeviceIndex.search_batch_full adds them (uploads:
    one copy a card), and mesh.batches, mesh.rows, mesh.boundary_rows,
    mesh.reserve_rows."""
    di._count_batch(queries, misses, full, buckets, readback_bytes,
                    uploads=uploads)
    profiling.count("mesh.batches")
    profiling.count("mesh.rows", queries)
    profiling.count("mesh.boundary_rows", crossing)
    profiling.count("mesh.reserve_rows", reserved)
