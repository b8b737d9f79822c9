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

import time
from typing import List, Optional

import numpy as np
import torch

from docodo_tpu_torch.core.postings import PostingSeq
from docodo_tpu_torch.index import PageTable
from docodo_tpu_torch.ops.device_index import (
    _bucket,
    _bucket4,
    build_page_of,
    build_small_tables,
)
from docodo_tpu_torch.ops.seqops import INF32
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

    def __init__(self, index, mesh, corpus: sh.ShardedCorpus,
                 shard_tables: List[PageTable], host=None):
        """`index` materializes results (its page text); `host` is the
        build (arr, pages) that `corpus` was staged from, the index's
        own by default."""
        src = index if host is None else host
        self.index = index
        self.arr, self.pages = src.arr, src.pages
        self.mesh = mesh
        self.corpus = corpus
        self.shard_tables = shard_tables
        self.terms = list(self.arr.terms)
        self._tmap = {t: i for i, t in enumerate(self.terms)}
        self._counts = np.diff(self.arr.offsets).astype(np.int64)
        # processes x devices (parallel/distributed): each process holds
        # the shards `own` of one plan; the counts cross processes
        self._is2d = isinstance(mesh, dd.GlobalMesh)
        self.devices = mesh.devices if self._is2d else tuple(mesh)
        self.own = mesh.own if self._is2d else range(len(shard_tables))
        # unpadded rows: the real tokens and pages of each own shard
        # (one INF32 slot where a shard has none)
        n_tok = [max(int(corpus.n_tokens[s]), 1) for s in self.own]
        n_pg = [max(len(shard_tables[s].page_ids), 1) for s in self.own]
        rows_t = [corpus.term_ids[s, :n] for s, n in zip(self.own, n_tok)]
        rows_c = [corpus.coords[s, :n] for s, n in zip(self.own, n_tok)]
        build = dd.distributed_build if self._is2d else sh.sharded_build
        with profiling.phase("mesh.build"):  # the rows' copies and sorts
            _, self._sc, self._off = build(mesh, rows_t, rows_c,
                                           len(self.terms))
        self._bounds, self._page_doc, self._is_header = [], [], []
        for s, p, dev in zip(self.own, n_pg, self.devices):
            header = np.zeros(p, dtype=bool)
            header[:len(shard_tables[s].page_ids)] = [
                pid == "0" for pid in shard_tables[s].page_ids]
            self._bounds.append(sh._on(corpus.bounds[s, :p], dev))
            self._page_doc.append(sh._on(corpus.page_doc[s, :p], dev))
            self._is_header.append(sh._on(header, dev))
        with profiling.phase("mesh.tables"):
            self._page_of, self._small = self._stage_paged_tables()
        pt = self.pages
        doc_base = _doc_bases(pt.bounds.astype(np.uint64),
                              pt.page_doc.astype(np.int64),
                              len(pt.doc_names)).astype(np.int64)
        # GLOBAL coordinates where shards 1..S-1 begin: a proximity
        # window across one of them is lost by the sharding
        self.boundaries = np.array(
            [int(doc_base[a[0]]) for a in corpus.doc_assign[1:] if a],
            dtype=np.uint64)
        # per shard, where each of its documents starts in the shard's
        # coordinates and what moves it to the index's
        self._starts, self._shift = [], []
        for docs, table in zip(corpus.doc_assign, shard_tables):
            local = _doc_bases(table.bounds, table.page_doc,
                               len(docs)).astype(np.int64)
            self._starts.append(local)
            self._shift.append(doc_base[docs] - local)

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

    def _global(self, s: int, hits: np.ndarray) -> np.ndarray:
        """Shard s's hit coordinates in the index's coordinates."""
        doc = np.searchsorted(self._starts[s], hits, side="right") - 1
        return (hits + self._shift[s][doc]).astype(np.uint64)

    def device_bytes(self) -> List[int]:
        """Bytes each own shard holds on its device."""
        out = []
        for k in range(len(self.devices)):
            ts = [self._off[k], self._sc[k], self._bounds[k],
                  self._page_doc[k], self._is_header[k], self._page_of[k]]
            for st in self._small[k] or ():
                ts += [st.row_map, st.tab]
            out.append(sum(t.numel() * t.element_size() for t in ts))
        return out

    # ---- staging -----------------------------------------------------------
    @classmethod
    def from_index(cls, index, mesh, host=None) -> "ShardedDeviceIndex":
        """Re-shard a built in-memory index by document (serving.py:194):
        the CSR's (term, coord) stream re-based into per-document
        coordinate spaces, documents assigned to shards in contiguous
        ranges, and per-shard page tables that keep the original page
        ids and doc names, so that snippets and headers resolve through
        the parent index. `host`: the build to stage (arr, pages), the
        index's own by default. With a GlobalMesh over several
        processes every process stages the same plan and uploads its
        own shards."""
        src = index if host is None else host
        arr, pt = src.arr, src.pages
        num_shards = mesh.num_shards if isinstance(
            mesh, dd.GlobalMesh) else len(mesh)
        with profiling.phase("mesh.reshard"):
            doc_tids, doc_coords, doc_pages, page_rows = doc_streams(arr, pt)
            extents = np.array([(p[-1] if p else 0) for p in doc_pages],
                               dtype=np.int64)
            assign = sh.assign_docs_contiguous(
                [t.size for t in doc_tids], extents, num_shards)
            corpus = sh.stage_shards_arrays(
                doc_tids, doc_coords, doc_pages, num_shards=num_shards,
                terms=list(arr.terms), assign=assign)
            tables = []
            for docs in corpus.doc_assign:
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
        return cls(index, mesh, corpus, tables, host=host)

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

