"""Document-sharded index build and query over a list of devices: twin
of docodo_tpu/parallel/sharding.py.

The JAX package shards over a jax.sharding Mesh with one axis "d"; here
the mesh is a tuple of torch devices, one a shard (make_mesh), and
several shards may share a card. The layout is the same:

* every shard owns a disjoint set of DOCUMENTS: its own coordinate
  space, postings CSR and page table rows; documents never span shards,
  so proximity windows need no halo exchange;
* build: one build_postings per shard on its device (sharded_build);
* query: the query batch is replicated; every shard evaluates it
  against its own CSR with the single-device routing of
  ops/device_index (the hand kernels on a card), and what the JAX
  package's all_gather over "d" does becomes copies of the shards'
  outputs onto one device (sharded_query, sharded_query_full) or into
  pinned host memory for a readback (fetch).

Each shard keeps its own state, unpadded, on its own device; the host
staging (ShardedCorpus) keeps the JAX package's padded [S, N] arrays.
Term ids are global, so every shard's CSR has offsets [T + 1].

    mesh = make_mesh(4)                          # the card(s)
    mesh = make_mesh(4, devices=["cpu"] * 4)     # the CPU, as the tests
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from docodo_tpu_torch.ops import device_index as di
from docodo_tpu_torch.ops.seqops import INF32, select_slots, topk_nonneg


def make_mesh(n_shards: int, devices=None) -> tuple:
    """One torch device a shard. By default the shards go round robin
    over the host's CUDA cards (on a one-card host every shard is on
    cuda:0); without CUDA that raises, and a CPU mesh needs `devices`."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh places shards on CUDA cards, but "
                               "CUDA is not available; pass devices=[\"cpu\""
                               "] * n to shard on the CPU")
        n = torch.cuda.device_count()
        devices = [torch.device("cuda", i % n) for i in range(n_shards)]
    devices = tuple(torch.device(d) for d in devices)
    if len(devices) != n_shards:
        raise ValueError(f"{n_shards} shards, {len(devices)} devices")
    return devices


def _on(x, dev) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(x) if isinstance(
        x, np.ndarray) else x, device=dev)


def fetch(tensors: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """Every tensor as numpy: a card's tensors go to pinned host memory
    on that card's current stream without waiting, one event is recorded
    on each card behind its copies, and the events are waited for once
    they are all queued."""
    out, events = [], {}
    for t in tensors:
        if not t.is_cuda:
            out.append(t)
            continue
        with torch.cuda.device(t.device):
            dst = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            out.append(dst.copy_(t, non_blocking=True))
            # re-recorded behind each copy: it ends behind the last
            events.setdefault(t.device, torch.cuda.Event()).record()
    for ev in events.values():
        ev.synchronize()
    return [t.numpy() for t in out]


# ---------------------------------------------------------------------------
# sharded build
# ---------------------------------------------------------------------------

def sharded_build(mesh, term_ids, coords, num_terms: int):
    """Sort every shard's tuple stream on its device (sharding.py:53):
    term_ids / coords hold one int32 row a shard (a list, or [S, N]
    arrays; padding slots carry term INF32). Returns per-shard lists
    (sorted terms, sorted coords, offsets int32[T + 1])."""
    st, sc, off = [], [], []
    for dev, t, c in zip(mesh, term_ids, coords):
        a, b, o = di.build_postings(_on(t, dev), _on(c, dev), num_terms)
        st.append(a)
        sc.append(b)
        off.append(o)
    return st, sc, off


# ---------------------------------------------------------------------------
# sharded query
# ---------------------------------------------------------------------------

def page_parts(mesh, term_offsets, coords, bounds, page_doc, page_base,
               terms, rs, cap: int, topk: int):
    """Each shard's page-level top k on its device (the torch route
    query_step, as the JAX package runs XLA's there), pages shifted by
    the shard's page_base: a list of (pages, ranks, counts) [B, topk]."""
    parts = []
    for s, dev in enumerate(mesh):
        p, r, c = di.batched_query_step(
            term_offsets[s], coords[s], _on(bounds[s], dev),
            _on(page_doc[s], dev), _on(terms, dev), _on(rs, dev), cap, topk)
        parts.append((torch.where(p >= 0, p + int(page_base[s]), -1), r, c))
    return parts


def combine_topk(parts, dev):
    """One top k over several (pages, ranks, counts) [B, k] results on
    `dev`: ties go to the lowest flat index (part, then slot), as
    jax.lax.top_k over the gathered [B, S k] does."""
    p, r, c = (torch.stack([x[f].to(dev) for x in parts]) for f in range(3))
    s, b, k = r.shape

    def flat(x):
        return x.transpose(0, 1).reshape(b, s * k)

    top_r, sel = topk_nonneg(flat(r), k)
    return select_slots(flat(p), sel), top_r, select_slots(flat(c), sel)


def sharded_query(mesh, term_offsets, coords, bounds, page_doc, page_base,
                  terms, rs, cap: int, topk: int):
    """The replicated page-level batch against every shard, then one
    global top k (sharding.py:85). Returns (pages int32[B, topk] global
    page rows, ranks f32, counts int32) on the first shard's device."""
    parts = page_parts(mesh, term_offsets, coords, bounds, page_doc,
                       page_base, terms, rs, cap, topk)
    return combine_topk(parts, mesh[0])


def shard_outputs(mesh, term_offsets, coords, bounds, page_doc, is_header,
                  terms, rs, cap: int, topk: int, hit_cap: int,
                  with_docs: bool = True, small=None, page_of=None,
                  use_kernels: bool = True) -> List[di.LocateFull]:
    """Every shard's finished LocateFull for one bucket, on its own
    device: _bucket_full with the single-device routing, the hand kernels
    where use_kernels (their plain versions on CPU tensors), else the
    plain route. small / page_of: one entry a shard, or None."""
    outs = []
    for s, dev in enumerate(mesh):
        outs.append(di._bucket_full(
            term_offsets[s], coords[s], _on(bounds[s], dev),
            _on(page_doc[s], dev), _on(is_header[s], dev), _on(terms, dev),
            _on(rs, dev), cap=cap, topk=topk, hit_cap=hit_cap,
            with_docs=with_docs, use_kernels=use_kernels,
            small=None if small is None else small[s],
            page_of=None if page_of is None else page_of[s]))
    return outs


def stack_fields(outs: Sequence[di.LocateFull], dev) -> tuple:
    """Per-shard LocateFulls as the eight fields [S, B, ...] on `dev`
    (None where the shards have None)."""
    return tuple(None if outs[0][f] is None
                 else torch.stack([o[f].to(dev) for o in outs])
                 for f in range(len(di.LocateFull._fields)))


def sharded_query_full(mesh, term_offsets, coords, bounds, page_doc,
                       is_header, terms, rs, cap: int, topk: int,
                       hit_cap: int, with_docs: bool = True, small=None,
                       page_of=None, use_kernels: bool = True):
    """Full-result twin of sharded_query (sharding.py:193): every shard
    evaluates the replicated batch (terms int32[B, W] or [B, W, V], rs
    [B, W]) with the single-device routed kernels, and the eight
    LocateFull fields come back as [S, B, ...] on the first shard's
    device, hits in SHARD-LOCAL coordinates. with_docs=False leaves None
    in the docs / doc_ranks slots, neither computed nor copied.

    Every row must hold all W words: on the kernel routes a -1 word
    empties the row, where the plain route (use_kernels=False) skips it.
    The per-shard arrays are lists, one entry a shard on its device."""
    outs = shard_outputs(mesh, term_offsets, coords, bounds, page_doc,
                         is_header, terms, rs, cap, topk, hit_cap,
                         with_docs=with_docs, small=small, page_of=page_of,
                         use_kernels=use_kernels)
    return stack_fields(outs, mesh[0])


# ---------------------------------------------------------------------------
# host-side shard assembly (numpy copies of sharding.py:246-461)
# ---------------------------------------------------------------------------

INT32_COORD_LIMIT = (1 << 31) - 1  # device coords are int32 per shard


class ShardCoordinateOverflow(ValueError):
    """A shard's coordinate space would exceed 2^31-1 chars (the int32
    device coordinate contract) — raise rather than silently wrap.
    Remedy: more shards, or split oversized documents."""


def _assign_docs(sizes, extents, num_shards: int):
    """Greedy least-loaded document assignment with an int32 coordinate
    budget per shard (sharding.py:255): each document, largest first,
    goes to the least-loaded shard whose coordinate space still fits its
    extent; a document that fits no shard raises."""
    loads = [0] * num_shards
    coord_loads = [0] * num_shards
    assign = [[] for _ in range(num_shards)]
    order = sorted(range(len(sizes)), key=lambda i: -sizes[i])
    for i in order:
        ext = int(extents[i])
        if ext > INT32_COORD_LIMIT:
            raise ShardCoordinateOverflow(
                f"document {i} spans {ext} chars > 2^31-1; split the "
                f"document (e.g. smaller pages) before staging"
            )
        for s in sorted(range(num_shards), key=loads.__getitem__):
            if coord_loads[s] + ext <= INT32_COORD_LIMIT:
                assign[s].append(i)
                loads[s] += sizes[i]
                coord_loads[s] += ext
                break
        else:
            raise ShardCoordinateOverflow(
                f"document {i} ({ext} chars) fits no shard: every "
                f"shard's int32 coordinate space is full — increase "
                f"num_shards (corpus needs > {num_shards} shards)"
            )
    for s in range(num_shards):
        assign[s].sort()
    return assign


@dataclass
class ShardedCorpus:
    """Host staging of a tokenized corpus into uniform shards."""

    term_ids: np.ndarray   # int32[S, Nloc]
    coords: np.ndarray     # int32[S, Nloc]
    bounds: np.ndarray     # int32[S, Ploc] page END coords per shard
    page_doc: np.ndarray   # int32[S, Ploc]
    page_base: np.ndarray  # int32[S] global page row offset
    terms: List[str]
    n_tokens: np.ndarray   # int32[S]
    # doc_assign[s] = original doc indices on shard s, in shard order
    doc_assign: Optional[List[List[int]]] = None


def _padded(rows, fill, dtype=np.int32):
    """Rows of unequal length as one [S, max(len) or 1] array."""
    width = max((len(r) for r in rows), default=1) or 1
    out = np.full((len(rows), width), fill, dtype=dtype)
    for s, r in enumerate(rows):
        out[s, :len(r)] = r
    return out


def stage_shards(docs: Sequence[Sequence[tuple]],
                 doc_pages: Sequence[Sequence[int]], term_to_id,
                 num_shards: int) -> ShardedCorpus:
    """Assign documents to shards (greedy least-loaded by token count),
    each shard getting its own 0-based coordinate space (sharding.py:306).

    docs[i]      : sequence of (term_id, coord) for document i (coords
                   doc-local ascending)
    doc_pages[i] : page END coords (doc-local) of document i
    """
    extents = [(p[-1] if p else 0) for p in doc_pages]
    assign = _assign_docs([len(d) for d in docs], extents, num_shards)
    tid_rows, coord_rows, bound_rows, pdoc_rows = [], [], [], []
    for s in range(num_shards):
        tids, cs, bs, pd = [], [], [], []
        base = 0
        for ndoc, i in enumerate(assign[s]):
            for t, c in docs[i]:
                tids.append(t)
                cs.append(base + c)
            for pend in doc_pages[i]:
                bs.append(base + pend)
                pd.append(ndoc)
            base += extents[i]
        tid_rows.append(tids)
        coord_rows.append(cs)
        bound_rows.append(bs)
        pdoc_rows.append(pd)
    n_pages = np.array([len(b) for b in bound_rows], dtype=np.int64)
    return ShardedCorpus(
        term_ids=_padded(tid_rows, INF32), coords=_padded(coord_rows, INF32),
        bounds=_padded(bound_rows, INF32), page_doc=_padded(pdoc_rows, 0),
        page_base=np.concatenate([[0], np.cumsum(n_pages)[:-1]]).astype(
            np.int32),
        terms=list(term_to_id),
        n_tokens=np.array([len(t) for t in tid_rows], dtype=np.int32),
        doc_assign=assign,
    )


def assign_docs_contiguous(sizes, extents, num_shards: int):
    """Contiguous balanced document partition (sharding.py:371): shard s
    owns a RANGE of consecutive documents, so within a shard the packed
    coordinate space keeps the global doc adjacency, and the reference's
    cross-document proximity windows match everywhere except at the S-1
    shard boundaries."""
    total = sum(sizes)
    target = max(1, total // num_shards + 1)
    assign = [[] for _ in range(num_shards)]
    s = 0
    load = 0
    coord_load = 0
    for i, size in enumerate(sizes):
        ext = int(extents[i])
        if ext > INT32_COORD_LIMIT:
            raise ShardCoordinateOverflow(
                f"document {i} spans {ext} chars > 2^31-1; split the "
                f"document (e.g. smaller pages) before staging"
            )
        remaining_docs = len(sizes) - i
        if assign[s] and s < num_shards - 1 and (
            load + size > target or coord_load + ext > INT32_COORD_LIMIT
            or remaining_docs <= num_shards - 1 - s
        ):
            s += 1
            load = coord_load = 0
        if coord_load + ext > INT32_COORD_LIMIT:
            raise ShardCoordinateOverflow(
                f"document {i} ({ext} chars) fits no shard: increase "
                f"num_shards (corpus needs > {num_shards} shards)"
            )
        assign[s].append(i)
        load += size
        coord_load += ext
    return assign


def stage_rows(doc_tids, doc_coords, doc_pages, assign, shards,
               nloc: int, ploc: int):
    """The padded rows of `shards` (term_ids, coords, bounds, page_doc
    [len(shards), nloc / ploc], n_tokens): each shard's documents packed
    in assign order, coordinates shifted by the extents before them."""
    k = len(shards)
    term_ids = np.full((k, nloc), INF32, dtype=np.int32)
    coords = np.full((k, nloc), INF32, dtype=np.int32)
    bounds = np.full((k, ploc), INF32, dtype=np.int32)
    page_doc = np.zeros((k, ploc), dtype=np.int32)
    n_tokens = np.zeros(k, dtype=np.int32)
    for row, s in enumerate(shards):
        pos = ppos = base = 0
        for ndoc, i in enumerate(assign[s]):
            t, c = doc_tids[i], doc_coords[i]
            if t is None or c is None:
                raise ValueError(
                    f"doc {i} assigned to local shard {s} but not loaded")
            n = t.size
            term_ids[row, pos: pos + n] = t
            coords[row, pos: pos + n] = c + np.int32(base)
            pos += n
            pages = np.asarray(doc_pages[i], dtype=np.int64)
            bounds[row, ppos: ppos + pages.size] = pages + base
            page_doc[row, ppos: ppos + pages.size] = ndoc
            ppos += pages.size
            base += int(pages[-1]) if pages.size else 0
        n_tokens[row] = pos
    return term_ids, coords, bounds, page_doc, n_tokens


def stage_shards_arrays(doc_tids: Sequence[np.ndarray],
                        doc_coords: Sequence[np.ndarray],
                        doc_pages: Sequence[Sequence[int]], num_shards: int,
                        terms: Sequence[str] = (),
                        assign: Optional[List[List[int]]] = None,
                        ) -> ShardedCorpus:
    """Array-native shard staging (sharding.py:408): the assignment of
    stage_shards, documents kept as numpy (term_id, coord) arrays end to
    end. `assign` overrides the greedy placement with per-shard doc
    lists (assign_docs_contiguous for serving)."""
    if assign is None:
        assign = _assign_docs([t.size for t in doc_tids],
                              [(p[-1] if p else 0) for p in doc_pages],
                              num_shards)
    nloc = max((sum(doc_tids[i].size for i in a) for a in assign),
               default=1) or 1
    shard_pages = [sum(len(doc_pages[i]) for i in a) for a in assign]
    ploc = max(shard_pages, default=1) or 1
    term_ids, coords, bounds, page_doc, n_tokens = stage_rows(
        doc_tids, doc_coords, doc_pages, assign, range(num_shards), nloc,
        ploc)
    return ShardedCorpus(
        term_ids=term_ids, coords=coords, bounds=bounds, page_doc=page_doc,
        page_base=np.concatenate([[0], np.cumsum(shard_pages)[:-1]]).astype(
            np.int32),
        terms=list(terms), n_tokens=n_tokens, doc_assign=assign,
    )


def full_step(mesh, corpus: ShardedCorpus, terms, rs, num_terms: int,
              cap: int, topk: int):
    """One combined build + query step over the mesh (sharding.py:464):
    the sharded build, then the replicated page-level batch and its
    global top k."""
    _, sc, off = sharded_build(mesh, corpus.term_ids, corpus.coords,
                               num_terms)
    return sharded_query(mesh, off, sc, corpus.bounds, corpus.page_doc,
                         corpus.page_base, terms, rs, cap=cap, topk=topk)


# ---------------------------------------------------------------------------
# the dry run (the twin of __graft_entry__.dryrun_multichip)
# ---------------------------------------------------------------------------

_TEXTS = [
    "the pickwick club met at noon and the club adjourned for dinner",
    "mr pickwick spoke to the club about travels and adventures abroad",
    "travels through kent were recounted by the club members at length",
    "noon came and went while pickwick pondered the proposed club rules",
    "the lady smiled at the club members who wandered through the town",
    "dinner was served at noon and the members of the club were pleased",
    "kent roads carried the club carriage through villages and fields",
    "adventures abroad were rare but the club pondered them at dinner",
]
_PAIRS = [[("pickwick", -12), ("club", -8)], [("club", 40), ("members", 40)],
          [("travels", 30), ("kent", 30)], [("noon", 25), ("dinner", 60)]]


def _tiny_corpus():
    from docodo_tpu_torch.lang.tokenizer import tokenize

    term_to_id = {}
    docs, doc_pages = [], []
    for text in _TEXTS:
        words, starts = tokenize(text)
        docs.append([(term_to_id.setdefault(w, len(term_to_id)), int(p))
                     for w, p in zip(words, starts) if 3 <= len(w) <= 32])
        doc_pages.append([len(text)])
    return term_to_id, docs, doc_pages


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """The sharded build, the page-level query with its global top k and
    the full-result leg over an n-device mesh on tiny shapes, then the
    same devices as two simulated hosts (parallel/distributed): process
    staging, the build and both query legs. Raises on a wrong shape or
    an empty result. `devices`: the mesh's devices (the card's by
    default)."""
    from docodo_tpu_torch.parallel import distributed as dd

    mesh = make_mesh(n_devices, devices)
    term_to_id, docs, doc_pages = _tiny_corpus()
    while len(docs) < n_devices:  # every shard owns a document
        docs, doc_pages = docs + docs, doc_pages + doc_pages
    corpus = stage_shards(docs, doc_pages, term_to_id, n_devices)
    terms = np.array([[term_to_id[w] for w, _ in q] for q in _PAIRS],
                     dtype=np.int32)
    rs = np.array([[r for _, r in q] for q in _PAIRS], dtype=np.int32)
    num_terms = len(term_to_id)

    pages, ranks, _ = full_step(mesh, corpus, terms, rs, num_terms, cap=16,
                                topk=8)
    pages, ranks = pages.cpu().numpy(), ranks.cpu().numpy()
    if pages.shape != (len(_PAIRS), 8) or not (pages[0] >= 0).any() \
            or not np.isfinite(ranks).all():
        raise RuntimeError("sharded page-level query: no phrase hit")

    _, sc, off = sharded_build(mesh, corpus.term_ids, corpus.coords,
                               num_terms)
    header = np.zeros(corpus.bounds.shape, dtype=bool)
    out = sharded_query_full(mesh, off, sc, corpus.bounds, corpus.page_doc,
                             header, terms, rs, cap=16, topk=8, hit_cap=64)
    hits = out[6].cpu().numpy()
    if hits.shape != (n_devices, len(_PAIRS), 64) or not (hits < INF32).any():
        raise RuntimeError("sharded full-result query emitted no hits")

    if n_devices >= 2 and n_devices % 2 == 0:
        h, d = 2, n_devices // 2
        doc_tids = [np.array([t for t, _ in x], dtype=np.int32) for x in docs]
        doc_coords = [np.array([c for _, c in x], dtype=np.int32)
                      for x in docs]
        assign = dd.plan_document_assignment(
            [t.size for t in doc_tids], [p[-1] for p in doc_pages], h * d)
        nloc = max(sum(doc_tids[i].size for i in a) for a in assign) or 1
        ploc = max(sum(len(doc_pages[i]) for i in a) for a in assign) or 1
        rows = dd.assemble_global([
            dd.stage_for_process(doc_tids, doc_coords, doc_pages, assign, h,
                                 d, p, nloc=nloc, ploc=ploc)
            for p in range(h)])
        gmesh = dd.make_global_mesh(mesh, num_hosts=h)
        _, sc, off = dd.distributed_build(gmesh, rows.term_ids, rows.coords,
                                          num_terms)
        gp, _, _ = dd.distributed_query(
            gmesh, off, sc, rows.bounds, rows.page_doc, rows.page_base,
            terms, rs, cap=16, topk=8)
        if not (gp.cpu().numpy()[0] >= 0).any():
            raise RuntimeError("two-host page-level query: no phrase hit")
        gout = dd.distributed_query_full(
            gmesh, off, sc, rows.bounds, rows.page_doc,
            np.zeros(rows.bounds.shape, dtype=bool), terms, rs, cap=16,
            topk=8, hit_cap=64)
        ghits = gout[6].cpu().numpy()
        if ghits.shape != (h * d, len(_PAIRS), 64) \
                or not (ghits < INF32).any():
            raise RuntimeError("two-host full-result query emitted no hits")
