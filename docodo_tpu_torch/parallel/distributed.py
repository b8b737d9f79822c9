"""Several processes over torch.distributed: twin of
docodo_tpu/parallel/distributed.py.

The JAX package extends its document sharding over a second mesh axis,
("h", "d") = (processes, local devices). Here a process group takes the
place of axis "h" and each process's local devices the place of "d"
(GlobalMesh): shard s lives in process s // D on its local device
s % D. Documents never span shards, so the only traffic between
processes is the query combine: sharded top k's are reduced within the
process first, and one [B, topk] all_gather crosses processes
(distributed_query); the full-result leg keeps each shard's streams in
the process that holds it and all-gathers only the [S, B] truncation
counts, so every process takes the same re-serve decisions
(distributed_query_full).

Host staging is process-local: stage_for_process materializes only the
rows of this process's shards.

The caller names the backend: "nccl" with one process a card, "gloo"
for CPU tensors, or for processes that share one card (NCCL refuses two
ranks on one card). Gloo gathers no CUDA tensors, so their gathers go
through host tensors. Without a process group, one process simulates
`num_hosts` hosts over its devices, as the JAX package's single-process
("h", "d") mesh does.

    init_distributed("nccl", "tcp://host:port", world_size, rank)
    mesh = make_global_mesh(devices=[f"cuda:{local_rank}"])
    ...
    spawn(fn, 2, "gloo")   # fn(rank, world_size, *args) in 2 processes
"""

from __future__ import annotations

import multiprocessing
import queue as queue_mod
import socket
import time
import traceback
from dataclasses import dataclass
from datetime import timedelta
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from docodo_tpu_torch.parallel import sharding as sh


def init_distributed(backend: str, init_method: Optional[str] = None,
                     world_size: int = 1, rank: int = 0,
                     timeout: float = 60.0) -> None:
    """Join the process group (distributed.py:45): no-op for one process
    or when the group is up. `timeout` (seconds) bounds the rendezvous
    and every collective."""
    if world_size <= 1 or dist.is_initialized():
        return
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=timedelta(seconds=timeout))


@dataclass(frozen=True)
class GlobalMesh:
    """Processes x local devices. `devices` are this process's shards'
    devices (with a group) or every host's, host-major (without one);
    shard s is on host s // num_local."""

    devices: tuple
    num_hosts: int
    group: object = None

    @property
    def num_local(self) -> int:
        return len(self.devices) // (1 if self.group is not None
                                     else self.num_hosts)

    @property
    def num_shards(self) -> int:
        return self.num_hosts * self.num_local

    @property
    def rank(self) -> int:
        return dist.get_rank(self.group) if self.group is not None else 0

    @property
    def own(self) -> range:
        """The shards this process holds."""
        if self.group is None:
            return range(self.num_shards)
        d = self.num_local
        return range(self.rank * d, (self.rank + 1) * d)


def make_global_mesh(devices=None, num_hosts: Optional[int] = None,
                     group=None) -> GlobalMesh:
    """The process group (`group`, else the default one when it is up)
    and this process's local devices (distributed.py:67): by default the
    card of its rank modulo the host's cards. Without a process group,
    one process simulates `num_hosts` hosts over `devices` (every card
    of the host by default)."""
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    if group is not None:
        hosts = dist.get_world_size(group)
        if num_hosts not in (None, hosts):
            raise ValueError(f"num_hosts {num_hosts}, but the process "
                             f"group has {hosts} processes")
        if devices is None:
            devices = sh.make_mesh(1, [torch.device(
                "cuda", dist.get_rank(group) % _cards())])
        return GlobalMesh(tuple(torch.device(d) for d in devices), hosts,
                          group)
    if devices is None:
        devices = sh.make_mesh(_cards())
    devices = tuple(torch.device(d) for d in devices)
    num_hosts = num_hosts or 1
    if len(devices) % num_hosts:
        raise ValueError(f"{len(devices)} devices not divisible by "
                         f"{num_hosts} hosts")
    return GlobalMesh(devices, num_hosts)


def _cards() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("the mesh places shards on CUDA cards, but CUDA "
                           "is not available; pass devices=")
    return torch.cuda.device_count()


# ---------------------------------------------------------------------------
# process-local staging (numpy copies of distributed.py:89-181)
# ---------------------------------------------------------------------------

@dataclass
class ProcessShards:
    """This process's rows of the global ShardedCorpus: shard s lives
    in process s // num_local, which materializes only its own rows."""

    term_ids: np.ndarray   # int32[num_local, Nloc]
    coords: np.ndarray     # int32[num_local, Nloc]
    bounds: np.ndarray     # int32[num_local, Ploc]
    page_doc: np.ndarray   # int32[num_local, Ploc]
    page_base: np.ndarray  # int32[num_local] global page row offsets
    n_tokens: np.ndarray   # int32[num_local]


def plan_document_assignment(doc_sizes: Sequence[int],
                             doc_extents: Sequence[int],
                             num_shards: int) -> List[List[int]]:
    """The global document -> shard plan (greedy least-loaded with the
    int32 coordinate guard): every process computes the same plan from
    the same metadata, then materializes only its own shards."""
    return sh._assign_docs(list(doc_sizes), list(doc_extents), num_shards)


def stage_for_process(doc_tids: Sequence[Optional[np.ndarray]],
                      doc_coords: Sequence[Optional[np.ndarray]],
                      doc_pages: Sequence[Sequence[int]],
                      assign: List[List[int]], num_hosts: int,
                      num_local: int, process_index: int,
                      nloc: Optional[int] = None, ploc: Optional[int] = None,
                      page_counts: Optional[Sequence[int]] = None,
                      ) -> ProcessShards:
    """The shard rows owned by `process_index` (distributed.py:114).
    doc_tids / doc_coords may hold None for documents of other
    processes (never touched; doc_pages is needed for every document,
    for the global page_base). nloc / ploc fix the row widths (pass the
    fleet's maxima for equal shapes); they default to this process's."""
    S = num_hosts * num_local
    if len(assign) != S:
        raise ValueError(f"plan has {len(assign)} shards, mesh has {S}")
    if page_counts is None:
        page_counts = [len(p) for p in doc_pages]
    shard_pages = [sum(page_counts[i] for i in a) for a in assign]
    page_base_all = np.concatenate(
        [[0], np.cumsum(shard_pages)[:-1]]).astype(np.int32)
    own = range(process_index * num_local, (process_index + 1) * num_local)
    if nloc is None:
        nloc = max((sum(doc_tids[i].size for i in assign[s]) for s in own),
                   default=1) or 1
    if ploc is None:
        ploc = max((shard_pages[s] for s in own), default=1) or 1
    term_ids, coords, bounds, page_doc, n_tokens = sh.stage_rows(
        doc_tids, doc_coords, doc_pages, assign, own, nloc, ploc)
    return ProcessShards(
        term_ids=term_ids, coords=coords, bounds=bounds, page_doc=page_doc,
        page_base=page_base_all[list(own)], n_tokens=n_tokens,
    )


def assemble_global(rows_per_process: Sequence[ProcessShards]
                    ) -> sh.ShardedCorpus:
    """Every process's rows stacked into the global [H D, ...] arrays
    (one process: the tests and the dry run)."""
    def cat(f):
        return np.concatenate([getattr(r, f) for r in rows_per_process])

    return sh.ShardedCorpus(
        term_ids=cat("term_ids"), coords=cat("coords"), bounds=cat("bounds"),
        page_doc=cat("page_doc"), page_base=cat("page_base"), terms=[],
        n_tokens=cat("n_tokens"),
    )


# ---------------------------------------------------------------------------
# build + query over the processes
# ---------------------------------------------------------------------------

def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """[P, ...] of every process's `t`, on t's device; through host
    tensors under gloo."""
    via_host = t.is_cuda and dist.get_backend(group) == "gloo"
    x = (t.cpu() if via_host else t).contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.stack(parts).to(t.device)


def distributed_build(mesh: GlobalMesh, term_ids, coords, num_terms: int):
    """Each local shard's sort on its device (distributed.py:191): this
    process's rows (all rows without a process group)."""
    return sh.sharded_build(mesh.devices, term_ids, coords, num_terms)


def distributed_query(mesh: GlobalMesh, term_offsets, coords, bounds,
                      page_doc, page_base, terms, rs, cap: int, topk: int):
    """The replicated page-level batch against every shard
    (distributed.py:217): each host reduces its shards to one top k,
    one all_gather of [B, topk] crosses the processes, and a last top k
    gives the same (pages, ranks, counts) in every process, on its first
    device."""
    dev = mesh.devices[0]
    parts = sh.page_parts(mesh.devices, term_offsets, coords, bounds,
                          page_doc, page_base, terms, rs, cap, topk)
    d = mesh.num_local
    hosts = [sh.combine_topk(parts[i: i + d], dev)
             for i in range(0, len(parts), d)]
    if mesh.group is not None:
        gathered = [all_gather(x, mesh.group) for x in hosts[0]]
        hosts = [tuple(g[h] for g in gathered) for h in range(mesh.num_hosts)]
    return sh.combine_topk(hosts, dev)


def distributed_query_full(mesh: GlobalMesh, term_offsets, coords, bounds,
                           page_doc, is_header, terms, rs, cap: int,
                           topk: int, hit_cap: int, with_docs: bool = True,
                           small=None, page_of=None,
                           use_kernels: bool = True):
    """The full-result leg over the processes (distributed.py:332), with
    sharded_query_full's arguments for this process's shards: the
    stream fields (pages, ranks, counts, docs, doc_ranks, hits) come
    back as [D, B, ...] of this process's shards (every shard without a
    process group), n_pages / n_hits all-gathered into [S, B], on the
    first local device."""
    dev = mesh.devices[0]
    outs = sh.shard_outputs(mesh.devices, term_offsets, coords, bounds,
                            page_doc, is_header, terms, rs, cap, topk,
                            hit_cap, with_docs=with_docs, small=small,
                            page_of=page_of, use_kernels=use_kernels)
    fields = list(sh.stack_fields(outs, dev))
    if mesh.group is not None:
        for f in (3, 7):  # n_pages, n_hits
            g = all_gather(fields[f], mesh.group)
            fields[f] = g.reshape(-1, g.shape[-1])
    return tuple(fields)


# ---------------------------------------------------------------------------
# processes on one host
# ---------------------------------------------------------------------------

FAILURE_GRACE_S = 5.0  # how long spawn waits for the other processes'
                       # reports once one has failed


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _process(rank, world_size, backend, init_method, timeout, fn, args,
             results):
    try:
        init_distributed(backend, init_method, world_size, rank, timeout)
        out = (rank, True, fn(rank, world_size, *args))
    except BaseException:  # noqa: BLE001 — reported to the parent
        out = (rank, False, traceback.format_exc())
    # reported before the group goes down: a partner waiting in a
    # collective then fails too, and its report must not be the only one
    results.put(out)
    if dist.is_initialized():
        dist.destroy_process_group()


def spawn(fn, nprocs: int, backend: str, args=(), timeout: float = 120.0,
          rank_args=None):
    """fn(rank, nprocs, *args, *rank_args[rank]) in `nprocs` fresh
    processes (spawn, not fork: CUDA does not survive a fork) joined in
    one process group over the loopback; returns the ranks' return
    values in rank order. `rank_args` (one tuple a rank) goes to its
    process only. A process that fails, or all of them not done within
    `timeout` seconds, raises here; every process is stopped either
    way. `fn` must be importable by name, its results picklable."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    init_method = f"tcp://127.0.0.1:{_free_port()}"
    procs = [ctx.Process(target=_process, daemon=True, args=(
        rank, nprocs, backend, init_method, timeout, fn,
        tuple(args) + tuple(rank_args[rank] if rank_args else ()), results))
        for rank in range(nprocs)]
    for p in procs:
        p.start()
    out, failed = {}, {}
    deadline = time.monotonic() + timeout
    try:
        while len(out) + len(failed) < nprocs:
            left = deadline - time.monotonic()
            if failed:  # the others' reports, briefly: they fail after it
                left = min(left, FAILURE_GRACE_S)
            try:
                rank, ok, value = results.get(timeout=max(left, 0.1))
            except queue_mod.Empty:
                if failed:
                    break
                if left <= 0:
                    raise TimeoutError(
                        f"{nprocs - len(out)} of {nprocs} processes not "
                        f"done within {timeout} s") from None
                dead = [p.exitcode for p in procs if p.exitcode]
                if dead:
                    raise RuntimeError(f"a process exited with {dead}")
                continue
            (out if ok else failed)[rank] = value
        if failed:
            raise RuntimeError("\n".join(
                f"process {r} failed:\n{v}" for r, v in sorted(failed.items())))
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [out[r] for r in range(nprocs)]
