"""One run of a benchmark cell: set-up, the measured window, the check of
its answers against the plain reference, and the result.

A cell of BENCHMARK.json names a configuration (configs/<config>.json:
the corpus and its guarantees) and a traffic mix (mixes/<mix>.json, read
by traffic.py); cells/<cell>.json holds the cell's batch and the
batches of its query pool. The call's topk and hit_cap, the warm-up and
the rows checked are the same in every cell (below). Each
metric is a reader, metrics/<metric>.py, whose read(ctx) returns a number
or None. None of these is named in code: a new cell, mix, configuration
or metric is a new file.

Set-up: the corpus from the seed, the port's build (build_index, the
CSR sorted on the card), its staging (DeviceIndex.from_index, or with the
configuration's `layout` the port's sharded index over the layout's
cards), the pool of query batches, and a few warm-up batches through the
timed loop. The window: a closed loop of one application that keeps two
batches in flight, each search_batch_full(deferred=True) call made before
the previous batch's finish(); it closes after the first finish past
`seconds`. Then the program's state is freed and the reference answers a
sample of the window's rows, drawn from the seed with the longest rows
in it; every field must agree exactly.

A configuration may hold "layout": {"shards": S, "cards": C}, S >= C >= 1:
the index staged as S document shards, shard i on card i % C
(parallel/sharding.make_mesh; on the CPU every shard on the CPU). One
shard holds every document, so a layout of one shard stages the one
DeviceIndex on its card. Without the key the run is one DeviceIndex on
the default card. Every card of the layout is synchronised, and its peak
reset and read, at the window's edges; the memory readings are the
fullest card's, the trace's as trace.read gives them over the cards.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level modules no run may load: the JAX package, its benchmarks and
# JAX itself (names compared whole: docodo_tpu_torch is the port)
FORBIDDEN = ("jax", "jaxlib", "flax", "docodo_tpu", "benchmarks")
GIB = float(1 << 30)
# every integer answer's pad (its dtype's maximum) compares as PAD
PAD = np.iinfo(np.int64).min
# every cell's call: search_batch_full(topk=TOPK, hit_cap=HIT_CAP)
TOPK = 64
HIT_CAP = 1024
# batches through the timed loop before the window
WARMUP_BATCHES = 4
# rows each window batch keeps for the check, drawn from the seed (and the
# row naming the most postings); rows checked, the longest among them
CHECK_PER_BATCH = 2
CHECK_ROWS = 128
CHECK_LONGEST = 24


def forbidden_modules() -> List[str]:
    """The forbidden top-level names that sys.modules holds."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    params: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def layout(cfg: dict) -> Optional[Tuple[int, int]]:
    """A configuration's (shards, cards), or None without a layout."""
    lay = cfg.get("layout")
    if lay is None:
        return None
    shards, cards = int(lay["shards"]), int(lay["cards"])
    if not shards >= cards >= 1:
        raise ValueError(f"layout {lay}: needs shards >= cards >= 1")
    return shards, cards


def cell(name: str) -> Cell:
    """A cell of BENCHMARK.json with its files, found by name. A cell
    whose chips differ from its configuration's cards (1 without a
    layout) is refused."""
    bench = _load(os.path.join(ROOT, "BENCHMARK.json"))
    work = [w for w in bench["workloads"] if w["name"] == name]
    if not work:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = work[0]
    conf = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    config = _load(os.path.join(ROOT, conf["file"]))
    cards = (layout(config) or (1, 1))[1]
    if int(w["chips"]) != cards:
        raise SystemExit(f"{name} asks for {w['chips']} chips, but its "
                         f"configuration {w['config']!r} is laid out over "
                         f"{cards} cards")

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]
    return Cell(name=name, chips=int(w["chips"]), config=config,
                mix=_load(os.path.join(HERE, "mixes", f"{w['traffic']}.json")),
                params=_load(os.path.join(HERE, "cells", f"{name}.json")),
                end_to_end=mine(bench["end_to_end"]),
                per_layer=mine(bench["per_layer"]))


def reader(metric: str) -> Callable:
    """read(ctx) of metrics/<metric>.py."""
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclass
class Batch:
    """One batch of the window, on the host clock."""

    pos: int          # position in the pool's sequence (pool index = pos % n)
    rows: int
    call: float       # search_batch_full called
    dispatched: float  # it returned
    finish0: float = 0.0  # finish() called
    done: float = 0.0     # finish() returned the answer


@dataclass
class Run:
    """What a run measured, for the metric readers."""

    setup_s: float
    build_s: float
    stage_s: float
    index_bytes: int
    batches: List[Batch]
    window_s: float
    peak_bytes: int
    bytes_moved: int
    trace: object = None
    peaks: dict = field(default_factory=dict)
    device: str = "cpu"


@contextmanager
def _frozen():
    """The collector off while the benchmark makes its own objects (the
    corpus's documents, the query pool), and those objects frozen after:
    a deployment reads its documents and takes its queries a few at a
    time, so the program's collections should not walk millions of the
    benchmark's objects."""
    gc.disable()
    try:
        yield
    finally:
        gc.enable()
        gc.freeze()


def _sync(*devs) -> None:
    import torch
    for dev in devs:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


@contextmanager
def _span(name: str, on: bool):
    if not on:
        yield
        return
    import torch
    with torch.profiler.record_function(name):
        yield


def _smi(cards) -> str:
    """Each card's name, power limit and, as the window closes, its
    clocks, temperature and power draw, as nvidia-smi reads them, one
    card after the other ("; ")."""
    if cards[0].type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.mem,temperature.gpu,power.draw",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        lines = out.stdout.strip().splitlines()
        return "; ".join(lines[d.index or 0] for d in cards)
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not read"


def _log_fn(dev):
    """The float32 logarithm of the device the program ran on."""
    import torch

    def log(a: np.ndarray) -> np.ndarray:
        t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
        return torch.log(t.to(dev)).cpu().numpy()
    return log


@dataclass
class Index:
    """The set-up's corpus and the port's staged index."""

    corp: object
    dix: object
    cards: tuple       # every card the index is staged on
    n_pages: int
    postings: int
    build_s: float
    stage_s: float
    index_bytes: int
    counts: np.ndarray
    notes: dict

    @property
    def dev(self):
        """The first card."""
        return self.cards[0]


def _cards(lay: Optional[Tuple[int, int]], dev) -> tuple:
    """The cards a run stages on: `dev` without a layout, else the
    layout's cards (the CPU once on the CPU)."""
    import torch
    if lay is None or dev.type != "cuda":
        return (dev,)
    return tuple(torch.device("cuda", i) for i in range(lay[1]))


def _stage(ind, lay: Optional[Tuple[int, int]], cards: tuple):
    """The port's staged index of `ind`: one DeviceIndex on the card
    without a layout or with one shard, else the sharded index over the
    layout's mesh, shard i on card i % C."""
    from docodo_tpu_torch.ops.device_index import DeviceIndex
    if lay is None or lay[0] == 1:
        return DeviceIndex.from_index(ind, device=cards[0])
    from docodo_tpu_torch import ShardedDeviceIndex
    from docodo_tpu_torch.parallel.sharding import make_mesh
    mesh = make_mesh(lay[0], [cards[i % len(cards)] for i in range(lay[0])])
    return ShardedDeviceIndex.from_index(ind, mesh)


def set_up(cfg: dict, seed: int, device: str) -> Index:
    """The corpus of `cfg` from `seed`, the port's build of it and its
    staging on `device`, or with a layout on its cards."""
    import torch

    from docodo_tpu_torch.index import IndexPage, ListDataSource, build_index
    from docodo_tpu_torch.utils import profiling
    from perfbench import corpus as gen

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    lay = layout(cfg)
    cards = _cards(lay, dev)
    dev = cards[0]
    t = time.perf_counter()
    with _frozen():
        corp = gen.generate(cfg, seed, IndexPage)
    corpus_s = time.perf_counter() - t
    profiling.reset()
    t = time.perf_counter()
    ind = build_index(ListDataSource("synth", corp.documents), device=device)
    _sync(dev)
    build_s = time.perf_counter() - t
    phases = {k: v for k, v, _ in profiling.report()}
    corp.documents = None
    if lay is not None:
        # the build's device tensors freed before the shards are staged
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    mem0 = [torch.cuda.memory_allocated(c) if cuda else 0 for c in cards]
    t = time.perf_counter()
    dix = _stage(ind, lay, cards)
    _sync(*cards)
    stage_s = time.perf_counter() - t
    by_card = [(torch.cuda.memory_allocated(c) - m) if cuda else 0
               for c, m in zip(cards, mem0)]
    index_bytes = max(by_card)
    n_pages = len(ind.pages.page_ids)
    postings = int(ind.arr.coords.size)
    del ind
    gc.collect()
    notes = {"corpus_s": corpus_s, "corpus_phases_s": corp.seconds,
             "build_s": build_s,
             "build_phases_s": phases, "stage_s": stage_s,
             "documents": int(corp.page_doc[-1]) + 1, "pages": n_pages,
             "postings": postings, "chars": corp.chars,
             "index_gib": index_bytes / GIB}
    if lay is not None:
        notes.update(
            layout={"shards": lay[0], "cards": lay[1]},
            index_gib_by_card=[b / GIB for b in by_card],
            mesh_phases_s={k: v for k, v, _ in profiling.report()
                           if k.startswith("mesh.")})
        if lay[0] > 1:
            notes["shard_gib"] = [b / GIB for b in dix.device_bytes()]
    return Index(corp=corp, dix=dix, cards=cards, n_pages=n_pages,
                 postings=postings, build_s=build_s, stage_s=stage_s,
                 index_bytes=index_bytes, counts=corp.counts(), notes=notes)


@dataclass
class Traffic:
    """A pool of query batches and what the harness reads of it."""

    pool: object
    post: np.ndarray       # int64 [n, batch] postings each query names
    bytes: List[int]       # least bytes of each batch (work.py)
    keep_rows: list        # rows of each batch kept for the check
    seconds: float


def draw(ix: Index, mix: dict, par: dict, seed: int) -> Traffic:
    """The pool of `par`'s batches of `mix` for `seed`."""
    from perfbench import traffic, work

    t = time.perf_counter()
    n_pool, batch = int(par["pool_batches"]), int(par["batch"])
    with _frozen():
        pool = traffic.draw_pool(mix, ix.counts, ix.corp.words, seed,
                                 n_pool, batch)
    post = np.zeros((n_pool, batch), dtype=np.int64)
    for c, grid in enumerate(pool.words):
        post[pool.classes == c] = work.query_postings(grid, ix.counts)
    nbytes = [work.batch_bytes(p, ix.n_pages, TOPK, HIT_CAP) for p in post]
    pick = np.random.default_rng([int(seed), 2])
    keep_rows = [np.unique(np.append(
        pick.choice(batch, size=min(batch, CHECK_PER_BATCH),
                    replace=False), np.argmax(p))) for p in post]
    return Traffic(pool=pool, post=post, bytes=nbytes, keep_rows=keep_rows,
                   seconds=time.perf_counter() - t)


@dataclass
class Window:
    """What the measured window saw."""

    batches: List[Batch]
    kept: Dict[tuple, dict]
    seconds: float
    peak_bytes: int              # the fullest card's
    setup_peak_bytes: int        # the fullest card's
    peak_bytes_by_card: List[int]
    launches: Dict[str, int]
    trace: object
    wrapped: bool
    card: str


def measure(ix: Index, tf: Traffic, seconds: float, trace: bool,
            on_start: Callable[[], None] = None) -> Window:
    """Warm-up batches, then the window: two batches in flight until the
    first finish past `seconds`. `on_start` runs just before the first
    timed batch."""
    import torch

    from docodo_tpu_torch.ops import _cuda
    from perfbench import trace as tracing

    dev, dix, pool = ix.dev, ix.dix, tf.pool
    cuda = dev.type == "cuda"
    n_pool = len(pool.batches)

    def call(pos: int):
        return dix.search_batch_full(pool.batches[pos % n_pool], topk=TOPK,
                                     hit_cap=HIT_CAP, want_docs=True,
                                     fused=True, deferred=True)

    # warm-up: the loop itself over the first batches of the pool
    warm = WARMUP_BATCHES
    prev = None
    for pos in range(warm):
        fin = call(pos)
        if prev is not None:
            prev()
        prev = fin
    if prev is not None:
        prev()
    _sync(*ix.cards)
    setup_peak = max(torch.cuda.max_memory_allocated(c) if cuda else 0
                     for c in ix.cards)
    if cuda:
        for c in ix.cards:
            torch.cuda.reset_peak_memory_stats(c)
    kernels = [k for k in vars(_cuda).values() if isinstance(k, _cuda.Kernel)]
    launches0 = {k.symbol: k.launches for k in kernels}
    if on_start is not None:
        on_start()

    kept: Dict[tuple, dict] = {}
    done: List[Batch] = []
    prof_cm = nullcontext()
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof_cm = torch.profiler.profile(activities=acts)
    with prof_cm as prof:
        t0 = time.perf_counter()
        pos = warm
        prev = None
        while True:
            with _span("bench.dispatch", trace):
                tc = time.perf_counter()
                fin = call(pos)
                cur = Batch(pos, len(pool.batches[pos % n_pool]), tc,
                            time.perf_counter())
            if prev is not None:
                _finish(prev, trace, kept, tf.keep_rows, n_pool, done)
            prev = (cur, fin)
            pos += 1
            if time.perf_counter() - t0 >= seconds:
                break
        _finish(prev, trace, kept, tf.keep_rows, n_pool, done)
        t1 = time.perf_counter()
        _sync(*ix.cards)
    card = _smi(ix.cards)
    del fin, prev
    peaks = [torch.cuda.max_memory_allocated(c) if cuda else 0
             for c in ix.cards]
    return Window(
        batches=done, kept=kept, seconds=t1 - t0, peak_bytes=max(peaks),
        setup_peak_bytes=setup_peak, peak_bytes_by_card=peaks,
        launches={k.symbol: k.launches - launches0[k.symbol]
                  for k in kernels if k.launches > launches0[k.symbol]},
        trace=tracing.read(prof, card_indices(ix.cards)) if trace else None,
        wrapped=pos - warm > n_pool, card=card)


def card_indices(cards) -> List[int]:
    """The device indices of the cards, as the profiler's trace numbers
    them (none on the CPU)."""
    import torch
    if cards[0].type != "cuda":
        return []
    return [torch.cuda.current_device() if c.index is None else c.index
            for c in cards]


def require_window_call(dix) -> None:
    """Stop the run, with no result, where the staged index has no
    search_batch_full, the call every window makes."""
    if not hasattr(dix, "search_batch_full"):
        raise SystemExit(
            f"{type(dix).__name__} has no search_batch_full(deferred=True),"
            f" the call the window makes: this layout stages but cannot be"
            f" measured; no result")


def check(ix: Index, tf: Traffic, win: Window, seed: int,
          control: bool = False) -> dict:
    """The reference's answers to a sample of the window's rows, drawn
    from the seed with the longest rows (by postings named) in it, against
    the program's. Returns {"differ": bool [rows], "fields": {field:
    rows differing}, "rows": n, "longest": n, "seconds": s} and with
    `control` the control's rows differing ("control")."""
    import torch

    from perfbench import traffic
    from perfbench.reference.search import (FIELDS, Postings, answers,
                                            fold_rows)

    t = time.perf_counter()
    corp, pool, kept = ix.corp, tf.pool, win.kept
    chk = np.random.default_rng([int(seed), 3])
    keys = sorted(kept)
    longest = sorted(keys, key=lambda k: -tf.post[k[0], k[1]])[
        :CHECK_LONGEST]
    chosen = set(longest)
    rest = [k for k in keys if k not in chosen]
    n_more = max(0, min(len(rest), CHECK_ROWS - len(longest)))
    sample = longest + [rest[i] for i in chk.choice(len(rest), size=n_more,
                                                    replace=False)]
    grids = [traffic.query_words(pool, b, r) for b, r in sample]
    rs = [[g[1] for g in pool.batches[b][r]] for b, r in sample]
    needed = np.concatenate([g[g >= 0] for g in grids])
    postings = Postings(corp.ids, corp.coords, needed, len(corp.words))
    log = _log_fn(ix.dev)
    runs = fold_rows(grids, rs, postings, corp.page_end, TOPK, HIT_CAP)
    ref = answers(runs, corp.page_doc, corp.is_header, log)
    got = {f: np.stack([kept[k][f] for k in sample]) for f in FIELDS}
    out = {"differ": _rows_differing(got, ref),
           "fields": {f: int(_field_rows(got[f], ref[f]).sum())
                      for f in FIELDS},
           "rows": len(sample), "longest": len(longest)}
    if control:
        low = answers(runs, corp.page_doc, corp.is_header, log,
                      rank_dtype=torch.bfloat16)
        out["control"] = int(_rows_differing(low, ref).sum())
    out["seconds"] = time.perf_counter() - t
    return out


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: Optional[float] = None,
             config: Optional[dict] = None, params: Optional[dict] = None,
             control: bool = False,
             note: Callable[[dict], None] = None) -> dict:
    """One run of cell `name`; returns the result line's object (and with
    `control` the control's readings under "control"). `config` and
    `params` override keys of the cell's files (the tests' small sizes:
    the corpus, the batch and the pool);
    `note(dict)` receives the earlier lines."""
    t_start = time.perf_counter() if t_start is None else t_start
    note = note or (lambda d: print(json.dumps(d), flush=True))
    import torch

    from perfbench import trace as tracing

    bad = forbidden_modules()
    if bad:
        raise RuntimeError(f"forbidden modules loaded at start: {bad}")
    spec = cell(name)
    cfg = dict(spec.config, **(config or {}))
    par = dict(spec.params, **(params or {}))
    ix = set_up(cfg, seed, device)
    tf = draw(ix, spec.mix, par, seed)
    note({"setup": dict(ix.notes, pool_s=tf.seconds,
                        pool_batches=len(tf.pool.batches),
                        batch=int(par["batch"]))})
    require_window_call(ix.dix)
    setup = {}
    win = measure(ix, tf, seconds, trace, on_start=lambda: setup.update(
        s=time.perf_counter() - t_start))
    dev, cuda = ix.dev, ix.dev.type == "cuda"
    note({"window": {"seconds": win.seconds, "batches": len(win.batches),
                     "queries": sum(b.rows for b in win.batches),
                     "pool_wrapped": win.wrapped, "card": win.card,
                     "peak_gib_by_card": [b / GIB
                                          for b in win.peak_bytes_by_card],
                     "kernel_launches": win.launches}})
    ix.dix = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    metrics = read_metrics(spec.per_layer if trace else spec.end_to_end,
                           window_run(ix, tf, win, setup["s"]))

    chk = check(ix, tf, win, seed, control)
    note({"check": {k: v for k, v in chk.items() if k != "differ"}})
    n_differ = int(chk["differ"].sum())
    bad = forbidden_modules()
    if bad:
        raise RuntimeError(f"forbidden modules loaded: {bad}")
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                   "count": len(ix.cards) if cuda else 1,
                   "memory_peak_bytes": int(max(win.setup_peak_bytes,
                                                win.peak_bytes))}
    result = {"correct": bool(n_differ == 0 and chk["rows"] >= 1),
              "attempted": sum(b.rows for b in win.batches), "failed": 0,
              "metrics": metrics, "device": device_info}
    if trace:
        device_info["busy_s"] = win.trace.busy_s
        device_info["window_s"] = win.trace.window_s
        device_info["busy_s_by_card"] = win.trace.busy_s_by_card
        result["breakdown"] = tracing.breakdown(win.trace)
    result["checks"] = {"rows_differing": {"value": n_differ, "limit": 0}}
    if control:
        result["control"] = {"program_rows_differing": n_differ,
                             "control_rows_differing": chk["control"],
                             "rows_checked": chk["rows"]}
    return result


def window_run(ix: Index, tf: Traffic, win: Window, setup_s: float) -> Run:
    """What the metric readers read of a run's set-up and window."""
    from perfbench import work

    n_pool = len(tf.pool.batches)
    return Run(setup_s=setup_s, build_s=ix.build_s, stage_s=ix.stage_s,
               index_bytes=ix.index_bytes, batches=win.batches,
               window_s=win.seconds, peak_bytes=win.peak_bytes,
               bytes_moved=sum(tf.bytes[b.pos % n_pool]
                               for b in win.batches),
               trace=win.trace, peaks=work.peaks(), device=ix.dev.type)


def read_metrics(metrics: List[dict], run: Run) -> dict:
    """{name: {"value", "unit"}} of each metric whose reader finds a
    number in `run`."""
    out = {}
    for m in metrics:
        v = reader(m["name"])(run)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def _finish(prev, trace: bool, kept: dict, keep_rows, n_pool: int,
            done: List[Batch]) -> None:
    """finish() of a batch in flight, its times, and its sampled rows."""
    cur, fin = prev
    with _span("bench.finish", trace):
        cur.finish0 = time.perf_counter()
        out = fin()
        cur.done = time.perf_counter()
    with _span("bench.between", trace):
        b = cur.pos % n_pool
        for r in keep_rows[b].tolist():
            if (b, r) not in kept:
                kept[(b, r)] = {f: v[r].copy() for f, v in out.items()}
        done.append(cur)


def _unpadded(a: np.ndarray) -> np.ndarray:
    """An integer answer as int64, its pad (its dtype's maximum: INT32_MAX
    for int32 hits, the maximum of uint64 or int64 global coordinates)
    mapped to PAD."""
    return np.where(a == np.iinfo(a.dtype).max, PAD, a.astype(np.int64))


def _field_rows(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Rows of a field that differ (bitwise for floats; integers with
    each side's pad mapped to one sentinel)."""
    if a.dtype.kind == "f":
        a, b = a.view(np.int32), b.astype(a.dtype).view(np.int32)
    else:
        a, b = _unpadded(a), _unpadded(b)
    diff = a != b
    return diff.reshape(diff.shape[0], -1).any(axis=1)


def _rows_differing(got: dict, ref: dict) -> np.ndarray:
    from perfbench.reference.search import FIELDS
    out = np.zeros(len(got["pages"]), dtype=bool)
    for f in FIELDS:
        out |= _field_rows(got[f], ref[f])
    return out


def summary_lines(result: dict) -> List[str]:
    """Each compared number beside its limit."""
    return [f"check {k}: {v['value']} (limit {v['limit']})"
            for k, v in result["checks"].items()]

