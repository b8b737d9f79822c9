"""Smoke run of docodo_tpu_torch on one NVIDIA GPU: builds the CUDA
kernels from the checkout, holds each against its plain PyTorch version,
builds a seeded 64 MB Zipf corpus index with the port's build (the
native tokenizer and interner, the CSR sorted on the card; held array for
array against the pure-Python build on the CPU), builds a 1 GB corpus's
CSR by the JAX package's packed protocol (tokenize on threads, pack,
pinned copy, sort on the card; build_mb_s) and by the port's build_index
over the same documents, writes that build to disk and reads it back,
runs the console app (python -m docodo_tpu_torch.cli) in processes of
its own to build the 64 MB corpus from .txt files into an index folder
and to serve that folder over HTTP with -batch, every answer held
against Index.search of the folder loaded in this process, whose device
index serves both mixes below through the kernels as the in-memory
build's does, serves the standard 10k query mix and the wide
10k mix (3-4-word phrases, variant ORs, wildcard unions, field rows)
plus 1,000 `a|b`
alternations through the kernel route and the plain route of the
full-result path (search_batch_full), the standard mix through both
routes of the page-level path (search_batch, topk 16), times every
kernel on the calls those batches make, checks sampled results against
an independent numpy oracle, and serves words of a small Russian corpus
built with Dict/ru.voc through their vocabulary keys. Both mixes also go
through the full-result path in the shape a server sends it: waves of
512 rows through search_batch_full(fused=False, cap_ladder, deferred)
with one wave in flight while the next is dispatched, then the truncated
rows of cap <= 2048 once more at the escalated budgets (topk 2048,
hit_cap 8192, clamp_budgets), once with each bucket's first-topk runs
and the torch tail (sort_topk=True) and once through the top-k-mode
kernels and merge_and_locate (sort_topk=False). Last, the serving path
as a user reaches it: request strings (benchmarks/serve_qps.py's recipe
and wide ones) through BatchExecutor.search from 64 client threads in
four configurations, pipeline and materialize on and off, with a
rebuild mid-stream, every request held against the host engine
(Index.search), then through DocodoServer on the loopback. Then the
document-sharded path (parallel/): BatchExecutor and DocodoServer with
mesh=make_mesh(4) on the same requests; two processes of two shards each
over one torch.distributed process group (NCCL with a card each where
the host has two or more, else gloo on one card), held against one
process's ShardedDeviceIndex; dryrun_multichip(4); and a 256 MB index
as four shards serving both mixes beside one card's route, every
compared row equal to one card's and sampled rows to the exact host
evaluation. Between the vocabulary and the batcher, the JAX package's
last surface (phase_surface): the 1 GB documents through
tokenize_intern_packed into one native interner in slices of whole
documents, split_packed and build_postings_packed on the card, held
against the packed protocol above; the standard mix's buckets through
multi_bucket_query_full_chained and multi_bucket_query_step_chained,
five reps chained with one readback, against the unchained calls; the
set operations (device_and / device_or / batch_and / batch_or /
device_locate_rank) on 256 pairs of posting lists and
batched_query_step_variants on the vocabulary groups, against the host
and the CPU; Index[term] on the 64 MB index and on the console app's
folder, loaded in memory and lazily. The memory-bounded build
(Index(path).create() spilling) runs the 1 GB documents on one thread,
its files byte-equal to the unspilled build's, and the first quarter of
them on two threads against build_index of that quarter: the depth cut
that pays for phase_surface.

    python3 chip_smoke.py [--corpus-mb 64] [--build-mb 1000] [--seed 0]
                          [--mesh-mb 256]

Prints one line per phase, a JSON line with every kernel's launches,
error, times and bound, the card's name and power limit, and as its last
line {"ok": true, "device": {...}}. Exits non-zero, without that line,
when there is no CUDA device or any phase fails. Imports no jax and
nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

TOPK = 64
HIT_CAP = 1024
PAGE_TOPK = 16      # bench.py:41, the page-level leg's budget
N_QUERIES = 10_000  # the standard and the wide mix's batch
N_ALTERNATIONS = 1_000
WIDE_SEED = 77      # bench.py:353

LOCATE_FULL = "docodo_tpu_torch/csrc/locate_full.cu"
PROBES = "docodo_tpu_torch/csrc/probes.cu"
CHUNKED = "docodo_tpu_torch/csrc/chunked.cu"
VARIANTS = "docodo_tpu_torch/csrc/variants.cu"
FETCH = "docodo_tpu_torch/csrc/fetch.cu"
PQ = "docodo_tpu/ops/pallas_query.py"
RU_VOC = Path(__file__).resolve().parent / "Dict" / "ru.voc"
# name -> (source, TPU kernel replaced, [(kernel core, plain core), ...]);
# the cores are the query_kernels functions a wrapper hands its inputs to
KERNELS = {
    "sorted_and_locate_full": (LOCATE_FULL, f"{PQ}:617",
                               [("_sorted_and_kernel", "_sorted_and_plain")]),
    "single_locate_full": (LOCATE_FULL, f"{PQ}:723",
                           [("_single_kernel", "_single_plain")]),
    "union_locate_full": (LOCATE_FULL, f"{PQ}:660",
                          [("_union_kernel", "_union_plain")]),
    "merge_and_locate_topk": (LOCATE_FULL, f"{PQ}:2623",
                              [("_merge_and_locate_kernel",
                                "_sorted_and_plain")]),
    "merge_tagged": (CHUNKED, f"{PQ}:2290",
                     [("_merge_tagged_kernel", "_merge_tagged_plain")]),
    "and_keep": (CHUNKED, f"{PQ}:1935",
                 [("_and_keep_kernel", "_and_keep_plain"),
                  ("_and_keep_compact_kernel", "_and_keep_compact_plain")]),
    "locate_runs": (CHUNKED, f"{PQ}:1480",
                    [("_locate_runs_kernel", "_locate_runs_plain")]),
    "variants_and_locate_full": (VARIANTS, f"{PQ}:638",
                                 [("_variants_and_kernel",
                                   "_variants_and_plain")]),
    "union_merge_locate_full": (VARIANTS, f"{PQ}:681",
                                [("_union_merge_kernel",
                                  "_union_merge_plain")]),
    "variants_keep": (CHUNKED, f"{PQ}:2071",
                      [("_variants_keep_kernel", "_variants_keep_plain")]),
    # also the counterpart of _and_locate_kernel (pallas_query.py:133)
    "and_locate_topk": (LOCATE_FULL, f"{PQ}:477",
                        [("_and_topk_kernel", "_and_topk_plain")]),
    "single_locate_topk": (LOCATE_FULL, f"{PQ}:200",
                           [("_single_topk_kernel", "_single_topk_plain")]),
    # the top-k-mode full-result kernels and the full-width fused kernel
    "sorted_and_locate_full_topk": (LOCATE_FULL, f"{PQ}:498",
                                    [("_sorted_and_topk_kernel",
                                      "_sorted_and_topk_plain")]),
    "variants_and_locate_full_topk": (VARIANTS, f"{PQ}:526",
                                      [("_variants_and_topk_kernel",
                                        "_variants_and_topk_plain")]),
    "union_locate_full_topk": (VARIANTS, f"{PQ}:550",
                               [("_union_topk_kernel", "_union_topk_plain")]),
    "single_locate_full_topk": (LOCATE_FULL, f"{PQ}:218",
                                [("_single_topk_mode_kernel",
                                  "_single_topk_mode_plain")]),
    "merge_and_locate": (LOCATE_FULL, f"{PQ}:2601",
                         [("_merge_and_locate_streams_kernel",
                           "_merge_and_locate_streams_plain")]),
    # no Pallas kernel: the JAX package's XLA gather (gather_term, and
    # gather_term_paged at :499)
    "fetch_postings": (FETCH, "docodo_tpu/ops/device_index.py:397",
                       [("_fetch_kernel", "_fetch_plain")]),
}
# the probe kernels of the JAX package's benchmarks/ (PERF.md rows 18-19):
# name -> (source, TPU kernel replaced); phase_probes launches and times
# them
PROBE_KERNELS = {
    "probe_locate": (PROBES, "benchmarks/probe_locate.py:130"),
    "row_gather": (PROBES, "benchmarks/probe_dma_fetch.py:80"),
}
# each phase's seconds in one run of commit ccdff79, before phase_surface
# and the cut of phase_build_spilled, on an NVIDIA H100 80GB HBM3 at
# 700 W; printed beside this run's
BEFORE = ("ccdff79", {
    "build": 24.2, "parity": 33.8, "index": 40.9, "build at scale": 92.8,
    "spilled build": 322.1, "disk": 103.4, "main and page": 7.2,
    "probes": 16.0, "serve": 8.5, "kernel times": 56.2,
    "oracle and vocabulary": 0.8, "batcher": 152.2, "mesh batcher": 19.0,
    "distributed": 24.0, "mesh": 59.8, "in all": 960.9})
# the rows of each mix phase_build_spilled serves on both builds of its
# two-thread leg
SPILLED_ROWS = 2_000
# phase_surface: slices of whole documents of about this many characters
# (benchmarks/scale_build.py:140 cuts its text every 8,000,000), the
# chained reps, the posting-list pairs of the set operations and their
# longest list, the Index[term] lookups an index
SURFACE_SLICE_CHARS = 8_000_000
SURFACE_REPS = 5
SURFACE_PAIRS = 256
SURFACE_CAP = 2048
SURFACE_TERMS = 1000
STANDARD_KERNELS = ("sorted_and_locate_full", "single_locate_full",
                    "union_locate_full", "merge_and_locate_topk",
                    "merge_tagged", "and_keep", "locate_runs",
                    "fetch_postings")
WIDE_KERNELS = ("variants_and_locate_full", "union_merge_locate_full",
                "variants_keep", "merge_tagged", "and_keep", "locate_runs",
                "fetch_postings")
PAGE_KERNELS = ("and_locate_topk", "single_locate_topk")
TOPK_MODE_KERNELS = ("sorted_and_locate_full_topk",
                     "variants_and_locate_full_topk",
                     "union_locate_full_topk", "single_locate_full_topk")
SERVE_KERNELS = TOPK_MODE_KERNELS + ("merge_and_locate",)
SERVE_REQUESTS = 10_000  # benchmarks/serve_qps.py's --n default
WIDE_REQUESTS = 2_000
BATCHER_CLIENTS = 64     # serve_qps.py's --conc default
# the first of each stream, not all 12,000: at 64 MB a third of the
# recipe's requests overflow even the escalated budget and the host
# engine answers them, each finding 1,000-10,000 pages whose snippets it
# makes. A request costs ~45-80 ms of the phase and a distinct one ~90 ms
# more to check (PERF.md sections 5 and 6), so 12,000 would take
# ~9 minutes a configuration. The first configuration (with the restage)
# serves 500, the other three the first BATCHER_LATER of them, which
# keeps the script, with the sharded phases and the two 1 GB builds that
# spill, under 1,000 s of the 1,200 it may take
BATCHER_SERVED = (425, 75)
BATCHER_LATER = 200
BATCHER_TAIL = 100       # served after the restage has landed
BATCHER_PROFILED = 256
BATCHER_HTTP = 128
BATCHER_CONFIGS = ((True, True), (False, True), (True, False),
                   (False, False))  # (pipeline, materialize)
# the kernels of PERF.md rows 1-12 the batcher's requests reach at 64
# MB: there every word of the recipe has more than 1,024 postings, so
# each bucket's cap is a rung of 16,384 or more (field rows: 1,024),
# past the slot kernels' admission; all go through the chunked and
# fused kernels
BATCHER_KERNELS = ("merge_and_locate_topk", "merge_tagged", "and_keep",
                   "locate_runs", "variants_keep", "fetch_postings")
# the sharded cell (phase_mesh): a corpus of four serving shards of
# ~64 MB (PERF.md section 4), served by ShardedDeviceIndex beside one
# card's DeviceIndex of the same index
MESH_MB = 256
MESH_SHARDS = 4
MESH_SAMPLED = 512   # rows a mix materialized and held against the host
MESH_HTTP = 16
# the kernels one shard of the sharded full-result path runs on the
# standard mix (device_index.bucket_pre: the chunked route)
MESH_FULL_KERNELS = ("merge_tagged", "and_keep", "locate_runs",
                     "fetch_postings")
# phase_distributed: two processes of two shards each over the 64 MB
# index; standard and wide rows of its buckets, page-level rows
DIST_HOSTS = 2
DIST_QUERIES = (1_000, 200)
DIST_PAGE_ROWS = 512
# locate_runs' kept range when it keeps every value: (0, seqops.INF32)
KEEP_ALL = (0, 2**31 - 1)
# the kernels that give a row many blocks (tiles of _cuda.tile_lanes())
TILED = ("and_keep", "variants_keep", "locate_runs")
PAGE_CAPS = {"and_locate_topk": (64, 128, 256, 512),
             "single_locate_topk": (64, 128)}
SLOT_CAPS = {
    "sorted_and_locate_full": (64, 128, 256, 512),
    "single_locate_full": (64, 128),
    "union_locate_full": (256, 512, 1024),
}
SLOT_ROWS = 4096
# rows of the W = 1 kernel's parity cases beyond SLOT_CAPS': a serving
# launch (one wave: a lane a thread) and more than a wave at every width
# (4 lanes a thread, the last block part-filled)
W1_ROWS = (128, SLOT_ROWS - 3)
# caps of the W = 1 kernel's other tails in those launch shapes: row 14
# (the page-level tail, caps up to 128) and row 15c at V = 1 (the top-k
# tail, a plain word past 128 lanes)
PAGE_W1_CAPS = (32, 64, 128)
UNION_V1_CAPS = (256, 512, 1024)
# (va, vb, cap, rows) of variants_and_locate_full's parity cases and
# (v, cap, rows, topk, hit_cap) of union_merge_locate_full's beyond n
# 512 / 1024 at 4096 rows: the other stream widths of the variant slot
# kernels (n 128, 256, 512), 16 and 32 blocks a row, the wide serving
# pass's launches (128 rows) and its escalated ones (512 rows at topk
# 128, hit_cap 2048); both tails. Their inputs come from a generator of
# their own, so that the other phases see the data they saw before.
VARIANT_SHAPES = ((2, 2, 32, SLOT_ROWS - 3), (2, 2, 64, SLOT_ROWS - 3),
                  (8, 8, 64, SLOT_ROWS - 3), (4, 4, 128, 128))
UNION_SHAPES = ((4, 32, SLOT_ROWS - 3, TOPK, HIT_CAP),
                (2, 128, SLOT_ROWS - 3, TOPK, HIT_CAP),
                (8, 64, SLOT_ROWS - 3, TOPK, HIT_CAP),
                (32, 32, SLOT_ROWS - 3, TOPK, HIT_CAP),
                (8, 128, 128, TOPK, HIT_CAP), (8, 128, 512, 128, 2048))
# rows of the fused batches' merge_and_locate_topk launches, caps 1024
# and 2048 (tools/tile_kernel_times.py --batch; PERF.md section 6)
FUSED_ROWS = (8, 16, 32, 64, 128)
PAGE_WRAPPERS = {"and_locate_topk": "sorted_and_locate",
                 "single_locate_topk": "batched_single_locate"}
FIELDS = ("pg_c", "rk_c", "ct_c", "n_pages", "n_hits", "hits")
PAGE_FIELDS = ("pages", "ranks", "counts")
FINISHED_FIELDS = PAGE_FIELDS + ("n_pages", "n_hits", "hits")
STREAM_FIELDS = ("hits", "page_s", "rank_s", "cnt_s")


def say(*parts) -> None:
    print(*parts, flush=True)


def require(ok, what: str) -> None:
    """A check of the run (kept under python -O, unlike assert)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in units of the last place between two
    non-negative f32 tensors."""
    ia = a.contiguous().view(torch.int32).long()
    ib = b.contiguous().view(torch.int32).long()
    return int((ia - ib).abs().max()) if a.numel() else 0


def same_outputs(got, want, what: str, fields=FIELDS) -> float:
    """A kernel's output fields (the six full-result ones, or
    PAGE_FIELDS): shapes and dtypes equal, ints exact, ranks within
    1 ulp. Returns the largest absolute rank difference."""
    diff = 0.0
    for field, g, w in zip(fields, got, want):
        require(g.shape == w.shape and g.dtype == w.dtype,
                f"{what}: {field} {tuple(g.shape)} {g.dtype}")
        if field in ("rk_c", "ranks", "rank_s"):
            u = ulps(g, w)
            require(u <= 1, f"{what}: ranks {u} ulp apart")
            diff = float((g - w).abs().max()) if g.numel() else 0.0
        else:
            bad = (g != w).nonzero()
            require(bad.numel() == 0, f"{what}: {field} differs at "
                    f"{bad[:4].tolist()}")
    return diff


def same_result(name: str, got, want, what: str) -> float:
    """A kernel core's outputs against its plain version's: a kept
    stream, a merge (pages compared at live lanes, where they are
    defined), a compacted fold operand, or the six full-result fields.
    Returns the largest absolute rank difference."""
    if name in PAGE_KERNELS:
        return same_outputs(got, want, what, PAGE_FIELDS)
    if name in TOPK_MODE_KERNELS:
        return same_outputs(got, want, what, FINISHED_FIELDS)
    if name == "merge_and_locate":
        return same_outputs(got, want, what, STREAM_FIELDS)
    if isinstance(got, torch.Tensor):
        require(torch.equal(got, want), f"{what} differs")
    elif name == "merge_tagged":
        live = want[0] < 2**31 - 1
        require(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
                and (got[2] is None) == (want[2] is None)
                and (got[2] is None or torch.equal(got[2][live],
                                                   want[2][live])),
                f"{what} differs")
    elif len(got) == 3:  # and_keep's compacted fold operand, a fetch
        require(all((g is None and w is None)
                    or (g is not None and w is not None and torch.equal(g, w))
                    for g, w in zip(got, want)), f"{what} differs")
    else:
        return same_outputs(got, want, what)
    return 0.0


def cuda_ms(fn, reps: int = 10) -> float:
    """Median of `reps` CUDA-event timings of fn(), after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return float(np.median(times))


def profiled_ms(fn) -> float:
    """Device ms of one fn() after a warm-up: the sum of the device
    events of torch.profiler's trace (a host event carries the device
    time of what it launched, so those are left out)."""
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(float(getattr(e, "self_device_time_total", 0)
                     or getattr(e, "self_cuda_time_total", 0))
               for e in prof.key_averages()
               if e.device_type != DeviceType.CPU) / 1e3


def phase_device() -> tuple:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    say(f"device: {name}; nvidia-smi: {smi}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    return name, smi


def phase_build() -> None:
    from docodo_tpu_torch.ops import _cuda

    secs = _cuda.build()
    _cuda.library()
    report = [ln.strip() for ln in _cuda.build_log.splitlines()
              if "registers" in ln or "spill" in ln]
    say(f"build: nvcc {secs:.1f} s ({len(_cuda.SOURCES)} sources in "
        f"parallel) -> {_cuda.library_path().name}")
    for ln in report:
        say(f"  ptxas {ln}")


def _parity_inputs(rng, rows: int, cap: int, dev, spread: bool = False,
                   full_first: bool = False):
    """Seeded posting blocks at a bucket's shape: two ascending subsets
    of one per-row pool (so the operands share coordinates), lengths
    0..cap with empty and full rows, both window signs, and the pages of
    256-char pages, so that long rows hold more runs than topk. With
    `spread`, every third row steps 200-300 chars (one hit on most
    pages: its runs tie at rank 1.0) and every third 40-120 (runs of a
    few hits, tying in groups); with `full_first` (the few rows of a
    wide bucket), row 0 is full (so a batch of one row keeps hits) and
    ordered with a window of 263, the pool jumps 400-699 chars at about
    one step in 8000 and word A skips the next 1000-3999 steps: gap
    segments that open there reach their first word-A mark (an ordered
    cut) hundreds of lanes on, often in a later tile."""
    lo, hi = 1, 40
    if spread:
        kind = np.arange(rows)[:, None] % 3
        lo = np.choose(kind, [1, 200, 40])
        hi = np.choose(kind, [40, 300, 120])
    steps = rng.integers(lo, hi, size=(rows, 2 * cap))
    skip = np.zeros((rows, 2 * cap))
    if full_first:
        for i, j in zip(*np.nonzero(rng.random((rows, 2 * cap)) < 1 / 8000)):
            steps[i, j] += rng.integers(400, 700)
            skip[i, j: j + rng.integers(1000, 4000)] = 2.0
    pool = np.cumsum(steps, axis=1)
    pool += rng.integers(0, 1 << 20, size=(rows, 1))

    def subset(avoid=0.0):
        key = rng.random((rows, 2 * cap)) + avoid
        pick = np.sort(np.argsort(key, axis=1)[:, :cap], axis=1)
        return np.take_along_axis(pool, pick, axis=1).astype(np.int32)

    a, b = subset(skip), subset()
    na = rng.integers(0, cap + 1, size=rows).astype(np.int32)
    nb = rng.integers(0, cap + 1, size=rows).astype(np.int32)
    na[0::7], nb[1::7] = 0, 0
    na[2::5], nb[2::5] = cap, cap
    ra = np.where(np.arange(rows) % 2 == 0, 260, -12).astype(np.int32)
    rb = np.where(np.arange(rows) % 2 == 0, 263, -10).astype(np.int32)
    if full_first:
        na[0] = nb[0] = cap
        ra[0], rb[0] = -260, -263
    top = int(pool.max()) + 1
    bounds = np.arange(256, top + 256, 256, dtype=np.int64).astype(np.int32)

    def pages(x):
        return np.minimum(np.searchsorted(bounds, x, side="right"),
                          bounds.size - 1).astype(np.int32)

    t = lambda x: torch.as_tensor(np.ascontiguousarray(x), device=dev)
    return dict(a=t(a), na=t(na), ra=t(ra), b=t(b), nb=t(nb), rb=t(rb),
                bounds=t(bounds), a_pg=t(pages(a)), b_pg=t(pages(b)))


def _variant_inputs(rng, rows: int, va: int, vb: int, cap: int, dev,
                    spacing: int = 12, gaps: bool = False):
    """Seeded variant blocks of two words at a bucket's shape, all drawn
    from one per-row pool, so variants and words share coordinates
    (runs of up to va + vb lanes): ragged lengths with empty variants
    and full blocks, word B empty and flagged bpad on every fifth row,
    ordered windows on every second row, and 256-char pages. With
    `gaps`, the pool jumps 100-299 chars at about one step in 8000 and
    word A's variants skip the next 1000-3999 steps, so gap segments
    open on word-B lanes and reach their first word-A mark (an ordered
    cut) thousands of lanes on."""
    steps = rng.integers(1, spacing, size=(rows, 2 * cap))
    skip = np.zeros((rows, 2 * cap), bool)
    if gaps:
        for i, j in zip(*np.nonzero(rng.random((rows, 2 * cap)) < 1 / 8000)):
            steps[i, j] += rng.integers(100, 300)
            skip[i, j: j + rng.integers(1000, 4000)] = True
    pool = np.cumsum(steps, axis=1)
    pool += rng.integers(0, 1 << 20, size=(rows, 1))

    def blocks(v, holed=False):
        key = rng.random((rows, v, 2 * cap)) + (2.0 * skip[:, None, :]
                                                if holed else 0.0)
        pick = np.sort(np.argsort(key, axis=2)[:, :, :cap], axis=2)
        x = np.take_along_axis(pool[:, None, :], pick, axis=2)
        n = rng.integers(0, cap + 1, (rows, v)).astype(np.int32)
        n[0::7, 0] = 0
        n[2::5] = cap
        return x.astype(np.int32), n

    a, na = blocks(va, holed=True)
    b, nb = blocks(vb)
    bpad = np.arange(rows) % 5 == 3
    nb[bpad] = 0
    ra = np.where(np.arange(rows) % 2 == 0, 260, -12).astype(np.int32)
    rb = np.where(np.arange(rows) % 2 == 0, 263, -10).astype(np.int32)
    top = int(pool.max()) + 1
    bounds = np.arange(256, top + 256, 256, dtype=np.int64).astype(np.int32)

    def pages(x):
        return np.minimum(np.searchsorted(bounds, x, side="right"),
                          bounds.size - 1).astype(np.int32)

    t = lambda x: torch.as_tensor(np.ascontiguousarray(x), device=dev)
    return dict(a=t(a), na=t(na), ra=t(ra), b=t(b), nb=t(nb), rb=t(rb),
                bpad=t(bpad), bounds=t(bounds), a_pg=t(pages(a)),
                b_pg=t(pages(b)))


def _w1_inputs(rng, rows: int, cap: int, dev, dups: bool):
    """_parity_inputs' spread word A as a W = 1 block, with lengths past
    cap on every 11th row (the kernels clamp them) and, with `dups`,
    about one lane in ten holding the value of the lane before it (the
    V = 1 union keeps the first lane of each run); pages of the result."""
    x = _parity_inputs(rng, rows, cap, dev, spread=True)
    a, na = x["a"], x["na"].clone()
    na[3::11] = cap + 9
    if dups:
        lane = torch.arange(cap, device=dev)[None, :]
        repeat = torch.as_tensor(rng.random((rows, cap)) < 0.1, device=dev)
        a = torch.gather(a, 1, torch.where(repeat, (lane - 1).clamp(min=0),
                                           lane))
    bounds = x["bounds"]
    pg = torch.searchsorted(bounds, a, right=True).clamp_max(
        bounds.numel() - 1).to(torch.int32)
    return dict(a=a.contiguous(), na=na, bounds=bounds, a_pg=pg)


def _keep_ranges(hv) -> tuple:
    """The kept ranges of a first, a middle and a last document shard
    over the values of hv (its lower and upper quartile): (0, hi),
    (lo, hi), (lo, INF32), what locate_runs' keep= takes."""
    from docodo_tpu_torch.ops.seqops import INF32

    v = hv[hv < INF32].sort().values
    if v.numel() < 4:
        return ()
    lo, hi = int(v[v.numel() // 4]), int(v[3 * v.numel() // 4])
    return (0, hi), (lo, hi), (lo, INF32)


def _tile_edges(vals, tag, ra, rb, variants: bool):
    """Of a merged stream [B, n]: the runs of equal coordinates that
    cross an edge of the tiled kernels' tiles, and the ordered cuts (a
    gap segment's first word-A mark, both windows < 0) in a later tile
    than their segment's gap start (segment_and's rule, seqops.py)."""
    from docodo_tpu_torch.ops import _cuda
    from docodo_tpu_torch.ops.seqops import INF32, combine_r, fold_dups, \
        run_marks

    tile = _cuda.tile_lanes()
    n = vals.shape[1]
    valid = vals < INF32
    edge = torch.arange(tile, max(n, tile), tile, device=vals.device)
    crossing = int(((vals[:, edge] == vals[:, edge - 1])
                    & valid[:, edge]).sum())
    if variants:
        isa = run_marks(vals, tag)[0]
    else:
        isa = fold_dups(vals, (tag == 0) & valid, (tag == 1) & valid,
                        valid)[0]
    r = combine_r(ra, rb)
    idx = torch.arange(n, device=vals.device)[None, :]
    prev = torch.cat([torch.zeros_like(vals[:, :1]), vals[:, :-1]], dim=1)
    gap = (r.abs()[:, None] != 0) & (vals - prev > r.abs()[:, None]) & valid
    start = (idx == 0) | gap
    start_idx = torch.cummax(torch.where(start, idx, -1), dim=1).values
    before = torch.cumsum(isa.long(), dim=1) - isa.long()
    at_start = torch.cummax(torch.where(start, before, -1), dim=1).values
    cut = (isa & (before == at_start) & (idx != start_idx)
           & (r < 0)[:, None])
    return crossing, int((cut & (idx // tile != start_idx // tile)).sum())


def phase_parity(rng) -> dict:
    """Each kernel against its plain version on seeded inputs at the
    main path's shapes and wider: ints exact, ranks within 1 ulp.
    Returns the largest rank difference per kernel."""
    from docodo_tpu_torch.ops import _cuda
    from docodo_tpu_torch.ops import query_kernels as qk
    from docodo_tpu_torch.ops.seqops import INF32

    dev = torch.device("cuda")
    err = {name: 0.0 for name in KERNELS}
    tile = _cuda.tile_lanes()

    def check(name, what, kern, plain, *args, **kw):
        got = getattr(qk, kern)(*args, **kw)
        torch.cuda.synchronize()
        want = getattr(qk, plain)(*args, **kw)
        err[name] = max(err[name], same_outputs(got, want, what))
        say(f"parity: {what}: equal")
        return got

    for name, caps in SLOT_CAPS.items():
        for cap in caps:
            x = _parity_inputs(rng, SLOT_ROWS, cap, dev)
            kw = dict(topk=TOPK, hit_cap=HIT_CAP, tail=False)
            if name == "sorted_and_locate_full":
                args = (x["a"], x["na"], x["ra"], x["b"], x["nb"], x["rb"],
                        x["bounds"])
                kw.update(a_pg=x["a_pg"], b_pg=x["b_pg"])
            elif name == "single_locate_full":
                args = (x["a"], x["na"], x["bounds"])
                kw.update(a_pg=x["a_pg"])
            else:
                args = (x["a"][:, None], x["na"][:, None], x["bounds"])
                kw.update(a_pg=x["a_pg"][:, None])
            check(name, f"{name} cap {cap} B {SLOT_ROWS}", name,
                  name + "_plain", *args, **kw)

    # the fused kernel's two stream widths (N = 2048, 4096), at 1024 rows
    # and at the fused batches' row counts
    for cap in (1024, 2048):
        for rows in (1024,) + FUSED_ROWS:
            x = _parity_inputs(rng, rows, cap, dev)
            for topk in (TOPK, 2048):
                check("merge_and_locate_topk",
                      f"merge_and_locate_topk cap {cap} topk {topk} B {rows}",
                      "merge_and_locate_topk", "merge_and_locate_topk_plain",
                      x["a"], x["na"], x["ra"], x["b"], x["nb"], x["rb"],
                      x["a_pg"], x["b_pg"], topk=topk, hit_cap=HIT_CAP)

    # W = 2 bucket shapes, and cap 262144 (n 524288, 128 tiles a row) at
    # the one to eight rows of a wide bucket
    for cap, rows in ((1024, 1024), (2048, 1024), (4096, 1024),
                      (32768, 256), (262144, 1), (262144, 3), (262144, 8)):
        x = _parity_inputs(rng, rows, cap, dev, full_first=rows < 8)
        n = 2 * cap
        for paged in (True, False):
            pgs = (x["a_pg"], x["b_pg"]) if paged else (None, None)
            vals, tag, pg = qk.merge_tagged(x["a"], x["na"], x["b"], x["nb"],
                                            *pgs)
            torch.cuda.synchronize()
            wv, wt, wp = qk.merge_tagged_plain(x["a"], x["na"], x["b"],
                                               x["nb"], *pgs)
            live = wv < INF32
            require(torch.equal(vals, wv) and torch.equal(tag, wt)
                    and (not paged or torch.equal(pg[live], wp[live])),
                    f"merge_tagged n {n} paged {paged} differs")
            say(f"parity: merge_tagged n {n} B {rows} paged {paged}: equal")
            if not paged:
                continue
            hv = qk.and_keep(vals, tag, x["ra"], x["rb"])
            torch.cuda.synchronize()
            require(torch.equal(hv, qk.and_keep_plain(vals, tag, x["ra"],
                                                      x["rb"])),
                    f"and_keep n {n} differs")
            kept = int((hv < INF32).sum())
            require(kept > 0, f"and_keep n {n} kept nothing")
            for cpg in ((pg, None) if cap > 32768 else (pg,)):
                got = qk.and_keep_compact(vals, tag, x["ra"], x["rb"], cpg)
                torch.cuda.synchronize()
                same_result("and_keep", got, qk.and_keep_compact_plain(
                    vals, tag, x["ra"], x["rb"], cpg),
                    f"and_keep compact n {n} pages {cpg is not None}")
            runs, cuts = _tile_edges(vals, tag, x["ra"], x["rb"], False)
            require(n <= tile or cuts > 0, f"and_keep n {n}: no ordered "
                    "cut across a tile edge")
            say(f"parity: and_keep n {n} B {rows}: equal, and its compacted "
                f"fold operand ({kept} kept, {cuts} ordered cuts across "
                f"tile edges)")
            if n < 8192:
                continue
            for carried in (True, False):
                for keep in (None,) + _keep_ranges(hv):
                    check("locate_runs",
                          f"locate_runs n {n} B {rows} "
                          f"{'carried' if carried else 'shared'} pages"
                          + ("" if keep is None else f" keep {keep}"),
                          "locate_runs", "locate_runs_plain", hv,
                          x["bounds"], topk=TOPK, hit_cap=HIT_CAP,
                          pg=pg if carried else None, keep=keep)
    # the W = 1 form: a posting block, INF32 after its length, at the
    # widest cap of the parity shapes and at the four-card books cell's
    # (its longest lists: ~1e6 postings a shard)
    for cap in (262144, 1 << 20):
        x = _parity_inputs(rng, 8, cap, dev, full_first=True)
        lane = torch.arange(cap, device=dev)[None, :]
        block = torch.where(lane < x["na"][:, None], x["a"], INF32)
        for carried in (True, False):
            for keep in (None,) + _keep_ranges(block):
                check("locate_runs",
                      f"locate_runs on a posting block n {cap} B 8 "
                      f"{'carried' if carried else 'shared'} pages"
                      + ("" if keep is None else f" keep {keep}"),
                      "locate_runs", "locate_runs_plain", block,
                      x["bounds"], topk=TOPK, hit_cap=HIT_CAP,
                      pg=x["a_pg"] if carried else None, keep=keep)

    # the variant slot kernels at each stream width they are compiled for
    # (n 128-1024: 8 / 4 / 2 / 1 rows a block, the last block part-filled
    # at 4093 rows), at 16 and 32 blocks a row, and at the wide serving
    # pass's launches (128 rows; 512 escalated rows at topk 128, hit_cap
    # 2048)
    vrng = np.random.default_rng(rng.bit_generator.seed_seq.spawn(1)[0])
    for gen, va, vb, cap, rows in (
            [(rng, 2, 2, 128, SLOT_ROWS), (rng, 4, 4, 128, SLOT_ROWS)]
            + [(vrng,) + shape for shape in VARIANT_SHAPES]):
        x = _variant_inputs(gen, rows, va, vb, cap, dev)
        for carried in (True, False):
            pgs = dict(a_pg=x["a_pg"], b_pg=x["b_pg"]) if carried else {}
            check("variants_and_locate_full",
                  f"variants_and_locate_full V {va}+{vb} n {(va + vb) * cap}"
                  f" B {rows} {'carried' if carried else 'shared'} "
                  f"pages", "variants_and_locate_full",
                  "variants_and_locate_full_plain", x["a"], x["na"], x["ra"],
                  x["b"], x["nb"], x["rb"], x["bpad"], x["bounds"], topk=TOPK,
                  hit_cap=HIT_CAP, tail=False, **pgs)
    for gen, v, cap, rows, topk, hit_cap in (
            [(rng, v, cap, SLOT_ROWS, TOPK, HIT_CAP)
             for v, cap in ((2, 512), (4, 256), (8, 128))]
            + [(vrng,) + shape for shape in UNION_SHAPES]):
        x = _variant_inputs(gen, rows, v, 1, cap, dev)
        for carried in (True, False):
            check("union_merge_locate_full",
                  f"union_merge_locate_full V {v} cap {cap} B {rows} topk "
                  f"{topk} hit_cap {hit_cap} "
                  f"{'carried' if carried else 'shared'} pages",
                  "union_merge_locate_full", "union_merge_locate_full_plain",
                  x["a"], x["na"], x["bounds"], topk=topk, hit_cap=hit_cap,
                  tail=False, a_pg=x["a_pg"] if carried else None)
    for va, vb, cap, rows in ((2, 2, 512, 1024), (2, 2, 1024, 1024),
                              (4, 4, 4096, 128), (4, 4, 32768, 3)):
        x = _variant_inputs(rng, rows, va, vb, cap, dev, spacing=4,
                            gaps=(va + vb) * cap > tile)
        vals, tag, pg = qk.merge_tagged(x["a"], x["na"], x["b"], x["nb"],
                                        x["a_pg"], x["b_pg"])
        torch.cuda.synchronize()
        n = vals.shape[1]
        same_result("merge_tagged", (vals, tag, pg), qk.merge_tagged_plain(
            x["a"], x["na"], x["b"], x["nb"], x["a_pg"], x["b_pg"]),
            f"merge_tagged of {va}+{vb} variant blocks n {n}")
        hv = qk.variants_keep(vals, tag, x["ra"], x["rb"], x["bpad"])
        torch.cuda.synchronize()
        same_result("variants_keep", hv, qk.variants_keep_plain(
            vals, tag, x["ra"], x["rb"], x["bpad"]), f"variants_keep n {n}")
        crossing, cuts = _tile_edges(vals, tag, x["ra"], x["rb"], True)
        require(n <= tile or (crossing > 0 and cuts > 0),
                f"variants_keep n {n}: {crossing} runs and {cuts} ordered "
                "cuts across tile edges")
        kept = int((hv < INF32).sum())
        require(kept > 0, f"variants_keep n {n} kept nothing")
        say(f"parity: merge_tagged of {va}+{vb} variant blocks and "
            f"variants_keep n {n} B {rows}: equal ({kept} kept, {crossing} "
            f"runs and {cuts} ordered cuts across tile edges, "
            f"{int(x['bpad'].sum())} bpad rows)")

    # merge_tagged's pairwise tree and its other shapes: 8 blocks at n
    # 2,097,152 (V 4+4 at cap 262144, the widest W = 2 bucket) and in rows
    # that one block merges (n <= 2048), a fold step's running stream
    # against the next word's narrower block, and a word's union alone
    # (vb = 0)
    for va, vb, cap, rows in ((4, 4, 262144, 8), (8, 0, 32768, 8),
                              (4, 4, 256, 512), (8, 0, 128, 512)):
        x = _variant_inputs(rng, rows, va, max(vb, 1), cap, dev, spacing=4)
        b, nb, b_pg = ((x["b"], x["nb"], x["b_pg"]) if vb
                       else (None, None, None))
        got = qk.merge_tagged(x["a"], x["na"], b, nb, x["a_pg"], b_pg)
        torch.cuda.synchronize()
        same_result("merge_tagged", got, qk.merge_tagged_plain(
            x["a"], x["na"], b, nb, x["a_pg"], b_pg),
            f"merge_tagged of {va}+{vb} blocks n {got[0].shape[1]}")
        passes = _cuda.merge_passes(va, cap, vb, cap)
        say(f"parity: merge_tagged of {va}+{vb} blocks n {got[0].shape[1]} "
            f"B {rows} ({f'{passes} passes' if passes else 'one block a row'}"
            f"): equal")
    for cap_a, cap_b, rows in ((65536, 32768, 16), (4096, 1024, 512)):
        x = _parity_inputs(rng, rows, cap_a, dev)
        b = x["b"][:, :cap_b].contiguous()
        b_pg = x["b_pg"][:, :cap_b].contiguous()
        nb = x["nb"].clamp(max=cap_b)
        for pgs in ((x["a_pg"], b_pg), (None, None)):
            got = qk.merge_tagged(x["a"], x["na"], b, nb, *pgs)
            torch.cuda.synchronize()
            same_result("merge_tagged", got, qk.merge_tagged_plain(
                x["a"], x["na"], b, nb, *pgs),
                f"merge_tagged caps {cap_a} + {cap_b}")
        say(f"parity: merge_tagged of a fold step's stream (cap {cap_a}) "
            f"and a block of cap {cap_b}, B {rows}, paged and unpaged: "
            f"equal")

    def check_topk(name, what, *args, **kw):
        # the bounds form of the W = 2 kernel goes through its own
        # wrapper, batched_and_locate (pallas_batched_and_locate)
        wrapper = ("batched_and_locate"
                   if name == "and_locate_topk" and "a_pg" not in kw
                   else PAGE_WRAPPERS[name])
        got = getattr(qk, wrapper)(*args, **kw)
        torch.cuda.synchronize()
        want = getattr(qk, wrapper + "_plain")(*args, **kw)
        err[name] = max(err[name], same_outputs(got, want, what, PAGE_FIELDS))
        return want

    for name, caps in PAGE_CAPS.items():
        for cap in caps:
            x = _parity_inputs(rng, SLOT_ROWS, cap, dev, spread=True)
            if name == "and_locate_topk":
                args = (x["a"], x["na"], x["ra"], x["b"], x["nb"], x["rb"],
                        x["bounds"])
                pgs = dict(a_pg=x["a_pg"], b_pg=x["b_pg"])
                at = torch.searchsorted(x["b"], x["a"])
                lane = torch.arange(cap, device=dev)[None, :]
                dups = int(((at < x["nb"][:, None])
                            & (lane < x["na"][:, None])
                            & (torch.gather(x["b"], 1,
                                            at.clamp_max(cap - 1))
                               == x["a"])).sum())
                require(dups > 0, f"{name} cap {cap}: no shared coordinate")
            else:
                args = (x["a"], x["na"], x["bounds"])
                pgs = dict(a_pg=x["a_pg"])
                dups = 0
            for topk in (PAGE_TOPK, 64):
                for carried in (True, False):
                    want = check_topk(
                        name, f"{name} cap {cap} topk {topk} "
                        f"{'carried' if carried else 'bounds'}", *args,
                        topk=topk, **(pgs if carried else {}))
            # rows whose best 2 topk runs all tie: more than topk tied
            # runs at the cut
            wide = check_topk(name, f"{name} cap {cap} topk {2 * PAGE_TOPK}",
                              *args, topk=2 * PAGE_TOPK, **pgs)
            tied = int(((wide[1][:, 0] == wide[1][:, -1])
                        & (wide[0][:, -1] >= 0)).sum())
            empty = int((want[0][:, 0] < 0).sum())
            require(tied > 0 and empty > 0,
                    f"{name} cap {cap}: {tied} tied rows, {empty} empty")
            say(f"parity: {name} cap {cap} B {SLOT_ROWS} topk {PAGE_TOPK} / "
                f"64, carried pages / bounds: equal ({tied} rows with more "
                f"than {PAGE_TOPK} runs tied at the cut, {empty} rows "
                f"serving nothing"
                + (f", ordered windows on every second row, {dups} "
                   f"coordinates in both words)" if dups else ")"))

    def check_mode(name, what, wrapper, args, topk, hit_cap, **pgs):
        """A top-k-mode kernel through its wrapper (sort_topk=False)
        against its plain version; returns the plain outputs."""
        kw = dict(topk=topk, hit_cap=hit_cap, sort_topk=False, **pgs)
        got = getattr(qk, wrapper)(*args, **kw)
        torch.cuda.synchronize()
        want = getattr(qk, wrapper + "_plain")(*args, **kw)
        err[name] = max(err[name], same_outputs(got, want, what,
                                                FINISHED_FIELDS))
        return want

    def mode_sweep(name, wrapper, label, args, n, pgs):
        """topk 16 carried / 64 looked up / the escalated 2048 clamped to
        the stream with 8192 hits; the inputs hold rows with more runs
        than topk, rows whose runs tie at the cut, and empty rows."""
        shared = {k: None for k in pgs}
        want = check_mode(name, f"{name} {label} topk 16", wrapper, args,
                          16, HIT_CAP, **pgs)
        check_mode(name, f"{name} {label} topk {TOPK} pages looked up",
                   wrapper, args, TOPK, HIT_CAP, **shared)
        check_mode(name, f"{name} {label} topk {min(2048, n)} hit_cap 8192",
                   wrapper, args, min(2048, n), 8192, **pgs)
        cut = int((want[3] > 16).sum())
        tied = int(((want[1][:, 0] == want[1][:, -1]) & (want[3] > 16)).sum())
        empty = int((want[3] == 0).sum())
        require(cut > 0, f"{name} {label}: no row with more than 16 runs")
        say(f"parity: {name} {label} B {want[0].shape[0]}, topk 16 / {TOPK} "
            f"/ {min(2048, n)}, hit_cap {HIT_CAP} / 8192, carried pages / "
            f"looked up: equal ({cut} rows with more than 16 runs, {tied} of "
            f"them with all 16 served runs tied, {empty} empty rows)")
        return tied, empty

    def sweep(*a):
        t, e = mode_sweep(*a)
        seen[0] += t
        seen[1] += e

    seen = [0, 0]  # rows tied at the cut, empty rows
    for cap in (64, 128, 256, 512):
        x = _parity_inputs(rng, SLOT_ROWS, cap, dev, spread=True)
        sweep(
            "sorted_and_locate_full_topk", "sorted_and_locate_full",
            f"cap {cap}",
            (x["a"], x["na"], x["ra"], x["b"], x["nb"], x["rb"], x["bounds"]),
            2 * cap, dict(a_pg=x["a_pg"], b_pg=x["b_pg"]))
    for cap in (64, 128):
        x = _parity_inputs(rng, SLOT_ROWS, cap, dev, spread=True)
        sweep("single_locate_full_topk", "single_locate_full",
                           f"cap {cap}", (x["a"], x["na"], x["bounds"]),
                           cap, dict(a_pg=x["a_pg"]))
    for cap in (256, 1024):  # a plain word past the W = 1 kernel: V = 1
        x = _parity_inputs(rng, SLOT_ROWS, cap, dev, spread=True)
        sweep("union_locate_full_topk", "union_locate_full",
                           f"V 1 cap {cap}",
                           (x["a"][:, None], x["na"][:, None], x["bounds"]),
                           cap, dict(a_pg=x["a_pg"][:, None]))
    # narrow rows step wider, so that they too hold more than 16 runs
    for gen, v, cap, rows in (
            [(rng, v, cap, SLOT_ROWS) for v, cap in ((2, 512), (4, 256),
                                                    (8, 128))]
            + [(vrng,) + shape[:3] for shape in UNION_SHAPES]):
        x = _variant_inputs(gen, rows, v, 1, cap, dev,
                            spacing=120 * max(1, 128 // cap))
        sweep("union_locate_full_topk", "union_locate_full",
                           f"V {v} cap {cap}",
                           (x["a"], x["na"], x["bounds"]), v * cap,
                           dict(a_pg=x["a_pg"]))
    for gen, va, vb, cap, rows in (
            [(rng, 2, 2, 128, SLOT_ROWS), (rng, 4, 4, 128, SLOT_ROWS)]
            + [(vrng,) + shape for shape in VARIANT_SHAPES]):
        x = _variant_inputs(gen, rows, va, vb, cap, dev,
                            spacing=120 * max(1, 128 // cap))
        sweep(
            "variants_and_locate_full_topk", "variants_and_locate_full",
            f"V {va}+{vb} cap {cap}",
            (x["a"], x["na"], x["ra"], x["b"], x["nb"], x["rb"], x["bpad"],
             x["bounds"]), (va + vb) * cap,
            dict(a_pg=x["a_pg"], b_pg=x["b_pg"]))
    require(min(seen) > 0, f"top-k-mode parity: {seen[0]} rows tied at the "
            f"cut, {seen[1]} empty rows")
    # the W = 2 slot kernel's row groups (8, 8, 4 and 2 rows a block at
    # caps 64-512) with the last block part-filled, in both tails
    for cap in (64, 128, 256, 512):
        rows = SLOT_ROWS - 3
        x = _parity_inputs(rng, rows, cap, dev, spread=True)
        args = (x["a"], x["na"], x["ra"], x["b"], x["nb"], x["rb"],
                x["bounds"])
        pgs = dict(a_pg=x["a_pg"], b_pg=x["b_pg"])
        check("sorted_and_locate_full",
              f"sorted_and_locate_full cap {cap} B {rows}",
              "sorted_and_locate_full", "sorted_and_locate_full_plain",
              *args, topk=TOPK, hit_cap=HIT_CAP, tail=False, **pgs)
        check_mode("sorted_and_locate_full_topk",
                   f"sorted_and_locate_full_topk cap {cap} B {rows}",
                   "sorted_and_locate_full", args, TOPK, HIT_CAP, **pgs)
        say(f"parity: sorted_and_locate_full_topk cap {cap} B {rows}: equal")
        # the page-level tail on the same row groups, both page forms
        for carried in (True, False):
            check_topk("and_locate_topk",
                       f"and_locate_topk cap {cap} B {rows}", *args,
                       topk=PAGE_TOPK, **(pgs if carried else {}))
        say(f"parity: and_locate_topk cap {cap} B {rows} topk {PAGE_TOPK}, "
            f"carried pages / bounds: equal")

    for cap, rows in [(c, r) for c in (1024, 2048)
                      for r in (1024,) + FUSED_ROWS]:
        x = _parity_inputs(rng, rows, cap, dev)
        args = (x["a"], x["na"], x["ra"], x["b"], x["nb"], x["rb"], x["a_pg"],
                x["b_pg"])
        got = qk.merge_and_locate(*args)
        torch.cuda.synchronize()
        err["merge_and_locate"] = max(
            err["merge_and_locate"],
            same_outputs(got, qk.merge_and_locate_plain(*args),
                         f"merge_and_locate cap {cap}", STREAM_FIELDS))
        # its three-step form against the fused kernel with its tails
        fused = qk.merge_and_locate_topk(*args, topk=TOPK, hit_cap=HIT_CAP)
        pg_c, rk_c, ct_c, n_pages = qk.compact_streams_topk(*got[1:], TOPK)
        live = rk_c > 0
        require(torch.equal(n_pages, fused[3])
                and torch.equal(pg_c[live], fused[0][live])
                and torch.equal(ct_c, fused[2]) and ulps(rk_c, fused[1]) <= 1,
                f"merge_and_locate cap {cap}: its streams' first {TOPK} runs "
                f"differ from merge_and_locate_topk's")
        at = torch.searchsorted(x["b"], x["a"])
        lane = torch.arange(cap, device=dev)[None, :]
        dups = int(((at < x["nb"][:, None]) & (lane < x["na"][:, None])
                    & (torch.gather(x["b"], 1, at.clamp_max(cap - 1))
                       == x["a"])).sum())
        empty = int(((x["na"] == 0) | (x["nb"] == 0)).sum())
        kept = int((got[0] < INF32).sum())
        require(dups > 0 and empty > 0 and kept > 0,
                f"merge_and_locate cap {cap}: {dups} duplicates, {empty} "
                f"empty operands, {kept} kept")
        say(f"parity: merge_and_locate cap {cap} n {2 * cap} B {rows}: "
            f"equal, and its first {TOPK} runs equal merge_and_locate_topk's "
            f"({kept} kept, ordered windows on every second row, {empty} "
            f"rows with an empty operand, {dups} coordinates in both words)")

    # the W = 1 kernel (rows 2, 15d and 3 at V = 1) at every cap it serves
    # in both launch shapes (W1_ROWS), both tails of row 2, carried and
    # looked-up pages; inputs from a generator of their own
    wrng = np.random.default_rng(rng.bit_generator.seed_seq.spawn(1)[0])
    for name in ("single_locate_full", "union_locate_full"):
        union = name == "union_locate_full"
        for cap, rows in [(c, r) for c in SLOT_CAPS[name] for r in W1_ROWS]:
            x = _w1_inputs(wrng, rows, cap, dev, dups=union)
            a, na, a_pg = x["a"], x["na"], x["a_pg"]
            if union:
                a, na, a_pg = a[:, None], na[:, None], a_pg[:, None]
            for carried in (True, False):
                check(name, f"{name} cap {cap} B {rows} "
                      f"{'carried' if carried else 'shared'} pages",
                      name, name + "_plain", a, na, x["bounds"], topk=TOPK,
                      hit_cap=HIT_CAP, tail=False,
                      a_pg=a_pg if carried else None)
            lane = torch.arange(cap, device=dev)[None, :]
            live = lane < x["na"][:, None]
            dups = int(((x["a"][:, 1:] == x["a"][:, :-1])
                        & live[:, 1:]).sum())
            past = int((x["na"] > cap).sum())
            require(past > 0 and (dups > 0) == union,
                    f"{name} cap {cap} B {rows}: {past} rows past cap, "
                    f"{dups} repeated lanes")
            say(f"parity: {name} cap {cap} B {rows}: {past} rows with a "
                f"length past cap, {dups} lanes repeating the one before")
            if not union:
                sweep("single_locate_full_topk", "single_locate_full",
                      f"cap {cap} B {rows}", (a, na, x["bounds"]), cap,
                      dict(a_pg=a_pg))

    # the W = 1 kernel's other two tails in both launch shapes: row 14 at
    # topk 16 and past the row's runs, pages carried and looked up in the
    # bounds inside the kernel; row 15c at V = 1, with repeated lanes.
    # Inputs from a generator of their own
    trng = np.random.default_rng(rng.bit_generator.seed_seq.spawn(1)[0])
    for cap, rows in [(c, r) for c in PAGE_W1_CAPS for r in W1_ROWS]:
        x = _w1_inputs(trng, rows, cap, dev, dups=False)
        args = (x["a"], x["na"], x["bounds"])
        for topk in (PAGE_TOPK, cap + 3):
            for carried in (True, False):
                got = check_topk(
                    "single_locate_topk", f"single_locate_topk cap {cap} B "
                    f"{rows} topk {topk} "
                    f"{'carried' if carried else 'bounds'}", *args,
                    topk=topk, a_pg=x["a_pg"] if carried else None)
            if topk == PAGE_TOPK:
                top = got
        runs = (got[0] >= 0).sum(dim=1)
        cut = int((runs > PAGE_TOPK).sum())
        tied = int(((top[1][:, -1] == top[1][:, -2])
                    & (top[0][:, -1] >= 0)).sum())
        past = int((x["na"] > cap).sum())
        require(cut > 0 and tied > 0 and past > 0,
                f"single_locate_topk cap {cap} B {rows}: {cut} rows cut, "
                f"{tied} tied at the cut, {past} past cap")
        say(f"parity: single_locate_topk cap {cap} B {rows} topk "
            f"{PAGE_TOPK} / {cap + 3}, carried pages / bounds: equal ({cut} "
            f"rows with more than {PAGE_TOPK} runs, {tied} tied at the cut, "
            f"{past} with a length past cap)")
    for cap, rows in [(c, r) for c in UNION_V1_CAPS for r in W1_ROWS]:
        x = _w1_inputs(trng, rows, cap, dev, dups=True)
        sweep("union_locate_full_topk", "union_locate_full",
              f"V 1 cap {cap} with repeated lanes",
              (x["a"][:, None], x["na"][:, None], x["bounds"]), cap,
              dict(a_pg=x["a_pg"][:, None]))

    # the posting fetch at caps up to the 1 GB cells' 2^21: lists empty,
    # shorter than, as long as and past the cap, at starts on every
    # residue mod 4; -1 terms; [B] and strided [B, V] terms; a base off
    # 16 bytes; with and without pages. A generator of its own
    frng = np.random.default_rng(rng.bit_generator.seed_seq.spawn(2)[1])
    for cap, rows in ((64, 4096), (4096, 1024), (1 << 16, 64),
                      (1 << 21, 8)):
        counts = np.concatenate([[0, 1, 3, cap // 2 + 1, cap - 1, cap,
                                  cap + 1, 2 * cap + 3],
                                 frng.integers(0, cap + 2, 8)])
        offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
        coords = np.cumsum(frng.integers(1, 40, int(offsets[-1])))
        buf = torch.empty(coords.size + 1, dtype=torch.int32, device=dev)
        co = buf[1:]
        co.copy_(torch.from_numpy(coords.astype(np.int32)))
        pg = co // 997
        off = torch.from_numpy(offsets).to(dev)
        ids = frng.integers(-1, counts.size, (rows, 2, 4))
        ids[0, 0, 0], ids[0, 1] = 6, (-1, 0, 5, 3)  # past, none, full, part
        ids = torch.from_numpy(ids.astype(np.int32)).to(dev)
        for terms in (ids[:, 0, 0], ids[:, 1]):
            for page_of in (None, pg):
                got = qk._fetch_kernel(co, off, terms, cap, page_of)
                torch.cuda.synchronize()
                want = qk._fetch_plain(co, off, terms, cap, page_of)
                same_result("fetch_postings", got, want,
                            f"fetch_postings cap {cap} terms "
                            f"{tuple(terms.shape)}")
        ln = got[2]
        require(bool((ln == cap).any() and (ln == 0).any()
                     and ((ln > 0) & (ln < cap)).any()),
                f"fetch_postings cap {cap}: no full, empty or part row")
        say(f"parity: fetch_postings cap {cap} terms [{rows}] and strided "
            f"[{rows}, 4], pages or not: equal")
    return err


def phase_index(corpus_mb: float, seed: int):
    """The corpus indexed by the port's host engine (docodo_tpu_torch.index
    Index, which keeps the page text for snippets): body pages through the
    native tokenizer and interner, the CSR sorted on the card. Its build
    must equal, array for array, the pure-Python build sorted on the CPU
    (build_index(native=False, device="cpu")). Staged on the card.
    Returns (index, device index)."""
    from docodo_tpu_torch.index import Index, ListDataSource, build_index
    from docodo_tpu_torch.lang import tokenizer
    from docodo_tpu_torch.ops.device_index import DeviceIndex, build_postings
    from docodo_tpu_torch.synthetic import zipf_documents
    from docodo_tpu_torch.utils import profiling

    t0 = time.perf_counter()
    docs = zipf_documents(int(corpus_mb * 1e6), seed=seed)
    t1 = time.perf_counter()
    profiling.reset()
    ind = Index()
    ind.add_data_source(ListDataSource("synth", docs))
    ind.create()
    t_native = time.perf_counter() - t1
    native_report = profiling.format_report()
    profiling.reset()
    t2 = time.perf_counter()
    ref = build_index(ListDataSource("synth", docs), native=False,
                      device="cpu")
    t_ref = time.perf_counter() - t2
    python_report = profiling.format_report()
    got, want = ind.host, ref
    require(got.arr.terms == want.arr.terms
            and got.pages.page_ids == want.pages.page_ids
            and got.pages.doc_names == want.pages.doc_names
            and got.arr.max_coord == want.arr.max_coord
            and all(a.dtype == b.dtype and np.array_equal(a, b)
                    for a, b in ((got.arr.offsets, want.arr.offsets),
                                 (got.arr.coords, want.arr.coords),
                                 (got.pages.bounds, want.pages.bounds),
                                 (got.pages.page_doc, want.pages.page_doc))),
            "Index.create (native, on the card) differs from the "
            "pure-Python build on the CPU")
    t2 = time.perf_counter()
    dix = DeviceIndex.from_index(ind)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    counts = np.diff(dix.offsets_np)
    say(f"index: {corpus_mb:g} MB seed {seed}: {len(docs)} docs, "
        f"{dix.bounds.numel()} pages, {len(dix.terms)} terms, "
        f"{dix.coords.numel()} postings, largest list {int(counts.max())}, "
        f"{dix.device_bytes() / 1e6:.1f} MB on device; corpus "
        f"{t1 - t0:.1f} s, build {t_native:.2f} s (Index.create: "
        f"native tokenizer, sort on the card), pure-Python build on the "
        f"CPU {t_ref:.2f} s, equal array for array (terms, offsets, "
        f"coords, bounds, page_doc, page_ids, doc_names); staging "
        f"{t3 - t2:.1f} s")
    for label, report in (("native, card", native_report),
                          ("pure Python, CPU", python_report)):
        say(f"build phases ({label}): " + "; ".join(
            " ".join(line.split()) for line in report.splitlines()))

    # the device build over the tokenizer's stream, against numpy
    text = " ".join(p.text for d in docs for p in d.pages[1:])
    words, starts = tokenizer.tokenize(text)
    ids: dict = {}
    tids = np.fromiter((ids.setdefault(w, len(ids)) for w in words),
                       np.int64, len(words))
    n_terms = len(ids)
    tt = torch.as_tensor(tids.astype(np.int32), device="cuda")
    tc = torch.as_tensor(starts.astype(np.int32), device="cuda")
    build_postings(tt, tc, n_terms)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    st, sc, off = build_postings(tt, tc, n_terms)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t4
    order = np.lexsort((starts, tids))
    want_off = np.concatenate(
        [[0], np.cumsum(np.bincount(tids, minlength=n_terms))])
    require(np.array_equal(sc.cpu().numpy(), starts[order].astype(np.int32))
            and np.array_equal(st.cpu().numpy(), tids[order].astype(np.int32))
            and np.array_equal(off.cpu().numpy(),
                               want_off.astype(np.int32)),
            "build_postings differs from numpy lexsort")
    say(f"build_postings: {tids.size} tokens, {n_terms} terms, "
        f"{t_build * 1e3:.2f} ms on the card; equals numpy lexsort")
    return ind, dix


def phase_build_scale(build_mb: float, seed: int, card: str):
    """BASELINE.md's 1 GB build, twice over the same seeded Zipf
    documents. First by the JAX package's build_mb_s protocol
    (BUILD_r04.json, benchmarks/scale_build.py), which no entry point of
    the port runs: the documents (body pages joined by newlines)
    tokenized and interned on threads (parallel_tokenize_intern), packed
    with absolute starts (one coordinate space over the documents in
    order, a newline between documents as between pages), copied to the
    card from pinned memory and sorted into one CSR
    there (build_postings_packed). Requires offsets[-1] to be the token
    count, every list ascending and 1,000 seeded terms' lists equal to a
    numpy lexsort of the same stream. End to end is tokenize to the CSR
    on the card; device-only the copy and the sort. Then by the port's
    build, build_index (the native tokenizer on one thread, the CSR
    sorted on the card), whose lists of the same 1,000 words must equal
    the protocol's, moved to its coordinates (no newline between pages,
    header pages between documents). Returns build_index's index, which
    phase_disk writes to disk, the documents, and what phase_surface
    holds its packed build against (`proto`: the document texts and
    their bases, the terms, the 1,000 sampled ids and their postings,
    the token count, the tokenize MB/s)."""
    import os

    from docodo_tpu_torch.benchmarks import common as bc
    from docodo_tpu_torch.index import ListDataSource, build_index
    from docodo_tpu_torch.lang import tokenizer
    from docodo_tpu_torch.native import pipeline
    from docodo_tpu_torch.ops.device_index import (
        build_postings_packed,
        pack_tokens,
    )
    from docodo_tpu_torch.synthetic import zipf_documents
    from docodo_tpu_torch.utils import profiling

    t0 = time.perf_counter()
    docs = zipf_documents(int(build_mb * 1e6), seed=seed)
    # a text a document, its body pages joined by newlines: calls of a
    # page each would hold the threads on the interpreter lock
    texts = ["\n".join(p.text for p in d.pages[1:]) for d in docs]
    mb = sum(map(len, texts)) / 1e6  # ASCII: a character is a byte
    t_corpus = time.perf_counter() - t0
    workers = min(os.cpu_count() or 1, 8)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ids_l, starts_l, terms = pipeline.parallel_tokenize_intern(
        texts, workers=workers)
    t2 = time.perf_counter()
    # one newline between documents, as between pages: a text of several
    # documents joined by newlines tokenizes as they do one by one
    bases = np.cumsum([0] + [tokenizer.char_len(t) + 1 for t in texts[:-1]])
    counts = np.fromiter((a.size for a in ids_l), np.int64, len(ids_l))
    ids = np.concatenate(ids_l)
    starts = (np.concatenate(starts_l).astype(np.int64)
              + np.repeat(bases, counts))
    del ids_l, starts_l
    packed = pack_tokens(ids, starts)
    t3 = time.perf_counter()
    pinned = torch.empty(packed.size, dtype=torch.int32, pin_memory=True)
    pinned.numpy()[:] = packed.view(np.int32)
    t4 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    dev = pinned.to("cuda", non_blocking=True)
    torch.cuda.synchronize()
    t5 = time.perf_counter()
    num_terms = len(terms)
    st, sc, off = build_postings_packed(dev, num_terms)
    torch.cuda.synchronize()
    t6 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated() - held
    n = ids.size
    require(int(off[-1]) == n and int(off[0]) == 0,
            f"build {mb:.0f} MB: offsets[-1] {int(off[-1])} != {n} tokens")
    require(bool(((st[1:n] > st[:n - 1])
                  | ((st[1:n] == st[:n - 1]) & (sc[1:n] > sc[:n - 1])))
                 .all()), f"build {mb:.0f} MB: a list is not ascending")
    rng = np.random.default_rng(seed)
    sample = np.sort(rng.choice(np.flatnonzero(np.bincount(
        ids, minlength=num_terms)), size=1000, replace=False))
    pick = np.zeros(num_terms, dtype=bool)
    pick[sample] = True
    mask = pick[ids]
    sub_ids, sub_starts = ids[mask], starts[mask]
    want = sub_starts[np.lexsort((sub_starts, sub_ids))]
    off_h = off.cpu().numpy().astype(np.int64)
    lens = off_h[sample + 1] - off_h[sample]
    at = (np.repeat(off_h[sample] - (np.cumsum(lens) - lens), lens)
          + np.arange(int(lens.sum())))
    got = sc[torch.from_numpy(at).cuda()].cpu().numpy()
    require(np.array_equal(lens, np.bincount(sub_ids,
                                             minlength=num_terms)[sample])
            and np.array_equal(got, want),
            f"build {mb:.0f} MB: the 1,000 sampled lists differ from numpy")
    # the sort again, warm, on CUDA events
    csr_bytes = sum(x.numel() * x.element_size() for x in (st, sc, off))
    del st, sc, off
    sort_ms = cuda_ms(lambda: build_postings_packed(dev, num_terms), reps=3)
    # the least time: the packed rows read once, the CSR written once
    bound_ms = bc.bound(packed.nbytes + csr_bytes)["bound_ms"]
    say(f"build {mb:.1f} MB (seed {seed}, {len(texts)} documents): "
        f"{n} tokens, {packed.size} packed rows, {num_terms} terms; corpus "
        f"{t_corpus:.1f} s (untimed); tokenize+intern on {workers} threads "
        f"{t2 - t1:.2f} s ({mb / (t2 - t1):.1f} MB/s), pack "
        f"{t3 - t2:.2f} s, pinned copy {t4 - t3:.2f} s, H2D "
        f"{(t5 - t4) * 1e3:.1f} ms ({packed.nbytes / (t5 - t4) / 1e9:.1f} "
        f"GB/s), sort {(t6 - t5) * 1e3:.1f} ms (warm {sort_ms:.1f} ms, CUDA "
        f"events; bytes bound {bound_ms:.3f} ms); end to end {t6 - t1:.2f} s = {mb / (t6 - t1):.1f} MB/s, "
        f"device-only {mb / (t6 - t4):.1f} MB/s, tokenize "
        f"{mb / (t2 - t1):.1f} MB/s; card: {packed.nbytes / 1e6:.1f} MB "
        f"copied, CSR {csr_bytes / 1e6:.1f} MB, peak "
        f"{peak / 1e9:.2f} GB; offsets[-1] = tokens, lists ascending, "
        f"1,000 seeded lists equal numpy lexsort; {card}")
    proto = dict(texts=texts, bases=bases, terms=terms, sample=sample,
                 sub_ids=sub_ids, sub_starts=sub_starts, tokens=n, mb=mb,
                 tokenize_mb_s=mb / (t2 - t1), workers=workers)
    del dev, pinned, ids, starts, packed, mask
    torch.cuda.empty_cache()

    # the port's entry point over the same documents
    profiling.reset()
    t7 = time.perf_counter()
    built = build_index(ListDataSource("synth", docs))
    t8 = time.perf_counter()
    report = " ".join(profiling.format_report().split())
    arr, pages = built.arr, built.pages
    require(int(arr.offsets[-1]) == arr.coords.size,
            f"build_index {mb:.0f} MB: offsets[-1] {int(arr.offsets[-1])} "
            f"!= {arr.coords.size} postings")
    steps = np.diff(arr.coords.view(np.int64))
    firsts = np.zeros(steps.size, dtype=bool)
    heads = arr.offsets[1:-1]
    firsts[heads[(heads > 0) & (heads <= steps.size)] - 1] = True
    require(bool((firsts | (steps > 0)).all()),
            f"build_index {mb:.0f} MB: a list is not ascending")
    del steps, firsts
    # body page k starts at protocol coordinate sum_{i<k}(units_i + 1);
    # in build_index at the end of the page before it
    body = np.array([pid != "0" for pid in pages.page_ids])
    units = np.array([tokenizer.char_len(p.text) for d in docs
                      for p in d.pages[1:]], dtype=np.int64)
    at = np.cumsum(units + 1) - (units + 1)
    shift = (np.concatenate([[0], pages.bounds[:-1].astype(np.int64)])[body]
             - at)
    moved = sub_starts + shift[np.searchsorted(at, sub_starts,
                                               side="right") - 1]
    require(all(np.array_equal(arr.get(terms[t]).astype(np.int64),
                               moved[sub_ids == t]) for t in sample),
            f"build_index {mb:.0f} MB: the 1,000 sampled words' lists "
            f"differ from the protocol's")
    say(f"build_index {mb:.1f} MB (the port's build: native tokenizer on "
        f"one thread, CSR sorted on the card) over the same "
        f"{len(docs)} documents: {t8 - t7:.2f} s = "
        f"{mb / (t8 - t7):.1f} MB/s; {len(arr.terms)} terms, "
        f"{arr.coords.size} postings; {report}; offsets[-1] = postings, "
        f"lists ascending, the 1,000 sampled words' lists equal the "
        f"protocol's; {card}")
    return built, docs, proto


def _serve_cli(argv, reqs, host, clients: int = 16):
    """`python -m docodo_tpu_torch.cli <argv> server -p:0 -batch` in a
    process of its own (the port it prints), `reqs` sent over HTTP from
    `clients` threads, every JSON body held against
    result_to_json(host.search(req)); then its input is closed, which
    ends it, and its exit code must be 0. Returns (its /status, the
    requests' seconds, its start's seconds)."""
    import concurrent.futures as cf
    import os
    import re
    import sys
    import threading
    import urllib.parse
    import urllib.request

    from docodo_tpu_torch.server import result_to_json

    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "docodo_tpu_torch.cli", *argv, "server",
         "-p:0", "-batch"], cwd=str(Path(__file__).resolve().parent),
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, PYTHONUNBUFFERED="1"))
    lines = []
    listening = threading.Event()
    port = []

    def read():
        for line in proc.stdout:
            lines.append(line)
            m = re.search(r"listening on port (\d+)", line)
            if m:
                port.append(int(m.group(1)))
                listening.set()

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    try:
        require(listening.wait(600) and proc.poll() is None,
                "cli server did not start: " + "".join(lines[-20:]))
        t_start = time.perf_counter() - t0
        base = f"http://127.0.0.1:{port[0]}"

        def get(path):
            with urllib.request.urlopen(base + path, timeout=600) as r:
                return json.loads(r.read().decode("utf-8"))

        t1 = time.perf_counter()
        with cf.ThreadPoolExecutor(clients) as pool:
            bodies = list(pool.map(
                lambda r: get("/search?req=" + urllib.parse.quote(r)), reqs))
        secs = time.perf_counter() - t1
        status = get("/status")
        for req, body in zip(reqs, bodies):
            want = json.loads(json.dumps(result_to_json(host.search(req)),
                                         ensure_ascii=False))
            require(body == want, f"cli server: /search {req!r} differs "
                    "from result_to_json(Index.search) of the loaded index")
        proc.stdin.close()
        rc = proc.wait(timeout=300)
        reader.join(timeout=60)
        require(rc == 0, f"cli server exited {rc}: " + "".join(lines[-20:]))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return status, secs, t_start


def phase_disk(corpus_mb: float, seed: int, card: str, built,
               tmp: Path) -> dict:
    """The index on disk and the console app (docodo_tpu_torch.cli). The
    seeded corpus as .txt files (the first 8 in a subfolder whose .dscr
    gives them an author and a year, one with a .dscr of its own), then:
    the CLI builds its index into a folder (`-i: -source:files,... -mem`,
    keys I and E, in a process of its own); Index(folder) loads it, and
    it must equal, array for array, an Index() built in memory on the
    card from the same folder; both are staged, and the standard mix and
    the wide mix + alternations through search_batch_full on the loaded
    one (counts zeroed just before, read just after) must launch every
    kernel of STANDARD_KERNELS and WIDE_KERNELS, take no plain bucket,
    and equal the in-memory build's field for field; then the CLI serves
    the folder (`server -batch`, in a process of its own) and 128
    requests over HTTP must equal the loaded index's Index.search,
    snippets from its page cache included, with requests served on the
    card. Last, `built` (phase_build_scale's 1 GB build) is written with
    write_postings_arrays and PageTable.save and read back with
    read_index and PageTable.load, equal. The files live in `tmp`, which
    the caller removes (phase_surface reads the console app's folder,
    `tmp / "idx"`, first). Returns the launches of the mixes on the
    loaded index."""
    import glob
    import random
    import sys

    from docodo_tpu_torch.core import storage
    from docodo_tpu_torch.core.pagetable import PageTable
    from docodo_tpu_torch.index import Index
    from docodo_tpu_torch.lang.vocab import Vocab, load_stop_words
    from docodo_tpu_torch.mix import serve_requests, wide_requests
    from docodo_tpu_torch.ops import _cuda
    from docodo_tpu_torch.ops import device_index as tdi
    from docodo_tpu_torch.ops.device_index import DeviceIndex
    from docodo_tpu_torch.sources import IndexTextFilesDataSource
    from docodo_tpu_torch.synthetic import zipf_documents

    root = Path(__file__).resolve().parent
    mb = lambda *paths: sum(p.stat().st_size for p in paths) / 1e6
    # (a) the corpus as files
    docs = zipf_documents(int(corpus_mb * 1e6), seed=seed)
    corpus = tmp / "corpus"
    (corpus / "sub").mkdir(parents=True)
    (corpus / "sub" / ".dscr").write_text("author=dickens\nyear=1836\n")
    for i, d in enumerate(docs):
        folder = corpus / "sub" if i < 8 else corpus
        (folder / f"{d.name}.txt").write_text(
            " ".join(p.text for p in d.pages[1:]))
    (corpus / f"{docs[8].name}.txt.dscr").write_text("category=fiction\n")
    source_mb = sum(f.stat().st_size for f in corpus.rglob("*.txt")) / 1e6
    idx = tmp / "idx"
    argv = [f"-i:{idx}", f"-source:files,{corpus}/", "-mem"]

    # (b) the console app builds the index
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "docodo_tpu_torch.cli", *argv],
        input="I\nE\n", capture_output=True, text=True, timeout=900,
        cwd=str(root))
    t_cli = time.perf_counter() - t0
    require(proc.returncode == 0 and "Indexing completed." in proc.stdout
            and "Error" not in proc.stdout,
            f"cli build exited {proc.returncode}: {proc.stdout[-2000:]} "
            f"{proc.stderr[-2000:]}")
    files = {n: idx / n for n in (storage.INDEX_FILE, storage.PAGES_FILE,
                                  "files.cache.zip")}
    say(f"disk: {len(docs)} documents as .txt files ({source_mb:.1f} MB)"
        f"; `python -m docodo_tpu_torch.cli {' '.join(argv)}` with keys "
        f"I, E: {t_cli:.2f} s in all (its process's start and the "
        f"build), .index {mb(files['.index']):.2f} MB, .index.list "
        f"{mb(files['.index.list']):.2f} MB, files.cache.zip "
        f"{mb(files['files.cache.zip']):.2f} MB; on {card}")

    # (c) loaded, against the in-memory build of the same folder; the
    # vocabularies and stop words the console app loads from Dict/
    vocs = [Vocab(f) for f in sorted(glob.glob(str(root / "Dict"
                                                   / "*.voc")))]
    stops = root / "Dict" / "stop.txt"
    stop_words = load_stop_words(str(stops)) if stops.exists() else None
    t0 = time.perf_counter()
    loaded = Index(str(idx), vocs=vocs, stop_words=stop_words)
    t_load = time.perf_counter() - t0
    require(loaded.can_search, "Index(path) did not load the cli's index")
    loaded.add_data_source(IndexTextFilesDataSource("files", f"{corpus}/"))
    t0 = time.perf_counter()
    mem = Index(vocs=vocs, stop_words=stop_words)
    mem.add_data_source(IndexTextFilesDataSource("files", f"{corpus}/"))
    mem.create()
    t_mem = time.perf_counter() - t0
    got, want = loaded.host, mem.host
    require(got.arr.terms == want.arr.terms
            and got.pages.page_ids == want.pages.page_ids
            and got.pages.doc_names == want.pages.doc_names
            and got.arr.max_coord == want.arr.max_coord
            and all(a.dtype == b.dtype and np.array_equal(a, b)
                    for a, b in ((got.arr.offsets, want.arr.offsets),
                                 (got.arr.coords, want.arr.coords),
                                 (got.pages.bounds, want.pages.bounds),
                                 (got.pages.page_doc,
                                  want.pages.page_doc))),
            "the loaded index differs from the in-memory build")
    say(f"disk: Index(path) loaded in {t_load:.2f} s "
        f"({mb(files['.index']) / t_load:.1f} MB/s of .index; "
        f"{len(got.arr.terms)} terms, {got.arr.coords.size} postings, "
        f"{len(got.pages)} pages); equal array for array (terms, "
        f"offsets, coords, max_coord, bounds, page_doc, page_ids, "
        f"doc_names) to Index() built in memory on the card from the "
        f"same folder in {t_mem:.2f} s; on {card}")
    dl, dm = DeviceIndex.from_index(loaded), DeviceIndex.from_index(mem)
    mixes = (("standard mix", _queries(dm, N_QUERIES)),
             ("wide mix + alternations",
              _wide_queries(dm, N_QUERIES, N_ALTERNATIONS)))
    for _, q in mixes:  # warm
        dl.search_batch_full(q, topk=TOPK, hit_cap=HIT_CAP,
                             use_kernels=True)
    torch.cuda.synchronize()
    plain = []
    inner = tdi.query_step_full

    def plain_bucket(*a, **k):
        plain.append(1)
        return inner(*a, **k)

    tdi.query_step_full = plain_bucket
    for k in _cuda.KERNELS.values():
        k.launches = 0
    try:
        outs = [dl.search_batch_full(q, topk=TOPK, hit_cap=HIT_CAP,
                                     use_kernels=True) for _, q in mixes]
        torch.cuda.synchronize()
    finally:
        tdi.query_step_full = inner
    launches = {name: k.launches for name, k in _cuda.KERNELS.items()}
    for name in STANDARD_KERNELS + WIDE_KERNELS:
        require(launches[name] > 0, f"kernel {name} was not launched "
                "on the loaded index")
    require(not plain, f"{len(plain)} buckets of the loaded index took "
            "query_step_full")
    for (label, q), out in zip(mixes, outs):
        ref = dm.search_batch_full(q, topk=TOPK, hit_cap=HIT_CAP,
                                   use_kernels=True)
        for f, v in out.items():
            require(np.array_equal(v, ref[f]), f"disk, {label}: {f} "
                    "differs from the in-memory build's")
    say(f"disk: both mixes ({sum(len(q) for _, q in mixes)} rows) on "
        f"the loaded index's DeviceIndex through the kernel route, "
        f"every field equal to the in-memory build's; launches "
        f"{({n: c for n, c in launches.items() if c})}; no plain "
        f"bucket")
    del dl, dm, outs, mixes
    torch.cuda.empty_cache()

    # (d) the console app serves the folder
    words = {}
    for d in docs[:8]:
        body = d.pages[1].text.split()
        words[d.name] = body[len(body) // 2: len(body) // 2 + 2]
    std = serve_requests(loaded, 400)
    wide = wide_requests(loaded, 200)
    reqs = std[:80] + wide[:16]
    for name, (w1, w2) in words.items():
        reqs += [f'"{w1} {w2}"', f"{w1} {{author=dickens}}"]
    reqs += ["{year=1836}", "{category=fiction}", "{name=sub}",
             f"{words[docs[0].name][0]} {{source=files}}",
             f'"{words[docs[1].name][0]} {words[docs[1].name][1]}" '
             f"{{year=1836}}"]
    reqs += std[80: 80 + BATCHER_HTTP - len(reqs)]
    random.Random(seed).shuffle(reqs)
    require(len(reqs) == BATCHER_HTTP, f"{len(reqs)} requests")
    status, secs, t_start = _serve_cli(argv, reqs, loaded)
    st = status["batcher"]
    require(status["canSearch"] and st["device_queries"] > 0
            and st["device_timeouts"] == 0,
            f"cli server /status: {status}")
    say(f"disk: `python -m docodo_tpu_torch.cli {' '.join(argv)} server "
        f"-p:0 -batch` up in {t_start:.2f} s; {len(reqs)} /search "
        f"requests (the batcher's recipe, wide ones, quoted phrases and "
        f"field requests) from 16 clients in {secs:.2f} s, every body "
        f"equal to result_to_json(Index.search) of the loaded index, "
        f"snippets from files.cache.zip included; /status batcher "
        f"{st}; the process exited 0 when its input closed")
    loaded.dispose()
    mem.dispose()

    # (e) phase_build_scale's build written and read back
    big = tmp / "big"
    big.mkdir()
    arr, pages = built.arr, built.pages
    t0 = time.perf_counter()
    with open(big / storage.INDEX_FILE, "wb") as f:
        storage.write_postings_arrays(f, arr.max_coord, arr.terms,
                                      arr.offsets, arr.coords)
    t1 = time.perf_counter()
    with open(big / storage.PAGES_FILE, "wb") as f:
        pages.save(f)
    t2 = time.perf_counter()
    back = storage.read_index(str(big / storage.INDEX_FILE))
    t3 = time.perf_counter()
    with open(big / storage.PAGES_FILE, "rb") as f:
        back_pages = PageTable.load(f)
    t4 = time.perf_counter()
    require(back.terms == arr.terms and back.max_coord == arr.max_coord
            and np.array_equal(back.offsets, arr.offsets)
            and np.array_equal(back.coords, arr.coords)
            and back_pages.page_ids == pages.page_ids
            and back_pages.doc_names == pages.doc_names
            and np.array_equal(back_pages.bounds, pages.bounds)
            and np.array_equal(back_pages.page_doc, pages.page_doc),
            "the build at scale read back differs from the build")
    imb = mb(big / storage.INDEX_FILE)
    lmb = mb(big / storage.PAGES_FILE)
    say(f"disk, the build at scale ({arr.coords.size} postings, "
        f"{len(arr.terms)} terms, {len(pages)} pages): .index "
        f"{imb:.1f} MB written in {t1 - t0:.2f} s ({imb / (t1 - t0):.1f} "
        f"MB/s), read in {t3 - t2:.2f} s ({imb / (t3 - t2):.1f} MB/s); "
        f".index.list {lmb:.2f} MB written in {t2 - t1:.2f} s, read in "
        f"{t4 - t3:.2f} s; equal to the build array for array; {card}")
    del back, back_pages
    return launches


def _queries(dix, n: int):
    from docodo_tpu_torch.mix import mix_queries, standard_mix

    terms, rs = standard_mix(np.diff(dix.offsets_np), dix.terms, n)
    return mix_queries(terms, rs, dix.terms)


def _alternations(counts, n: int, seed: int):
    """`a|b` alternations (ref Search.cs:351) and two-code words: one word
    of two variants, or two such words, ordered on every third query.
    Returns (terms int32[n, 2, 2], rs int32[n, 2])."""
    rng = np.random.default_rng(seed)
    eligible = np.flatnonzero(counts >= 2)
    terms = np.full((n, 2, 2), -1, np.int32)
    rs = np.ones((n, 2), np.int32)
    for i in range(n):
        picks = rng.choice(eligible, size=4, replace=False)
        w = 1 + i % 2
        terms[i, :w] = picks[: 2 * w].reshape(w, 2)
        rs[i, :w] = -9 if i % 3 == 0 else 262
    return terms, rs


def _wide_queries(dix, n: int, n_alt: int):
    """The wide mix's rows (bench.py:353: seed 77) as queries, a field
    query's two rows each a query of its own, then the alternations."""
    from docodo_tpu_torch.mix import mix_queries, wide_mix

    counts = np.diff(dix.offsets_np)
    terms, rs, _ = wide_mix(counts, dix.terms, n, seed=WIDE_SEED)
    at, ar = _alternations(counts, n_alt, WIDE_SEED)
    return (mix_queries(terms, rs, dix.terms)
            + mix_queries(at, ar, dix.terms))


def _rows_equal(a: dict, b: dict, rows, what: str) -> None:
    """Two result dicts equal on `rows` (a mask or a slice): ints exact,
    ranks and doc ranks within 1 ulp."""
    for f, v in a.items():
        x, y = v[rows], b[f][rows]
        if v.dtype == np.float32:
            u = ulps(torch.from_numpy(np.ascontiguousarray(x)),
                     torch.from_numpy(np.ascontiguousarray(y)))
            require(u <= 1, f"{what}: {f} {u} ulp apart")
        else:
            bad = np.argwhere(x != y)
            require(bad.size == 0, f"{what}: {f} differs at rows "
                    f"{bad[:4, 0].tolist()}")


def phase_main(dix, queries, card: str, label: str, required):
    """One mix on the main path: the batch on the kernel route with every
    launch count zeroed just before and read just after, the bucket
    routes counted, then the plain route, field for field. Every kernel
    in `required` must have launched and no bucket may take the plain
    route. Returns (results, launches)."""
    from docodo_tpu_torch.ops import _cuda
    from docodo_tpu_torch.ops import device_index as tdi

    def run(use_kernels: bool):
        return dix.search_batch_full(queries, topk=TOPK, hit_cap=HIT_CAP,
                                     use_kernels=use_kernels)

    run(True)  # warm
    torch.cuda.synchronize()
    routes = {"slot": "_kernel_bucket_full", "chunked": "_chunked_bucket_full",
              "plain": "query_step_full"}
    served = dict.fromkeys(routes, 0)
    saved = {name: getattr(tdi, fn) for name, fn in routes.items()}

    def counted(name):
        def call(*a, **k):
            out = saved[name](*a, **k)
            served[name] += out is not None
            return out
        return call

    for name, fn in routes.items():
        setattr(tdi, fn, counted(name))
    for k in _cuda.KERNELS.values():
        k.launches = 0
    try:
        t0 = time.perf_counter()
        out = run(True)
        secs = time.perf_counter() - t0
    finally:
        for name, fn in routes.items():
            setattr(tdi, fn, saved[name])
    launches = {name: k.launches for name, k in _cuda.KERNELS.items()}
    shapes = {}
    for q in queries:
        cg = dix.compile_group_query(q)
        if cg is not None:
            key = f"W{cg[2]}V{tdi._bucket(cg[3], lo=1)}"
            shapes[key] = shapes.get(key, 0) + 1
    say(f"main path, {label}: {len(queries)} queries {shapes}, kernel route "
        f"{secs * 1e3:.1f} ms warm ({len(queries) / secs:.0f} QPS) on "
        f"{card}; buckets per route {served}; launches {launches}")
    for name in required:
        require(launches[name] > 0,
                f"kernel {name} was not launched on the {label} main path")
    require(served["plain"] == 0,
            f"{served['plain']} {label} buckets took query_step_full")
    run(False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = run(False)
    psecs = time.perf_counter() - t0
    _rows_equal(out, plain, slice(None), f"{label}, kernel and plain routes")
    say(f"plain route, {label}: {psecs * 1e3:.1f} ms warm "
        f"({len(queries) / psecs:.0f} QPS); every field equal to the "
        f"kernel route (ranks within 1 ulp)")
    return out, launches


def _profile_batch():
    """tools/profile_batch.py as a module, loaded by its path: its
    per-bucket timer of the page-level leg is the one this script uses."""
    import importlib.util

    path = Path(__file__).resolve().parent / "tools" / "profile_batch.py"
    spec = importlib.util.spec_from_file_location("profile_batch", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def phase_page(dix, queries, card: str):
    """The page-level main path: the standard mix through search_batch
    (topk 16) on the kernel route with every launch count zeroed just
    before and read just after, each bucket alone with a synchronise
    around it (buckets, rows and ms per route), then the torch route,
    field for field. Both page-level kernels must have launched.
    Returns (results, launches)."""
    from docodo_tpu_torch.ops import _cuda

    def run(use_kernels: bool):
        return dix.search_batch(queries, topk=PAGE_TOPK,
                                use_kernels=use_kernels)

    run(True)  # warm
    torch.cuda.synchronize()
    for k in _cuda.KERNELS.values():
        k.launches = 0
    t0 = time.perf_counter()
    out = run(True)
    secs = time.perf_counter() - t0
    launches = {name: k.launches for name, k in _cuda.KERNELS.items()}

    served = {name: dict(buckets=0, rows=0, ms=0.0)
              for name in ("kernel", "torch")}
    for b in _profile_batch().page_bucket_times(dix, queries, True):
        served[b["route"]]["buckets"] += 1
        served[b["route"]]["rows"] += b["rows"]
        served[b["route"]]["ms"] += b["ms"]
    per_route = {name: f"{v['buckets']} buckets, {v['rows']} rows, "
                 f"{v['ms']:.1f} ms" for name, v in served.items()}
    say(f"main path, page level: {len(queries)} queries topk {PAGE_TOPK}, "
        f"kernel route {secs * 1e3:.1f} ms warm ({len(queries) / secs:.0f} "
        f"QPS) on {card}; each bucket alone, synchronised: {per_route}; "
        f"launches {({n: launches[n] for n in PAGE_KERNELS})}")
    for name in PAGE_KERNELS + ("fetch_postings",):
        require(launches[name] > 0,
                f"kernel {name} was not launched on the page-level path")
    require(all(launches[n] == 0 for n in launches
                if n not in PAGE_KERNELS + ("fetch_postings",)),
            "a full-result kernel launched on the page-level path")
    run(False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = run(False)
    psecs = time.perf_counter() - t0
    same_outputs([torch.from_numpy(x) for x in out],
                 [torch.from_numpy(x) for x in plain], "page-level routes",
                 PAGE_FIELDS)
    say(f"torch route, page level: {psecs * 1e3:.1f} ms warm "
        f"({len(queries) / psecs:.0f} QPS); pages and counts equal to the "
        f"kernel route, ranks within 1 ulp")
    return out, launches


def phase_serve(dix, queries, fused_out, card: str, rng):
    """Both mixes through the serving shape of search_batch_full
    (tools/profile_batch.py, serve_pass: waves of 512, fused=False, the
    cap ladder, deferred, then the escalated pass), once per sort_topk
    mode, with every launch count zeroed just before a pass and read
    just after. The top-k-mode pass must launch each of SERVE_KERNELS;
    only W >= 3 buckets with variants may take the plain route; the
    passes agree on every row not flagged truncated, and with the fused
    batch (`fused_out`, the same queries) on every row neither flags;
    sampled rows, escalated ones among them, are held against the numpy
    oracle. Returns the launches of both passes summed."""
    from docodo_tpu_torch.ops import _cuda

    pb = _profile_batch()
    pb.serve_pass(dix, queries[: 4 * pb.SERVE_WAVE], True)  # warm
    pb.serve_pass(dix, queries[: 4 * pb.SERVE_WAVE], False)
    torch.cuda.synchronize()
    runs, launches = {}, {}
    for st in (True, False):
        for k in _cuda.KERNELS.values():
            k.launches = 0
        runs[st] = pb.serve_pass(dix, queries, st)
        launches[st] = {n: k.launches for n, k in _cuda.KERNELS.items()}
        r = runs[st]
        med, emed = pb.wave_medians(r["stats"]), pb.wave_medians(
            r["esc_stats"])
        plain = [wv for s in r["stats"] + r["esc_stats"] for wv in s["plain"]]
        say(f"serving path, sort_topk={st}: {len(queries)} rows in "
            f"{len(r['stats'])} waves of {pb.SERVE_WAVE}, "
            f"{r['secs'] * 1e3:.1f} ms ({len(queries) / r['secs']:.0f} QPS) "
            f"on {card}; per wave (medians): {med['buckets']:.0f} buckets, "
            f"{med['launches']:.0f} kernel launches, deferred call "
            f"{med['call_ms']:.2f} ms ({med['launch_ms']:.2f} ms of it in "
            f"the buckets' launches), finish {med['finish_ms']:.2f} ms; "
            f"{r['truncated']} rows truncated, {len(r['esc_rows'])} of cap "
            f"<= {pb.ESC_CAP_MAX} escalated (topk {pb.ESC_TOPK}, hit_cap "
            f"{pb.ESC_HIT_CAP}, clamped) in {len(r['esc_stats'])} waves, "
            f"{r['esc_secs'] * 1e3:.1f} ms"
            + (f" (per wave {emed['buckets']:.0f} buckets, call "
               f"{emed['call_ms']:.2f} ms, finish {emed['finish_ms']:.2f} "
               f"ms)" if emed else "")
            + f", {pb.still_truncated(r['esc_out'])} still truncated; "
            f"{len(plain)} buckets on the plain route; launches "
            f"{({n: c for n, c in launches[st].items() if c})}")
        require(all(w >= 3 and v > 1 for w, v in plain),
                f"buckets {sorted(set(plain))} took query_step_full")
        require(len(r["esc_rows"]) > 0, "no row was escalated")
    for name in SERVE_KERNELS:
        require(launches[False][name] > 0, f"kernel {name} was not launched "
                "on the serving path with sort_topk=False")
        require(launches[True][name] == 0, f"kernel {name} launched with "
                "sort_topk=True")

    a, b = runs[True], runs[False]
    whole = (a["out"]["n_pages"] <= TOPK) & (a["out"]["n_hits"] <= HIT_CAP)
    _rows_equal(a["out"], b["out"], whole, "serving path, sort_topk modes")
    require(a["esc_rows"] == b["esc_rows"], "the modes escalate other rows")
    ea, eb = a["esc_out"], b["esc_out"]
    esc_whole = ((ea["n_pages"] <= ea["topk_eff"])
                 & (ea["n_hits"] <= ea["hit_cap_eff"]))
    _rows_equal(ea, eb, esc_whole, "escalated pass, sort_topk modes")
    both = whole & (fused_out["n_pages"] <= TOPK) & (fused_out["n_hits"]
                                                      <= HIT_CAP)
    for st in (True, False):
        _rows_equal(runs[st]["out"], fused_out, both,
                    f"serving path sort_topk={st} against the fused batch")
    say(f"serving path: the sort_topk modes agree on all {int(whole.sum())} "
        f"rows not flagged truncated and on {int(esc_whole.sum())} of "
        f"{esc_whole.size} escalated rows served whole; both equal the "
        f"fused batch on the {int(both.sum())} rows neither flags (ranks "
        f"within 1 ulp)")
    for st in (True, False):
        r = runs[st]
        phase_oracle(dix, queries, r["out"], rng,
                     f"serving path sort_topk={st}")
        phase_oracle(dix, [queries[i] for i in r["esc_rows"]], r["esc_out"],
                     rng, f"escalated pass sort_topk={st}", n=256,
                     topk=r["esc_out"]["topk_eff"],
                     hit_cap=r["esc_out"]["hit_cap_eff"])
    return {n: launches[True][n] + launches[False][n] for n in launches[True]}


def _valid(n, cap: int) -> int:
    return int(n.clamp(0, cap).sum())


def _bytes_moved(name: str, args) -> int:
    """Bytes a kernel core's function must move for these inputs: each
    input lane it needs read once (only the valid lanes of a posting
    block or stream), each output written once."""
    from docodo_tpu_torch.ops.query_kernels import as_variant_blocks
    from docodo_tpu_torch.ops.seqops import INF32

    if name == "fetch_postings":
        # each row's term and two offsets read and its length written,
        # each real posting (and page) read once, each lane written
        coords, offsets, terms, cap, page_of = args
        flat = terms.reshape(-1)
        safe = flat.clamp_min(0).long()
        n = torch.where(flat >= 0, offsets[safe + 1] - offsets[safe], 0)
        per = 4 if page_of is None else 8
        return per * (_valid(n, cap) + flat.numel() * cap) + 16 * flat.numel()
    if name == "merge_and_locate":  # four full-width streams out
        a, _, na, _, b, _, nb, _ = args
        rows, cap = a.shape
        return (8 * (_valid(na, cap) + _valid(nb, cap)) + 16 * rows
                + rows * 2 * cap * 16)
    if name in ("sorted_and_locate_full", "merge_and_locate_topk",
                "sorted_and_locate_full_topk"):
        a, _, na, _, b, _, nb, _, kpad, hpad = args
        rows, cap = a.shape
        return (8 * (_valid(na, cap) + _valid(nb, cap)) + 16 * rows
                + rows * (12 * kpad + 4 * hpad + 8))
    if name in ("single_locate_full", "union_locate_full",
                "single_locate_full_topk"):
        a, _, na, kpad, hpad = args
        rows, cap = a.shape
        return 8 * _valid(na, cap) + 4 * rows + rows * (12 * kpad + 4 * hpad
                                                        + 8)
    if name == "and_locate_topk":
        a, a_pg, na, _, b, _, nb, _, bounds, topk = args
        rows, cap = a.shape
        per = 8 if a_pg is not None else 4
        return (per * (_valid(na, cap) + _valid(nb, cap)) + 16 * rows
                + (0 if a_pg is not None else 4 * bounds.numel())
                + 12 * rows * topk)
    if name == "single_locate_topk":
        a, a_pg, na, bounds, topk = args
        rows, cap = a.shape
        per = 8 if a_pg is not None else 4
        return (per * _valid(na, cap) + 4 * rows
                + (0 if a_pg is not None else 4 * bounds.numel())
                + 12 * rows * topk)
    if name in ("variants_and_locate_full",
                "variants_and_locate_full_topk"):
        a, _, na, _, b, _, nb, _, _, kpad, hpad = args
        rows, cap = a.shape[0], a.shape[2]
        return (8 * (_valid(na, cap) + _valid(nb, cap))
                + 4 * (na.numel() + nb.numel()) + 12 * rows
                + rows * (12 * kpad + 4 * hpad + 8))
    if name in ("union_merge_locate_full", "union_locate_full_topk"):
        a, _, na, kpad, hpad = args
        rows, cap = a.shape[0], a.shape[2]
        return (8 * _valid(na, cap) + 4 * na.numel()
                + rows * (12 * kpad + 4 * hpad + 8))
    if name == "merge_tagged":
        a, a_pg, na, b, _, nb = as_variant_blocks(*args)
        per = 4 if a_pg is None else 8
        width = a.shape[1] * a.shape[2] + b.shape[1] * b.shape[2]
        return (per * (_valid(na, a.shape[2]) + _valid(nb, b.shape[2]))
                + 4 * (na.numel() + nb.numel())
                + a.shape[0] * width * (per + 4))
    if name in ("and_keep", "variants_keep"):
        vals, rows = args[0], args[0].shape[0]
        valid = int((vals < INF32).sum())
        if name == "and_keep" and len(args) == 5:  # a fold step's operand
            per = 8 if args[4] is None else 12     # vals, tag (, pages)
            return per * valid + (per - 4) * vals.numel() + 12 * rows
        return 8 * valid + 4 * vals.numel() + 12 * rows
    # locate_runs: the whole stream (dropped lanes are read to find the
    # kept ones), and the pages of the lanes in its kept range or the
    # bounds once
    hv, pg, bounds, kpad, hpad, (lo, hi) = args
    kept = int(((hv < INF32) & (hv >= lo) & (hv < hi)).sum())
    pages = 4 * kept if pg is not None else 4 * bounds.numel()
    return 4 * hv.numel() + pages + hv.shape[0] * (12 * kpad + 4 * hpad + 8)


def _ops(name: str, args, outs=None) -> int:
    """Integer operations a kernel core does on these inputs:
    OPS_PER_LANE for every lane that holds data, for the merges
    OPS_PER_STEP for each binary-search step that ranks an element in
    another block (the variant slot kernels: in its partner run, once a
    level of their pairwise tree), and for a top-k-mode kernel one
    compare for every pair of the row's runs (its n_pages, from
    `outs`)."""
    from docodo_tpu_torch.benchmarks.common import OPS_PER_LANE, OPS_PER_STEP
    from docodo_tpu_torch.ops.query_kernels import as_variant_blocks
    from docodo_tpu_torch.ops.seqops import INF32

    if name == "fetch_postings":  # a copy: no operation on the data
        return 0
    if name in TOPK_MODE_KERNELS:
        base = {"sorted_and_locate_full_topk": "sorted_and_locate_full",
                "single_locate_full_topk": "single_locate_full",
                "union_locate_full_topk": "union_merge_locate_full",
                "variants_and_locate_full_topk": "variants_and_locate_full"}
        return _ops(base[name], args) + int((outs[3].long() ** 2).sum())
    if name in ("and_keep", "variants_keep", "locate_runs"):
        return OPS_PER_LANE * int((args[0] < INF32).sum())
    if name in ("merge_tagged", "variants_and_locate_full",
                "union_merge_locate_full"):
        if name == "merge_tagged":
            a, _, na, b, _, nb = as_variant_blocks(*args)
            blocks = [(a, na), (b, nb)]
        elif name == "variants_and_locate_full":
            blocks = [(args[0], args[2]), (args[4], args[6])]
        else:
            blocks = [(args[0], args[2])]
        k = sum(x.shape[1] for x, _ in blocks)
        cap = max(x.shape[2] for x, _ in blocks)
        lanes = sum(_valid(n, x.shape[2]) for x, n in blocks)
        if name == "merge_tagged":
            steps = (k - 1) * max(1, int(np.ceil(np.log2(cap + 1))))
        else:
            steps = sum(int(np.ceil(np.log2((cap << j) + 1)))
                        for j in range(int(np.ceil(np.log2(k)))))
        return lanes * (OPS_PER_LANE + OPS_PER_STEP * steps)
    # the W = 2 cores carry (a, a_pg, na, ra, b, b_pg, nb, rb, ...), the
    # W = 1 cores (a, a_pg, na, ...)
    two = name in ("sorted_and_locate_full", "merge_and_locate_topk",
                   "and_locate_topk", "merge_and_locate")
    lengths = (args[2], args[6]) if two else (args[2],)
    cap = args[0].shape[1]
    return OPS_PER_LANE * sum(_valid(n, cap) for n in lengths)


def _library_call(name: str, calls):
    """The one PyTorch call that computes a core's function, where there
    is one: for the merges, a stable sort of the packed key
    coord << 2 | tag over the blocks' concatenation."""
    from docodo_tpu_torch.ops.query_kernels import as_variant_blocks
    from docodo_tpu_torch.ops.seqops import INF32, variant_blocks

    if name != "merge_tagged":
        return None
    keys = []
    for a, _, na, b, _, nb in (as_variant_blocks(*c) for c in calls):
        av, bv = variant_blocks(a, na), variant_blocks(b, nb)
        vals = torch.cat([av, bv], dim=1)
        tag = torch.cat([torch.where(av < INF32, 0, 2),
                         torch.where(bv < INF32, 1, 2)], dim=1)
        keys.append((vals.long() << 2) | tag)
    return lambda: [torch.sort(k, dim=1, stable=True) for k in keys]


def phase_kernel_times(batches, names, most: int = 0,
                       where: str = "the batches") -> dict:
    """The kernels `names` on the calls the kernel-route batches
    (callables that run one batch each) make: the
    calls' inputs are recorded, then each kernel's launches for the
    batches and its plain version's run back to back between CUDA events
    (median of 10), are checked equal, and give the bound and, for
    merge_tagged, the one PyTorch call that computes the same function
    (a stable sort of the packed coord << 2 | tag key). With `most`, at
    most that many of a core's calls, evenly spaced over the batches,
    are timed. `where` names the batches in the printed lines."""
    from docodo_tpu_torch.benchmarks import common as bc
    from docodo_tpu_torch.ops import _cuda
    from docodo_tpu_torch.ops import query_kernels as qk

    calls = {core: [] for name in names
             for core, _ in KERNELS[name][2]}
    saved = {}
    for core in calls:
        saved[core] = getattr(qk, core)

        def rec(*args, _fn=saved[core], _core=core):
            calls[_core].append(args)
            return _fn(*args)
        setattr(qk, core, rec)
    try:
        for batch in batches:
            batch()
    finally:
        for core, fn in saved.items():
            setattr(qk, core, fn)
    torch.cuda.synchronize()
    made = {core: len(cs) for core, cs in calls.items()}
    if most:
        calls = {core: cs[:: -(-len(cs) // most) or 1]
                 for core, cs in calls.items()}

    res = {}
    for name in names:
        cores = KERNELS[name][2]
        runs = [(getattr(qk, core), getattr(qk, plain), calls[core])
                for core, plain in cores]
        err = 0.0
        ops = 0
        for kern, plain, cs in runs:
            for args in cs:
                got = kern(*args)
                err = max(err, same_result(name, got, plain(*args),
                                           f"{name} on the main path"))
                ops += _ops(name, args, got)
        ms = cuda_ms(lambda: [kern(*a) for kern, _, cs in runs for a in cs])
        plain_ms = cuda_ms(lambda: [plain(*a) for _, plain, cs in runs
                                    for a in cs])
        lib = _library_call(name, calls[cores[0][0]])
        library_ms = None if lib is None else cuda_ms(lib)
        nbytes = sum(_bytes_moved(name, a) for _, _, cs in runs for a in cs)
        n_calls = sum(len(cs) for _, _, cs in runs)
        res[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         **bc.bound(nbytes, ops), library_ms=library_ms)
        if lib is not None:  # both sides on the profiler's device clock
            kdev = profiled_ms(lambda: [kern(*a) for kern, _, cs in runs
                                        for a in cs])
            say(f"device time: {name} {kdev:.4f} ms, library "
                f"{profiled_ms(lib):.4f} ms, on the same {n_calls} calls "
                "(torch.profiler)")
        # a fetch's shape is its terms' and cap, not the whole CSR's
        shapes = sorted({tuple(a[2].shape) + (a[3],)
                         if name == "fetch_postings" else tuple(a[0].shape)
                         for _, _, cs in runs for a in cs})
        n_made = sum(made[core] for core, _ in cores)
        say(f"kernel time: {name}: {n_calls} "
            f"{'' if n_calls == n_made else f'of the {n_made} '}calls of "
            f"{where} (shapes {shapes[:3]}{'...' if len(shapes) > 3 else ''}), "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{res[name]['bound_ms']:.4f} ms ({nbytes} bytes, {ops} ops), "
            f"library "
            f"{'none' if library_ms is None else f'{library_ms:.4f} ms'}; "
            f"equal to the plain version")
        if name in TILED:
            rows, n = max((tuple(a[0].shape) for _, _, cs in runs
                           for a in cs), key=lambda shape: shape[::-1])
            tiles = -(-n // _cuda.tile_lanes())
            say(f"blocks per launch: {name}, widest call n {n} B {rows}: "
                f"{tiles} tiles a row x {rows} rows = {tiles * rows} blocks"
                + ("" if name == "locate_runs" else
                   ", in each of its two launches"))
        if name in FORMS:
            # the same launches in the kernel's other input form
            label, form = FORMS[name]
            (kern, plain, cs), = runs
            other = [form(a) for a in cs]
            for a in other:
                same_result(name, kern(*a), plain(*a), f"{name} {label}")
            fms = cuda_ms(lambda: [kern(*a) for a in other])
            fplain = cuda_ms(lambda: [plain(*a) for a in other])
            fbytes = sum(_bytes_moved(name, a) for a in other)
            say(f"kernel time: {name} {label}: {len(other)} calls, kernel "
                f"{fms:.4f} ms, plain {fplain:.4f} ms, bound "
                f"{bc.bound(fbytes)['bound_ms']:.4f} ms ({fbytes} bytes); "
                f"equal to the plain version")
        for label, keep in SPLITS.get(name, ()):
            part = [(kern, plain, [a for a in cs if keep(a)])
                    for kern, plain, cs in runs]
            n_part = sum(len(cs) for _, _, cs in part)
            if not n_part:
                continue
            pms = cuda_ms(lambda: [k(*a) for k, _, cs in part for a in cs])
            pplain = cuda_ms(lambda: [p(*a) for _, p, cs in part
                                      for a in cs])
            pbytes = sum(_bytes_moved(name, a) for _, _, cs in part
                         for a in cs)
            say(f"kernel time: {name} {label}: {n_part} calls, "
                f"kernel {pms:.4f} ms, plain {pplain:.4f} ms, bound "
                f"{bc.bound(pbytes)['bound_ms']:.4f} ms ({pbytes} bytes)")
    return res


def _n_blocks(args) -> int:
    from docodo_tpu_torch.ops.query_kernels import as_variant_blocks

    a, _, _, b, _, _ = as_variant_blocks(*args)
    return a.shape[1] + b.shape[1]


# and_locate_topk without its page streams is the counterpart of
# _and_locate_kernel (pallas_query.py:133, PERF.md's row 17): the batch's
# calls (a, a_pg, na, ra, b, b_pg, nb, rb, bounds, topk) with the pages
# looked up in bounds
FORMS = {"and_locate_topk": (
    "from bounds (pallas_query.py:133)",
    lambda a: (a[0], None, a[2], a[3], a[4], None) + tuple(a[6:]))}


def _stream_width(args) -> int:
    """n of a variant slot core's call: (va + vb) cap, or V cap."""
    a = args[0]
    return (a.shape[1] + (args[4].shape[1] if len(args) > 5 else 0)) \
        * a.shape[2]


VARIANT_WIDTHS = tuple(
    (f"N = {w}", lambda a, w=w: w // 2 < _stream_width(a) <= w)
    for w in (128, 256, 512, 1024))

W1_CAPS = tuple((f"cap {cap}", lambda a, cap=cap: a[0].shape[1] == cap)
                for cap in (64, 128, 256, 512, 1024))

# the TPU kernels a port covers in parts: its calls split by width or V
# (PERF.md's rows 8 / 9, 11 / 12 and 3 / 5); the fetch's calls by cap,
# up to and past the small tables' widest band
SPLITS = {
    "fetch_postings": (
        ("cap <= 4096", lambda a: a[3] <= 4096),
        ("4096 < cap <= 32768", lambda a: 4096 < a[3] <= 32768),
        ("cap > 32768", lambda a: a[3] > 32768)),
    "and_keep": (("n = 2048", lambda a: a[0].shape[1] == 2048),
                 ("n = 4096", lambda a: a[0].shape[1] == 4096),
                 ("n <= 4096", lambda a: a[0].shape[1] <= 4096),
                 ("n > 4096", lambda a: a[0].shape[1] > 4096)),
    # a document shard's calls keep a range of values (parallel/serving
    # FullShard); one index's keep every value
    "locate_runs": (("every value kept", lambda a: a[5] == KEEP_ALL),
                    ("a kept range", lambda a: a[5] != KEEP_ALL)),
    "variants_keep": (("n <= 4096", lambda a: a[0].shape[1] <= 4096),
                      ("n > 4096", lambda a: a[0].shape[1] > 4096)),
    "union_merge_locate_full": (("V = 2", lambda a: a[0].shape[1] == 2),
                                ("V > 2", lambda a: a[0].shape[1] > 2))
    + VARIANT_WIDTHS,
    # the variant slot kernels' four stream widths
    "variants_and_locate_full": VARIANT_WIDTHS,
    "variants_and_locate_full_topk": VARIANT_WIDTHS,
    "union_locate_full_topk": (("V = 1", lambda a: a[0].shape[1] == 1),
                               ("V > 1", lambda a: a[0].shape[1] > 1))
    + VARIANT_WIDTHS,
    # one pass, or a tree of passes
    "merge_tagged": (("2 blocks", lambda a: _n_blocks(a) <= 2),
                     ("more than 2 blocks", lambda a: _n_blocks(a) > 2)),
    # the W = 1 kernel's caps (rows 2 and 15d: 64, 128; row 3: 256-1024)
    "single_locate_full": W1_CAPS,
    "single_locate_full_topk": W1_CAPS,
    "union_locate_full": W1_CAPS,
    # the W = 2 slot kernel's four stream widths, the page-level one's
    # likewise, the fused kernel's two
    "sorted_and_locate_full": tuple(
        (f"cap {cap}", lambda a, cap=cap: a[0].shape[1] == cap)
        for cap in (64, 128, 256, 512)),
    "and_locate_topk": tuple(
        (f"cap {cap}", lambda a, cap=cap: a[0].shape[1] == cap)
        for cap in (64, 128, 256, 512)),
    "merge_and_locate_topk": (
        ("n <= 2048", lambda a: a[0].shape[1] <= 1024),
        ("n > 2048", lambda a: a[0].shape[1] > 1024)),
}


def _oracle_row(dix, coords, query):
    """One query on the host: each word's variants OR-merged and the
    words' proximity-AND fold over the host postings (fold_row), the
    page bounds and the rank formula (as benchmarks/common.py:306-338).
    Returns (kept coordinates, run pages, run counts, run ranks f64),
    the runs in page order."""
    from docodo_tpu_torch.oracle import fold_row

    off = dix.offsets_np
    bounds = dix.bounds_np
    words, rs = [], []
    for codes, r in query:
        keys = (codes,) if isinstance(codes, str) else codes
        ids = [dix.term_id(c) for c in keys]
        words.append([coords[off[t]: off[t + 1]] for t in ids if t >= 0])
        rs.append(r)
    acc = np.zeros(0, np.int64)
    if words and all(words):  # a word with no known variant serves nothing
        acc = np.asarray(fold_row(words, rs), dtype=np.int64)
    page = np.minimum(np.searchsorted(bounds, acc, side="right"),
                      bounds.size - 1)
    first = np.concatenate([[True], page[1:] != page[:-1]])[:acc.size]
    run = np.cumsum(first) - 1
    gaps = np.diff(acc, prepend=0)
    bonus = np.where(~first, 30 // np.maximum(5, gaps), 0)
    cnt = np.bincount(run, minlength=run.max(initial=-1) + 1)
    rank = (1.0 + np.bincount(run, weights=bonus, minlength=cnt.size)
            + np.log(np.maximum(cnt, 1)))
    return acc, page[first], cnt, rank


def phase_oracle(dix, queries, out, rng, label: str, n: int = 512,
                 topk: int = TOPK, hit_cap: int = HIT_CAP) -> None:
    """Served full-result rows against numpy (_oracle_row); `out` was
    served with `topk` and `hit_cap`, one budget for all rows or an
    array of per-row budgets."""
    coords = dix.coords.cpu().numpy()
    checked = mismatches = 0
    topk = np.broadcast_to(topk, len(queries))
    hit_cap = np.broadcast_to(hit_cap, len(queries))
    for qi in rng.choice(len(queries), size=min(n, len(queries)),
                         replace=False):
        npg, nht = int(out["n_pages"][qi]), int(out["n_hits"][qi])
        if npg > topk[qi] or nht > hit_cap[qi]:
            continue  # truncated: re-served on the host by the caller
        acc, pages, cnt, rank = _oracle_row(dix, coords, queries[qi])
        want = sorted(zip(pages.tolist(), cnt.tolist()))
        got_pages = out["pages"][qi][: npg]
        got = sorted(zip(got_pages.tolist(),
                         out["counts"][qi][: npg].tolist()))
        got_rank = dict(zip(got_pages.tolist(),
                            out["ranks"][qi][: npg].tolist()))
        ok = (npg == pages.size and nht == acc.size
              and np.array_equal(out["hits"][qi][:nht], acc)
              and got == want
              and all(abs(got_rank[p] - rk) <= 1e-5 * rk
                      for p, rk in zip(pages.tolist(), rank)))
        checked += 1
        mismatches += not ok
    say(f"oracle, {label}: {checked} served rows of {n} sampled checked "
        f"against the numpy variant-OR and AND fold + rank formula; "
        f"mismatches {mismatches}")
    require(checked > 0 and mismatches == 0, f"{label} oracle mismatches")


def phase_page_oracle(dix, queries, out, rng, n: int = 512) -> None:
    """Sampled page-level rows against numpy: _oracle_row's runs, the
    top PAGE_TOPK by (rank descending, page ascending); pages and counts
    exact, ranks within 1e-5 relative."""
    coords = dix.coords.cpu().numpy()
    pages_out, ranks_out, counts_out = out
    mismatches = served = cut = 0
    sample = rng.choice(len(queries), size=min(n, len(queries)),
                        replace=False)
    for qi in sample:
        _, pages, cnt, rank = _oracle_row(dix, coords, queries[qi])
        # ties are decided on the stored f32 rank, as the kernel does
        order = np.lexsort((pages, -rank.astype(np.float32)))[:PAGE_TOPK]
        k = order.size
        ok = (np.array_equal(pages_out[qi][:k], pages[order])
              and np.array_equal(counts_out[qi][:k], cnt[order])
              and np.allclose(ranks_out[qi][:k], rank[order], rtol=1e-5,
                              atol=0)
              and (pages_out[qi][k:] == -1).all()
              and (ranks_out[qi][k:] == 0).all()
              and (counts_out[qi][k:] == 0).all())
        mismatches += not ok
        served += k > 0
        cut += pages.size > PAGE_TOPK
    say(f"oracle, page level: {len(sample)} sampled rows ({served} serving "
        f"pages, {cut} with more than {PAGE_TOPK} runs) against the numpy "
        f"AND fold, rank formula and top {PAGE_TOPK} by (rank, page); "
        f"mismatches {mismatches}")
    require(served > 0 and cut > 0 and mismatches == 0,
            "page-level oracle mismatches")


def phase_vocabulary(seed: int, rng):
    """A Russian corpus of the forms Dict/ru.voc knows, indexed with the
    vocabulary and stop words; words become (variant keys, R) groups by
    word_group (vocabulary group keys, an exact upper-case form, a
    wildcard OR), are served by search_batch_full on the card and held
    against the numpy oracle. Returns (index, queries of groups)."""
    from docodo_tpu_torch.index import word_group
    from docodo_tpu_torch.lang.vocab import Vocab
    from docodo_tpu_torch.ops.device_index import DeviceIndex
    from docodo_tpu_torch.synthetic import (
        build_index,
        vocabulary_documents,
        vocabulary_forms,
    )

    voc = Vocab(RU_VOC)
    stop = {"это", "как", "которые"}
    docs = vocabulary_documents(voc, n_docs=40, pages=8, words=400,
                                seed=seed, extra=("зюзюка", "бармаглот",
                                                  "1812", *sorted(stop)))
    ind = build_index(docs, vocs=[voc], stop_words=stop)
    dix = DeviceIndex.from_index(ind)
    forms = vocabulary_forms(voc)
    words = [forms[i] for i in rng.choice(len(forms), size=48,
                                          replace=False)]
    groups = [word_group(ind, w) for w in words]
    queries = [[g] for g in groups]
    queries += [[a, b] for a, b in zip(groups[::2], groups[1::2])]
    queries += [[word_group(ind, w.upper())] for w in words[:8]]
    queries += [[word_group(ind, w[:3] + "_")] for w in words[:8]]
    keys = [k for q in queries for g in q for k in g[0]]
    require(all(g is not None for q in queries for g in q)
            and word_group(ind, "это") is None
            and sum(k[0] == "#" for k in keys) >= 48
            and any(len(g[0]) > 1 for q in queries for g in q),
            "vocabulary groups: a known form without its group key")
    # budgets past the corpus's 360 pages: group keys gather every form
    # of a stem, so most words hit more than 64 pages
    topk, hit_cap = 512, 8192
    out = dix.search_batch_full(queries, topk=topk, hit_cap=hit_cap)
    say(f"vocabulary: {RU_VOC.name} ({len(voc)} stems, {len(forms)} known "
        f"forms), {len(docs)} docs, {dix.bounds.numel()} pages, "
        f"{len(dix.terms)} terms ({sum(t[0] == '#' for t in dix.terms)} "
        f"group keys), {len(stop)} stop words unindexed; {len(queries)} "
        f"queries of word_group groups, {int((out['n_hits'] > 0).sum())} "
        f"with hits")
    phase_oracle(dix, queries, out, rng, "vocabulary groups",
                 n=len(queries), topk=topk, hit_cap=hit_cap)
    return ind, queries


def _serve(ex, reqs, clients: int, restage=None):
    """`reqs` through ex.search from `clients` threads. With `restage`
    (a callable), a thread runs it once a quarter of the requests are
    answered, while the clients go on. Returns (results, latencies s,
    seconds, the restage's (start, end) on the same clock)."""
    import concurrent.futures as cf
    import threading

    out = [None] * len(reqs)
    lat = np.zeros(len(reqs))
    answered = [0]
    lock = threading.Lock()
    quarter = threading.Event()
    span = []

    def one(i):
        t0 = time.perf_counter()
        out[i] = ex.search(reqs[i])
        lat[i] = time.perf_counter() - t0
        with lock:
            answered[0] += 1
            if answered[0] >= len(reqs) // 4:
                quarter.set()

    def run_restage():
        quarter.wait()
        t0 = time.perf_counter()
        restage()
        span.extend((t0, time.perf_counter()))

    side = threading.Thread(target=run_restage) if restage else None
    t0 = time.perf_counter()
    if side:
        side.start()
    with cf.ThreadPoolExecutor(clients) as pool:
        for f in [pool.submit(one, i) for i in range(len(reqs))]:
            f.result()
    secs = time.perf_counter() - t0
    if side:
        side.join()
    return out, lat, secs, [t - t0 for t in span]


def phase_batcher(index, dix, card: str, required=BATCHER_KERNELS):
    """The serving path as a user reaches it: request strings (the
    serve_qps.py recipe, and wide ones: alternations, wildcards, long
    phrases, field requests, `~` and `-filter:`) through
    BatchExecutor.search from BATCHER_CLIENTS threads in four
    configurations (pipeline on / off, materialize on / off), the first
    with a create() on the same documents mid-stream; every request
    served is held against the host engine (Index.search), whole where
    materialized, and in brief mode with doc ranks within 1 ulp and
    orders equal; the stats add up and host fallbacks have only the
    reference's reasons; then BATCHER_HTTP requests through DocodoServer
    on the loopback. Launch counts are zeroed just before the first
    configuration and read after the last; every kernel in `required`
    (and at least one) must launch, and no bucket takes the plain route
    but W >= 3 with variants. Returns the launches, the request stream
    and the host engine's results by request."""
    import concurrent.futures as cf
    import random
    import urllib.parse
    import urllib.request

    from docodo_tpu_torch.mix import serve_requests, wide_requests
    from docodo_tpu_torch.ops import _cuda
    from docodo_tpu_torch.ops import device_index as tdi
    from docodo_tpu_torch.query.batcher import BatchExecutor
    from docodo_tpu_torch.query.search import brief_ulps, result_fields
    from docodo_tpu_torch.server import DocodoServer, result_to_json

    t_phase = time.perf_counter()
    std = serve_requests(index, SERVE_REQUESTS)
    wide = wide_requests(index, WIDE_REQUESTS)
    stream = std[: BATCHER_SERVED[0]] + wide[: BATCHER_SERVED[1]]
    random.Random(5).shuffle(stream)
    t_reqs = time.perf_counter() - t_phase
    hosts: dict = {}

    def host(req):
        """The host engine's result; the same documents before and after
        the restage, so one result serves both."""
        if req not in hosts:
            hosts[req] = index.search(req)
        return hosts[req]

    plain = []
    inner = tdi.query_step_full

    def plain_bucket(*a, **k):
        plain.append((int(a[5].shape[1]), tdi._variants(a[5])))
        return inner(*a, **k)

    checking = [0.0]

    def check(reqs, got, brief: bool, what: str) -> int:
        """Every result against the host engine; returns the largest doc
        rank ulp (brief mode)."""
        t0 = time.perf_counter()
        worst = 0
        for req, res in zip(reqs, got):
            want = host(req)
            if result_fields(res) == result_fields(want):
                continue  # materialized, or a host fallback
            ulp = brief_ulps(res, want) if brief else None
            require(ulp is not None,
                    f"{what}: {req!r} differs from Index.search")
            worst = max(worst, ulp)
        checking[0] += time.perf_counter() - t0
        return worst

    tdi.query_step_full = plain_bucket
    for k in _cuda.KERNELS.values():
        k.launches = 0
    rows = []
    try:
        for n, (pipeline, materialize) in enumerate(BATCHER_CONFIGS):
            reqs = stream if n == 0 else stream[:BATCHER_LATER]
            ex = BatchExecutor(index, device_index=dix, pipeline=pipeline,
                               materialize=materialize)
            gen = index.generation
            try:
                got, lat, secs, span = _serve(
                    ex, reqs, BATCHER_CLIENTS,
                    restage=index.create if n == 0 else None)
                if n == 0:  # served after the restage, equal too
                    tail, _, _, _ = _serve(ex, stream[:BATCHER_TAIL],
                                           BATCHER_CLIENTS)
                    require(index.generation == gen + 1
                            and ex._gen == index.generation
                            and ex.di is not dix, "the restage was not "
                            "staged by the executor")
                    worst = check(stream[:BATCHER_TAIL], tail,
                                  not materialize, "after the restage")
                st = dict(ex.stats)
            finally:
                ex.close()
            worst = max(check(reqs, got, not materialize,
                              f"pipeline={pipeline} "
                              f"materialize={materialize}"),
                        worst if n == 0 else 0)
            served = len(reqs) + (BATCHER_TAIL if n == 0 else 0)
            require(st["device_timeouts"] == 0,
                    f"{st['device_timeouts']} requests timed out: {st}")
            require(st["device_queries"] + st["host_queries"]
                    + st["truncated_fallbacks"] == served,
                    f"stats do not add up to the {served} requests: {st}")
            require(st["host_queries"] == st["fallback_unsupported"]
                    + st["fallback_shape"] + st["fallback_no_index"]
                    and st["fallback_no_index"] == 0,
                    f"host fallbacks of another reason: {st}")
            n_tilde = sum("~" in r for r in reqs) + (
                sum("~" in r for r in stream[:BATCHER_TAIL]) if n == 0
                else 0)
            require(st["fallback_unsupported"] == n_tilde,
                    f"{st['fallback_unsupported']} unsupported fallbacks "
                    f"for {n_tilde} `~` requests")
            require(worst <= 1, f"brief doc ranks {worst} ulp apart")
            p50, p95, p99 = np.percentile(lat, [50, 95, 99]) * 1e3
            dispatched = (served - st["host_queries"] + st["escalations"])
            reasons = {k: f"{st[k]} ({st[k] / served:.1%})" for k in (
                "fallback_unsupported", "fallback_shape",
                "fallback_no_index", "truncated_fallbacks")}
            say(f"batcher, pipeline={pipeline} materialize={materialize}: "
                f"{len(reqs)} requests from {BATCHER_CLIENTS} clients in "
                f"{secs:.2f} s, {len(reqs) / secs:.1f} requests/s, "
                f"latency p50 {p50:.1f} / p95 {p95:.1f} / p99 {p99:.1f} ms, "
                f"on {card}; device_s {st['device_s']:.2f}, material_s "
                f"{st['material_s']:.2f}, {st['batches']} batches, "
                f"{dispatched / max(st['batches'], 1):.1f} requests a "
                f"batch; device {st['device_queries']}, escalated "
                f"{st['escalations']}, host {st['host_queries']}; "
                f"fallbacks {reasons}; every request equal to "
                f"Index.search" + (f" (doc ranks within {worst} ulp)"
                                   if not materialize else "")
                + (f"; restage (create() on the same documents) from "
                   f"{span[0]:.2f} to {span[1]:.2f} s, then "
                   f"{BATCHER_TAIL} more requests equal" if n == 0
                   else ""))
            rows.append(len(reqs) / secs)
        launches = {name: k.launches for name, k in _cuda.KERNELS.items()}
    finally:
        tdi.query_step_full = inner
    say(f"batcher: launches over the four configurations "
        f"{({n: c for n, c in launches.items() if c})}; buckets on the "
        f"plain route by (W, V): {sorted(set(plain))} ({len(plain)})")
    require(any(launches.values()), "the batcher launched no kernel")
    for name in required:
        require(launches[name] > 0,
                f"kernel {name} was not launched by the batcher")
    require(all(w >= 3 and v > 1 for w, v in plain),
            f"buckets {sorted(set(plain))} took query_step_full")

    # one pass under the profiler: the device's busy share
    from torch.autograd import DeviceType

    ex = BatchExecutor(index, device_index=dix)
    try:
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            _, _, secs, _ = _serve(ex, stream[:BATCHER_PROFILED],
                                   BATCHER_CLIENTS)
            torch.cuda.synchronize()
    finally:
        ex.close()
    events = prof.key_averages()
    dev_ms = sum(float(getattr(e, "self_device_time_total", 0)
                       or getattr(e, "self_cuda_time_total", 0))
                 for e in events if e.device_type != DeviceType.CPU) / 1e3
    # the waves' pinned readback buffers: PyTorch's host cache, or new
    # pinned allocations
    pinned = [(e.count, e.cpu_time_total / 1e3) for e in events
              if e.key == "cudaHostAlloc"]
    say(f"batcher profile: {BATCHER_PROFILED} requests (pipeline, "
        f"materialize) in {secs * 1e3:.1f} ms under torch.profiler, device "
        f"{dev_ms:.2f} ms: busy {dev_ms / (secs * 1e3):.4f}; cudaHostAlloc "
        f"{pinned[0][0] if pinned else 0} calls, "
        f"{pinned[0][1] if pinned else 0.0:.2f} ms")

    # over HTTP
    srv = DocodoServer(index, port=0, host="127.0.0.1")  # on the card
    srv.start(background=True)
    base = f"http://127.0.0.1:{srv.port}"

    def get(path):
        with urllib.request.urlopen(base + path, timeout=600) as r:
            return json.loads(r.read().decode("utf-8"))

    try:
        reqs = stream[:BATCHER_HTTP]
        t0 = time.perf_counter()
        with cf.ThreadPoolExecutor(BATCHER_CLIENTS) as pool:
            bodies = list(pool.map(
                lambda r: get("/search?req=" + urllib.parse.quote(r)), reqs))
        secs = time.perf_counter() - t0
        for req, body in zip(reqs, bodies):
            want = json.loads(json.dumps(result_to_json(host(req)),
                                         ensure_ascii=False))
            require(body == want, f"HTTP /search {req!r} differs from "
                    "result_to_json(Index.search)")
        prefixes = sorted({r.strip('"')[:3] for r in reqs[:16]})
        for pre in prefixes:
            require(get("/suggest?req=" + urllib.parse.quote(pre))
                    == index.get_suggestions(pre), f"/suggest {pre!r}")
        status = get("/status")
        require(status["canSearch"] and status["batcher"]["device_queries"]
                > 0 and status["batcher"]["device_timeouts"] == 0,
                f"/status without the batcher's stats, or with timeouts: "
                f"{status}")
    finally:
        srv.stop()
    say(f"batcher over HTTP: {len(reqs)} /search requests from "
        f"{BATCHER_CLIENTS} clients in {secs:.2f} s "
        f"({len(reqs) / secs:.1f}/s), every body equal to "
        f"result_to_json(Index.search); /suggest equal on {len(prefixes)} "
        f"prefixes; /status batcher {status['batcher']}; the phase "
        f"{time.perf_counter() - t_phase:.1f} s, of which the requests' "
        f"making {t_reqs:.1f} s and their checks against Index.search "
        f"{checking[0]:.1f} s")
    return launches, stream, hosts


def _launches() -> dict:
    from docodo_tpu_torch.ops import _cuda

    return {name: k.launches for name, k in _cuda.KERNELS.items()}


def _zero_launches() -> None:
    from docodo_tpu_torch.ops import _cuda

    for k in _cuda.KERNELS.values():
        k.launches = 0


def phase_mesh_batcher(index, stream, hosts, card: str, required):
    """The sharded path as a user reaches it: BatchExecutor(index,
    mesh=make_mesh(MESH_SHARDS)) serves the batcher stream's first
    requests from BATCHER_CLIENTS threads, every request held whole
    against Index.search (`hosts`: the batcher phase's results); the
    stats add up; then DocodoServer(index, mesh=...) answers MESH_HTTP
    requests over the loopback. Launch counts are zeroed just before and
    read just after; every kernel in `required` must launch and no
    bucket take the plain route but W >= 3 with variants. Returns the
    launches."""
    import concurrent.futures as cf
    import urllib.parse
    import urllib.request

    from docodo_tpu_torch.ops import device_index as tdi
    from docodo_tpu_torch.parallel.sharding import make_mesh
    from docodo_tpu_torch.query.batcher import BatchExecutor
    from docodo_tpu_torch.query.search import result_fields
    from docodo_tpu_torch.server import DocodoServer, result_to_json

    def host(req):
        if req not in hosts:
            hosts[req] = index.search(req)
        return hosts[req]

    t0 = time.perf_counter()
    ex = BatchExecutor(index, mesh=make_mesh(MESH_SHARDS))
    t_stage = time.perf_counter() - t0
    plain = []
    inner = tdi.query_step_full

    def plain_bucket(*a, **k):
        plain.append((int(a[5].shape[1]), tdi._variants(a[5])))
        return inner(*a, **k)

    tdi.query_step_full = plain_bucket
    _zero_launches()
    try:
        got, lat, secs, _ = _serve(ex, stream, BATCHER_CLIENTS)
        st = dict(ex.stats)
        ex.close()
        srv = DocodoServer(index, port=0, host="127.0.0.1",
                           mesh=make_mesh(MESH_SHARDS))
        srv.start(background=True)
        try:
            base = f"http://127.0.0.1:{srv.port}/search?req="

            def get(req):
                with urllib.request.urlopen(
                        base + urllib.parse.quote(req), timeout=600) as r:
                    return json.loads(r.read().decode("utf-8"))

            with cf.ThreadPoolExecutor(MESH_HTTP) as pool:
                bodies = list(pool.map(get, stream[:MESH_HTTP]))
        finally:
            srv.stop()
    finally:
        tdi.query_step_full = inner
    launches = _launches()
    for req, res in zip(stream, got):
        require(result_fields(res) == result_fields(host(req)),
                f"mesh batcher: {req!r} differs from Index.search")
    for req, body in zip(stream, bodies):
        require(body == json.loads(json.dumps(result_to_json(host(req)),
                                              ensure_ascii=False)),
                f"mesh server: /search {req!r} differs from Index.search")
    require(st["device_timeouts"] == 0 and st["device_queries"] > 0
            and st["device_queries"] + st["host_queries"]
            + st["truncated_fallbacks"] == len(stream),
            f"mesh batcher stats: {st}")
    p50, p99 = np.percentile(lat, [50, 99]) * 1e3
    say(f"mesh batcher: BatchExecutor(mesh=make_mesh({MESH_SHARDS})) "
        f"staged in {t_stage:.2f} s, {len(stream)} requests from "
        f"{BATCHER_CLIENTS} clients in {secs:.2f} s "
        f"({len(stream) / secs:.1f} requests/s, p50 {p50:.1f} / p99 "
        f"{p99:.1f} ms) on {card}; device_queries {st['device_queries']}, "
        f"boundary_reserves {st['boundary_reserves']}, truncated_fallbacks "
        f"{st['truncated_fallbacks']}, host_queries {st['host_queries']}, "
        f"device_timeouts {st['device_timeouts']}, {st['batches']} batches; "
        f"every request equal to Index.search; DocodoServer(mesh=) "
        f"{MESH_HTTP} bodies equal to result_to_json(Index.search); "
        f"launches {({n: c for n, c in launches.items() if c})}; plain "
        f"buckets by (W, V) {sorted(set(plain))}")
    require(any(launches.values()), "the mesh batcher launched no kernel")
    for name in required:
        require(launches[name] > 0,
                f"kernel {name} was not launched by the mesh batcher")
    require(all(w >= 3 and v > 1 for w, v in plain),
            f"mesh batcher buckets {sorted(set(plain))} took the plain route")
    return launches


def _global_hits(res, page_index, page_base) -> np.ndarray:
    """A sharded result's hits in global coordinates: each found doc's
    pages (doc name, page id) -> global page row, + position."""
    parts = [page_base[page_index[(d.name, p.id)]] + np.asarray(p.pos,
                                                               np.int64)
             for d in res.found_docs for p in d.pages]
    return np.concatenate(parts) if parts else np.zeros(0, np.int64)


def phase_mesh(mb: float, seed: int, card: str, rng):
    """The sharded cell: a seeded Zipf corpus of `mb` MB indexed by
    Index.create() on the card, staged as
    ShardedDeviceIndex.from_index(index, make_mesh(MESH_SHARDS)) and as
    one card's DeviceIndex; the standard and the wide mix (drawn on this
    index as the main paths draw them) through
    search_batch(materialize="defer") with launch counts zeroed just
    before and read just after, and through the one-card kernel route
    (search_batch_full). Every row that neither truncates nor reserves
    (nor truncates on one card): its hits moved back to global
    coordinates equal the one-card row's hits, and its whole result the
    one-card hits located on the index's page table. MESH_SAMPLED served
    rows a mix, materialized, equal the exact host evaluation of the
    same row (_host_reserve's fold, materialized the same way). Every
    kernel of the mix's main path must launch on the mesh path, no
    bucket take the plain route. Returns the launches."""
    from docodo_tpu_torch.index import Index, ListDataSource
    from docodo_tpu_torch.ops import device_index as tdi
    from docodo_tpu_torch.ops.device_index import DeviceIndex
    from docodo_tpu_torch.parallel.serving import ShardedDeviceIndex
    from docodo_tpu_torch.parallel.sharding import make_mesh
    from docodo_tpu_torch.query.search import (prepare_search_result,
                                               result_fields)
    from docodo_tpu_torch.synthetic import zipf_documents
    from docodo_tpu_torch.utils import profiling

    t0 = time.perf_counter()
    docs = zipf_documents(int(mb * 1e6), seed=seed)
    t1 = time.perf_counter()
    ind = Index()
    ind.add_data_source(ListDataSource("synth", docs))
    ind.create()
    t2 = time.perf_counter()
    dix = DeviceIndex.from_index(ind)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    profiling.reset()
    mesh = make_mesh(MESH_SHARDS)
    sdi = ShardedDeviceIndex.from_index(ind, mesh)  # search_batch_full's
    for dev in set(mesh):
        torch.cuda.synchronize(dev)
    t4 = time.perf_counter()
    sdi.stage("served")  # search_batch's shards
    for dev in set(mesh):
        torch.cuda.synchronize(dev)
    t5 = time.perf_counter()
    split = {name: secs for name, secs, _ in profiling.report()}
    say(f"mesh index: {mb:g} MB seed {seed}: {len(docs)} docs, "
        f"{dix.bounds.numel()} pages, {dix.coords.numel()} postings; corpus "
        f"{t1 - t0:.1f} s, Index.create() {t2 - t1:.2f} s, one card's "
        f"DeviceIndex {t3 - t2:.2f} s ({dix.device_bytes() / 1e6:.1f} MB); "
        f"ShardedDeviceIndex over {[str(d) for d in mesh]}: from_index "
        f"{t4 - t3:.2f} s (documents to shards {split['mesh.assign']:.2f} "
        f"s, the full-result shards and halos {split['mesh.halo']:.2f} s), "
        f"stage(\"served\") {t5 - t4:.2f} s (host re-shard "
        f"{split['mesh.reshard']:.2f} s, copies and sorts "
        f"{split['mesh.build']:.2f} s, page_of and small tables "
        f"{split['mesh.tables']:.2f} s); MB a shard "
        f"{[round(b / 1e6, 1) for b in sdi.device_bytes()]}, docs a shard "
        f"{[len(a) for a in sdi.assign]}, "
        f"{sdi.boundaries.size} boundaries")
    pt = ind.pages
    page_index = {(pt.doc_names[d], pid): p for p, (d, pid) in
                  enumerate(zip(pt.page_doc.tolist(), pt.page_ids))}
    page_base = np.concatenate([[0], pt.bounds[:-1]]).astype(np.int64)
    routes = {"slot": "_kernel_bucket_full",
              "chunked": "_chunked_bucket_full", "plain": "query_step_full"}
    saved = {name: getattr(tdi, fn) for name, fn in routes.items()}
    total = dict.fromkeys(_launches(), 0)
    standard = _queries(dix, N_QUERIES)
    for label, queries, required in (
            ("standard mix", standard, STANDARD_KERNELS),
            ("wide mix + alternations",
             _wide_queries(dix, N_QUERIES, N_ALTERNATIONS), WIDE_KERNELS)):
        sdi.search_batch(queries[:512], topk=TOPK, hit_cap=HIT_CAP,
                         materialize="defer")  # warm
        dix.search_batch_full(queries[:512], topk=TOPK, hit_cap=HIT_CAP)
        torch.cuda.synchronize()
        served = dict.fromkeys(routes, 0)

        def counted(name):
            def call(*a, **k):
                out = saved[name](*a, **k)
                served[name] += out is not None
                return out
            return call

        for name, fn in routes.items():
            setattr(tdi, fn, counted(name))
        _zero_launches()
        profiling.reset()
        try:
            t0 = time.perf_counter()
            res = sdi.search_batch(queries, topk=TOPK, hit_cap=HIT_CAP,
                                   materialize="defer")
            mesh_s = time.perf_counter() - t0
        finally:
            for name, fn in routes.items():
                setattr(tdi, fn, saved[name])
        launches = _launches()
        spans = "; ".join(f"{name[5:]} {secs * 1e3:.1f}" for name, secs, _
                          in profiling.report())
        t0 = time.perf_counter()
        out = dix.search_batch_full(queries, topk=TOPK, hit_cap=HIT_CAP,
                                    use_kernels=True)
        one_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        count = dict(truncated=0, reserved=0, one_card_truncated=0,
                     compared=0)
        for qi, r in enumerate(res):
            if r is None:
                count["truncated"] += 1
                continue
            if r.boundary_reserved:
                count["reserved"] += 1
                continue
            nh = int(out["n_hits"][qi])
            if out["n_pages"][qi] > TOPK or nh > HIT_CAP:
                count["one_card_truncated"] += 1
                continue
            hits = out["hits"][qi][:nh].astype(np.int64)
            require(np.array_equal(_global_hits(r, page_index, page_base),
                                   hits),
                    f"mesh, {label}: row {qi}'s hits differ from one card's")
            require(result_fields(r) == result_fields(prepare_search_result(
                hits.astype(np.uint64), pt, [])),
                f"mesh, {label}: row {qi}'s docs differ from one card's")
            count["compared"] += 1
        t_check = time.perf_counter() - t0
        t0 = time.perf_counter()
        ok = [qi for qi, r in enumerate(res) if r is not None]
        sample = sorted(rng.choice(ok, size=min(MESH_SAMPLED, len(ok)),
                                   replace=False).tolist())
        full = sdi.search_batch([queries[i] for i in sample], topk=TOPK,
                                hit_cap=HIT_CAP)
        for qi, r in zip(sample, full):
            want = sdi._host_reserve(queries[qi], None)
            ind._materialize_docs(want)
            want.found_docs.sort(key=lambda d: d.rank)
            require(r is not None and result_fields(r) == result_fields(want),
                    f"mesh, {label}: sampled row {qi} differs from the host")
        t_host = time.perf_counter() - t0
        say(f"mesh, {label}: {len(queries)} queries on {MESH_SHARDS} shards "
            f"{mesh_s * 1e3:.1f} ms (search_batch, materialize=\"defer\"; "
            f"ms {spans}), "
            f"one card's kernel route {one_s * 1e3:.1f} ms, on {card}; rows "
            f"{count}; every compared row's hits (global coordinates) and "
            f"docs equal to one card's ({t_check:.1f} s); {len(sample)} "
            f"sampled rows materialized equal to the exact host fold "
            f"({t_host:.1f} s); buckets per route {served}; launches "
            f"{({n: c for n, c in launches.items() if c})}")
        for name in required:
            require(launches[name] > 0,
                    f"kernel {name} was not launched on the {label} mesh path")
        require(served["plain"] == 0,
                f"{served['plain']} {label} mesh buckets took the plain route")
        require(count["compared"] > 0, f"mesh, {label}: no row compared")
        total = {n: total[n] + c for n, c in launches.items()}
    rows = standard + _straddling(sdi)
    launches = _mesh_full(sdi, dix, rows, card)
    total = {n: total[n] + c for n, c in launches.items()}
    phase_kernel_times(
        [lambda: sdi.search_batch_full(rows, topk=TOPK, hit_cap=HIT_CAP)],
        MESH_FULL_KERNELS, where="the sharded full-result batch")
    return total


def _straddling(sdi) -> list:
    """Rows whose two words meet across each shard boundary: the words
    of the last posting before it and of the first (or second) at or
    past it, from the postings near each boundary that boundary_status
    reads; proximity and ordered windows, both ways round."""
    import bisect

    rows = []
    for near in sdi._near:
        pairs = sorted((x, t) for t, xs in near.items() for x in xs)
        at = bisect.bisect_left(pairs, (0, -1))
        for i, j in ((at - 1, at), (at - 1, at + 1), (at - 2, at)):
            if i < 0 or j >= len(pairs) or pairs[i][1] == pairs[j][1]:
                continue
            a, c = sdi.terms[pairs[i][1]], sdi.terms[pairs[j][1]]
            r = pairs[j][0] - pairs[i][0] + 4
            rows += [[(a, r), (c, r)], [(c, r), (a, r)],
                     [(a, -r), (c, -r)], [(c, -r), (a, -r)]]
    return rows


def _mesh_full(sdi, dix, queries, card: str) -> dict:
    """The sharded full-result path on the card: one
    sdi.search_batch_full(deferred=True) of `queries` (each shard's
    FullShard through bucket_pre: the chunked kernels, locate_runs with
    the shard's kept range; the merge on the first card), launch counts
    zeroed just before and read just after, held field for field against
    one card's dix.search_batch_full (its hits as int64 coordinates).
    Every kernel of MESH_FULL_KERNELS must launch, no bucket take the
    plain route, and some row fold a window across a boundary on the
    cards. Returns the launches."""
    from docodo_tpu_torch.ops import device_index as tdi
    from docodo_tpu_torch.ops.seqops import INF32
    from docodo_tpu_torch.parallel.serving import HIT_PAD
    from docodo_tpu_torch.utils import profiling

    sdi.search_batch_full(queries[:512], topk=TOPK, hit_cap=HIT_CAP)  # warm
    torch.cuda.synchronize()
    chunked = tdi._chunked_bucket_full
    plain = []

    def counted(*a, **k):
        out = chunked(*a, **k)
        if out is None:
            plain.append(tuple(a[3].shape[1:]))
        return out

    tdi._chunked_bucket_full = counted
    _zero_launches()
    profiling.reset()
    try:
        t0 = time.perf_counter()
        got = sdi.search_batch_full(queries, topk=TOPK, hit_cap=HIT_CAP,
                                    deferred=True)()
        secs = time.perf_counter() - t0
    finally:
        tdi._chunked_bucket_full = chunked
    launches = _launches()
    count = profiling.counters()
    t0 = time.perf_counter()
    want = dix.search_batch_full(queries, topk=TOPK, hit_cap=HIT_CAP,
                                 use_kernels=True)
    one_s = time.perf_counter() - t0
    want["hits"] = np.where(want["hits"] == INF32, HIT_PAD,
                            want["hits"].astype(np.int64))
    for f, w in want.items():
        g = got[f]
        require(g.shape == w.shape and g.dtype == w.dtype,
                f"mesh full: {f} is {g.dtype} {g.shape}, one card's "
                f"{w.dtype} {w.shape}")
        bad = np.flatnonzero((g != w).reshape(len(queries), -1).any(1))
        require(bad.size == 0, f"mesh full: {f} differs from one card's "
                f"in {bad.size} rows, first {bad[:5].tolist()}")
    crossing = sum(cg is not None and cg[6] == 1 for cg, _ in
                   map(sdi._compile_full, queries))
    say(f"mesh full: {len(queries)} rows ({len(queries) - N_QUERIES} built "
        f"to straddle the {sdi.boundaries.size} boundaries) on "
        f"{MESH_SHARDS} shards through search_batch_full(deferred=True) "
        f"{secs * 1e3:.1f} ms, one card's {one_s * 1e3:.1f} ms, on {card}; "
        f"every field of every row equal to one card's (ranks bit for "
        f"bit, hits as int64 coordinates), {crossing} rows with a "
        f"window across a boundary; counters mesh.rows "
        f"{count.get('mesh.rows', 0)}, mesh.boundary_rows "
        f"{count.get('mesh.boundary_rows', 0)}, mesh.reserve_rows "
        f"{count.get('mesh.reserve_rows', 0)}; plain buckets "
        f"{sorted(set(plain))}; launches "
        f"{({n: c for n, c in launches.items() if c})}")
    for name in MESH_FULL_KERNELS:
        require(launches[name] > 0,
                f"kernel {name} was not launched by the sharded full path")
    require(not plain, f"sharded full-path buckets {sorted(set(plain))} "
            "took the plain route")
    require(count.get("mesh.boundary_rows", 0) > 0,
            "no row folded a window across a shard boundary on the cards")
    return launches


def _distributed_leg(rank, world, nccl, doc_pages, assign, nloc, ploc,
                     num_terms, buckets, page_terms, page_rs, doc_tids,
                     doc_coords):
    """One process of phase_distributed: its own shards staged
    (stage_for_process: its documents only), built and queried over the
    process group on its card; numpy results."""
    from docodo_tpu_torch.parallel import distributed as dd

    dev = torch.device("cuda", rank if nccl else 0)
    torch.cuda.set_device(dev)
    d = len(assign) // world
    mesh = dd.make_global_mesh(devices=[dev] * d)
    rows = dd.stage_for_process(doc_tids, doc_coords, doc_pages, assign,
                                world, d, rank, nloc=nloc, ploc=ploc)
    _, sc, off = dd.distributed_build(mesh, rows.term_ids, rows.coords,
                                      num_terms)
    header = np.zeros(rows.bounds.shape, dtype=bool)
    _zero_launches()
    t0 = time.perf_counter()
    outs = [dd.distributed_query_full(mesh, off, sc, rows.bounds,
                                      rows.page_doc, header, terms, rs,
                                      cap=cap, topk=TOPK, hit_cap=HIT_CAP,
                                      with_docs=False)
            for cap, terms, rs in buckets]
    full = [[None if x is None else x.cpu().numpy() for x in o]
            for o in outs]
    secs = time.perf_counter() - t0
    page = [x.cpu().numpy() for x in dd.distributed_query(
        mesh, off, sc, rows.bounds, rows.page_doc, rows.page_base,
        page_terms, page_rs, cap=1024, topk=PAGE_TOPK)]
    return full, page, secs, sum(_launches().values())


def phase_distributed(index, dix, card: str) -> None:
    """Two processes (torch.multiprocessing spawn) of two shards each,
    one plan of four over the 64 MB index: each stages only its own
    documents (stage_for_process), builds and serves a batch's buckets
    (distributed_query_full) and a page-level batch (distributed_query)
    over one process group: NCCL with one card a process where the host
    has two or more, else gloo with both on cuda:0 (the counts gathered
    through host tensors). Each process's stream fields, the gathered
    counts and the page-level top k must equal the one-process
    ShardedDeviceIndex over the same plan. A failure or a timeout in
    either process fails the phase. Then dryrun_multichip(4) on the
    card."""
    from docodo_tpu_torch.parallel import distributed as dd
    from docodo_tpu_torch.parallel import sharding as sh
    from docodo_tpu_torch.parallel.serving import (ShardedDeviceIndex,
                                                   doc_streams)

    cards = torch.cuda.device_count()
    nccl = cards >= DIST_HOSTS
    backend = "nccl" if nccl else "gloo"
    shards = 2 * DIST_HOSTS
    sdi = ShardedDeviceIndex.from_index(index, sh.make_mesh(shards))
    doc_tids, doc_coords, doc_pages, _ = doc_streams(index.arr, index.pages)
    assign = sdi.corpus.doc_assign
    nloc = max(sum(doc_tids[i].size for i in a) for a in assign)
    ploc = max(sum(len(doc_pages[i]) for i in a) for a in assign)
    queries = (_queries(dix, DIST_QUERIES[0])
               + _wide_queries(dix, DIST_QUERIES[1], 0))
    buckets = [(cap, terms, rs)
               for _, cap, terms, rs in sdi.bucket_arrays(queries)]
    page_terms, page_rs, _ = dix.compile_queries(
        _queries(dix, DIST_PAGE_ROWS), pad_w=2)
    d = shards // DIST_HOSTS
    own = [{i for s in range(p * d, (p + 1) * d) for i in assign[s]}
           for p in range(DIST_HOSTS)]
    rank_args = [([t if i in own[p] else None
                   for i, t in enumerate(doc_tids)],
                  [c if i in own[p] else None
                   for i, c in enumerate(doc_coords)])
                 for p in range(DIST_HOSTS)]
    t0 = time.perf_counter()
    outs = dd.spawn(_distributed_leg, DIST_HOSTS, backend, timeout=300,
                    args=(nccl, doc_pages, assign, nloc, ploc,
                          len(sdi.terms), buckets, page_terms, page_rs),
                    rank_args=rank_args)
    secs = time.perf_counter() - t0
    mismatches = 0
    for k, (cap, terms, rs) in enumerate(buckets):
        want = sh.sharded_query_full(
            sdi.devices, sdi._off, sdi._sc, sdi._bounds, sdi._page_doc,
            sdi._is_header, terms, rs, cap=cap, topk=TOPK, hit_cap=HIT_CAP,
            with_docs=False, small=sdi._small, page_of=sdi._page_of)
        for f, w in enumerate(want):
            if w is None:
                continue
            w = w.cpu().numpy()
            if f in (3, 7):  # n_pages, n_hits: every process, all shards
                got = [outs[p][0][k][f] for p in range(DIST_HOSTS)]
            else:  # each process its own shards
                got = [np.concatenate([outs[p][0][k][f]
                                       for p in range(DIST_HOSTS)])]
            for g in got:
                if w.dtype == np.float32:
                    mismatches += ulps(torch.from_numpy(g),
                                       torch.from_numpy(w)) > 1
                else:
                    mismatches += not np.array_equal(g, w)
    want = sh.sharded_query(sdi.devices, sdi._off, sdi._sc, sdi._bounds,
                            sdi._page_doc, sdi.corpus.page_base, page_terms,
                            page_rs, cap=1024, topk=PAGE_TOPK)
    for p in range(DIST_HOSTS):
        for g, w in zip(outs[p][1], want):
            mismatches += not np.array_equal(g, w.cpu().numpy())
    say(f"distributed: {DIST_HOSTS} processes (spawn) of {d} shards, "
        f"backend {backend}, {cards} card(s){' (both processes on cuda:0)' if not nccl else ''}, "
        f"on {card}; {len(queries)} rows in {len(buckets)} buckets + "
        f"{DIST_PAGE_ROWS} page-level rows; the processes' query seconds "
        f"{[round(o[2], 2) for o in outs]}, launches "
        f"{[o[3] for o in outs]}; the phase {secs:.1f} s; mismatches "
        f"against the one-process ShardedDeviceIndex {mismatches}")
    require(mismatches == 0, "the processes' results differ from one "
            "process's")
    require(all(o[3] > 0 for o in outs), "a process launched no kernel")
    t0 = time.perf_counter()
    sh.dryrun_multichip(MESH_SHARDS)
    say(f"dryrun_multichip({MESH_SHARDS}) on the card: ok "
        f"({time.perf_counter() - t0:.2f} s)")


def phase_probes(dix, card: str):
    """The probes of the JAX package's benchmarks/ that hold a TPU kernel,
    run on the card through their entry points (docodo_tpu_torch.
    benchmarks), counts zeroed just before and read just after: probe_locate
    (docodo_probe_locate under its three page locates, at the TPU probe's
    shape and on the 64 MB index's real page table and cap-64 W = 2
    bucket), probe_dma_fetch (docodo_row_gather, copy and sum128 at q 32
    / 64 / 128, beside torch.index_select, tab[ids] and gather_term) and
    profile_cap64 (the stage prefixes of the cap-64 bucket over row 1's
    kernel). Each run holds its kernels against their plain versions bit
    for bit, two_level against bounds and every gather leg against
    tab[ids]; both probe kernels and row 1's must launch. Returns
    (launches, the two kernels' timing rows)."""
    from docodo_tpu_torch.benchmarks import (probe_dma_fetch, probe_locate,
                                             profile_cap64)
    from docodo_tpu_torch.ops import probe_kernels as pk

    _zero_launches()
    t0 = time.perf_counter()
    loc = probe_locate.run("cuda", dix=dix)
    fetch = probe_dma_fetch.run("cuda")
    stages = profile_cap64.run("cuda", dix=dix)
    secs = time.perf_counter() - t0
    launches = _launches()
    for key in ("probe", "index"):
        r = loc[key]
        say(f"probe_locate, {r['shape']}: bound {r['bound_ms'] * 1e3:.2f} us "
            f"({r['bound_by']}); plain {r['plain_ms']:.3f} ms; the locate's "
            f"share of row 1's body {r['locate_share']:.3f}; " + "; ".join(
                f"{p} {r[p]['ms']:.4f} ms (device {r[p]['profiler_ms']:.4f}"
                f" ms, {r[p]['share']:.3f} of bounds'), rows differing from "
                f"bounds {r[p]['mismatch_rows']}, kernel vs plain "
                f"{r[p]['max_abs_err']}" for p in pk.POLICIES) + f"; {card}")
    say("probe_dma_fetch, R=16384 n=2048 B=10,000: " + "; ".join(
        f"{name} {leg['ms']:.4f} ms ({leg['gb_s']:.1f} GB/s, device "
        f"{leg['profiler_ms']:.4f} ms, bound {leg['bound_ms'] * 1e3:.1f} us)"
        for name, leg in fetch.items() if isinstance(leg, dict))
        + f"; plain copy {fetch['plain_copy_ms']:.4f} ms, plain sum128 "
        f"{fetch['plain_sum128_ms']:.4f} ms; every leg equal to tab[ids], "
        f"sum128 to its formula; {card}")
    say(f"profile_cap64, the cap-64 W=2 hit-128 bucket ({stages['rows']} "
        f"rows): " + "; ".join(
            f"{name} {t['ms']:.3f} ms ({t['delta_ms']:+.3f}), device "
            f"{t['profiler_ms']:.3f} ms ({t['delta_profiler_ms']:+.3f})"
            for name, t in stages["stages"].items())
        + "; the row-1 kernel merges both words itself (no tagged-sort "
        f"stage); pages, counts, hits equal to the plain route's; {card}")
    say(f"probes: {secs:.1f} s; launches "
        f"{({n: c for n, c in launches.items() if c})}")
    for name in (*PROBE_KERNELS, "sorted_and_locate_full"):
        require(launches[name] > 0, f"kernel {name} was not launched on the "
                "probe path")
    err = max(loc[k][p]["max_abs_err"] for k in ("probe", "index")
              for p in pk.POLICIES)
    probe, copy = loc["probe"], fetch["kernel copy q=32"]
    times = {
        "probe_locate": dict(
            ms=probe["bounds"]["ms"], profiler_ms=probe["bounds"]["profiler_ms"],
            plain_ms=probe["plain_ms"], bound_ms=probe["bound_ms"],
            bound_by=probe["bound_by"], library_ms=None, max_abs_err=err),
        "row_gather": dict(
            ms=copy["ms"], profiler_ms=copy["profiler_ms"],
            plain_ms=fetch["plain_copy_ms"], bound_ms=copy["bound_ms"],
            bound_by=copy["bound_by"],
            library_ms=fetch["index_select"]["ms"],
            max_abs_err=fetch["max_abs_err"]),
    }
    return launches, times


class _RssPeak:
    """The process's resident set, sampled every 20 ms on a thread while
    a `with` block runs: its value at the start and its largest, in
    bytes."""

    def __enter__(self):
        import threading

        self.start = self.peak = self._rss()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._watch, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=5)
        self.peak = max(self.peak, self._rss())
        return False

    def _watch(self):
        while not self._stop.wait(0.02):
            self.peak = max(self.peak, self._rss())

    @staticmethod
    def _rss() -> int:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
        return 0


def phase_build_spilled(docs, card: str, built):
    """The memory-bounded build: Index(path).create() on the card, each
    thread's builder spilling past the default max_tmp_index_items
    (1,000,001 postings), its spills sorted on the card one at a time and
    merged on the host. (a) One thread over phase_build_scale's 1 GB
    documents (zipf_documents(build_mb, seed), BASELINE.md's scale): its
    `.index` and `.index.list` must equal, byte for byte, `built`'s
    (build_index's unspilled one-thread build) written with
    write_postings_arrays and PageTable.save. (b) Two threads over the
    first quarter of the documents (the depth cut that pays for
    phase_surface; it was the whole 1 GB): its arrays and page table must
    equal build_index's in-memory build of the same quarter, and
    SPILLED_ROWS rows of the standard mix and of the wide mix +
    alternations, drawn on that index, through search_batch_full on both
    builds' device indexes, every field equal (pages, ranks, counts,
    hits, docs). Seconds, MB/s, the spills, the phases, peak host RSS
    (sampled) and the card's peak allocation for each build. The files
    live under build/ and are removed."""
    import filecmp
    import os
    import shutil

    from docodo_tpu_torch.core import storage
    from docodo_tpu_torch.index import Index, ListDataSource, build_index
    from docodo_tpu_torch.ops.device_index import DeviceIndex
    from docodo_tpu_torch.utils import profiling

    t_start = time.perf_counter()
    quarter = docs[: max(1, len(docs) // 4)]
    root = Path(__file__).resolve().parent / "build" / (
        f"phase_spill_{os.getpid()}")
    try:
        (root / "unspilled").mkdir(parents=True)
        arr, pages = built.arr, built.pages
        with open(root / "unspilled" / storage.INDEX_FILE, "wb") as f:
            storage.write_postings_arrays(f, arr.max_coord, arr.terms,
                                          arr.offsets, arr.coords)
        with open(root / "unspilled" / storage.PAGES_FILE, "wb") as f:
            pages.save(f)
        say(f"spilled build: the unspilled files written in "
            f"{time.perf_counter() - t_start:.1f} s")
        builds = {}
        for threads, part in ((1, docs), (2, quarter)):
            mb = sum(len(p.text) for d in part for p in d.pages) / 1e6
            path = root / f"threads{threads}"
            ind = Index(str(path))
            ind.max_degree_of_parallelism = threads
            ind.add_data_source(ListDataSource("synth", part))
            profiling.reset()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            with _RssPeak() as rss:
                t0 = time.perf_counter()
                ind.create()
                secs = time.perf_counter() - t0
            card_peak = torch.cuda.max_memory_allocated() - held
            report = {name: (round(sec, 2), calls)
                      for name, sec, calls in profiling.report()}
            spills = report.get("build.spill-save", (0, 0))[1]
            builds[threads] = ind
            say(f"spilled build, {threads} thread(s), {mb:.1f} MB "
                f"({len(part)} documents), max_tmp_index_items "
                f"{ind.max_tmp_index_items}: {secs:.2f} s = "
                f"{mb / secs:.1f} MB/s; {spills} spills sorted on the card; "
                f"phases (s, calls; summed over threads) {report}; peak "
                f"host RSS {rss.peak / 1e9:.2f} GB ("
                f"{(rss.peak - rss.start) / 1e9:+.2f} GB over its start), "
                f"card peak "
                f"{card_peak / 1e9:.3f} GB; {len(ind.arr.terms)} terms, "
                f"{ind.arr.coords.size} postings; {card}")
        for name in (storage.INDEX_FILE, storage.PAGES_FILE):
            require(filecmp.cmp(root / "threads1" / name,
                                root / "unspilled" / name, shallow=False),
                    f"the spilled one-thread build's {name} differs from "
                    f"the unspilled build's")
        t0 = time.perf_counter()
        one, two = build_index(ListDataSource("synth", quarter)), builds[2]
        ref_s = time.perf_counter() - t0
        a, b = one.arr, two.arr
        require(a.terms == b.terms and a.max_coord == b.max_coord
                and np.array_equal(a.offsets, b.offsets)
                and np.array_equal(a.coords, b.coords)
                and np.array_equal(one.pages.bounds, two.pages.bounds)
                and np.array_equal(one.pages.page_doc, two.pages.page_doc)
                and one.pages.page_ids == two.pages.page_ids
                and one.pages.doc_names == two.pages.doc_names,
                "the two-thread build's arrays differ from build_index's "
                "of the same documents")
        t0 = time.perf_counter()
        dixs = [DeviceIndex.from_index(ind) for ind in (one, two)]
        torch.cuda.synchronize()
        stage_s = time.perf_counter() - t0
        rows = {}
        for label, queries in (
                ("standard mix", _queries(dixs[0], SPILLED_ROWS)),
                ("wide mix + alternations",
                 _wide_queries(dixs[0], SPILLED_ROWS, SPILLED_ROWS // 10))):
            t0 = time.perf_counter()
            outs = [d.search_batch_full(queries, topk=TOPK, hit_cap=HIT_CAP,
                                        use_kernels=True) for d in dixs]
            for f in outs[0]:
                require(np.array_equal(outs[0][f], outs[1][f]),
                        f"spilled builds, {label}: field {f} differs "
                        f"between build_index and two threads")
            rows[label] = (len(queries),
                           round(time.perf_counter() - t0, 1))
        say(f"spilled builds: the one-thread build's .index and .index.list "
            f"equal build_index's unspilled files byte for byte; the "
            f"two-thread build's arrays and page table equal build_index's "
            f"of the same {len(quarter)} documents (in memory, "
            f"{ref_s:.1f} s); both staged ({stage_s:.1f} s), (rows, s) "
            f"{rows} through search_batch_full equal field for field "
            f"(pages, ranks, counts, hits, docs); {card}")
        del dixs
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _captured(name: str, call):
    """The (args, kwargs) of the last call `call()` makes of
    device_index.<name>."""
    from docodo_tpu_torch.ops import device_index as tdi

    seen = []
    inner = getattr(tdi, name)

    def record(*a, **k):
        seen.append((a, k))
        return inner(*a, **k)

    setattr(tdi, name, record)
    try:
        call()
    finally:
        setattr(tdi, name, inner)
    return seen[-1]


def _surface_packed(proto, card: str) -> None:
    """(a) of phase_surface: the 1 GB documents tokenized by
    tokenize_intern_packed into one native interner, in slices of whole
    documents (SURFACE_SLICE_CHARS, newlines between documents, so that a
    slice starts at one of the protocol's document bases), each slice's
    stream cut by split_packed at a power of two >= 5/4 of the first
    slice's rows and every part built on the card by
    build_postings_packed, as benchmarks/scale_build.py:140-186 runs
    it."""
    from docodo_tpu_torch.native import pipeline
    from docodo_tpu_torch.ops.device_index import (
        build_postings_packed,
        pack_tokens,
        pack_tokens_split,
        split_packed,
    )

    texts, bases = proto["texts"], proto["bases"]
    cuts, size = [0], 0
    for i, t in enumerate(texts):
        size += len(t) + 1
        if size >= SURFACE_SLICE_CHARS or i == len(texts) - 1:
            cuts.append(i + 1)
            size = 0
    it = pipeline.make_interner()
    tok_s = build_s = 0.0
    cap = first = None
    parts = []  # (sorted coords, offsets, base) on the card
    rows = postings = 0
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        text = "\n".join(texts[lo:hi])
        t0 = time.perf_counter()
        packed = pipeline.tokenize_intern_packed(text, it)
        tok_s += time.perf_counter() - t0
        rows += packed.size
        if cap is None:
            cap = 1 << (-(-packed.size * 5 // 4) - 1).bit_length()
            first = (text, packed)
        num_terms = len(it)
        t0 = time.perf_counter()
        for part in split_packed(packed, cap):
            dev = torch.from_numpy(part.view(np.int32)).to("cuda")
            _, sc, off = build_postings_packed(dev, num_terms)
            postings += int(off[-1])
            parts.append((sc, off, int(bases[lo])))
        build_s += time.perf_counter() - t0
    require(postings == proto["tokens"],
            f"packed build: {postings} postings in the parts, "
            f"{proto['tokens']} tokens")
    # the 1,000 sampled terms, by string: each part's list moved by its
    # slice's base, the parts in order, against the protocol's list
    ids = {w: i for i, w in enumerate(it.terms())}
    sample, sub_ids, sub_starts = (proto["sample"], proto["sub_ids"],
                                   proto["sub_starts"])
    want_sorted = sub_starts[np.lexsort((sub_starts, sub_ids))]
    want_ids = np.sort(sub_ids)
    pid = torch.tensor([ids[proto["terms"][t]] for t in sample],
                       dtype=torch.long, device="cuda")
    got = [[] for _ in sample]
    for sc, off, base in parts:
        live = (pid < off.numel() - 1)
        at = torch.where(live, pid, 0)
        lo_, hi_ = off[at], torch.where(live, off[at + 1], off[at])
        lens = (hi_ - lo_).cpu().numpy().astype(np.int64)
        if not lens.any():
            continue
        starts = lo_.cpu().numpy().astype(np.int64)
        flat = (np.repeat(starts - (np.cumsum(lens) - lens), lens)
                + np.arange(int(lens.sum())))
        vals = sc[torch.from_numpy(flat).cuda()].cpu().numpy()
        for k, part in enumerate(np.split(vals, np.cumsum(lens)[:-1])):
            if part.size:
                got[k].append(part.astype(np.int64) + base)
    for k, t in enumerate(sample):
        w = want_sorted[want_ids == t]
        g = np.concatenate(got[k]) if got[k] else np.zeros(0, np.int64)
        require(np.array_equal(g, w), f"packed build: the list of "
                f"{proto['terms'][t]!r} differs from the protocol's")
    # one slice against the unpacked path, and split at an eighth of the
    # cap both ways (split_packed, pack_tokens_split), parts against the
    # whole slice's CSR
    text, packed = first
    ids0, starts0 = pipeline.tokenize_intern(text, pipeline.make_interner())
    require(np.array_equal(packed, pack_tokens(ids0, starts0)),
            "packed build: slice 0's rows differ from "
            "pack_tokens(*tokenize_intern(...))")
    n_terms0 = int(ids0.max()) + 1
    whole = build_postings_packed(
        torch.from_numpy(packed.view(np.int32)).cuda(), n_terms0)
    n0 = int(whole[2][-1])
    for how, pieces in (("split_packed", split_packed(packed, cap // 8)),
                        ("pack_tokens_split",
                         pack_tokens_split(ids0, starts0, cap // 8))):
        st, sc = [], []
        for p in pieces:
            t_, c_, o_ = build_postings_packed(
                torch.from_numpy(p.view(np.int32)).cuda(), n_terms0)
            st.append(t_[: int(o_[-1])])
            sc.append(c_[: int(o_[-1])])
        st, sc = torch.cat(st), torch.cat(sc)
        order = torch.sort((st.long() << 32) | sc.long()).indices
        require(len(pieces) > 1 and torch.equal(st[order], whole[0][:n0])
                and torch.equal(sc[order], whole[1][:n0]),
                f"packed build: slice 0 in {len(pieces)} parts by {how} "
                f"differs from its whole build")
    torch.cuda.synchronize()
    mb = proto["mb"]
    say(f"surface, packed build: {mb:.1f} MB in {len(cuts) - 1} slices of "
        f"whole documents (~{SURFACE_SLICE_CHARS / 1e6:g} M characters) "
        f"through tokenize_intern_packed into one native interner on one "
        f"thread: {tok_s:.2f} s = {mb / tok_s:.1f} MB/s (the protocol's "
        f"parallel_tokenize_intern on {proto['workers']} threads: "
        f"{proto['tokenize_mb_s']:.1f} MB/s); {rows} rows, split_packed "
        f"at cap {cap} into {len(parts)} parts, built on the card by "
        f"build_postings_packed in {build_s:.2f} s; postings = tokens "
        f"({postings}); the 1,000 sampled terms' lists, each part moved by "
        f"its slice's base, equal the protocol's; slice 0 equals "
        f"pack_tokens(*tokenize_intern(...)), and its parts at cap "
        f"{cap // 8} by split_packed and by pack_tokens_split build its "
        f"CSR; {card}")
    del parts


def _surface_chained(dix, queries, card: str) -> dict:
    """(b) of phase_surface: the standard mix's buckets (as
    search_batch_full and search_batch hand them to the dispatchers)
    through multi_bucket_query_full_chained and
    multi_bucket_query_step_chained on the kernel route, SURFACE_REPS
    reps chained through their checksums with one readback, launch counts
    zeroed just before and read just after; every output field of every
    rep equal to the unchained call's and every checksum to the sums
    over its outputs. Returns the launches."""
    from docodo_tpu_torch.ops import device_index as tdi

    legs = (
        ("full", "multi_bucket_query_full", 7, STANDARD_KERNELS,
         lambda: dix.search_batch_full(queries, topk=TOPK, hit_cap=HIT_CAP,
                                       use_kernels=True)),
        ("page-level step", "multi_bucket_query_step", 6, PAGE_KERNELS,
         lambda: dix.search_batch(queries, topk=PAGE_TOPK,
                                  use_kernels=True)))
    total = {name: 0 for name in _launches()}
    for label, name, split, required, call in legs:
        a, k = _captured(name, call)
        fn, chained = getattr(tdi, name), getattr(tdi, name + "_chained")
        plain = fn(*a, **k)
        want = torch.zeros((), device=dix.device)
        for o in plain:
            want = (want + o.ranks.sum() + o.n_hits.to(torch.float32).sum()
                    if label == "full" else want + o[1].sum())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SURFACE_REPS):
            fn(*a, **k)
            torch.cuda.synchronize()
        unchained_ms = (time.perf_counter() - t0) * 1e3 / SURFACE_REPS
        _zero_launches()
        t0 = time.perf_counter()
        chain = torch.zeros((), device=dix.device)
        reps = []
        for _ in range(SURFACE_REPS):
            outs, chain = chained(*a[:split], chain, *a[split:], **k)
            reps.append((outs, chain))
        final = float(chain)  # the one readback
        chained_ms = (time.perf_counter() - t0) * 1e3 / SURFACE_REPS
        launches = _launches()
        for kname in required:
            require(launches[kname] > 0, f"chained {label}: kernel {kname} "
                    "was not launched")
        for n, c in launches.items():
            total[n] += c
        require(final == float(want), f"chained {label}: checksum {final} "
                f"!= {float(want)} over the unchained outputs")
        for outs, s in reps:
            require(float(s) == float(want), f"chained {label}: a rep's "
                    "checksum differs")
            for g, w in zip(outs, plain):
                require(all(torch.equal(x, y) for x, y in zip(g, w)
                            if x is not None),
                        f"chained {label}: a rep's outputs differ from the "
                        f"unchained call's")
        say(f"surface, chained {label}: {len(a[split - 2])} buckets of the "
            f"standard mix, {SURFACE_REPS} reps chained through their "
            f"checksums with one readback {chained_ms:.3f} ms a rep, "
            f"unchained with a synchronise a rep {unchained_ms:.3f} ms; "
            f"every field and checksum ({final:.6g}) equal to the "
            f"unchained call's; launches "
            f"{({n: c for n, c in launches.items() if c})}; {card}")
    return total


def _surface_set_ops(dix, vocabulary, card: str) -> None:
    """(c) of phase_surface: device_and / device_or / batch_and /
    batch_or / device_locate_rank on the card over SURFACE_PAIRS pairs of
    the 64 MB index's posting lists, against the host PostingSeq * and +
    and the same calls on the CPU; batched_query_step_variants over
    phase_vocabulary's groups on the card against its CPU run, and on
    V = 1 rows against batched_query_step."""
    from docodo_tpu_torch.core.postings import PostingSeq
    from docodo_tpu_torch.ops import device_index as tdi
    from docodo_tpu_torch.ops import seqops
    from docodo_tpu_torch.ops.device_index import DeviceIndex

    t0 = time.perf_counter()
    rng = np.random.default_rng(SURFACE_PAIRS)
    counts = np.diff(dix.offsets_np)
    # lists of (cap / 2, cap] postings: a pair shares a few dozen windows
    pool = np.flatnonzero((counts > SURFACE_CAP // 2)
                          & (counts <= SURFACE_CAP))
    pairs = rng.choice(pool, size=(SURFACE_PAIRS, 2))
    coords = dix.coords.cpu().numpy()
    lists = [[coords[dix.offsets_np[t]:dix.offsets_np[t + 1]] for t in p]
             for p in pairs]
    pad = [np.stack([seqops.pad_to(ls[j], SURFACE_CAP)[0] for ls in lists])
           for j in (0, 1)]
    n = [np.array([ls[j].size for ls in lists], np.int32) for j in (0, 1)]
    r = np.where(np.arange(SURFACE_PAIRS) % 3 == 0, -9, 262).astype(np.int32)
    cpu = [torch.from_numpy(x) for x in (pad[0], n[0], r, pad[1], n[1], r)]
    card_in = [x.cuda() for x in cpu]
    bounds, page_doc = dix.bounds, dix.page_doc
    for op, one, host in (
            (seqops.batch_and, seqops.device_and, PostingSeq.__mul__),
            (seqops.batch_or, seqops.device_or, PostingSeq.__add__)):
        got = op(*card_in)
        want = op(*cpu)
        require(all(torch.equal(g.cpu(), w) for g, w in zip(got, want)),
                f"{op.__name__} on the card differs from the CPU")
        out, cnt, rr = (x.cpu().numpy() for x in got)
        for q, ls in enumerate(lists):
            h = host(PostingSeq(ls[0], int(r[q])),
                     PostingSeq(ls[1], int(r[q])))
            require(np.array_equal(out[q, :cnt[q]], h.coords.astype(np.int64))
                    and rr[q] == h.R, f"{op.__name__} row {q} differs from "
                    f"the host PostingSeq")
            o1, c1, r1 = one(*[x[q] for x in card_in])
            require(torch.equal(o1, got[0][q]) and int(c1) == cnt[q]
                    and int(r1) == rr[q], f"{one.__name__} of pair {q} "
                    "differs from its batch row")
        if op is seqops.batch_and:
            kept = int(cnt.sum())
            for q in range(SURFACE_PAIRS):
                g = seqops.device_locate_rank(got[0][q], got[1][q], bounds,
                                              page_doc, 2 * SURFACE_CAP)
                w = seqops.device_locate_rank(
                    want[0][q], want[1][q], bounds.cpu(), page_doc.cpu(),
                    2 * SURFACE_CAP)
                require(all(torch.equal(x.cpu(), y)
                            for x, y in zip(g[:3], w[:3]))
                        and ulps(g[3].cpu(), w[3]) <= 1,
                        f"device_locate_rank of pair {q} differs from the "
                        f"CPU")
    # the variant step over phase_vocabulary's groups
    ind, queries = vocabulary
    vdix = DeviceIndex.from_index(ind)
    vcpu = DeviceIndex.from_index(ind, device="cpu")
    # buckets of (W, V to a power of two, cap), as search_batch_full
    # makes them
    buckets: dict = {}
    for q in queries:
        cg = vdix.compile_group_query(q)
        if cg is not None:
            buckets.setdefault((cg[2], tdi._bucket(cg[3], lo=1),
                                tdi._bucket(cg[4])), []).append(cg)
    variant_rows = one_rows = 0
    for (w, v, cap), cgs in sorted(buckets.items()):
        terms = np.full((len(cgs), w, v), -1, np.int32)
        rs = np.ones((len(cgs), w), np.int32)
        for i, cg in enumerate(cgs):
            for j, (idv, rv) in enumerate(zip(cg[0], cg[1])):
                terms[i, j, : len(idv)] = idv
                rs[i, j] = rv
        tt, rt = torch.from_numpy(terms), torch.from_numpy(rs)
        got = tdi.batched_query_step_variants(
            vdix.term_offsets, vdix.coords, vdix.bounds, vdix.page_doc,
            tt.cuda(), rt.cuda(), cap, PAGE_TOPK, vdix.small)
        want = tdi.batched_query_step_variants(
            vcpu.term_offsets, vcpu.coords, vcpu.bounds, vcpu.page_doc, tt,
            rt, cap, PAGE_TOPK, vcpu.small)
        require(torch.equal(got[0].cpu(), want[0])
                and torch.equal(got[2].cpu(), want[2])
                and ulps(got[1].cpu(), want[1]) <= 1,
                f"batched_query_step_variants W {w} V {v} on the card "
                f"differs from the CPU")
        single = (terms[:, :, 1:] < 0).all(axis=(1, 2)) if v > 1 else \
            np.ones(len(cgs), bool)
        if single.any():
            step = tdi.batched_query_step(
                vdix.term_offsets, vdix.coords, vdix.bounds, vdix.page_doc,
                tt[single][:, :, 0].cuda(), rt[single].cuda(), cap,
                PAGE_TOPK, vdix.small)
            require(all(torch.equal(x[torch.from_numpy(single).cuda()], y)
                        for x, y in zip(got, step)),
                    f"batched_query_step_variants' V = 1 rows (W {w}) "
                    f"differ from batched_query_step")
        variant_rows += int((~single).sum())
        one_rows += int(single.sum())
    require(variant_rows > 0, "vocabulary groups: no row of V > 1")
    say(f"surface, set operations: {SURFACE_PAIRS} pairs of the 64 MB "
        f"index's lists ({SURFACE_CAP // 2 + 1}-{SURFACE_CAP} postings) "
        f"through batch_and / "
        f"batch_or on the card equal to the CPU and to the host "
        f"PostingSeq * / + ({kept} coordinates kept by the AND), "
        f"device_and / device_or pair by pair equal to the batch rows, "
        f"device_locate_rank of every AND row equal to the CPU; "
        f"batched_query_step_variants over phase_vocabulary's groups "
        f"({variant_rows} rows of V > 1, {one_rows} of V = 1) equal to "
        f"the CPU, its V = 1 rows to batched_query_step; "
        f"{time.perf_counter() - t0:.1f} s; {card}")


def _surface_getitem(index, dix, folder: Path, card: str) -> None:
    """(d) of phase_surface: Index[term] on the 64 MB index against its
    device CSR, and on phase_disk's folder loaded in memory and lazily
    against the loaded CSR, for SURFACE_TERMS seeded terms each; an
    absent term raises KeyError."""
    from docodo_tpu_torch.index import Index

    t0 = time.perf_counter()
    rng = np.random.default_rng(SURFACE_TERMS)
    coords = dix.coords.cpu().numpy()
    for t in rng.choice(len(dix.terms), size=SURFACE_TERMS, replace=False):
        off = dix.offsets_np
        require(np.array_equal(index[dix.terms[t]].coords,
                               coords[off[t]:off[t + 1]]),
                f"Index[{dix.terms[t]!r}] differs from the device CSR")
    loaded = Index(str(folder))
    lazy = Index(str(folder), in_memory=False)
    try:
        arr = loaded.arr
        require(loaded.can_search and lazy.can_search
                and lazy.arr.coords is None, "phase_disk's folder did not "
                "load in memory and lazily")
        for t in rng.choice(len(arr.terms), size=SURFACE_TERMS,
                            replace=False):
            want = arr.coords[arr.offsets[t]:arr.offsets[t + 1]]
            for ind in (loaded, lazy):
                require(np.array_equal(ind[arr.terms[t]].coords, want),
                        f"Index[{arr.terms[t]!r}] of the loaded folder "
                        f"differs from its CSR")
        for ind in (index, loaded, lazy):
            try:
                ind["nosuchword"]
                require(False, "Index['nosuchword'] raised no KeyError")
            except KeyError:
                pass
    finally:
        loaded.dispose()
        lazy.dispose()
    say(f"surface, Index[term]: {SURFACE_TERMS} terms of the 64 MB index "
        f"equal to its device CSR, {SURFACE_TERMS} of phase_disk's folder "
        f"loaded in memory and lazily equal to its CSR, an absent term "
        f"KeyError; {time.perf_counter() - t0:.1f} s; {card}")


def phase_surface(proto, index, dix, queries, vocabulary, folder: Path,
                  card: str) -> dict:
    """The JAX package's last surface on the card: (a) the packed build
    at 1 GB (_surface_packed), (b) the chained calls
    (_surface_chained), (c) the set operations and the variant step
    (_surface_set_ops), (d) Index[term] (_surface_getitem). Returns the
    launches of (b)."""
    _surface_packed(proto, card)
    launches = _surface_chained(dix, queries, card)
    _surface_set_ops(dix, vocabulary, card)
    _surface_getitem(index, dix, folder, card)
    return launches


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--corpus-mb", type=float, default=64.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--build-mb", type=float, default=1000.0)
    ap.add_argument("--mesh-mb", type=float, default=float(MESH_MB))
    args = ap.parse_args()

    marks = [("start", time.perf_counter())]

    def lap(name):  # the seconds each phase took, printed at the end
        marks.append((name, time.perf_counter()))

    card, smi = phase_device()
    phase_build()
    lap("build")
    rng = np.random.default_rng(args.seed)
    err = phase_parity(rng)
    lap("parity")
    index, dix = phase_index(args.corpus_mb, args.seed)
    lap("index")
    built, docs, proto = phase_build_scale(args.build_mb, args.seed,
                                           f"{card} ({smi})")
    lap("build at scale")
    phase_build_spilled(docs, f"{card} ({smi})", built)
    del docs
    lap("spilled build")
    root = Path(__file__).resolve().parent
    (root / "build").mkdir(exist_ok=True)
    # phase_disk's files; phase_surface reads its folder too
    disk_tmp = Path(tempfile.mkdtemp(prefix="phase_disk_",
                                     dir=root / "build"))
    try:
        dlaunches = phase_disk(args.corpus_mb, args.seed, f"{card} ({smi})",
                               built, disk_tmp)
        del built
        lap("disk")
        queries = _queries(dix, N_QUERIES)
        wide = _wide_queries(dix, N_QUERIES, N_ALTERNATIONS)
        out, launches = phase_main(dix, queries, f"{card} ({smi})",
                                   "standard mix", STANDARD_KERNELS)
        wout, wlaunches = phase_main(dix, wide, f"{card} ({smi})",
                                     "wide mix + alternations", WIDE_KERNELS)
        pout, planches = phase_page(dix, queries, f"{card} ({smi})")
        lap("main and page")
        prlaunches, probe_times = phase_probes(dix, f"{card} ({smi})")
        lap("probes")
        slaunches = phase_serve(
            dix, queries + wide,
            {f: np.concatenate([out[f], wout[f]]) for f in out},
            f"{card} ({smi})", rng)
        lap("serve")
        earlier = [n for n in KERNELS if n not in SERVE_KERNELS]
        times = phase_kernel_times([
            lambda: dix.search_batch_full(queries, topk=TOPK,
                                          hit_cap=HIT_CAP, use_kernels=True),
            lambda: dix.search_batch_full(wide, topk=TOPK, hit_cap=HIT_CAP,
                                          use_kernels=True),
            lambda: dix.search_batch(queries, topk=PAGE_TOPK,
                                     use_kernels=True),
        ], earlier)
        # the five kernels of the serving path, on calls of its top-k-mode
        # pass (both mixes, the escalated rows included)
        times.update(phase_kernel_times(
            [lambda: _profile_batch().serve_pass(dix, queries + wide, False)],
            SERVE_KERNELS, most=64, where="the top-k-mode serving pass"))
        # the variant slot kernels and the W = 1 kernel on the serving pass
        # the batcher sends (sort_topk=True): printed beside their
        # fused-batch times above
        phase_kernel_times(
            [lambda: _profile_batch().serve_pass(dix, queries + wide, True)],
            ("variants_and_locate_full", "union_merge_locate_full",
             "single_locate_full", "union_locate_full"), most=64,
            where="the serving pass")
        lap("kernel times")
        phase_oracle(dix, queries, out, rng, "standard mix")
        phase_oracle(dix, wide, wout, rng, "wide mix + alternations")
        phase_page_oracle(dix, queries, pout, rng)
        vocabulary = phase_vocabulary(args.seed, rng)
        lap("oracle and vocabulary")
        surf_launches = phase_surface(proto, index, dix, queries, vocabulary,
                                      disk_tmp / "idx", f"{card} ({smi})")
        del proto, vocabulary
        lap("surface")
    finally:
        shutil.rmtree(disk_tmp, ignore_errors=True)
    # BATCHER_KERNELS are the ones the requests reach at the default size
    blaunches, stream, hosts = phase_batcher(
        index, dix, f"{card} ({smi})",
        BATCHER_KERNELS if args.corpus_mb == 64 else ())
    lap("batcher")
    mblaunches = phase_mesh_batcher(
        index, stream[:BATCHER_LATER], hosts, f"{card} ({smi})",
        BATCHER_KERNELS if args.corpus_mb == 64 else ())
    lap("mesh batcher")
    phase_distributed(index, dix, f"{card} ({smi})")
    lap("distributed")
    mlaunches = phase_mesh(args.mesh_mb, args.seed, f"{card} ({smi})", rng)
    lap("mesh")
    commit, before = BEFORE
    say(f"phases (s; {commit}'s beside): " + ", ".join(
        f"{name} {t - prev:.1f} ({before.get(name, 'new')})"
        for (name, t), (_, prev) in zip(marks[1:], marks))
        + f"; in all {marks[-1][1] - marks[0][1]:.1f} "
        f"({before['in all']})")
    say(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=src, replaces=replaces,
             launches=(launches[name] + wlaunches[name] + planches[name]
                       + slaunches[name] + blaunches[name]
                       + mblaunches[name] + mlaunches[name]
                       + dlaunches[name] + prlaunches[name]
                       + surf_launches[name]),
             **dict(times[name],
                    max_abs_err=max(err[name], times[name]["max_abs_err"])))
        for name, (src, replaces, _) in KERNELS.items()] + [
        dict(name=name, route="cuda", source=src, replaces=replaces,
             launches=prlaunches[name], **probe_times[name])
        for name, (src, replaces) in PROBE_KERNELS.items()]}))
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
