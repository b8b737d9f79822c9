"""Where the time of one batch goes: docodo_tpu_torch's
search_batch_full (--leg full: topk 64, hit_cap 1024) over the standard
10k mix or the wide 10k mix (benchmarks/common.wide_mix, seed 77, as
bench.py serves it), or its page-level search_batch (--leg page: topk
16, the standard mix), on a seeded Zipf corpus (the corpus and mixes of
chip_smoke.py), on the kernel route and the plain (torch) route. With
--leg serve the mix goes through search_batch_full in the shape a server
sends it (batcher.py:701-768): waves of 512 rows, fused=False, the cap
ladder, deferred=True with one wave in flight while the next is
dispatched, then the truncated rows of cap <= 2048 once more at the
escalated budgets (topk 2048, hit_cap 8192, clamp_budgets=True); its two
routes are sort_topk True (each bucket's first-topk runs, then the torch
tail) and False (the top-k-mode kernels).

    python3 tools/profile_batch.py [--leg full|page|serve]
                                   [--mix standard|wide]
                                   [--corpus-mb 64] [--seed 0] [--out FILE]
                                   [--trace-dir DIR]

Prints, per route:
  - the whole batch and its phases over RUNS warm runs, the routes
    alternating (median, min, max, ms on the host clock): bucketing
    (query compile and bucket arrays), dispatch (every bucket enqueued),
    drain (the device finishing after dispatch), readback (device to
    numpy and the scatter into the result);
  - each bucket alone with a synchronise around it: cap, words,
    variants, rows, the route that served it (a slot kernel, the chunked
    kernels or the plain route; on the page leg a page-level kernel or
    the torch route), ms;
  - one batch under torch.profiler: device time, profiled wall, busy
    share, the largest device items and each CUDA kernel's device time.
The phase split synchronises once, after dispatch, so a batch reads a
little slower than unsplit. The last line is one JSON object with all of
it, also written to --out. The serve leg prints per route the pass and
its per-wave medians instead (the whole deferred call, the part of it
inside the buckets' launches, finish), buckets and kernel launches per
wave, the escalated pass, and the profiler's figures. --trace-dir writes
one more batch a route as a Chrome trace there. Imports no jax.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from docodo_tpu_torch.mix import (  # noqa: E402
    mix_queries,
    standard_mix,
    wide_mix,
)
from docodo_tpu_torch.ops import device_index as tdi  # noqa: E402
from docodo_tpu_torch.synthetic import build_index, zipf_documents  # noqa: E402
from docodo_tpu_torch.utils import profiling  # noqa: E402

TOPK = 64
HIT_CAP = 1024
PAGE_TOPK = 16  # bench.py:41
N_QUERIES = 10_000
RUNS = 5
ROUTES = {"kernel": True, "plain": False}
# each CUDA kernel's name in the profiler's device events (the keep
# kernels launch two each); the W = 1 kernel is one template on its keep
# rule and its tail (rows 2, 3 at V = 1, 14, 15c at V = 1 and 15d)
W1 = "w1_locate_full_kernel<docodo::"
KERNEL_NAMES = {"sorted_and_locate_full": "sorted_and_locate_full_kernel",
                "single_locate_full": W1 + "SingleKeep, docodo::SlotsTail",
                "union_locate_full": W1 + "UnionKeep, docodo::SlotsTail",
                "merge_and_locate_topk": "merge_and_locate_topk_kernel",
                "merge_tagged": ("merge_pass_kernel", "merge_row_kernel"),
                "and_keep": ("keep_marks_kernel<false>",
                             "keep_resolve_kernel<false>"),
                "locate_runs": "locate_runs_kernel",
                "variants_and_locate_full": "variants_and_locate_full_kernel",
                "union_merge_locate_full": "union_merge_locate_full_kernel",
                "variants_keep": ("keep_marks_kernel<true>",
                                  "keep_resolve_kernel<true>"),
                "and_locate_topk": (
                    "sorted_and_locate_full_kernel<docodo::PageTopkTail"),
                "single_locate_topk": W1 + "SingleKeep, docodo::PageTopkTail",
                "merge_and_locate": "merge_and_locate_kernel",
                "single_locate_full_topk": W1 + "SingleKeep, docodo::TopkTail",
                "fetch_postings": "fetch_postings_kernel"}
# the other slot kernels are one template each, instantiated for both
# tails (the W = 2 one also for the page-level tail, and for four stream
# widths after the tail)
for _name in ("sorted_and_locate_full", "variants_and_locate_full",
              "union_merge_locate_full"):
    _fn = KERNEL_NAMES[_name]
    KERNEL_NAMES[_name] = _fn + "<docodo::SlotsTail"
    KERNEL_NAMES[_name.replace("union_merge", "union") + "_topk"] = (
        _fn + "<docodo::TopkTail")
# the V = 1 union's top-k form runs the W = 1 body
KERNEL_NAMES["union_locate_full_topk"] = (
    KERNEL_NAMES["union_locate_full_topk"], W1 + "UnionKeep, docodo::TopkTail")
WIDE_SEED = 77  # bench.py:353


def card() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return smi.splitlines()[0]


# the shape a server sends (batcher.py:399, :606-612, :746)
SERVE_WAVE = 512
CAP_LADDER = (128, 1024, 16384, 1 << 17)
ESC_TOPK = 2048
ESC_HIT_CAP = 1 << 13
ESC_CAP_MAX = 2048
SERVE_ROUTES = {"slot tail": True, "kernel top-k": False}


def serve_waves(dix, queries, *, topk: int, hit_cap: int,
                sort_topk: bool = True, clamp: bool = False,
                wave: int = SERVE_WAVE):
    """`queries` in waves of `wave` rows through search_batch_full as a
    server sends them: fused=False, the cap ladder, deferred=True, each
    wave's finish() called after the next wave is dispatched. Returns
    (the waves' results joined, one dict per wave: rows, buckets, their
    shapes as "cap W V rows topk hit_cap", the buckets served by the
    plain route as (W, V) pairs, kernel launches,
    call_ms for the deferred call, launch_ms for the part of it inside
    batched_query_full, finish_ms; the pass's seconds)."""
    from docodo_tpu_torch.ops import _cuda

    stats, outs = [], []
    inner, plain_inner = tdi.batched_query_full, tdi.query_step_full
    cur = {}

    def bucket(*a, **k):
        t0 = time.perf_counter()
        out = inner(*a, **k)
        cur["launch_ms"] += (time.perf_counter() - t0) * 1e3
        cur["buckets"] += 1
        tq = a[5]
        cur["shapes"].append(f"{k['cap']} {tq.shape[1]} {tdi._variants(tq)} "
                             f"{tq.shape[0]} {k['topk']} {k['hit_cap']}")
        return out

    def plain(*a, **k):
        tq = a[5]
        cur["plain"].append((int(tq.shape[1]), tdi._variants(tq)))
        return plain_inner(*a, **k)

    def launches():
        return sum(k.launches for k in _cuda.KERNELS.values())

    def finish_last(pending):
        t0 = time.perf_counter()
        outs.append(pending())
        stats[-1]["finish_ms"] = (time.perf_counter() - t0) * 1e3

    tdi.batched_query_full, tdi.query_step_full = bucket, plain
    try:
        pending = None
        start = time.perf_counter()
        for lo in range(0, len(queries), wave):
            rows = queries[lo: lo + wave]
            cur = {"rows": len(rows), "buckets": 0, "plain": [],
                   "shapes": [], "launch_ms": 0.0}
            before = launches()
            t0 = time.perf_counter()
            finish = dix.search_batch_full(
                rows, topk=topk, hit_cap=hit_cap, cap_ladder=CAP_LADDER,
                fused=False, deferred=True, clamp_budgets=clamp,
                sort_topk=sort_topk)
            cur["call_ms"] = (time.perf_counter() - t0) * 1e3
            cur["launches"] = launches() - before
            if pending is not None:
                finish_last(pending)
            stats.append(cur)
            pending = finish
        if pending is not None:
            finish_last(pending)
        secs = time.perf_counter() - start
    finally:
        tdi.batched_query_full, tdi.query_step_full = inner, plain_inner
    joined = {k: np.concatenate([o[k] for o in outs]) for k in outs[0]} \
        if outs else {}
    return joined, stats, secs


def serve_pass(dix, queries, sort_topk: bool, topk: int = TOPK,
               hit_cap: int = HIT_CAP) -> dict:
    """The serving path once: every wave at the normal budgets, then the
    truncated rows whose longest list is within ESC_CAP_MAX once more at
    the escalated budgets. Returns out / stats / secs of the first pass,
    esc_rows (indices into `queries`) and esc_out / esc_stats / esc_secs
    of the second."""
    out, stats, secs = serve_waves(dix, queries, topk=topk, hit_cap=hit_cap,
                                   sort_topk=sort_topk)
    cut = np.flatnonzero((out["n_pages"] > topk) | (out["n_hits"] > hit_cap))
    esc_rows = [int(i) for i in cut
                if dix.compile_group_query(queries[i])[4] <= ESC_CAP_MAX]
    esc_out, esc_stats, esc_secs = serve_waves(
        dix, [queries[i] for i in esc_rows], topk=ESC_TOPK,
        hit_cap=ESC_HIT_CAP, sort_topk=sort_topk, clamp=True)
    return dict(out=out, stats=stats, secs=secs, truncated=int(cut.size),
                esc_rows=esc_rows, esc_out=esc_out, esc_stats=esc_stats,
                esc_secs=esc_secs)


def still_truncated(esc_out) -> int:
    """Escalated rows that overflow their clamped budgets too."""
    if not esc_out:
        return 0
    return int(((esc_out["n_pages"] > esc_out["topk_eff"])
                | (esc_out["n_hits"] > esc_out["hit_cap_eff"])).sum())


def shape_counts(stats) -> dict:
    """How many buckets of each "cap W V rows topk hit_cap" a pass
    launched."""
    counts: dict = {}
    for s in stats:
        for shape in s["shapes"]:
            counts[shape] = counts.get(shape, 0) + 1
    return dict(sorted(counts.items(),
                       key=lambda kv: [int(x) for x in kv[0].split()]))


def wave_medians(stats) -> dict:
    keys = ("rows", "buckets", "launches", "call_ms", "launch_ms",
            "finish_ms")
    return {k: statistics.median(s[k] for s in stats) for k in keys} \
        if stats else {}


def run_batch(dix, queries, use_kernels: bool, leg: str):
    if leg == "serve":  # the route is the sort_topk mode
        return serve_pass(dix, queries, use_kernels)
    if leg == "page":
        return dix.search_batch(queries, topk=PAGE_TOPK,
                                use_kernels=use_kernels)
    return dix.search_batch_full(queries, topk=TOPK, hit_cap=HIT_CAP,
                                 use_kernels=use_kernels)


DISPATCHERS = {"full": "multi_bucket_query_full",
               "page": "multi_bucket_query_step"}


def phased_batch(dix, queries, use_kernels: bool, leg: str) -> dict:
    """One batch, its host clock split at the entry and exit of the
    leg's dispatcher (multi_bucket_query_full or _step), with a
    synchronise after dispatch."""
    marks = {}
    name = DISPATCHERS[leg]
    inner = getattr(tdi, name)

    def timed(*a, **k):
        marks["enter"] = time.perf_counter()
        outs = inner(*a, **k)
        marks["dispatched"] = time.perf_counter()
        torch.cuda.synchronize()
        marks["drained"] = time.perf_counter()
        return outs

    setattr(tdi, name, timed)
    try:
        t0 = time.perf_counter()
        run_batch(dix, queries, use_kernels, leg)
        t1 = time.perf_counter()
    finally:
        setattr(tdi, name, inner)
    ms = lambda a, b: (b - a) * 1e3
    return {"batch": ms(t0, t1), "bucketing": ms(t0, marks["enter"]),
            "dispatch": ms(marks["enter"], marks["dispatched"]),
            "drain": ms(marks["dispatched"], marks["drained"]),
            "readback": ms(marks["drained"], t1)}


def bucket_times(dix, queries, use_kernels: bool) -> list:
    """Each bucket of one batch with a synchronise before and after."""
    rows = []
    inner = tdi._bucket_full
    chunked_inner = tdi._chunked_bucket_full
    chunked = []

    def chunk_seen(*a, **k):
        out = chunked_inner(*a, **k)
        chunked.append(out is not None)
        return out

    def timed(*a, **k):
        chunked.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(*a, **k)
        torch.cuda.synchronize()
        tq = a[5]
        route = ("plain" if not isinstance(out, tdi.PreFull)
                 else "chunked" if any(chunked) else "slot")
        rows.append({"cap": k["cap"], "words": int(tq.shape[1]),
                     "variants": int(tq.shape[2]) if tq.dim() == 3 else 1,
                     "rows": int(tq.shape[0]), "route": route,
                     "ms": (time.perf_counter() - t0) * 1e3})
        return out

    tdi._bucket_full = timed
    tdi._chunked_bucket_full = chunk_seen
    try:
        dix.search_batch_full(queries, topk=TOPK, hit_cap=HIT_CAP,
                              use_kernels=use_kernels)
    finally:
        tdi._bucket_full = inner
        tdi._chunked_bucket_full = chunked_inner
    return rows


def page_bucket_times(dix, queries, use_kernels: bool) -> list:
    """Each bucket of one page-level batch with a synchronise before
    and after: the page-level kernels' buckets and the torch route's."""
    rows = []
    routes = {"kernel": "_kernel_bucket", "torch": "query_step"}
    saved = {route: getattr(tdi, fn) for route, fn in routes.items()}

    def timed(route):
        def call(term_offsets, coords, bounds, *a, **k):
            # _kernel_bucket(.., tq, rq, cap, ..); query_step(.., page_doc,
            # terms, rs, cap, ..)
            tq, cap = (a[0], a[2]) if route == "kernel" else (a[1], a[3])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = saved[route](term_offsets, coords, bounds, *a, **k)
            torch.cuda.synchronize()
            rows.append({"cap": int(cap), "words": int(tq.shape[1]),
                         "variants": 1, "rows": int(tq.shape[0]),
                         "route": route,
                         "ms": (time.perf_counter() - t0) * 1e3})
            return out
        return call

    for route, fn in routes.items():
        setattr(tdi, fn, timed(route))
    try:
        run_batch(dix, queries, use_kernels, "page")
    finally:
        for route, fn in routes.items():
            setattr(tdi, fn, saved[route])
    return rows


def profiled_batch(dix, queries, use_kernels: bool, leg: str,
                   top: int = 8, trace_dir=None, label: str = "") -> dict:
    """One batch under torch.profiler: summed device time of every
    kernel and copy against the profiled wall. Only device-side events
    count: a host op carries the device time of what it launched. With
    trace_dir, one more batch is traced (profiling.device_trace) into
    the Chrome trace `<trace_dir>/<label>.json`, the batch a span of its
    own (`batch.<leg>`; the measured batch has no span, since the
    profiler counts a span's device time as an item of its own)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run_batch(dix, queries, use_kernels, leg)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    with profiling.device_trace(label, trace_dir):
        with profiling.annotate(f"batch.{leg}"):
            run_batch(dix, queries, use_kernels, leg)

    def dev_us(e):
        return float(getattr(e, "self_device_time_total", None)
                     or getattr(e, "self_cuda_time_total", 0.0) or 0.0)

    items = sorted(((dev_us(e), e.count, e.key)
                    for e in prof.key_averages()
                    if e.device_type != DeviceType.CPU and dev_us(e) > 0),
                   reverse=True)
    device_ms = sum(us for us, _, _ in items) / 1e3
    kernels = {name: sum(us for us, _, k in items
                         if any(f in k for f in ((fn,) if isinstance(fn, str)
                                                 else fn))) / 1e3
               for name, fn in KERNEL_NAMES.items()}
    return {"device_ms": device_ms, "wall_ms": wall,
            "busy_share": device_ms / wall,
            "top": [{"name": k[:80], "calls": n, "ms": us / 1e3}
                    for us, n, k in items[:top]],
            "kernels_ms": kernels}


def summarize(runs: list) -> dict:
    return {key: {"median": statistics.median(r[key] for r in runs),
                  "min": min(r[key] for r in runs),
                  "max": max(r[key] for r in runs)}
            for key in runs[0]}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--leg", choices=("full", "page", "serve"),
                    default="full")
    ap.add_argument("--mix", choices=("standard", "wide"),
                    default="standard")
    ap.add_argument("--corpus-mb", type=float, default=64.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--trace-dir", default=None,
                    help="write a Chrome trace of one batch a route here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_batch: no CUDA device")
    if args.leg == "page" and args.mix != "standard":
        raise SystemExit("profile_batch: the page leg serves V = 1 rows: "
                         "--mix standard")
    leg = args.leg
    smi = card()

    docs = zipf_documents(int(args.corpus_mb * 1e6), seed=args.seed)
    dix = tdi.DeviceIndex.from_index(build_index(docs))
    counts = np.diff(dix.offsets_np)
    if args.mix == "wide":
        terms, rs, _ = wide_mix(counts, dix.terms, N_QUERIES, seed=WIDE_SEED)
    else:
        terms, rs = standard_mix(counts, dix.terms, N_QUERIES)
    queries = mix_queries(terms, rs, dix.terms)
    print(f"{args.corpus_mb:g} MB seed {args.seed}: {dix.bounds.numel()} "
          f"pages, {dix.coords.numel()} postings, {args.mix} mix of "
          f"{len(queries)} queries, {leg} leg; {smi}", flush=True)

    report = {"card": smi, "leg": leg, "mix": args.mix,
              "corpus_mb": args.corpus_mb,
              "seed": args.seed, "runs": RUNS, "routes": {}}
    if leg == "serve":
        serve_report(dix, queries, report, smi, args.trace_dir)
        return finish_report(report, args.out)
    for use in ROUTES.values():  # warm both routes
        run_batch(dix, queries, use, leg)
    phased = {name: [] for name in ROUTES}
    for i in range(RUNS):
        order = list(ROUTES) if i % 2 == 0 else list(ROUTES)[::-1]
        for name in order:
            phased[name].append(phased_batch(dix, queries, ROUTES[name],
                                             leg))
    for name, use in ROUTES.items():
        timer = page_bucket_times if leg == "page" else bucket_times
        rep = {"phases_ms": summarize(phased[name]),
               "buckets": timer(dix, queries, use),
               "profile": profiled_batch(
                   dix, queries, use, leg, trace_dir=args.trace_dir,
                   label=f"{leg}_{args.mix}_{name}")}
        report["routes"][name] = rep
        print(f"== {name} route ({smi})")
        for key, v in rep["phases_ms"].items():
            print(f"  {key:9s} median {v['median']:9.3f} ms "
                  f"(min {v['min']:.3f}, max {v['max']:.3f})")
        for b in rep["buckets"]:
            print(f"  bucket cap {b['cap']:8d} W={b['words']} "
                  f"V={b['variants']} rows "
                  f"{b['rows']:5d} {b['route']:7s} {b['ms']:9.3f} ms")
        p = rep["profile"]
        print(f"  profiler: device {p['device_ms']:.3f} ms of "
              f"{p['wall_ms']:.3f} ms wall, busy share "
              f"{p['busy_share']:.3f}")
        for t in p["top"]:
            print(f"    {t['ms']:9.3f} ms {t['calls']:6d}x {t['name']}")
        for k, ms in p["kernels_ms"].items():
            print(f"    kernel {k}: {ms:.3f} ms of device time")
    finish_report(report, args.out)


def finish_report(report: dict, out) -> None:
    line = json.dumps(report)
    if out:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        Path(out).write_text(line + "\n")
    print(line)


def serve_report(dix, queries, report: dict, smi: str,
                 trace_dir=None) -> None:
    """The serve leg: RUNS passes per sort_topk mode, alternating, and
    one profiled pass each."""
    for st in SERVE_ROUTES.values():  # warm both modes
        serve_pass(dix, queries, st)
    passes = {name: [] for name in SERVE_ROUTES}
    for i in range(RUNS):
        order = list(SERVE_ROUTES) if i % 2 == 0 else list(SERVE_ROUTES)[::-1]
        for name in order:
            passes[name].append(serve_pass(dix, queries, SERVE_ROUTES[name]))
    for name, st in SERVE_ROUTES.items():
        runs = passes[name]
        last = runs[-1]
        per_run = [dict(pass_ms=r["secs"] * 1e3,
                        qps=len(queries) / r["secs"],
                        esc_pass_ms=r["esc_secs"] * 1e3,
                        **{"wave_" + k: v
                           for k, v in wave_medians(r["stats"]).items()},
                        **{"esc_wave_" + k: v
                           for k, v in wave_medians(r["esc_stats"]).items()})
                   for r in runs]
        rep = {"phases_ms": summarize(per_run),
               "waves": len(last["stats"]),
               "buckets": sum(s["buckets"] for s in last["stats"]),
               "launches": sum(s["launches"] for s in last["stats"]),
               "plain_buckets": sum(len(s["plain"]) for s in last["stats"]
                                    + last["esc_stats"]),
               "truncated": last["truncated"],
               "escalated": len(last["esc_rows"]),
               "esc_waves": len(last["esc_stats"]),
               "esc_buckets": sum(s["buckets"] for s in last["esc_stats"]),
               "still_truncated": still_truncated(last["esc_out"]),
               "bucket_shapes": shape_counts(last["stats"]),
               "esc_bucket_shapes": shape_counts(last["esc_stats"]),
               "profile": profiled_batch(
                   dix, queries, st, "serve", trace_dir=trace_dir,
                   label=f"serve_{name.replace(' ', '_')}")}
        report["routes"][name] = rep
        print(f"== serving path, {name} (sort_topk={st}) ({smi})")
        for key in ("waves", "buckets", "launches", "plain_buckets",
                    "truncated", "escalated", "esc_waves", "esc_buckets",
                    "still_truncated"):
            print(f"  {key:16s} {rep[key]}")
        for key, v in rep["phases_ms"].items():
            print(f"  {key:22s} median {v['median']:10.3f} "
                  f"(min {v['min']:.3f}, max {v['max']:.3f})")
        for key in ("bucket_shapes", "esc_bucket_shapes"):
            print(f"  {key} (cap W V rows topk hit_cap: buckets): {rep[key]}")
        p = rep["profile"]
        print(f"  profiler: device {p['device_ms']:.3f} ms of "
              f"{p['wall_ms']:.3f} ms wall, busy share "
              f"{p['busy_share']:.3f}")
        for t in p["top"]:
            print(f"    {t['ms']:9.3f} ms {t['calls']:6d}x {t['name']}")
        for k, ms in p["kernels_ms"].items():
            if ms:
                print(f"    kernel {k}: {ms:.3f} ms of device time")


if __name__ == "__main__":
    main()
