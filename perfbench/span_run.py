"""One traced run of a cell with the program's own spans on: the harness's
set-up, window and check, as perfbench/run.py --trace 1 makes them, with
the port's tracing (docodo_tpu_torch utils/profiling.tracing) turned on
for exactly the window, and the window's profile read a second time by
spans.py.

    python3 perfbench/span_run.py --workload <cell> --seed <n>
                                  --seconds <s>

Prints, as its last line, run.py's result object for --trace 1 (its
per-layer metrics, device and breakdown), with besides:

- in `breakdown`, spans.breakdown's device_by_span, idle_by_span and
  waits_by_span;
- `span_metrics`: spans.metrics (compile_ms, upload_ms, launch_ms,
  gc_ms, fetch_busy_pct) and `host_s`, each program span's total and
  self seconds, calls and longest call;
- `notes`: the program's counters as window deltas, the collector's
  collections by generation, the allocator's device allocations, frees
  and retries (summed over the layout's cards) and the pinned host
  allocator's statistics at the window's edges, the staging phases
  (stage.*; with a layout, the set-up note has mesh.*), spans.shares
  (the idle seconds
  in bench.dispatch that program spans name, the device seconds they
  launched), and whether trace.read, its breakdown and every per-layer
  metric read the same after spans.read.

Earlier lines as run.py's. A configuration's layout reads as in run.py:
busy and idle seconds a card's mean over the cards, `busy_s_by_card`
beside them. It needs a CUDA card and exits with code 2 without one.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

# torch.cuda.host_memory_stats keys read at the window's edges (the
# pinned allocator's allocations, frees and microseconds in each)
PINNED = ("num_host_alloc", "num_host_free", "host_alloc_time.total",
          "host_free_time.total")


@contextlib.contextmanager
def keeping_profile(kept: list):
    """trace.read as the harness calls it, keeping each profile it
    reads."""
    from perfbench import trace

    real = trace.read

    def read(prof, *args):
        kept.append(prof)
        return real(prof, *args)

    trace.read = read
    try:
        yield
    finally:
        trace.read = real


def readings(cards) -> dict:
    """The runtime's counts that a window's deltas are taken of (the
    device allocator's summed over `cards`)."""
    import torch

    from docodo_tpu_torch.utils import profiling

    out = {"counters": profiling.counters(),
           "gc_collections": [g["collections"] for g in gc.get_stats()]}
    if cards[0].type == "cuda":
        stats = [torch.cuda.memory_stats(c) for c in cards]
        out["device_allocator"] = {k: sum(ms.get(k, 0) for ms in stats)
                                   for k in ("num_device_alloc",
                                             "num_device_free",
                                             "num_alloc_retries")}
        host = getattr(torch.cuda, "host_memory_stats", None)
        if host is not None:
            hs = host()
            out["pinned_allocator"] = {k: hs.get(k, 0) for k in PINNED}
    return out


def deltas(a: dict, b: dict) -> dict:
    """b less a, key by key (lists by position)."""
    out = {}
    for k, v in b.items():
        if isinstance(v, dict):
            out[k] = {n: x - a.get(k, {}).get(n, 0) for n, x in v.items()}
        elif isinstance(v, list):
            out[k] = [x - y for x, y in zip(v, a[k])]
    return out


def run(name: str, seed: int, seconds: float, device: str = "cuda",
        config: dict = None, params: dict = None) -> dict:
    """The result object of one traced run with the program's spans on
    (`config` and `params` as harness.run_cell takes them)."""
    from docodo_tpu_torch.utils import profiling
    from perfbench import harness, spans, trace

    spec = harness.cell(name)
    cfg = dict(spec.config, **(config or {}))
    par = dict(spec.params, **(params or {}))
    ix = harness.set_up(cfg, seed, device)
    stage = {k: v for k, v, _ in profiling.report() if k.startswith("stage.")}
    tf = harness.draw(ix, spec.mix, par, seed)
    print(json.dumps({"setup": dict(ix.notes, pool_s=tf.seconds,
                                    stage_phases_s=stage)}), flush=True)
    harness.require_window_call(ix.dix)
    edge = {}

    def on_start():
        edge["setup_s"] = time.perf_counter() - T_START
        edge["start"] = readings(ix.cards)
        profiling.tracing(True)

    kept: list = []
    try:
        with keeping_profile(kept):
            win = harness.measure(ix, tf, seconds, True, on_start=on_start)
    finally:
        profiling.tracing(False)
    edge["end"] = readings(ix.cards)
    prof = kept[-1]
    wr = harness.window_run(ix, tf, win, edge["setup_s"])
    metrics = harness.read_metrics(spec.per_layer, wr)
    bd = trace.breakdown(win.trace)
    cards = harness.card_indices(ix.cards)
    sp = spans.read(prof, cards)
    again = trace.read(prof, cards)
    unchanged = (again == win.trace and trace.breakdown(again) == bd
                 and harness.read_metrics(spec.per_layer, wr) == metrics)
    del prof, kept
    ix.dix = None
    gc.collect()
    chk = harness.check(ix, tf, win, seed)
    n_differ = int(chk["differ"].sum())
    bd.update(spans.breakdown(sp))
    return {
        "correct": bool(n_differ == 0 and chk["rows"] >= 1),
        "attempted": sum(b.rows for b in win.batches), "failed": 0,
        "metrics": metrics,
        "device": {"kind": win.card, "count": len(ix.cards),
                   "busy_s": win.trace.busy_s,
                   "window_s": win.trace.window_s,
                   "busy_s_by_card": win.trace.busy_s_by_card},
        "breakdown": bd,
        "span_metrics": dict(spans.metrics(sp), host_s={
            k: list(v) for k, v in sorted(sp.host.items(),
                                          key=lambda kv: -kv[1][0])}),
        "notes": dict(deltas(edge["start"], edge["end"]),
                      stage_phases_s=stage, batches=len(win.batches),
                      span_batches=sp.batches, device_s=sp.device_s,
                      trace_read_unchanged=unchanged,
                      **spans.shares(sp, win.trace)),
        "checks": {"rows_differing": {"value": n_differ, "limit": 0}},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("no CUDA card: the spans are read only on one",
              file=sys.stderr)
        return 2
    print(json.dumps(run(args.workload, args.seed, args.seconds)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
