"""The batch-size sweep of a cell, on the card: one set-up, then a window
at each batch size, stopping at the first that runs out of memory.

    python3 perfbench/sweep.py --workload <cell> --seed <n> --seconds <s>
        [--batches 2048 4096 8192 16384] [--queries 600000] [--trace 1]

For each batch size: the batches and queries the window completed, the
cell's metrics as its readers (metrics/<name>.py) take them from the
window, and its peak allocation beside the card's memory (the cell's
batch is the largest whose peak leaves a fifth of it free and whose
window at run_seconds completes 200 batches or more); setup_s is the
sweep's set-up and pool. The pool holds --queries queries at each size.
With --trace 1 the last size is traced too, and the reading of the
trace timed. The last window's answers are checked against the
reference. One JSON line a size.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--batches", type=int, nargs="+",
                    default=[2048, 4096, 8192, 16384])
    ap.add_argument("--queries", type=int, default=600_000)
    ap.add_argument("--trace", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    from perfbench import harness

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    spec = harness.cell(args.workload)
    t_start = time.perf_counter()
    ix = harness.set_up(spec.config, args.seed, "cuda")
    print(json.dumps({"setup": ix.notes}), flush=True)
    total = torch.cuda.get_device_properties(0).total_memory
    last = None
    for batch in args.batches:
        par = dict(spec.params, batch=batch,
                   pool_batches=max(8, -(-args.queries // batch)))
        tf = harness.draw(ix, spec.mix, par, args.seed)
        setup_s = time.perf_counter() - t_start
        try:
            win = harness.measure(ix, tf, args.seconds, False)
        except torch.cuda.OutOfMemoryError as e:
            print(json.dumps({"batch": batch, "oom": str(e)[:300]}),
                  flush=True)
            del tf
            gc.collect()
            torch.cuda.empty_cache()
            break
        metrics = harness.read_metrics(
            spec.end_to_end + spec.per_layer,
            harness.window_run(ix, tf, win, setup_s))
        print(json.dumps({
            "batch": batch, "batches": len(win.batches),
            "queries": int(sum(b.rows for b in win.batches)),
            "window_s": win.seconds,
            "metrics": {k: v["value"] for k, v in metrics.items()},
            "card_gib": total / 2**30,
            "free_share": 1 - win.peak_bytes / total,
            "wrapped": win.wrapped, "launches": win.launches}), flush=True)
        last = (tf, win, par)
        t_start = time.perf_counter()
    if last is not None and args.trace:
        tf, _, par = last
        t = time.perf_counter()
        win = harness.measure(ix, tf, args.seconds, True)
        metrics = harness.read_metrics(
            spec.per_layer, harness.window_run(ix, tf, win, 0.0))
        print(json.dumps({"traced_batch": par["batch"],
                          "trace_read_s": time.perf_counter() - t
                          - win.seconds,
                          "metrics": {k: v["value"]
                                      for k, v in metrics.items()},
                          "busy_s": win.trace.busy_s,
                          "window_s": win.trace.window_s,
                          "device_ops": win.trace.launches,
                          "ops": win.trace.ops, "idle": win.trace.idle,
                          "gaps": win.trace.gaps}), flush=True)
        last = (tf, win, par)
    if last is not None:
        tf, win, par = last
        ix.dix = None
        gc.collect()
        torch.cuda.empty_cache()
        chk = harness.check(ix, tf, win, args.seed, control=True)
        print(json.dumps({"check": {k: (int(v.sum()) if k == "differ"
                                        else v) for k, v in chk.items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
