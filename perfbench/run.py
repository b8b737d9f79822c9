"""The benchmark of docodo_tpu_torch: one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

Loads and warms up, measures for --seconds, checks the window's answers
against the plain reference (perfbench/reference/), and prints as its
last line of standard output one JSON object: correct, attempted,
failed, metrics (the cell's end-to-end metrics; with --trace 1 its
per-layer metrics, read from a torch.profiler trace of the window),
device, with --trace 1 breakdown, and last the numbers compared, each
with its limit, which also end standard error. Earlier lines: set-up
phases, the window's batches and kernel launches, the check.

It needs a CUDA card: without one, or with fewer cards than the cell
asks for, it exits with code 2 and prints no result. It also fails, and
prints no result, if JAX, the JAX package or its benchmarks were loaded,
or if the configuration's layout stages an index that has no
search_batch_full (it stops after the set-up line, naming the class).
Every build of the port stays under the checkout's build/ directory.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from perfbench import harness

    spec = harness.cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark measures only on one",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < spec.chips:
        print(f"{args.workload} needs {spec.chips} cards, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), device="cuda",
                              t_start=T_START)
    for line in harness.summary_lines(result):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
