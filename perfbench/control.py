"""The control of a cell's check, on the card at the cell's own size: a
short window at the cell's load on each seed, then the same sampled rows
judged twice against the reference, once as the program answered them
and once as the control answers them, the reference itself with its
ranks and document sums in bfloat16, one precision below the float32
that the configurations state. The control has to come out not correct
(rows differing > 0) on every seed; the program's rows differing are
the lower readings beside it. The benchmark's own runs never run this.

    python3 perfbench/control.py --workload <cell> --seconds 10
                                 --seeds 11 12 13
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)

    import torch

    from perfbench import harness

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    readings = []
    for seed in args.seeds:
        res = harness.run_cell(args.workload, seed, args.seconds, False,
                               control=True, note=lambda d: None)
        readings.append(dict(res["control"], seed=seed,
                             correct=res["correct"]))
        print(json.dumps(readings[-1]), flush=True)
    print(json.dumps({
        "workload": args.workload,
        "program_max": max(r["program_rows_differing"] for r in readings),
        "control_min": min(r["control_rows_differing"] for r in readings),
        "seeds": len(readings)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
