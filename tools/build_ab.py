"""The port's in-memory build, `build_index`, at 1 GB on several trees in
one call, for comparing two versions of the build on one card.

For each ROOT, in turns first to last and back again (A B B A), a child
process imports that tree's own docodo_tpu_torch, makes the documents
chip_smoke.py's phase_build_scale makes (zipf_documents(build_mb MB,
seed), untimed), builds a 1 MB corpus once to warm the native library
and the card, then times `build_index(ListDataSource("synth", docs))`
--builds times, each with its profiling phases. Each child's output goes
to chiprun_out/build_ab_<turn>.log; one JSON line is printed: per turn
the tree, the build seconds, MB/s and phases, and per tree the median
MB/s.

    python3 tools/build_ab.py [--build-mb MB] [--builds N] ROOT ...

Run it on the card from the root of a checkout (a ROOT is a tree such as
the parent commit unpacked with `git archive` into build/parent).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve()


def measure(root: Path, build_mb: float, seed: int, builds: int) -> dict:
    """`builds` timed runs of the tree's build_index (in this process)."""
    sys.path.insert(0, str(root))
    import torch

    from docodo_tpu_torch.index import ListDataSource, build_index
    from docodo_tpu_torch.synthetic import zipf_documents
    from docodo_tpu_torch.utils import profiling

    build_index(ListDataSource("warm", zipf_documents(1_000_000, seed=1)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    docs = zipf_documents(int(build_mb * 1e6), seed=seed)
    corpus_s = time.perf_counter() - t0
    mb = sum(len(p.text) for d in docs for p in d.pages) / 1e6
    runs = []
    for _ in range(builds):
        profiling.reset()
        t0 = time.perf_counter()
        built = build_index(ListDataSource("synth", docs))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        runs.append({"s": secs, "mb_s": mb / secs,
                     "postings": int(built.arr.coords.size),
                     "phases": {name: sec for name, sec, _
                                in profiling.report()}})
        del built
    return {"tree": str(root), "mb": mb, "corpus_s": corpus_s,
            "runs": runs}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--build-mb", type=float, default=1000.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--builds", type=int, default=2)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        res = measure(Path(args.roots[0]).resolve(), args.build_mb,
                      args.seed, args.builds)
        print("RESULT " + json.dumps(res))
        return
    roots = [str(Path(r).resolve()) for r in args.roots]
    order = roots + roots[::-1]
    out = Path.cwd() / "chiprun_out"
    out.mkdir(exist_ok=True)
    turns = []
    for turn, root in enumerate(order):
        proc = subprocess.run(
            [sys.executable, str(HERE), "--child", "--build-mb",
             str(args.build_mb), "--seed", str(args.seed), "--builds",
             str(args.builds), root],
            capture_output=True, text=True, cwd=root)
        (out / f"build_ab_{turn}.log").write_text(proc.stdout + proc.stderr)
        if proc.returncode:
            sys.stderr.write(proc.stderr[-4000:])
            raise SystemExit(f"turn {turn} ({root}) exited "
                             f"{proc.returncode}")
        line = [x for x in proc.stdout.splitlines()
                if x.startswith("RESULT ")][-1]
        turns.append(json.loads(line[len("RESULT "):]))
        print(f"turn {turn} {root}: "
              + ", ".join(f"{r['s']:.2f} s ({r['mb_s']:.1f} MB/s)"
                          for r in turns[-1]["runs"]), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    median = {root: statistics.median(r["mb_s"] for t in turns
                                      if t["tree"] == root
                                      for r in t["runs"])
              for root in roots}
    print(json.dumps({"card": smi.strip(), "turns": turns,
                      "median_mb_s": median}))


if __name__ == "__main__":
    main()
