"""The batcher phase of chip_smoke.py, and the restage inside it, on
several trees in one call, for comparing two versions on one card.

For each ROOT, in turns first to last and back again (A B B A), a child
process imports that tree's own chip_smoke.py and runs its phase_device,
phase_build (the kernels, into the tree's build directory), phase_index
(the serving corpus, 64 MB of seed 0 by default) and phase_batcher: 64
clients through BatchExecutor in four configurations, the first with a
create() on the same documents while they are served. With --build-mb,
phase_build_scale runs before the batcher, as in chip_smoke.py, in trees
that have it. Each run reports the phase's seconds, the restage's
seconds and its span on the first configuration's clock, each
configuration's seconds and requests/s, the checks against Index.search
and the HTTP pass, and the index line. The whole output of each child
goes to chiprun_out/batcher_ab_<turn>.log; one JSON line is printed.

    python3 tools/batcher_ab.py [--corpus-mb MB] [--build-mb MB] ROOT ...

Run it on the card from the root of a checkout (a ROOT is a tree such as
the parent commit unpacked with `git archive` into build/parent).
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve()

RESTAGE = re.compile(r"restage \(create\(\) on the same documents\) from "
                     r"([\d.]+) to ([\d.]+) s")
CONFIG = re.compile(r"^batcher, pipeline=(\w+) materialize=(\w+): \d+ "
                    r"requests from \d+ clients in ([\d.]+) s, ([\d.]+) "
                    r"requests/s", re.M)
HTTP = re.compile(r"^batcher over HTTP: \d+ /search requests from \d+ "
                  r"clients in ([\d.]+) s")
CHECKS = re.compile(r"their checks against Index.search ([\d.]+) s")


def measure(root: Path, corpus_mb: float, build_mb: float) -> dict:
    """One run of the tree's batcher phase (in this process)."""
    sys.path.insert(0, str(root))
    import chip_smoke as cs

    lines = []
    say = cs.say

    def record(*parts):
        lines.append(" ".join(str(p) for p in parts))
        say(*parts)

    cs.say = record
    card, smi = cs.phase_device()
    cs.phase_build()
    t0 = time.perf_counter()
    index, dix = cs.phase_index(corpus_mb, 0)
    t_index = time.perf_counter() - t0
    scaled = build_mb > 0 and hasattr(cs, "phase_build_scale")
    if scaled:
        cs.phase_build_scale(build_mb, 0, f"{card} ({smi})")
    t1 = time.perf_counter()
    cs.phase_batcher(index, dix, f"{card} ({smi})",
                     cs.BATCHER_KERNELS if corpus_mb == 64 else ())
    t_phase = time.perf_counter() - t1
    text = "\n".join(lines)
    span = [float(x) for x in RESTAGE.search(text).groups()]
    configs = [dict(pipeline=m[0] == "True", materialize=m[1] == "True",
                    s=float(m[2]), requests_per_s=float(m[3]))
               for m in CONFIG.findall("\n".join(
                   ln for ln in lines if ln.startswith("batcher, ")))]
    http = [float(HTTP.match(ln).group(1)) for ln in lines
            if HTTP.match(ln)]
    checks = CHECKS.search(text)
    return dict(root=str(root), card=smi, phase_s=t_phase,
                index_phase_s=t_index, build_scale_before=scaled,
                restage_s=span[1] - span[0], restage_span=span,
                configs=configs, http_s=http[0] if http else None,
                checks_s=float(checks.group(1)) if checks else None,
                index_line=next(ln for ln in lines
                                if ln.startswith("index: ")))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="+", type=Path)
    ap.add_argument("--corpus-mb", type=float, default=64.0)
    ap.add_argument("--build-mb", type=float, default=0.0)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(measure(args.roots[0].resolve(), args.corpus_mb,
                                 args.build_mb)), flush=True)
        return
    out_dir = Path("chiprun_out")
    out_dir.mkdir(exist_ok=True)
    roots = [r.resolve() for r in args.roots]
    runs = []
    for turn, root in enumerate(roots + roots[::-1] if len(roots) > 1
                                else roots):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(HERE), "--child", str(root),
             "--corpus-mb", str(args.corpus_mb), "--build-mb",
             str(args.build_mb)], capture_output=True, text=True,
            cwd=root)
        (out_dir / f"batcher_ab_{turn}.log").write_text(
            proc.stdout + proc.stderr)
        if proc.returncode:
            raise SystemExit(f"batcher_ab on {root} failed:\n"
                             f"{proc.stdout[-4000:]}{proc.stderr[-4000:]}")
        run = json.loads(proc.stdout.strip().splitlines()[-1])
        run["child_s"] = time.perf_counter() - t0
        runs.append(run)
        print(f"turn {turn} {root}: batcher phase {run['phase_s']:.1f} s, "
              f"restage {run['restage_s']:.2f} s", flush=True)
    print(json.dumps({"turns": [r["root"] for r in runs], "runs": runs}),
          flush=True)


if __name__ == "__main__":
    main()
