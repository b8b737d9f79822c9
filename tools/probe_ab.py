"""The two probe kernels (csrc/probes.cu: docodo_probe_locate, PERF.md
row 18; docodo_row_gather, row 19) on several trees in one call, for
comparing two versions of them on one card.

For each ROOT, in turns first to last and back again (A B B A), a child
process imports that tree's own docodo_tpu_torch (its kernels built from
its own csrc/ into its own build/) and times, at chip_smoke.py
phase_probes' shapes, on the same inputs for every tree:

  row 18  probe_locate under each page policy (bounds, arith, two_level)
          at the TPU probe's shape (5,952 seeded rows of 128 lanes, 578
          pages of 3000) and on the 64 MB synthetic index's cap-64 W = 2
          hit-128 bucket (its real page table); the wrapper's call
  row 19  row_gather's launch (the wrapper's _gather_kernel: its host
          check of the ids stays out) in copy and sum128 at q 32 / 64 /
          128, R = 16384 x n = 2048, B = 10,000 ids (seed 5), beside
          torch.index_select, tab[ids], gather_term and one contiguous
          copy of the same bytes (the card's copy rate, no gather)

Each leg gets torch.profiler's device ms a call (per device activity
the median of its --reps durations, times its launches a call) and the
median CUDA-event ms of --reps calls
(with the host's launch), and is held equal to its plain version (ranks
within 1 ulp) in every turn. The index bucket's streams are made once,
by this tree's code, into build/probe_ab_inputs.pt. Each child's output
goes to chiprun_out/probe_ab_<turn>.log; one JSON line is printed: the
card, the bounds, per turn the tree and its legs, per tree the median of
its turns. It is a tool, not a benchmark. With --device cpu it runs
the same steps on the CPU with the plain versions and times nothing (a
rehearsal, at a small --corpus-mb).

    python3 tools/probe_ab.py [--reps N] [--corpus-mb MB] ROOT [ROOT ...]

Run it on the card from the root of a checkout (a ROOT is a tree such as
the parent commit unpacked with `git archive` into build/parent).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve()
REPO = HERE.parents[1]
INPUTS = REPO / "build" / "probe_ab_inputs.pt"
GATHER_R, GATHER_N, GATHER_B, GATHER_SEED = 16384, 2048, 10_000, 5


def gather_inputs():
    """Row 19's table int32 [R, n] and ids int32 [B] (seed 5), on the
    CPU, as probe_dma_fetch.run draws them."""
    import numpy as np
    import torch

    rng = np.random.default_rng(GATHER_SEED)
    tab = torch.from_numpy(rng.integers(0, 1 << 20, (GATHER_R, GATHER_N))
                           .astype(np.int32))
    ids = torch.from_numpy(rng.integers(0, GATHER_R, GATHER_B)
                           .astype(np.int32))
    return tab, ids


def cuda_ms(fn, reps: int):
    """Median CUDA-event ms of fn() over reps calls, after a warm-up;
    None without a card."""
    import torch

    if not torch.cuda.is_available():
        return None
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
    return statistics.median(times)


def profiled_ms(fn, reps: int):
    """Device ms a call of fn() by torch.profiler over reps calls: for
    each device activity (kernel, copy) the median of its durations times
    the times a call runs it. A median per activity, not the sum over
    reps: the profiler drops an event now and then, which a sum over
    reps reads as a faster call (one turn of a copy read 0). None
    without a card."""
    import torch
    from torch.autograd import DeviceType

    if not torch.cuda.is_available():
        return None
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    durations = {}
    for e in prof.events():
        if e.device_type != DeviceType.CPU:
            durations.setdefault(e.name, []).append(
                e.time_range.elapsed_us())
    if not durations:  # no per-event device times: the totals over reps
        return sum(float(getattr(e, "self_device_time_total", 0)
                         or getattr(e, "self_cuda_time_total", 0))
                   for e in prof.key_averages()
                   if e.device_type != DeviceType.CPU) / 1e3 / reps
    return sum(statistics.median(d) * max(1, round(len(d) / reps))
               for d in durations.values()) / 1e3


def prepare(corpus_mb: float, device: str) -> None:
    """The probe's seeded streams and the 64 MB index's cap-64 bucket,
    by this tree's code, saved for every child."""
    sys.path.insert(0, str(REPO))
    import numpy as np
    import torch

    from docodo_tpu_torch.benchmarks import common as bc
    from docodo_tpu_torch.benchmarks import probe_locate as pl

    dev = bc.device_of(device)
    rng = np.random.default_rng(0)
    probe_bounds = torch.arange(1, pl.PAGES + 1, dtype=torch.int32,
                                device=dev) * pl.PAGE_LEN
    probe = pl.probe_streams(rng, pl.ROWS, pl.CAP, pl.PAGES * pl.PAGE_LEN,
                             dev)
    dix = bc.synthetic_index(corpus_mb, 0, dev)
    index = pl.bucket_streams(dix, pl.CAP)
    INPUTS.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"probe": [x.cpu() for x in probe + (probe_bounds,)],
                "index": [x.cpu() for x in index + (dix.bounds,)]},
               INPUTS)


def _max_err(got, want) -> float:
    """The largest |g - w| over paired outputs; ranks compared in ulps
    are held to 1 by the caller."""
    return max((float((g.double() - w.double()).abs().max()) if g.numel()
                else 0.0 for g, w in zip(got, want)), default=0.0)


def _ulps(a, b) -> int:
    import torch

    ia = a.contiguous().view(torch.int32).long()
    ib = b.contiguous().view(torch.int32).long()
    return int((ia - ib).abs().max()) if a.numel() else 0


def measure(root: Path, reps: int, device: str) -> dict:
    """Every leg of the tree at `root`, in this process."""
    sys.path.insert(0, str(root))
    import torch

    from docodo_tpu_torch.ops import probe_kernels as pk
    from docodo_tpu_torch.ops.device_index import gather_term

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card; --device cpu rehearses on the CPU")
    saved = torch.load(INPUTS)
    build = build_report() if dev.type == "cuda" else {}
    legs = {}
    for shape in ("probe", "index"):
        vals, tag, ra, rb, bounds = (x.to(dev) for x in saved[shape])
        for policy in pk.POLICIES:
            def call(policy=policy):
                return pk.probe_locate(vals, tag, ra, rb, bounds,
                                       policy=policy)
            got = call()
            want = pk.probe_locate_plain(vals, tag, ra, rb, bounds,
                                         policy=policy)
            for g, w in zip(got, want):
                ok = (_ulps(g, w) <= 1 if g.dtype == torch.float32
                      else torch.equal(g, w))
                if not ok:
                    raise AssertionError(f"{root}: probe_locate {shape} "
                                         f"{policy} differs from its plain "
                                         f"version")
            legs[f"locate {shape} {policy}"] = {
                "profiler_ms": profiled_ms(call, reps),
                "ms": cuda_ms(call, reps),
                "max_abs_err": _max_err(got, want)}
    tab, ids = (x.to(dev) for x in gather_inputs())
    ids64 = ids.long()
    flat = tab.reshape(-1)
    offsets = torch.arange(GATHER_R + 1, dtype=torch.int32,
                           device=dev) * GATHER_N
    # the same bytes copied whole, one contiguous device-to-device copy:
    # what the card's copy reaches with no gather at all
    span = tab.reshape(-1)[:GATHER_B * GATHER_N]
    dst = torch.empty_like(span)
    gathers = {
        "gather index_select": lambda: torch.index_select(tab, 0, ids64),
        "gather tab[ids]": lambda: tab[ids64],
        "gather gather_term": lambda: gather_term(flat, offsets, ids,
                                                  GATHER_N)[0],
    }
    # the launch alone on the card; the plain version on the CPU
    core = pk._gather_kernel if dev.type == "cuda" else pk._gather_plain
    for mode in pk.GATHER_MODES:
        for q in pk.GATHER_Q:
            gathers[f"gather {mode} q={q}"] = (
                lambda mode=mode, q=q: core(tab, ids, mode, q))
    legs["copy contiguous"] = {
        "profiler_ms": profiled_ms(lambda: dst.copy_(span), reps),
        "ms": cuda_ms(lambda: dst.copy_(span), reps), "max_abs_err": 0.0}
    for name, fn in gathers.items():
        mode = "sum128" if "sum128" in name else "copy"
        got = fn()
        want = pk._gather_plain(tab, ids, mode, 32)
        if not torch.equal(got, want):
            raise AssertionError(f"{root}: {name} differs from the plain "
                                 f"row gather")
        legs[name] = {"profiler_ms": profiled_ms(fn, reps),
                      "ms": cuda_ms(fn, reps), "max_abs_err": 0.0}
    return {"tree": str(root), "device": (torch.cuda.get_device_name(0)
                                          if dev.type == "cuda" else "cpu"),
            "build": build, "legs": legs}


def build_report() -> dict:
    """The probe kernels' ptxas report (registers, shared memory, spills;
    when this process built the library) and their static SASS
    instruction counts."""
    from docodo_tpu_torch.ops import _cuda

    _cuda.library()
    lines = _cuda.build_log.splitlines()
    ptxas = []
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and (
                "probe_locate_kernel" in line or "row_gather_kernel" in line):
            ptxas.append(line.split("'")[1] if "'" in line else line)
            ptxas += [x.strip() for x in lines[i + 1:i + 4]
                      if "Used" in x or "spill" in x]
    out = {"ptxas": ptxas, "sass_instructions": sass_counts(_cuda)}
    print("BUILD " + json.dumps(out), flush=True)
    return out


def sass_counts(cuda) -> dict:
    """Static SASS instructions of each probe kernel in the tree's built
    library (cuobjdump -sass, beside nvcc), by its mangled name cut to
    the template; {} if cuobjdump is not found."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        text = subprocess.run([tool, "-sass", str(cuda.library_path())],
                              capture_output=True, text=True).stdout
    except OSError:
        return {}
    counts, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            k = m.group(1)
            name = (k[k.index("probe_locate_kernel"):][:60]
                    if "probe_locate_kernel" in k else
                    k[k.index("row_gather_kernel"):][:30]
                    if "row_gather_kernel" in k else None)
            if name:
                counts[name] = 0
        elif name and re.search(r"/\*[0-9a-f]{4}\*/", line):
            counts[name] += 1
    return counts


def bounds() -> dict:
    """Each leg's bound in ms (bytes at 3.35 TB/s, or the operations at
    the 32-bit rate, the larger), by this tree's formulas: row 18's
    (probe_locate.locate_bound) at each shape, row 19's
    (probe_dma_fetch.gather_bound: each distinct row read once) in each
    mode, over the ids the legs gather."""
    sys.path.insert(0, str(REPO))
    import torch

    from docodo_tpu_torch.benchmarks.probe_dma_fetch import gather_bound
    from docodo_tpu_torch.benchmarks.probe_locate import locate_bound

    saved = torch.load(INPUTS)
    ids = gather_inputs()[1]
    out = {f"locate {shape}": locate_bound(saved[shape][0],
                                           saved[shape][4])
           for shape in ("probe", "index")}
    for mode in ("copy", "sum128"):
        out[f"gather {mode}"] = gather_bound(ids, GATHER_N, mode)
    return out


def _median(xs):
    xs = [x for x in xs if x is not None]
    return statistics.median(xs) if xs else None


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--corpus-mb", type=float, default=64.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--prepare", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.prepare:
        prepare(args.corpus_mb, args.device)
        return
    if args.child:
        res = measure(Path(args.roots[0]).resolve(), args.reps, args.device)
        print("RESULT " + json.dumps(res))
        return
    if not args.roots:
        ap.error("give at least one ROOT")
    out = Path.cwd() / "chiprun_out"
    out.mkdir(exist_ok=True)
    proc = subprocess.run([sys.executable, str(HERE), "--prepare",
                           "--corpus-mb", str(args.corpus_mb), "--device",
                           args.device],
                          capture_output=True, text=True, cwd=REPO)
    (out / "probe_ab_prepare.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode:
        sys.stderr.write(proc.stderr[-4000:])
        raise SystemExit(f"preparing the inputs exited {proc.returncode}")
    roots = [str(Path(r).resolve()) for r in args.roots]
    order = roots + roots[::-1]
    turns = []
    for turn, root in enumerate(order):
        proc = subprocess.run(
            [sys.executable, str(HERE), "--child", "--reps", str(args.reps),
             "--device", args.device, root],
            capture_output=True, text=True, cwd=root)
        (out / f"probe_ab_{turn}.log").write_text(proc.stdout + proc.stderr)
        if proc.returncode:
            sys.stderr.write(proc.stderr[-4000:])
            raise SystemExit(f"turn {turn} ({root}) exited "
                             f"{proc.returncode}")
        line = [x for x in proc.stdout.splitlines()
                if x.startswith("RESULT ")][-1]
        turns.append(json.loads(line[len("RESULT "):]))
        print(f"turn {turn} {root}: " + "; ".join(
            f"{name} {leg['profiler_ms']} ms"
            for name, leg in turns[-1]["legs"].items()), flush=True)
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True).stdout
    except FileNotFoundError:  # the CPU rehearsal
        smi = "no card"
    median = {root: {name: {key: _median(
        t["legs"][name][key] for t in turns if t["tree"] == root)
        for key in ("profiler_ms", "ms")}
        for name in turns[order.index(root)]["legs"]}
        for root in roots}
    print(json.dumps({"card": smi.strip(), "bounds": bounds(),
                      "turns": turns, "median": median}))


if __name__ == "__main__":
    main()
