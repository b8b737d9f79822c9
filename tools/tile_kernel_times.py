"""Device time of kernels at the main path's bucket shapes, and the host
time of a wrapper call, on seeded chip_smoke.py inputs:

- the tiled kernels (and_keep, its compacted form, locate_runs with
  carried and looked-up pages, variants_keep);
- merge_tagged at the W = 2 buckets (8, 262144) and (8, 32768), the
  V 4+4 buckets at caps 32768, 2048, 1024 and 256 (8, 16, 32 and 128
  rows) and a W = 3 fold step (a running stream of 65536 lanes and the
  next word's block of 32768), with the device time of torch.sort on
  the same inputs (merge_tagged's library call: a stable sort of the
  packed key coord << 2 | tag);
- the W = 2 slot kernel (sorted_and_locate_full, and its top-k-mode form
  sorted_and_locate_full_topk) at the page-level batch's W = 2 buckets,
  cap 64 x 8192, 128 x 1024, 256 x 512 and 512 x 512 rows;
- the host microseconds of one call of merge_tagged and of
  sorted_and_locate_full at 8 rows of cap 64, where the card waits on
  the host (the least of 9 means over 100 calls).

A device time is the mean of one call over 20, from torch.profiler's
device events; beside the merge and slot shapes, their bytes bound
(chip_smoke.py's, at 3.35 TB/s). With --batch, also merge_tagged on the wide batch's own
calls (chip_smoke.py's 64 MB corpus, the wide mix and its alternations,
kernel route), grouped by the blocks' shapes and rows: calls and device
ms of all of them once.

    python3 tools/tile_kernel_times.py [--batch] [ROOT ...]

One ROOT (default: this checkout) is the tree whose docodo_tpu_torch and
chip_smoke.py are imported; prints one JSON line. With two or more, the
script runs itself on each ROOT in turns, first to last and back again
(A B B A), each run in a child process with its own tree's build, and
prints one JSON line holding every run: the way to compare trees that
differ in a kernel in one call on one card. A ROOT's query_kernels must
have as_variant_blocks. Needs a CUDA card.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve()
REPS = 20
HOST_CALLS = 100
HOST_REPS = 9
TILED = ("keep_marks_kernel", "keep_resolve_kernel", "locate_runs_kernel")
MERGE = ("merge_tagged_kernel", "merge_pass_kernel", "merge_row_kernel")
SLOT = ("sorted_and_locate_full_kernel",)
# (rows, cap) of W = 2 buckets: a wide bucket at the largest cap, a few
# rows at cap 32768, and many-row buckets within one tile
W2_SHAPES = ((8, 262144), (8, 32768), (64, 2048), (1024, 1024))
# (Va, Vb, cap, rows) of variant buckets
VARIANT_SHAPES = ((4, 4, 32768, 8), (4, 4, 512, 128))
# (cap, rows) of the W = 2 slot kernel's buckets
SLOT_SHAPES = ((64, 8192), (128, 1024), (256, 512), (512, 512))


def device_ms(fn, names=None) -> float:
    """Device ms of one fn() in the kernels whose names contain one of
    `names` (every device event without), over REPS calls."""
    import torch
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    us = sum(float(getattr(e, "self_device_time_total", 0)
                   or getattr(e, "self_cuda_time_total", 0))
             for e in prof.key_averages()
             if e.device_type != DeviceType.CPU
             and (names is None or any(k in e.key for k in names)))
    return us / 1e3 / REPS


def bound_ms(cs, name: str, core_args) -> float:
    """chip_smoke.py's bytes bound of a kernel core's call: each input lane
    it needs read once, each output written once, over HBM_BYTES_PER_S."""
    return cs._bytes_moved(name, core_args) / cs.HBM_BYTES_PER_S * 1e3


def host_us(fn) -> float:
    """Host microseconds of one fn(): the least mean over HOST_REPS runs
    of HOST_CALLS calls in a row (the host is shared; its least is the
    code's cost)."""
    import torch

    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(HOST_REPS):
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            fn()
        best = min(best, (time.perf_counter() - t0) / HOST_CALLS * 1e6)
        torch.cuda.synchronize()
    return best


def batch_merges(cs, qk) -> dict:
    """merge_tagged's calls in the wide batch, replayed by shape: the
    calls of each shape and their device ms, all of them once."""
    import contextlib
    import io

    import torch

    with contextlib.redirect_stdout(io.StringIO()):
        dix = cs.phase_index(64.0, 0)
    wide = cs._wide_queries(dix, cs.N_QUERIES, cs.N_ALTERNATIONS)
    groups = {}
    core = qk._merge_tagged_kernel

    def rec(*args):
        a, b = args[0], args[3]
        key = (f"merge_tagged wide batch B{a.shape[0]} a{tuple(a.shape[1:])}"
               f" b{tuple(b.shape[1:])} paged {args[1] is not None}")
        groups.setdefault(key, []).append(args)
        return core(*args)

    qk._merge_tagged_kernel = rec
    try:
        dix.search_batch_full(wide, topk=64, hit_cap=1024, use_kernels=True)
    finally:
        qk._merge_tagged_kernel = core
    torch.cuda.synchronize()
    return {key: [len(calls), device_ms(
        lambda calls=calls: [core(*a) for a in calls], MERGE)]
        for key, calls in sorted(groups.items())}


def measure(root: Path, batch: bool = False) -> dict:
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    import chip_smoke as cs
    from docodo_tpu_torch.ops import _cuda
    from docodo_tpu_torch.ops import query_kernels as qk

    if not torch.cuda.is_available():
        raise SystemExit("tile_kernel_times: no CUDA device")
    if not Path(qk.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"imported {qk.__file__}, not from {root}")
    _cuda.build()
    _cuda.library()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    out = {"root": str(root), "card": smi.splitlines()[0],
           "ptxas": [ln.strip() for ln in _cuda.build_log.splitlines()
                     if "registers" in ln or "Compiling entry" in ln]}
    for rows, cap in W2_SHAPES:
        x = cs._parity_inputs(rng, rows, cap, dev, full_first=rows < 8)
        vals, tag, pg = qk.merge_tagged(x["a"], x["na"], x["b"], x["nb"],
                                        x["a_pg"], x["b_pg"])
        ra, rb, bounds = x["ra"], x["rb"], x["bounds"]
        hv = qk.and_keep(vals, tag, ra, rb)
        key = f"W2 B{rows} n{2 * cap}"
        out[key + " and_keep"] = device_ms(
            lambda: qk.and_keep(vals, tag, ra, rb), TILED)
        out[key + " and_keep_compact"] = device_ms(
            lambda: qk.and_keep_compact(vals, tag, ra, rb, pg), TILED)
        for label, p in (("carried", pg), ("bounds", None)):
            out[f"{key} locate_runs {label}"] = device_ms(
                lambda: qk.locate_runs(hv, bounds, topk=64, hit_cap=1024,
                                       pg=p), TILED)
    for va, vb, cap, rows in VARIANT_SHAPES:
        x = cs._variant_inputs(rng, rows, va, vb, cap, dev, spacing=4)
        vals, tag, _ = qk.merge_tagged(x["a"], x["na"], x["b"], x["nb"])
        out[f"V{va}+{vb} B{rows} n{(va + vb) * cap} variants_keep"] = (
            device_ms(lambda: qk.variants_keep(vals, tag, x["ra"], x["rb"],
                                               x["bpad"]), TILED))

    merges = []
    for rows, cap in ((8, 262144), (8, 32768)):
        x = cs._parity_inputs(rng, rows, cap, dev, full_first=True)
        merges.append((f"W2 B{rows} n{2 * cap}", (
            x["a"], x["na"], x["b"], x["nb"], x["a_pg"], x["b_pg"])))
    for rows, cap in ((8, 32768), (16, 2048), (32, 1024), (128, 256)):
        x = cs._variant_inputs(rng, rows, 4, 4, cap, dev, spacing=4)
        merges.append((f"V4+4 B{rows} n{8 * cap}", (
            x["a"], x["na"], x["b"], x["nb"], x["a_pg"], x["b_pg"])))
    x = cs._parity_inputs(rng, 8, 65536, dev, full_first=True)
    merges.append(("W3 fold step B8 n65536+32768", (
        x["a"], x["na"], x["b"][:, :32768].contiguous(),
        x["nb"].clamp(max=32768), x["a_pg"],
        x["b_pg"][:, :32768].contiguous())))
    for key, args in merges:
        a, na, b, nb, a_pg, b_pg = args
        blocks = qk.as_variant_blocks(a, a_pg, na, b, b_pg, nb)
        out[f"{key} merge_tagged"] = device_ms(
            lambda: qk.merge_tagged(*args), MERGE)
        out[f"{key} merge_tagged bound"] = bound_ms(
            cs, "merge_tagged", blocks)
        sort = cs._library_call("merge_tagged", [blocks])
        out[f"{key} torch.sort"] = device_ms(sort)

    for cap, rows in SLOT_SHAPES:
        x = cs._parity_inputs(rng, rows, cap, dev)
        args = (x["a"], x["na"], x["ra"], x["b"], x["nb"], x["rb"],
                x["bounds"])
        pgs = dict(a_pg=x["a_pg"], b_pg=x["b_pg"])
        out[f"slot cap{cap} B{rows} bound"] = bound_ms(
            cs, "sorted_and_locate_full",
            (x["a"], x["a_pg"], x["na"], x["ra"], x["b"], x["b_pg"], x["nb"],
             x["rb"], min(64, 2 * cap), min(1024, 2 * cap)))
        out[f"slot cap{cap} B{rows} sorted_and_locate_full"] = device_ms(
            lambda: qk.sorted_and_locate_full(*args, topk=64, hit_cap=1024,
                                              tail=False, **pgs), SLOT)
        out[f"slot cap{cap} B{rows} sorted_and_locate_full_topk"] = (
            device_ms(lambda: qk.sorted_and_locate_full(
                *args, topk=64, hit_cap=1024, sort_topk=False, **pgs),
                SLOT))

    if batch:
        out.update(batch_merges(cs, qk))
    x = cs._parity_inputs(rng, 8, 64, dev)
    out["host us merge_tagged B8 cap64"] = host_us(
        lambda: qk.merge_tagged(x["a"], x["na"], x["b"], x["nb"], x["a_pg"],
                                x["b_pg"]))
    out["host us sorted_and_locate_full B8 cap64"] = host_us(
        lambda: qk.sorted_and_locate_full(
            x["a"], x["na"], x["ra"], x["b"], x["nb"], x["rb"], x["bounds"],
            topk=64, hit_cap=1024, tail=False, a_pg=x["a_pg"],
            b_pg=x["b_pg"]))
    return out


def main() -> None:
    args = sys.argv[1:]
    batch = "--batch" in args
    roots = ([Path(r).resolve() for r in args if r != "--batch"]
             or [HERE.parents[1]])
    if len(roots) == 1:
        print(json.dumps(measure(roots[0], batch)), flush=True)
        return
    runs = []
    for root in roots + roots[::-1]:
        proc = subprocess.run([sys.executable, str(HERE), str(root)]
                              + ["--batch"] * batch,
                              capture_output=True, text=True)
        if proc.returncode:
            raise SystemExit(f"tile_kernel_times on {root} failed:\n"
                             f"{proc.stdout[-4000:]}{proc.stderr[-4000:]}")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    print(json.dumps({"turns": [r["root"] for r in runs], "runs": runs}),
          flush=True)


if __name__ == "__main__":
    main()
