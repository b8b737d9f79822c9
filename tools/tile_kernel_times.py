"""Device time of the tiled kernels (and_keep, its compacted form,
locate_runs with carried and looked-up pages, variants_keep) at the main
path's bucket shapes: the mean device time of one call over 20, from
torch.profiler's device events, on seeded chip_smoke.py inputs.

    python3 tools/tile_kernel_times.py [ROOT]

ROOT (default: this checkout) is the tree whose docodo_tpu_torch and
chip_smoke.py are imported, so that two trees that differ only in a
kernel can be timed in one call on one card, in turns. Prints one JSON
line. Needs a CUDA card.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(sys.argv[1] if len(sys.argv) > 1
            else Path(__file__).resolve().parents[1]).resolve()
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from docodo_tpu_torch.ops import _cuda  # noqa: E402
from docodo_tpu_torch.ops import query_kernels as qk  # noqa: E402

KERNELS = ("keep_marks_kernel", "keep_resolve_kernel", "locate_runs_kernel")
REPS = 20
# (rows, cap) of W = 2 buckets: a wide bucket at the largest cap, a few
# rows at cap 32768, and many-row buckets within one tile
W2_SHAPES = ((8, 262144), (8, 32768), (64, 2048), (1024, 1024))
# (Va, Vb, cap, rows) of variant buckets
VARIANT_SHAPES = ((4, 4, 32768, 8), (4, 4, 512, 128))


def device_ms(fn) -> float:
    """Device ms of one fn() in the tiled kernels, over REPS calls."""
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
             if any(k in e.key for k in KERNELS))
    return us / 1e3 / REPS


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("tile_kernel_times: no CUDA device")
    if not Path(qk.__file__).resolve().is_relative_to(ROOT):
        raise SystemExit(f"imported {qk.__file__}, not from {ROOT}")
    _cuda.build()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    out = {"root": str(ROOT), "card": smi.splitlines()[0],
           "ptxas": [ln.strip() for ln in _cuda.build_log.splitlines()
                     if "registers" in ln]}
    for rows, cap in W2_SHAPES:
        x = cs._parity_inputs(rng, rows, cap, dev, full_first=rows < 8)
        vals, tag, pg = qk.merge_tagged(x["a"], x["na"], x["b"], x["nb"],
                                        x["a_pg"], x["b_pg"])
        ra, rb, bounds = x["ra"], x["rb"], x["bounds"]
        hv = qk.and_keep(vals, tag, ra, rb)
        key = f"W2 B{rows} n{2 * cap}"
        out[key + " and_keep"] = device_ms(
            lambda: qk.and_keep(vals, tag, ra, rb))
        out[key + " and_keep_compact"] = device_ms(
            lambda: qk.and_keep_compact(vals, tag, ra, rb, pg))
        for label, p in (("carried", pg), ("bounds", None)):
            out[f"{key} locate_runs {label}"] = device_ms(
                lambda: qk.locate_runs(hv, bounds, topk=64, hit_cap=1024,
                                       pg=p))
    for va, vb, cap, rows in VARIANT_SHAPES:
        x = cs._variant_inputs(rng, rows, va, vb, cap, dev, spacing=4)
        vals, tag, _ = qk.merge_tagged(x["a"], x["na"], x["b"], x["nb"])
        out[f"V{va}+{vb} B{rows} n{(va + vb) * cap} variants_keep"] = (
            device_ms(lambda: qk.variants_keep(vals, tag, x["ra"], x["rb"],
                                               x["bpad"])))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
