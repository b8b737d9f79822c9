"""Bytes bounds of TPU kernels of docodo_tpu/ops/pallas_query.py from
their shapes alone (PERF.md's kernel table).

    python3 tools/kernel_bounds.py

Rows 13, 14 and 17 (the page-level kernels, ported as
docodo_and_locate_topk and docodo_single_locate_topk, both entry points
of docodo_tpu_torch/csrc/locate_full.cu) at the shapes the
page-level standard 10k batch launches them on the 64 MB corpus of
chip_smoke.py (cap and rows of each bucket, topk 16), with every lane of
a block counted: an upper estimate of what chip_smoke.py measures on
the same launches, where only the valid lanes count. Row 17 launches
nothing of its own (it is row 13's function with the pages looked up in
bounds), so it is given at row 13's shapes without page streams.

Rows 15a-15d and 16 (the top-k-mode full-result kernels and
merge_and_locate) at the shapes the serving path launches them with
sort_topk=False on the same corpus: the buckets `tools/profile_batch.py
--leg serve` lists for the standard and the wide 10k mix (waves of 512
rows, cap ladder 128 / 1024 / 16384 / 131072, topk 64, hit_cap 1024) and
for their escalated passes (topk 2048 and hit_cap 8192, clamped per
bucket), page streams carried, every lane counted.

A bound is the bytes the kernel's function must move, each input read
once and each output written once, over the H100 SXM's 3.35 TB/s of
device memory (at 700 W): the least time the card could take. Prints
one line per shape, a total per row, and a JSON line. Needs no card.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from docodo_tpu_torch.benchmarks.common import HBM_BYTES_PER_S  # noqa: E402

PAGE_TOPK = 16
I32 = 4
PAGES = 21971  # the 64 MB corpus's page bounds, read once by row 17

# (cap, rows) of the page-level batch's kernel buckets
W2_BUCKETS = ((64, 8192), (128, 1024), (256, 512), (512, 512))
W1_BUCKETS = ((64, 4096), (128, 512))
PAGE_OUT = I32 * 3 * PAGE_TOPK



def _finished(topk: int, hit_cap: int, n: int) -> int:
    """Output bytes of one row of a top-k-mode kernel: three [topk]
    arrays, two totals and the first min(hit_cap, n) hits."""
    return I32 * (3 * topk + 2 + min(hit_cap, n))


# the serving path's buckets per kernel: (rows, topk, hit_cap, buckets),
# the standard mix's, the wide mix's, then their escalated passes'
W2_SERVE = ((512, 64, 1024, 20), (128, 64, 1024, 23))          # cap 128
W1_SERVE = ((128, 64, 1024, 24), (512, 64, 1024, 19),          # cap 128
            (32, 128, 256, 1), (512, 128, 256, 1), (128, 128, 256, 4))
# (V, cap, rows, topk, hit_cap, buckets): a plain word at cap 1024 (V = 1)
# and the wide mix's 8-variant unions
UNION_SERVE = ((1, 1024, 8, 64, 1024, 14), (1, 1024, 32, 64, 1024, 29),
               (8, 128, 32, 64, 1024, 1), (8, 128, 128, 64, 1024, 22),
               (1, 1024, 8, 1024, 2048, 1), (1, 1024, 512, 1024, 2048, 1),
               (1, 1024, 128, 1024, 2048, 4), (8, 128, 512, 128, 2048, 4))
VARIANTS_SERVE = ((32, 64, 1024, 1), (128, 64, 1024, 22))      # V 4+4 cap 128
FUSED_SERVE = ((32, 23), (128, 19), (8, 1))                    # cap 1024

# (row, kernel, call site, shape, rows, input bytes of one row, output
# bytes of one row, bytes read once per launch)
KERNELS = [
    (13, "_sorted_and_locate_kernel", "pallas_query.py:1123",
     f"W=2 cap {cap}: two blocks and their pages [cap], lengths, windows",
     rows, I32 * (4 * cap + 4), PAGE_OUT, 0)
    for cap, rows in W2_BUCKETS
] + [
    (14, "_single_word_kernel", "pallas_query.py:1428",
     f"W=1 cap {cap}: block, pages [cap], length",
     rows, I32 * (2 * cap + 1), PAGE_OUT, 0)
    for cap, rows in W1_BUCKETS
] + [
    ("15a", "_sorted_and_locate_full_kernel", "pallas_query.py:794",
     f"W=2 cap 128, {rows} rows x {k} buckets, topk {topk}, hit_cap {hc}",
     rows * k, I32 * (4 * 128 + 4), _finished(topk, hc, 256), 0)
    for rows, topk, hc, k in W2_SERVE
] + [
    ("15b", "_variants_and_locate_full_kernel", "pallas_query.py:794",
     f"W=2 V 4+4 cap 128 (n 1024), {rows} rows x {k} buckets, topk {topk}, "
     f"hit_cap {hc}",
     rows * k, I32 * (2 * 1024 + 8 + 3), _finished(topk, hc, 1024), 0)
    for rows, topk, hc, k in VARIANTS_SERVE
] + [
    ("15c", "_union_locate_full_kernel", "pallas_query.py:794",
     f"W=1 V {v} cap {cap}, {rows} rows x {k} buckets, topk {topk}, "
     f"hit_cap {hc}",
     rows * k, I32 * (2 * v * cap + v), _finished(topk, hc, v * cap), 0)
    for v, cap, rows, topk, hc, k in UNION_SERVE
] + [
    ("15d", "_single_word_full_kernel", "pallas_query.py:1325",
     f"W=1 cap 128, {rows} rows x {k} buckets, topk {topk}, hit_cap {hc}",
     rows * k, I32 * (2 * 128 + 1), _finished(topk, hc, 128), 0)
    for rows, topk, hc, k in W1_SERVE
] + [
    (16, "_merge_and_locate_kernel", "pallas_query.py:2714",
     f"W=2 cap 1024 (n 2048), {rows} rows x {k} buckets: two blocks and "
     f"their pages, lengths, windows; hits, page, rank, count streams [n]",
     rows * k, I32 * (4 * 1024 + 4), I32 * 4 * 2048, 0)
    for rows, k in FUSED_SERVE
] + [
    (17, "_and_locate_kernel", "pallas_query.py:1375",
     f"W=2 cap {cap}: two blocks [cap], lengths, windows; bounds [P]",
     rows, I32 * (2 * cap + 4), PAGE_OUT, I32 * PAGES)
    for cap, rows in W2_BUCKETS
]


def main() -> None:
    out = []
    totals: dict = {}
    for row, name, site, shape, rows, inb, outb, once in KERNELS:
        nbytes = rows * (inb + outb) + once
        us = nbytes / HBM_BYTES_PER_S * 1e6
        totals[row] = totals.get(row, 0.0) + us
        out.append({"row": row, "kernel": name, "site": site,
                    "shape": shape, "rows": rows, "bytes": nbytes,
                    "bound_us": us})
        print(f"row {row}: {name} ({site}), {shape}, {rows} rows: "
              f"{nbytes} bytes, bound {us:.2f} us")
    for row, us in sorted(totals.items(), key=lambda kv: str(kv[0])):
        print(f"row {row} total: bound {us:.2f} us")
    print(json.dumps({"shapes": out, "row_total_us": totals}))


if __name__ == "__main__":
    main()
