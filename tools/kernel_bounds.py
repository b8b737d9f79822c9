"""Bytes bounds of TPU kernels of docodo_tpu/ops/pallas_query.py from
their shapes alone (PERF.md's kernel table).

    python3 tools/kernel_bounds.py

Rows 13, 14 and 17 (the page-level kernels, ported as
docodo_and_locate_topk and docodo_single_locate_topk) at the shapes the
page-level standard 10k batch launches them on the 64 MB corpus of
chip_smoke.py (cap and rows of each bucket, topk 16), with every lane of
a block counted: an upper estimate of what chip_smoke.py measures on
the same launches, where only the valid lanes count. Row 17 launches
nothing of its own (it is row 13's function with the pages looked up in
bounds), so it is given at row 13's shapes without page streams.

Rows 15 and 16, which no path of docodo_tpu_torch launches yet, at the
largest shape each one's JAX caller admits, for 4096 query rows, topk
64 (the mixes' full-result budget), page streams carried.

A bound is the bytes the kernel's function must move, each input read
once and each output written once, over the H100 SXM's 3.35 TB/s of
device memory (at 700 W): the least time the card could take. Prints
one line per shape, a total per row, and a JSON line. Needs no card.
"""

from __future__ import annotations

import json

ROWS = 4096
TOPK = 64
PAGE_TOPK = 16
HBM_BYTES_PER_S = 3.35e12
I32 = 4
PAGES = 21971  # the 64 MB corpus's page bounds, read once by row 17

# (cap, rows) of the page-level batch's kernel buckets
W2_BUCKETS = ((64, 8192), (128, 1024), (256, 512), (512, 512))
W1_BUCKETS = ((64, 4096), (128, 512))
PAGE_OUT = I32 * 3 * PAGE_TOPK

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
    (15, "_variants_and_locate_full_kernel (largest of the four twins)",
     "pallas_query.py:794",
     "n 1024 (MAX_STREAM_WIDTH): vals, tag, pages [n], ra, rb, bpad",
     ROWS, I32 * (3 * 1024 + 3), I32 * (3 * TOPK + 2 + 1024), 0),
    (16, "_merge_and_locate_kernel", "pallas_query.py:2714",
     "2 cap 4096 (FUSED_AND_MAX): vals, tag, pages [2 cap], ra, rb; "
     "hits, page, rank, count streams [2 cap]",
     ROWS, I32 * (3 * 4096 + 2), I32 * 4 * 4096, 0),
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
    for row, us in sorted(totals.items()):
        print(f"row {row} total: bound {us:.2f} us")
    print(json.dumps({"shapes": out, "row_total_us": totals}))


if __name__ == "__main__":
    main()
