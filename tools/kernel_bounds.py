"""Bytes bounds of the TPU kernels that no path of docodo_tpu_torch
launches yet (PERF.md's kernel table, rows 13-17), at the largest shape
each one's JAX caller admits, for 4096 query rows.

    python3 tools/kernel_bounds.py

A bound is the bytes the kernel's function must move, each input read
once and each output written once, over the H100 SXM's 3.35 TB/s of
device memory (at 700 W): the least time the card could take. The
shapes are those of the kernels' pallas_call sites in
docodo_tpu/ops/pallas_query.py, with the page streams carried (the
larger input), topk 64 (the mixes' budget). Prints one line per row and
a JSON line. Needs no card.
"""

from __future__ import annotations

import json

ROWS = 4096
TOPK = 64
HBM_BYTES_PER_S = 3.35e12
I32 = 4

# row -> (kernel, call site, shape, input bytes of one row, output bytes
# of one row)
KERNELS = {
    13: ("_sorted_and_locate_kernel", "pallas_query.py:1123",
         "W=2, cap 512 (MAX_SORTED_PALLAS_CAP): vals, tag, pages [2 cap]",
         I32 * (3 * 1024 + 2), I32 * 3 * TOPK),
    14: ("_single_word_kernel", "pallas_query.py:1428",
         "W=1, cap 128 (MAX_PALLAS_CAP): block, pages [cap], length",
         I32 * (2 * 128 + 1), I32 * 3 * TOPK),
    15: ("_variants_and_locate_full_kernel (largest of the four twins)",
         "pallas_query.py:794",
         "n 1024 (MAX_STREAM_WIDTH): vals, tag, pages [n], ra, rb, bpad",
         I32 * (3 * 1024 + 3), I32 * (3 * TOPK + 2 + 1024)),
    16: ("_merge_and_locate_kernel", "pallas_query.py:2714",
         "2 cap 4096 (FUSED_AND_MAX): vals, tag, pages [2 cap], ra, rb; "
         "hits, page, rank, count streams [2 cap]",
         I32 * (3 * 4096 + 2), I32 * 4 * 4096),
    17: ("_and_locate_kernel", "pallas_query.py:1375",
         "W=2, cap 128 (MAX_PALLAS_CAP): two blocks [cap], lengths, "
         "windows",
         I32 * (2 * 128 + 4), I32 * 3 * TOPK),
}


def main() -> None:
    out = []
    for row, (name, site, shape, inb, outb) in KERNELS.items():
        nbytes = ROWS * (inb + outb)
        us = nbytes / HBM_BYTES_PER_S * 1e6
        out.append({"row": row, "kernel": name, "site": site,
                    "shape": shape, "rows": ROWS, "bytes": nbytes,
                    "bound_us": us})
        print(f"row {row}: {name} ({site}), {shape}, {ROWS} rows: "
              f"{nbytes} bytes, bound {us:.2f} us")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
