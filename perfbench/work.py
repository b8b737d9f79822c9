"""The least bytes a batch of full-result queries moves, counted from the
benchmark's own corpus (not from what the program launches), so that the
count is the same whatever serves the queries:

* every posting list the query names, each coordinate 4 bytes, read once;
* the answer written once: pages, ranks, counts, docs and doc ranks
  (topk each, 4 bytes), n_pages and n_hits (4 bytes each) and the hits
  (hit_cap, 4 bytes);
* the page table's ends, 4 bytes a page, read once a batch.

peaks.json holds the card's bandwidth that turns bytes into the least
time.
"""

from __future__ import annotations

import json
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
COORD_BYTES = 4


def peaks() -> dict:
    with open(os.path.join(HERE, "peaks.json")) as f:
        return json.load(f)


def answer_bytes(topk: int, hit_cap: int) -> int:
    """Bytes of one query's answer."""
    return 4 * (5 * topk + 2 + hit_cap)


def query_postings(grid: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Postings each query names: grid int [..., W, V] word ids (-1 pad)."""
    return np.where(grid >= 0, counts[np.maximum(grid, 0)], 0).sum(
        axis=(-2, -1))


def batch_bytes(postings: np.ndarray, n_pages: int, topk: int,
                hit_cap: int) -> int:
    """The least bytes of one batch whose queries name `postings`."""
    return int(COORD_BYTES * postings.sum()
               + postings.size * answer_bytes(topk, hit_cap)
               + COORD_BYTES * n_pages)
