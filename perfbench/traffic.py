"""The one generator of query traffic: a mix file (mixes/<name>.json) of
parameters, read here, draws seeded batches of queries in bulk.

A mix names frequency bands, ranks by the corpus's own posting counts
(rank 1 the most frequent word, ties by word id), and classes of queries,
each with its share of every batch (the shares are weights, taken over
their sum) and its words: a word is a list of
bands, one variant drawn from each, so ["high", "med"] is an OR of a
frequent and a middling word. Every word of a query and every variant of
a word is distinct. `window` sets each word's R as the port's query
compiler takes it: "proximity" is 255 + the word's length (the longest
variant's), "ordered" -(length + 4), an exact phrase.

    {"bands": {"high": [11, 200]},
     "classes": [{"name": "AndHighHigh", "share": 0.3,
                  "words": [["high"], ["high"]], "window": "proximity"}]}

The file also names its `source` and lists under `assumed` what stands
in for it. Every batch holds each class's share of its rows, rounded so that the
shares fill the batch, in an order drawn from the seed; so every seed
sends the same shapes in another order.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
DEFAULT_DIST = 255


@dataclass
class Pool:
    """Batches of queries, as search_batch_full takes them, and for each
    query its class and its words' variant word ids."""

    batches: List[list]               # [n][batch] query = [(codes, r), ...]
    classes: np.ndarray               # int16 [n, batch] class index
    slots: np.ndarray                 # int32 [n, batch] row in its class
    per_batch: np.ndarray             # int64 [classes] rows a batch
    words: List[np.ndarray]           # per class int32 [n * per, W, V]
    class_names: List[str]


def load_mix(name: str) -> dict:
    with open(os.path.join(HERE, "mixes", f"{name}.json")) as f:
        return json.load(f)


def band_words(counts: np.ndarray, bands: Dict[str, list]) -> Dict[str,
                                                                   np.ndarray]:
    """Word ids of each band: ranks lo..hi (1-based, inclusive) of the
    words by posting count, descending, ties by word id."""
    order = np.lexsort((np.arange(counts.size), -counts))
    out = {}
    for name, (lo, hi) in bands.items():
        ids = order[int(lo) - 1:int(hi)]
        if ids.size < int(hi) - int(lo) + 1 or counts[ids].min() == 0:
            raise ValueError(f"band {name} {lo}-{hi}: the corpus has too "
                             f"few words")
        out[name] = ids.astype(np.int32)
    return out


def class_rows(shares: List[float], batch: int) -> np.ndarray:
    """Rows of each class in a batch: the shares rounded, largest
    remainders first, so that they fill it."""
    want = np.asarray(shares, dtype=np.float64) / sum(shares) * batch
    n = np.floor(want).astype(np.int64)
    n[np.argsort(-(want - n), kind="stable")[:batch - int(n.sum())]] += 1
    return n


def _draw_distinct(rng: np.random.Generator, pools: List[np.ndarray],
                   n: int) -> np.ndarray:
    """[n, k] word ids, column j from pools[j], distinct in each row."""
    out = np.stack([p[rng.integers(0, p.size, size=n)] for p in pools], 1)
    while True:
        srt = np.sort(out, axis=1)
        bad = np.flatnonzero((srt[:, 1:] == srt[:, :-1]).any(axis=1))
        if bad.size == 0:
            return out
        j = rng.integers(0, len(pools), size=bad.size)
        for col in np.unique(j):
            rows = bad[j == col]
            p = pools[col]
            out[rows, col] = p[rng.integers(0, p.size, size=rows.size)]


def draw_pool(mix: dict, counts: np.ndarray, words: List[str], seed: int,
              n_batches: int, batch: int) -> Pool:
    """`n_batches` batches of `batch` queries of `mix` over a corpus of
    posting counts `counts` and vocabulary `words`."""
    rng = np.random.default_rng([int(seed), 1])
    bands = band_words(counts, mix["bands"])
    classes = mix["classes"]
    per = class_rows([c["share"] for c in classes], batch)
    wlen = np.fromiter((len(w) for w in words), np.int64, len(words))
    kind = np.concatenate([np.full(k, c, dtype=np.int16)
                           for c, k in enumerate(per)])
    cls = kind[np.argsort(rng.random((n_batches, batch)), axis=1)]
    slots = np.zeros((n_batches, batch), dtype=np.int32)
    flat: list = []
    start = np.zeros(len(classes), dtype=np.int64)
    drawn = []
    for c, spec in enumerate(classes):
        mask = cls == c
        slots[mask] = (np.cumsum(mask, axis=1) - 1)[mask]
        shape = [[bands[b] for b in word] for word in spec["words"]]
        ids = _draw_distinct(rng, [p for w in shape for p in w],
                             n_batches * int(per[c]))
        v = max(len(w) for w in shape)
        grid = np.full((ids.shape[0], len(shape), v), -1, dtype=np.int32)
        col = 0
        for j, word in enumerate(shape):
            grid[:, j, :len(word)] = ids[:, col:col + len(word)]
            col += len(word)
        drawn.append(grid)
        start[c] = len(flat)
        flat.extend(_queries(grid, spec["window"], words, wlen))
    at = (start[cls] + np.arange(n_batches)[:, None] * per[cls]
          + slots).tolist()
    batches = [[flat[k] for k in row] for row in at]
    return Pool(batches=batches, classes=cls, slots=slots, per_batch=per,
                words=drawn, class_names=[c["name"] for c in classes])


def _queries(grid: np.ndarray, window: str, words: List[str],
             wlen: np.ndarray) -> List[list]:
    """The queries [(codes, r), ...] of word-id rows grid [n, W, V]."""
    live = grid >= 0
    n = np.where(live, wlen[np.maximum(grid, 0)], 0).max(axis=2)  # [n, W]
    rs = (DEFAULT_DIST + n if window == "proximity" else -(n + 4)).tolist()
    if grid.shape[2] == 1:
        ids = grid[:, :, 0].tolist()
        return [[(words[w], r) for w, r in zip(row, rr)]
                for row, rr in zip(ids, rs)]
    out = []
    for row, rr in zip(grid.tolist(), rs):
        q = []
        for variants, r in zip(row, rr):
            keys = tuple(words[w] for w in variants if w >= 0)
            q.append((keys[0] if len(keys) == 1 else keys, r))
        out.append(q)
    return out


def query_words(pool: Pool, b: int, row: int) -> np.ndarray:
    """[W, V] variant word ids of query `row` of batch `b` (-1 padded)."""
    c = int(pool.classes[b, row])
    return pool.words[c][b * int(pool.per_batch[c]) + int(pool.slots[b, row])]
