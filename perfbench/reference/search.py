"""The plain reference of a full-result query batch: what
DeviceIndex.search_batch_full(queries, topk, hit_cap, want_docs=True)
answers, worked out from the generated corpus alone (every token's word
and coordinate, the page ends, each page's document and header flag).
Nothing here imports the port.

A row's answer (the API's contract, docodo_tpu_torch/ops/device_index.py
as of revision 75513271):

* kept: the fold of the row (fold.py), ascending;
* n_hits: its length, and hits its first `tier` coordinates as int64,
  the dtype's maximum (HIT_PAD) after them, so that a coordinate past
  2^31 keeps its value (the check maps each side's pad to one
  sentinel); a row whose smallest word (its variants' postings summed)
  bounds its result small reads back a tier of 128 or 512 and flags an
  overflow as n_hits = hit_cap + 1;
* a page run: consecutive kept coordinates on one page (the page of c:
  the number of page ends <= c, at most the last page); n_pages the runs;
  of the first `topk` runs in coordinate order, each run's count and
  rank = (1 + bonus) + ln(count) in float32, each later coordinate of a
  run adding 30 // max(5, gap to the previous one) to its bonus;
* pages / ranks / counts: those runs by rank descending, ties by
  position; -1 / 0 / 0 after them;
* docs: each top slot's document (-1 after them), and doc_ranks, at each
  document's first top slot, 1 + ln(the sum of its top slots' ranks),
  summed in the port's segmented doubling order (a float32 sum depends
  on the order), times 10 when one of them is a header page; 0 elsewhere.

The logarithm is taken by `log`, a callable over float32 arrays that the
caller gives: torch.log on the device the port ran on, whose float32
logarithm the port's kernels share, so that ranks agree to the bit.
With `rank_dtype=torch.bfloat16` the ranks and document sums are
computed in bfloat16: the control, one precision below the float32 that
the configuration states.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Sequence

import numpy as np
import torch

from perfbench.reference.fold import fold_row

INT32_MAX = 2**31 - 1
HIT_PAD = np.iinfo(np.int64).max
THREADS = 8
FIELDS = ("pages", "ranks", "counts", "n_pages", "n_hits", "hits", "docs",
          "doc_ranks")


class Postings:
    """The posting lists of the words a check needs, from the corpus's
    token arrays: ids int32 [N] and coords int64 [N] in coordinate
    order."""

    def __init__(self, ids: np.ndarray, coords: np.ndarray,
                 words: Sequence[int], n_vocab: int):
        words = np.unique(np.asarray(words, dtype=np.int64))
        # 16-bit keys: NumPy sorts them by radix, in linear time
        key_t = np.int16 if words.size < 2**15 else np.int32
        lut = np.full(n_vocab, -1, dtype=key_t)
        lut[words] = np.arange(words.size, dtype=key_t)
        key = lut[ids]
        at = np.flatnonzero(key >= 0)
        key = key[at]
        order = np.argsort(key, kind="stable")
        self.coords = coords[at[order]]
        counts = np.bincount(key, minlength=words.size)
        self.offsets = np.concatenate([[0], np.cumsum(counts)])
        self.slot = {int(w): i for i, w in enumerate(words.tolist())}

    def of(self, word: int) -> np.ndarray:
        i = self.slot[int(word)]
        return self.coords[self.offsets[i]:self.offsets[i + 1]]


def hit_tier(min_need: int, hit_cap: int) -> int:
    """The hit buffer a row reads back by its smallest word's volume."""
    want = 4 * min_need + 16
    for t in sorted({min(hit_cap, t) for t in (128, 512, hit_cap)}):
        if want <= t:
            return t
    return hit_cap


def fold_rows(rows, rs, postings: Postings, page_end: np.ndarray,
              topk: int, hit_cap: int) -> dict:
    """Each row's fold, totals, hits and first `topk` page runs (page,
    count, bonus), before any rank is computed."""
    b = len(rows)
    out = {
        "n_pages": np.zeros(b, dtype=np.int32),
        "n_hits": np.zeros(b, dtype=np.int32),
        "hits": np.full((b, hit_cap), HIT_PAD, dtype=np.int64),
        "bon": np.zeros((b, topk), dtype=np.int64),
        "cnt": np.zeros((b, topk), dtype=np.int64),
        "pg": np.full((b, topk), -1, dtype=np.int64),
        "n_runs": np.zeros(b, dtype=np.int64),
    }
    n_last = len(page_end) - 1

    def one(i):
        words = [[postings.of(w) for w in variants if w >= 0]
                 for variants in np.asarray(rows[i]).tolist()]
        min_need = min(sum(v.size for v in word) for word in words)
        kept = fold_row(words, rs[i])
        tier = hit_tier(min_need, hit_cap)
        out["n_hits"][i] = (hit_cap + 1 if tier < hit_cap
                            and kept.size > tier else kept.size)
        out["hits"][i, :min(tier, kept.size)] = kept[:tier]
        if kept.size == 0:
            return
        page = np.minimum(np.searchsorted(page_end, kept, side="right"),
                          n_last)
        first = np.ones(kept.size, dtype=bool)
        first[1:] = page[1:] != page[:-1]
        gap = np.diff(kept, prepend=kept[0])
        bonus = np.where(first, 0, 30 // np.maximum(5, gap))
        run = np.cumsum(first) - 1
        n = int(run[-1]) + 1
        out["n_pages"][i] = n
        m = min(n, topk)
        live = run < m
        out["cnt"][i, :m] = np.bincount(run[live], minlength=m)
        out["bon"][i, :m] = np.bincount(run[live], weights=bonus[live],
                                        minlength=m).astype(np.int64)
        out["pg"][i, :m] = page[first][:m]
        out["n_runs"][i] = m

    # rows on threads: NumPy's sorts and searches release the lock
    with ThreadPoolExecutor(THREADS) as pool:
        list(pool.map(one, range(b)))
    return out


def answers(runs: dict, page_doc: np.ndarray, is_header: np.ndarray,
            log: Callable[[np.ndarray], np.ndarray],
            rank_dtype=torch.float32) -> Dict[str, np.ndarray]:
    """The answer fields of folded rows (fold_rows), their ranks and
    document ranks computed in `rank_dtype`."""
    pg, cnt, bon = runs["pg"], runs["cnt"], runs["bon"]
    topk = pg.shape[1]
    served = np.arange(topk)[None, :] < runs["n_runs"][:, None]
    logs = torch.from_numpy(log(np.maximum(cnt, 1).astype(np.float32)))
    rank = (1.0 + torch.from_numpy(bon.astype(np.float32)).to(rank_dtype)
            ) + logs.to(rank_dtype)
    rank = torch.where(torch.from_numpy(served), rank, 0.0)
    top_rank, slot = torch.sort(rank, dim=1, descending=True, stable=True)
    slot = slot.numpy()
    valid = (top_rank > 0).numpy()
    out = {f: runs[f] for f in ("n_pages", "n_hits", "hits")}
    out["pages"] = np.where(valid, np.take_along_axis(pg, slot, 1),
                            -1).astype(np.int32)
    out["counts"] = np.where(valid, np.take_along_axis(cnt, slot, 1),
                             0).astype(np.int32)
    out["ranks"] = top_rank.to(torch.float32).numpy()
    out["docs"], out["doc_ranks"] = _doc_group(out["pages"], top_rank,
                                               page_doc, is_header, log)
    return out


def _doc_group(pages: np.ndarray, top_rank: torch.Tensor,
               page_doc: np.ndarray, is_header: np.ndarray,
               log) -> tuple:
    """Each top slot's document and the document ranks (module doc)."""
    bsz, topk = pages.shape
    valid = top_rank > 0
    safe = np.maximum(pages, 0)
    docs = np.where(valid.numpy(), page_doc[safe], -1).astype(np.int32)
    hdr = torch.from_numpy(is_header[safe]) & valid
    key = torch.from_numpy(np.where(valid.numpy(), docs, INT32_MAX))
    skey, skidx = torch.sort(key, dim=1, stable=True)
    run_sum = torch.gather(top_rank, 1, skidx)
    run_hdr = torch.gather(hdr.to(torch.int32), 1, skidx)
    start = torch.cat([torch.ones((bsz, 1), dtype=torch.bool),
                       skey[:, 1:] != skey[:, :-1]], dim=1)
    d = 1
    while d < topk:
        same = torch.cat([skey[:, d:], skey.new_full((bsz, d), -7)],
                         dim=1) == skey
        run_sum = run_sum + torch.where(
            same, torch.cat([run_sum[:, d:], run_sum.new_zeros((bsz, d))],
                            dim=1), 0.0)
        run_hdr = run_hdr + torch.where(
            same, torch.cat([run_hdr[:, d:], run_hdr.new_zeros((bsz, d))],
                            dim=1), 0)
        d <<= 1
    low = run_sum.dtype
    pre = torch.clamp_min(run_sum.to(torch.float32), 1e-30).numpy()
    doc_rank = 1.0 + torch.from_numpy(log(pre)).to(low)
    doc_rank = torch.where(run_hdr > 0, doc_rank * 10.0, doc_rank)
    sval = torch.where(start & (skey < INT32_MAX), doc_rank, 0.0)
    out = torch.empty_like(sval).scatter_(1, skidx, sval)
    return docs, out.to(torch.float32).numpy()
