"""What the benchmark reads from torch.profiler's trace of its window:
the device operations' intervals (kernels, copies, sets), grouped by the
card they ran on; on each card their union (the seconds it was busy) and
the gaps in which it ran nothing, their seconds shared out over the
harness spans (`bench.dispatch`, `bench.finish`, `bench.between`) the
host was in meanwhile, each gap named by the span that held most of it;
and each operation's time by name, summed over the cards. Over several
cards the busy and idle seconds are the mean of the cards' and the
kernel-busy seconds their sum; on one card each reads that card's.
Nothing is written to disk.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np

SPANS = ("bench.dispatch", "bench.finish", "bench.between")
TOP = 10


@dataclass
class Trace:
    """A traced window's device time, in seconds."""

    window_s: float
    busy_s: float                 # a card's union of operations, mean
    kernel_busy_s: float          # a card's union of kernels, summed
    ops: List[Tuple[str, float]]  # device seconds by operation, largest first
    idle: Dict[str, float]        # a card's idle seconds by span, mean
    gaps: List[Tuple[str, float, int]]  # the longest: span, seconds, card
    launches: int = 0             # device operations in the window
    cards: List[int] = field(default_factory=list)  # device indices
    busy_s_by_card: List[float] = field(default_factory=list)


def _union(iv: np.ndarray) -> np.ndarray:
    """Disjoint sorted intervals covering the rows [start, end] of iv."""
    if iv.size == 0:
        return iv.reshape(0, 2)
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    reach = np.maximum.accumulate(iv[:, 1])
    new = np.ones(iv.shape[0], dtype=bool)
    new[1:] = iv[1:, 0] > reach[:-1]
    starts = iv[new, 0]
    ends = np.append(reach[np.flatnonzero(new)[1:] - 1], reach[-1])
    return np.stack([starts, ends], axis=1)


def short(name: str) -> str:
    """A device operation's name without its parameter list, return
    type and anonymous namespaces, at most 160 characters."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return name.split("(", 1)[0][:160]


def _is_kernel(name: str) -> bool:
    low = name.lower()
    return not ("memcpy" in low or "memset" in low)


def by_card(rows: Sequence[tuple], cards: Sequence[int] = ()
            ) -> Dict[int, np.ndarray]:
    """The positions in `rows` ((start, end, card, ...) tuples) of each
    card's operations: every card of `cards` (a card that ran nothing
    has none) and every other card that ran something; card 0 alone when
    there is neither."""
    at: Dict[int, List[int]] = {c: [] for c in cards}
    for i, row in enumerate(rows):
        at.setdefault(row[2], []).append(i)
    if not at:
        at[0] = []
    return {c: np.asarray(at[c], dtype=np.int64) for c in sorted(at)}


def _seconds(iv: np.ndarray) -> float:
    return float((iv[:, 1] - iv[:, 0]).sum()) * 1e-9


def read(prof, cards: Sequence[int] = ()) -> Trace:
    """The trace of a torch.profiler.profile over the window: from the
    first harness span's start to the last one's end, on the profiler's
    clock. `cards`: the device indices of the cards the run uses."""
    events = prof.profiler.kineto_results.events()
    raw, spans = [], []
    for e in events:
        name = e.name()
        cpu = str(e.device_type()).endswith("CPU")
        if e.is_user_annotation():
            if name in SPANS and cpu:
                spans.append((e.start_ns(), e.end_ns(), name))
        elif not cpu:
            raw.append((e.start_ns(), e.end_ns(), e.device_index(), name))
    if not spans:
        raise ValueError("the trace holds no harness span")
    t0_ns = min(s for s, _, _ in spans)
    t1_ns = max(t for _, t, _ in spans)
    dev = []
    for s, t, card, name in raw:
        s, t = max(s, t0_ns), min(t, t1_ns)
        if t > s:
            dev.append((s, t, card, name))
    window = max(t1_ns - t0_ns, 1)
    iv = np.asarray([d[:2] for d in dev], dtype=np.int64).reshape(-1, 2)
    kern = np.array([_is_kernel(d[3]) for d in dev], dtype=bool)
    by_name: Dict[str, float] = defaultdict(float)
    for s, t, _, n in dev:
        by_name[short(n)] += (t - s) * 1e-9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    spans.sort()
    span_start = np.array([s for s, _, _ in spans], dtype=np.int64)
    span_end = np.array([t for _, t, _ in spans], dtype=np.int64)
    idle: Dict[str, float] = defaultdict(float)
    gaps = []
    busy_s_by_card, kernel_busy = [], 0.0
    groups = by_card(dev, cards)
    for card, at in groups.items():
        busy = _union(iv[at])
        kbusy = _union(iv[at][kern[at]]) if at.size else busy
        busy_s_by_card.append(_seconds(busy))
        kernel_busy += _seconds(kbusy)
        # the idle gaps: before the first operation, between, after the
        # last
        edges = np.concatenate([[t0_ns], busy.reshape(-1), [t1_ns]])
        gap_iv = edges.reshape(-1, 2)
        gap_iv = gap_iv[gap_iv[:, 1] > gap_iv[:, 0]]
        for s, t in gap_iv.tolist():
            # the gap's seconds shared out over the spans it overlaps
            share: Dict[str, float] = defaultdict(float)
            k = max(int(np.searchsorted(span_start, s, side="right")) - 1,
                    0)
            while k < len(spans) and span_start[k] < t:
                lo, hi = max(s, span_start[k]), min(t, span_end[k])
                if hi > lo:
                    share[spans[k][2]] += (hi - lo) * 1e-9
                k += 1
            rest = (t - s) * 1e-9 - sum(share.values())
            if rest > 1e-12:
                share["outside"] += rest
            for label, sec in share.items():
                idle[label] += sec
            gaps.append((max(share, key=share.get), (t - s) * 1e-9, card))
    n = len(groups)
    gaps.sort(key=lambda g: -g[1])
    return Trace(window_s=window * 1e-9, busy_s=sum(busy_s_by_card) / n,
                 kernel_busy_s=kernel_busy, ops=ops,
                 idle={k: v / n for k, v in idle.items()}, gaps=gaps[:TOP],
                 launches=len(dev), cards=list(groups),
                 busy_s_by_card=busy_s_by_card)


def breakdown(tr: Trace) -> dict:
    """The result line's breakdown: the device operations that took most
    time, and the idle seconds by the host's span, then the longest
    gaps (over several cards with their card), at most TOP entries
    each."""
    idle = sorted(tr.idle.items(), key=lambda kv: -kv[1])
    on = len(tr.cards) > 1
    longest = [[f"longest gap in {n}" + (f" on card {c}" if on else ""), s]
               for n, s, c in tr.gaps]
    return {"device_ops": [[n, s] for n, s in tr.ops][:TOP],
            "idle_gaps": ([[f"idle in {n}", s] for n, s in idle]
                          + longest)[:TOP]}
