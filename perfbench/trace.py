"""What the benchmark reads from torch.profiler's trace of its window:
the device operations' intervals (kernels, copies, sets), their union
(the seconds the device was busy), each operation's time by name, and
the gaps in which no operation ran, their seconds shared out over the
harness spans (`bench.dispatch`, `bench.finish`, `bench.between`) the
host was in meanwhile, each gap named by the span that held most of
it. Nothing is written to disk.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

SPANS = ("bench.dispatch", "bench.finish", "bench.between")
TOP = 10


@dataclass
class Trace:
    """A traced window's device time, in seconds."""

    window_s: float
    busy_s: float                 # union of every device operation
    kernel_busy_s: float          # union of the kernels alone
    ops: List[Tuple[str, float]]  # device seconds by operation, largest first
    idle: Dict[str, float]        # idle seconds by the host's span
    gaps: List[Tuple[str, float]]  # the longest idle gaps, by span
    launches: int = 0             # device operations in the window


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


def read(prof) -> Trace:
    """The trace of a torch.profiler.profile over the window: from the
    first harness span's start to the last one's end, on the profiler's
    clock."""
    events = prof.profiler.kineto_results.events()
    raw, spans = [], []
    for e in events:
        name = e.name()
        cpu = str(e.device_type()).endswith("CPU")
        if e.is_user_annotation():
            if name in SPANS and cpu:
                spans.append((e.start_ns(), e.end_ns(), name))
        elif not cpu:
            raw.append((e.start_ns(), e.end_ns(), name))
    if not spans:
        raise ValueError("the trace holds no harness span")
    t0_ns = min(s for s, _, _ in spans)
    t1_ns = max(t for _, t, _ in spans)
    dev, dev_names = [], []
    for s, t, name in raw:
        s, t = max(s, t0_ns), min(t, t1_ns)
        if t > s:
            dev.append((s, t))
            dev_names.append(name)
    window = max(t1_ns - t0_ns, 1)
    iv = np.asarray(dev, dtype=np.int64).reshape(-1, 2)
    busy = _union(iv)
    kern = np.array([_is_kernel(n) for n in dev_names], dtype=bool)
    kbusy = _union(iv[kern]) if iv.size else busy
    by_name: Dict[str, float] = defaultdict(float)
    for (s, t), n in zip(dev, dev_names):
        by_name[short(n)] += (t - s) * 1e-9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    # the idle gaps: before the first operation, between, after the last
    edges = np.concatenate([[t0_ns], busy.reshape(-1), [t1_ns]])
    gap_iv = edges.reshape(-1, 2)
    gap_iv = gap_iv[gap_iv[:, 1] > gap_iv[:, 0]]
    spans.sort()
    span_start = np.array([s for s, _, _ in spans], dtype=np.int64)
    span_end = np.array([t for _, t, _ in spans], dtype=np.int64)
    idle: Dict[str, float] = defaultdict(float)
    gaps = []
    for s, t in gap_iv.tolist():
        # the gap's seconds shared out over the spans it overlaps
        share: Dict[str, float] = defaultdict(float)
        k = max(int(np.searchsorted(span_start, s, side="right")) - 1, 0)
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
        gaps.append((max(share, key=share.get), (t - s) * 1e-9))
    gaps.sort(key=lambda g: -g[1])
    return Trace(window_s=window * 1e-9,
                 busy_s=float((busy[:, 1] - busy[:, 0]).sum()) * 1e-9,
                 kernel_busy_s=float((kbusy[:, 1] - kbusy[:, 0]).sum())
                 * 1e-9,
                 ops=ops, idle=dict(idle), gaps=gaps[:TOP],
                 launches=len(dev))


def breakdown(tr: Trace) -> dict:
    """The result line's breakdown: the device operations that took most
    time, and the idle seconds by the host's span, then the longest
    gaps, at most TOP entries each."""
    idle = sorted(tr.idle.items(), key=lambda kv: -kv[1])
    longest = [[f"longest gap in {n}", s] for n, s in tr.gaps]
    return {"device_ops": [[n, s] for n, s in tr.ops][:TOP],
            "idle_gaps": ([[f"idle in {n}", s] for n, s in idle]
                          + longest)[:TOP]}
