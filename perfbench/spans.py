"""What the program's own spans say of a traced window: the port's
`query.*`, `route.*`, `tail.*` and `host.gc` spans (docodo_tpu_torch
utils/profiling.span, recorded while the program's tracing is on) read
from the same torch.profiler events as trace.read, over the same window
(the first harness span's start to the last one's end).

- Host seconds of each program span, total, self (the span's time less
  what its child spans cover) and its longest call.
- Device seconds by program span: each device operation is linked by
  its correlation id to the runtime call that launched it on the host,
  and goes to the innermost program span that held that call on its own
  thread; the device runs behind the host, so time overlap on the device
  says nothing of who launched. An operation launched under no program
  span is `unattributed`.
- Device idle seconds by program span: trace.read's gaps, split over the
  innermost span the harness's thread was in meanwhile; gap time in no
  program span keeps its harness span's label (`outside` if none). Over
  several cards, as in trace.read, each card's gaps are its own and the
  idle and busy seconds are the mean of the cards'.
- Blocking runtime calls by span: count and seconds of every
  cuda*Synchronize, cudaMalloc, cudaFree, cudaHostAlloc and plain
  cudaMemcpy, by the innermost span of their thread.

Device copies of user annotations are not device work here either.
Nothing here changes what trace.read reads.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from perfbench import trace

PROGRAM = ("query.", "route.", "tail.", "host.gc")
BLOCKING = ("cudaMalloc", "cudaFree", "cudaHostAlloc", "cudaMemcpy")
UNATTRIBUTED = "unattributed"
TOP = trace.TOP


def is_program(name: str) -> bool:
    return name.startswith(PROGRAM)


def is_runtime(name: str) -> bool:
    """A CUDA API call on the host (cudaLaunchKernel, cuLaunchKernel,
    cudaStreamSynchronize, ...)."""
    return name.startswith("cuda") or (name.startswith("cu")
                                       and name[2:3].isupper())


def is_blocking(name: str) -> bool:
    """A CUDA API call that makes the host wait: any cuda*Synchronize,
    an allocation or free of device or pinned memory, a copy that is not
    async."""
    return ((name.startswith("cuda") and name.endswith("Synchronize"))
            or name in BLOCKING)


@dataclass
class Spans:
    """A traced window's readings by program span, in seconds."""

    # name: (total, self, calls, longest call)
    host: Dict[str, Tuple[float, float, int, float]]
    device: Dict[str, float]       # device seconds by launching span
    idle: Dict[str, float]         # idle seconds by the host's span
    waits: Dict[Tuple[str, str], Tuple[int, float]]  # (span, call): n, s
    device_s: float                # every device operation's seconds
    busy_s: float                  # a card's union, mean (trace.read's)
    batches: int                   # query.dispatch spans in the window
    cards: int = 1                 # cards that busy_s is the mean over


class _Innermost:
    """The innermost of one thread's nested spans at any time: change
    points of a step function built by a sweep over the spans."""

    def __init__(self, spans: List[Tuple[int, int, str]]):
        spans = sorted(spans, key=lambda s: (s[0], -s[1]))
        times: List[int] = []
        labels: List[Optional[str]] = []
        stack: List[Tuple[int, str]] = []

        def close_until(t: int) -> None:
            while stack and stack[-1][0] <= t:
                end, _ = stack.pop()
                times.append(end)
                labels.append(stack[-1][1] if stack else None)

        for s, t, name in spans:
            close_until(s)
            if stack:  # a span never outlives its parent on one thread
                t = min(t, stack[-1][0])
            times.append(s)
            labels.append(name)
            stack.append((t, name))
        close_until(np.iinfo(np.int64).max)
        self.times = np.asarray(times, dtype=np.int64)
        self.labels = labels

    def at(self, t: np.ndarray) -> List[Optional[str]]:
        """The innermost span's name at each time of `t`."""
        k = np.searchsorted(self.times, t, side="right") - 1
        return [self.labels[i] if i >= 0 else None for i in k.tolist()]

    def split(self, s: int, t: int) -> Dict[Optional[str], int]:
        """Nanoseconds of [s, t) under each innermost span name."""
        lo = int(np.searchsorted(self.times, s, side="right"))
        hi = int(np.searchsorted(self.times, t, side="left"))
        cuts = [s] + self.times[lo:hi].tolist() + [t]
        first = self.labels[lo - 1] if lo > 0 else None
        out: Dict[Optional[str], int] = defaultdict(int)
        for label, a, b in zip([first] + self.labels[lo:hi], cuts,
                               cuts[1:]):
            out[label] += b - a
        return out


def _device(e) -> bool:
    return not str(e.device_type()).endswith("CPU")


def read(prof, cards: Sequence[int] = ()) -> Spans:
    """The program spans' readings of a torch.profiler.profile over a
    harness window; `cards` as trace.read takes them."""
    events = prof.profiler.kineto_results.events()
    bench, prog, ops, calls = [], [], [], {}
    op_thread: Dict[int, int] = {}
    for e in events:
        name = e.name()
        if e.is_user_annotation():
            if _device(e):
                continue
            row = (e.start_ns(), e.end_ns(), name, e.start_thread_id())
            if name in trace.SPANS:
                bench.append(row)
            elif is_program(name):
                prog.append(row)
        elif _device(e):
            ops.append((e.start_ns(), e.end_ns(), e.device_index(),
                        e.correlation_id()))
        elif is_runtime(name):
            calls[e.correlation_id()] = (e.start_ns(), e.end_ns(), name,
                                         e.start_thread_id(),
                                         e.linked_correlation_id())
        else:
            op_thread[e.correlation_id()] = e.start_thread_id()
    if not bench:
        raise ValueError("the trace holds no harness span")
    t0 = min(s for s, _, _, _ in bench)
    t1 = max(t for _, t, _, _ in bench)

    def thread_of(call) -> int:
        # a runtime call's own thread id may be the OS's; the torch op it
        # ran under carries the profiler's, as the spans do
        return op_thread.get(call[4], call[3])

    by_thread: Dict[int, list] = defaultdict(list)
    for s, t, name, tid in prog:
        by_thread[tid].append((s, t, name))
    for s, t, name, tid in bench:
        by_thread[tid].append((s, t, name))
    inner = {tid: _Innermost(sp) for tid, sp in by_thread.items()}

    # host seconds: total by name, self from the innermost step function
    host_total: Dict[str, float] = defaultdict(float)
    host_calls: Dict[str, int] = defaultdict(int)
    host_max: Dict[str, float] = defaultdict(float)
    batches = 0
    for s, t, name, _ in prog:
        s, t = max(s, t0), min(t, t1)
        if t > s:
            host_total[name] += (t - s) * 1e-9
            host_calls[name] += 1
            host_max[name] = max(host_max[name], (t - s) * 1e-9)
            batches += name == "query.dispatch"
    host_self: Dict[str, float] = defaultdict(float)
    for tid, inn in inner.items():
        for label, ns in inn.split(t0, t1).items():
            if label is not None and is_program(label):
                host_self[label] += ns * 1e-9
    host = {n: (host_total[n], host_self[n], host_calls[n], host_max[n])
            for n in host_total}

    # device seconds by launching span
    device: Dict[str, float] = defaultdict(float)
    iv = []
    pending: Dict[int, List[Tuple[int, float]]] = defaultdict(list)
    for s, t, card, corr in ops:
        s, t = max(s, t0), min(t, t1)
        if t <= s:
            continue
        iv.append((s, t, card))
        call = calls.get(corr)
        if call is None:
            device[UNATTRIBUTED] += (t - s) * 1e-9
        else:
            pending[thread_of(call)].append((call[0], (t - s) * 1e-9))
    for tid, rows in pending.items():
        inn = inner.get(tid)
        labels = (inn.at(np.array([r[0] for r in rows], dtype=np.int64))
                  if inn is not None else [None] * len(rows))
        for label, (_, sec) in zip(labels, rows):
            device[label if label is not None and is_program(label)
                   else UNATTRIBUTED] += sec
    iv_arr = np.asarray([r[:2] for r in iv], dtype=np.int64).reshape(-1, 2)

    # each card's idle gaps by the harness thread's innermost span
    main = inner[bench[0][3]]
    idle: Dict[str, float] = defaultdict(float)
    busy_s = 0.0
    groups = trace.by_card(iv, cards)
    for at in groups.values():
        busy = trace._union(iv_arr[at])
        busy_s += trace._seconds(busy)
        edges = np.concatenate([[t0], busy.reshape(-1), [t1]])
        gaps = edges.reshape(-1, 2)
        for s, t in gaps[gaps[:, 1] > gaps[:, 0]].tolist():
            for label, ns in main.split(s, t).items():
                idle[label if label is not None else "outside"] += ns * 1e-9
    n = len(groups)

    # blocking runtime calls by span
    waits: Dict[Tuple[str, str], List[float]] = defaultdict(
        lambda: [0, 0.0])
    for call in calls.values():
        s, t, name = call[0], call[1], call[2]
        if not is_blocking(name) or not (t0 <= s < t1):
            continue
        inn = inner.get(thread_of(call))
        label = inn.at(np.array([s], dtype=np.int64))[0] if inn else None
        w = waits[(label or "outside", name)]
        w[0] += 1
        w[1] += (t - s) * 1e-9
    return Spans(host=host, device=dict(device),
                 idle={k: v / n for k, v in idle.items()},
                 waits={k: (int(v[0]), v[1]) for k, v in waits.items()},
                 device_s=float(sum(r[1] - r[0] for r in iv)) * 1e-9,
                 busy_s=busy_s / n, batches=batches, cards=n)


def breakdown(sp: Spans) -> dict:
    """The three breakdown keys of a result line, at most TOP entries
    each, largest first: device seconds by launching span, idle seconds
    by the host's span, and blocking runtime calls ("<span>: <call>",
    count, seconds)."""
    def top(d):
        return [[n, s] for n, s in sorted(d.items(), key=lambda kv: -kv[1])
                ][:TOP]
    waits = sorted(sp.waits.items(), key=lambda kv: -kv[1][1])[:TOP]
    return {"device_by_span": top(sp.device),
            "idle_by_span": top(sp.idle),
            "waits_by_span": [[f"{span}: {call}", n, s]
                              for (span, call), (n, s) in waits]}


def shares(sp: Spans, tr: trace.Trace) -> Dict[str, Optional[float]]:
    """How much the program's spans name: the share of trace.read's idle
    seconds in bench.dispatch that fall inside a program span, and the
    share of device seconds launched under one."""
    idle = tr.idle.get("bench.dispatch", 0.0)
    dev = sp.device_s
    return {"dispatch_idle_named": (1.0 - sp.idle.get("bench.dispatch",
                                                       0.0) / idle
                                    if idle > 0 else None),
            "device_attributed": (1.0 - sp.device.get(UNATTRIBUTED, 0.0)
                                  / dev if dev > 0 else None)}


def metrics(sp: Optional[Spans]) -> Dict[str, Optional[float]]:
    """The per-layer readings the program's spans give: compile_ms,
    upload_ms, launch_ms, gc_ms (mean ms a batch in query.compile,
    query.upload, query.launch and host.gc) and fetch_busy_pct (device
    seconds launched under route.fetch over the window's busy seconds,
    summed over the cards, in percent). Every value is None without a
    trace or a batch."""
    out: Dict[str, Optional[float]] = dict.fromkeys(
        ("compile_ms", "upload_ms", "launch_ms", "gc_ms", "fetch_busy_pct"))
    if sp is None or not sp.batches:
        return out
    for key, span in (("compile_ms", "query.compile"),
                      ("upload_ms", "query.upload"),
                      ("launch_ms", "query.launch"), ("gc_ms", "host.gc")):
        total = sp.host[span][0] if span in sp.host else 0.0
        out[key] = 1e3 * total / sp.batches
    if sp.busy_s > 0:
        out["fetch_busy_pct"] = 100.0 * sp.device.get("route.fetch",
                                                      0.0) / (sp.busy_s
                                                              * sp.cards)
    return out
