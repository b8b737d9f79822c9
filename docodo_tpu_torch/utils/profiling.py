"""Phase timing, program spans, counters and device traces: the port's
copy of docodo_tpu/utils/profiling.py, its traces over torch.profiler.

Every build phase reports into a process-wide registry (`phase`,
`record`, `report`, `format_report`, `reset`).

    with profiling.phase("build.sort"):
        ...
    print(profiling.format_report())

The query path names its steps with `span(name, batch)`: with tracing
on (`tracing(True)`, off by default) a span is a torch.profiler
record_function, so it lands in the profiler's trace on the clock of
the device operations it launched, and each collection of Python's
collector is a `host.gc` span; with tracing off a span is one shared
no-op. `count(name, n)` adds to a counter table that is always on
(`counters()`, cleared by `reset()`); the query path adds once a batch.

`device_trace(label, out_dir)` records a region under torch.profiler
(the host and, on a card, its kernels) and writes a Chrome trace
`<out_dir>/<label>.json`; with no out_dir it does nothing. `annotate`
names a span inside it (record_function). tools/profile_batch.py
traces a batch with them (--trace-dir).
"""

from __future__ import annotations

import contextlib
import gc
import os
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional, Tuple

_lock = threading.Lock()
_totals: Dict[str, float] = defaultdict(float)
_counts: Dict[str, int] = defaultdict(int)
_counters: Dict[str, int] = defaultdict(int)
# torch.profiler.record_function while tracing is on, else None
_record = None
# the host.gc span of the collection under way (collections never overlap)
_gc_open: list = []


@contextlib.contextmanager
def phase(name: str) -> Iterator[None]:
    """Time a named phase; nest freely across threads."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        record(name, time.perf_counter() - t0)


def record(name: str, seconds: float) -> None:
    """Record an externally-timed phase."""
    with _lock:
        _totals[name] += seconds
        _counts[name] += 1


def report() -> List[Tuple[str, float, int]]:
    """(name, total seconds, calls), slowest first."""
    with _lock:
        rows = [(k, _totals[k], _counts[k]) for k in _totals]
    return sorted(rows, key=lambda r: -r[1])


def reset() -> None:
    with _lock:
        _totals.clear()
        _counts.clear()
        _counters.clear()


def count(name: str, n: int = 1) -> None:
    """Add `n` to counter `name` (always on; once a batch on the hot
    path)."""
    with _lock:
        _counters[name] += n


def counters() -> Dict[str, int]:
    """Every counter since the last reset()."""
    with _lock:
        return dict(_counters)


# the span while tracing is off
_NO_SPAN = contextlib.nullcontext()


def span(name: str, batch: Optional[int] = None):
    """A named step of the program: with tracing on, a record_function
    whose args are the batch's sequence number; off, a shared no-op that
    reads no clock and makes no torch call."""
    rec = _record
    if rec is None:
        return _NO_SPAN
    return rec(name, None if batch is None else str(batch))


def _gc_span(phase_name: str, info: dict) -> None:
    """gc.callbacks hook: a host.gc span around each collection, its
    generation as the span's args."""
    rec = _record
    if phase_name == "start":
        if rec is not None:
            r = rec("host.gc", str(info.get("generation")))
            r.__enter__()
            _gc_open.append(r)
    elif _gc_open:
        _gc_open.pop().__exit__(None, None, None)


def tracing(on: bool) -> None:
    """Turn the program's spans and the collector's host.gc spans on or
    off (off by default). Off, no hook stays in gc.callbacks."""
    global _record
    with _lock:
        if on and _record is None:
            import torch

            _record = torch.profiler.record_function
            gc.callbacks.append(_gc_span)
        elif not on and _record is not None:
            _record = None
            gc.callbacks.remove(_gc_span)
            _gc_open.clear()


def format_report() -> str:
    return "\n".join(
        f"{name:30s} {total*1e3:10.1f} ms  x{calls}"
        for name, total, calls in report()
    )


@contextlib.contextmanager
def device_trace(label: str = "docodo",
                 out_dir: Optional[str] = None) -> Iterator[None]:
    """The region under torch.profiler, written as a Chrome trace to
    `<out_dir>/<label>.json`; nothing at all without out_dir."""
    if not out_dir:
        yield
        return
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, f"{label}.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named span inside a device trace (torch.profiler's
    record_function)."""
    import torch

    with torch.profiler.record_function(name):
        yield
