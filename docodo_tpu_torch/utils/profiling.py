"""Phase timing and device traces: the port's copy of
docodo_tpu/utils/profiling.py, its traces over torch.profiler.

Every build phase reports into a process-wide registry (`phase`,
`record`, `report`, `format_report`, `reset`).

    with profiling.phase("build.sort"):
        ...
    print(profiling.format_report())

`device_trace(label, out_dir)` records a region under torch.profiler
(the host and, on a card, its kernels) and writes a Chrome trace
`<out_dir>/<label>.json`; with no out_dir it does nothing. `annotate`
names a span inside it (record_function). tools/profile_batch.py
traces a batch with them (--trace-dir).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional, Tuple

_lock = threading.Lock()
_totals: Dict[str, float] = defaultdict(float)
_counts: Dict[str, int] = defaultdict(int)


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
