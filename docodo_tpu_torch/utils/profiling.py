"""Phase timing: the port's copy of docodo_tpu/utils/profiling.py,
without its device traces (`device_trace`, `annotate`), which nothing
calls.

Every build phase reports into a process-wide registry (`phase`,
`record`, `report`, `format_report`, `reset`).

    with profiling.phase("build.sort"):
        ...
    print(profiling.format_report())
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Tuple

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
