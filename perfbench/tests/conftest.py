"""The benchmark's tests: the CPU at small sizes. Tests marked `cuda`
need the card and skip without it (decided inside the test)."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the cells' sizes cut for a test run on the CPU
SMALL_CONFIG = {"corpus_chars": 3_000_000}
SMALL_PARAMS = {"batch": 64, "pool_batches": 6}
