"""The standard 10k query mix of the benchmarks: a copy of
benchmarks/common.standard_mix for the port, which imports nothing of the
benchmarks or the JAX package."""

from __future__ import annotations

import numpy as np


def standard_mix(counts: np.ndarray, id_to_term, n_queries: int,
                 seed: int = 42):
    """The standard mixed word/phrase/proximity query set over the real
    term distribution (BASELINE.json: '10k concurrent mixed queries').
    Returns (terms int32[N, 2], rs int32[N, 2])."""
    rng = np.random.default_rng(seed)
    eligible = np.flatnonzero(counts >= 2)
    terms = np.full((n_queries, 2), -1, dtype=np.int32)
    rs = np.ones((n_queries, 2), dtype=np.int32)
    for i in range(n_queries):
        a, b = rng.choice(eligible, size=2, replace=False)
        kind = i % 3
        if kind == 0:      # single word
            terms[i, 0] = a
            rs[i, 0] = 255 + len(id_to_term[a])
        elif kind == 1:    # ordered "phrase"
            terms[i] = (a, b)
            rs[i] = (-(len(id_to_term[a]) + 4), -(len(id_to_term[b]) + 4))
        else:              # proximity AND, default dist
            terms[i] = (a, b)
            rs[i] = (255 + len(id_to_term[a]), 255 + len(id_to_term[b]))
    return terms, rs
