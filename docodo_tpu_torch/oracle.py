"""The host posting oracle: the wide-row fold of tests/test_wide_mix.py
over the host posting algebra (core/postings.py's group_and and
or_merge), for checking the port's results without the JAX package.
"""

from __future__ import annotations

import numpy as np

from docodo_tpu_torch.core.postings import group_and, or_merge

__all__ = ["fold_row", "group_and", "or_merge"]


def fold_row(words, rs):
    """One query row on the host (tests/test_wide_mix.py:51-70): each
    word's variants OR-merged in order, then the proximity-AND left fold
    of the words (ref Search.cs:501). words: per word the list of its
    variants' ascending coordinate arrays; rs: the words' windows.
    Returns the kept coordinates, ascending."""
    acc, r_acc = None, 0
    for variants, r in zip(words, rs):
        b = np.asarray(variants[0], dtype=np.uint64)
        for nxt in variants[1:]:
            b, _ = or_merge(b, nxt, 1, 1)
        if acc is None:
            acc, r_acc = b, int(r)
        else:
            acc, r_acc = group_and(acc, b, r_acc, int(r))
    return acc
