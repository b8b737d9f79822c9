"""Corpus tokenizer: a copy of docodo_tpu/lang/tokenizer.py for the port's
own host build.

Token semantics match the reference build loop (ref Docodo.NET/Build.cs:526-531):
tokens are maximal runs matching \\p{L}+ or \\p{N}+ over the lowercased text,
and a token's coordinate is its character offset. "Character" means UTF-16
code unit (C# char): we classify the UTF-16 encoding of the text, so offsets
— and the treatment of astral characters as non-letters (surrogates are
category Cs) — agree with the reference exactly.

The classifier is a 64K-entry category table driving vectorized NumPy run
detection.
"""

from __future__ import annotations

import unicodedata
from typing import List, Tuple

import numpy as np

_TABLE: np.ndarray | None = None  # uint8[65536]: 0 other, 1 letter, 2 number


def _unit_table() -> np.ndarray:
    global _TABLE
    if _TABLE is None:
        tbl = np.zeros(0x10000, dtype=np.uint8)
        for cp in range(0x10000):
            if 0xD800 <= cp <= 0xDFFF:
                continue  # surrogates: not letters (matches UTF-16 regex)
            cat = unicodedata.category(chr(cp))
            if cat[0] == "L":
                tbl[cp] = 1
            elif cat[0] == "N":
                tbl[cp] = 2
        _TABLE = tbl
    return _TABLE


def lower_keep_length(text: str) -> str:
    """Lowercase preserving length (C# ToLower is a per-char map)."""
    low = text.lower()
    if len(low) == len(text):
        return low
    return "".join(
        (c.lower() if len(c.lower()) == 1 else c) for c in text
    )


def to_units(text: str) -> np.ndarray:
    """UTF-16 code units of `text` as uint16."""
    return np.frombuffer(text.encode("utf-16-le"), dtype="<u2")


def tokenize(text: str, lowered: bool = False) -> Tuple[List[str], np.ndarray]:
    """Tokenize lowercased `text`.

    Returns (words, starts): lowercase token strings and their UTF-16
    code-unit offsets in the lowercased text. No length filtering here —
    the index builder applies the 3..32 rule (ref Index.cs:97,113).
    Pass lowered=True when the caller already ran lower_keep_length
    (the build hot loop — avoids a second full lowercase pass).
    """
    low = text if lowered else lower_keep_length(text)
    units = to_units(low)
    n = units.size
    if n == 0:
        return [], np.zeros(0, dtype=np.int64)
    cls = _unit_table()[units]
    # run boundaries: position 0, every class change, and the end
    change = np.empty(n, dtype=bool)
    change[0] = True
    np.not_equal(cls[1:], cls[:-1], out=change[1:])
    bounds = np.flatnonzero(change)
    run_cls = cls[bounds]
    keep = run_cls > 0
    starts = bounds[keep]
    ends = np.append(bounds[1:], n)[keep]
    raw = units.tobytes()
    words = [
        raw[2 * a: 2 * b].decode("utf-16-le")
        for a, b in zip(starts.tolist(), ends.tolist())
    ]
    return words, starts.astype(np.int64)


def char_len(text: str) -> int:
    """Length of `text` in UTF-16 code units (C# String.Length)."""
    return len(text.encode("utf-16-le")) // 2
