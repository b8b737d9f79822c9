"""Search result types, materialization, ranking and snippets: a copy of
docodo_tpu/query/search.py.

Behavioral match of the reference result pipeline (ref
Docodo.NET/Search.cs:20-123, 365-428, 552-601, 619-751), with the
coordinate->page resolution and ranking arithmetic vectorized:

* page rank = 1 + sum(30 // max(5, gap)) + ln(n_pos) — the reference's
  30/Math.Max(5,gap) is INTEGER division, reproduced here;
* doc rank = 1 + ln(sum page ranks), x10 when the first found page is the
  header page "0";
* final doc ordering is ascending rank and the doc summary joins the three
  LOWEST-ranked pages — quirks of the reference, preserved for parity.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from docodo_tpu_torch.constants import (
    BEGIN_MATCHED_SYMBOL,
    DOC_RANK_MULTIPLY,
    END_MATCHED_SYMBOL,
    MAX_FOUND_DOCS,
    MAX_FOUND_PAGES,
)


@dataclass
class WordInfo:
    word: str = ""
    n_found: int = 0
    original_word: str = ""
    n_orig_found: int = 0


class ResultDocPage:
    __slots__ = ("id", "pos", "text", "_rank")

    def __init__(self, page_id: str, pos=None, rank: float = None):
        self.id = page_id
        self.pos: List[int] = pos if pos is not None else []
        self.text: Optional[str] = None
        # batch materialization precomputes ranks vectorized (one
        # reduceat across all runs — the per-position Python loop was
        # 57% of the host serving path, SERVE_PROFILE_r05); ad-hoc
        # construction leaves it None and the property computes lazily
        self._rank = rank

    @property
    def rank(self) -> float:
        if self._rank is not None:
            return self._rank
        bonus = 0
        p = self.pos
        for q in range(1, len(p)):
            bonus += 30 // max(5, p[q] - p[q - 1])
        return 1.0 + bonus + math.log(len(p)) if p else 1.0

    def __eq__(self, other):
        return (
            isinstance(other, ResultDocPage)
            and self.id == other.id
            and list(self.pos) == list(other.pos)
        )

    def __repr__(self):
        return f"ResultDocPage(id={self.id!r}, n={len(self.pos)})"


class ResultDocument:
    def __init__(self, name: str):
        self.name = name
        self.pages: List[ResultDocPage] = []
        self.rank: float = 0.0
        self.summary: str = ""
        self.headers: Dict[str, str] = {}
        self.found_words: List[str] = []

    def make_headers(self, text: str) -> None:
        self.headers = {}
        splits = re.split("[=\n]", text)
        for q in range(0, len(splits) - 1, 2):
            if splits[q] not in self.headers:
                self.headers[splits[q]] = splits[q + 1]

    def __repr__(self):
        return f"ResultDocument({self.name!r}, pages={len(self.pages)})"


class SearchResult:
    def __init__(self):
        self.found_docs: List[ResultDocument] = []
        self.found_pages: List[ResultDocPage] = []
        self.success = True
        self.error = ""
        self.words: List[WordInfo] = []
        # sharded serving (parallel/serving.py): the query's proximity
        # window could cross a shard boundary, and was served from the
        # shards anyway (boundary="flag"), or evaluated exactly on the
        # host instead (the default "reserve")
        self.boundary_risk = False
        self.boundary_reserved = False

    def __eq__(self, other):
        if isinstance(other, SearchResult):
            return self.found_pages == other.found_pages
        return NotImplemented

    # .NET-style aliases used by the server JSON layer
    @property
    def foundDocs(self):
        return self.found_docs

    @property
    def foundPages(self):
        return self.found_pages


def result_fields(res: SearchResult) -> dict:
    """Every field a client reads of a result, for holding two results
    equal as a whole: success and error, the found pages (id, positions,
    rank, snippet), the found docs in order (name, rank, summary,
    headers, found words, pages) and the words' posting counts."""
    return dict(
        success=res.success, error=res.error,
        pages=[(p.id, list(p.pos), p.rank, p.text) for p in res.found_pages],
        docs=[(d.name, d.rank, d.summary, d.headers, d.found_words,
               [(p.id, list(p.pos), p.text) for p in d.pages])
              for d in res.found_docs],
        words=[(w.word, w.n_found, w.original_word, w.n_orig_found)
               for w in res.words])


def f32_ulps(a: float, b: float) -> int:
    """How many float32 steps lie between a and b."""
    x, y = np.float32(a).view(np.int32), np.float32(b).view(np.int32)
    return abs(int(x) - int(y))


def brief_ulps(got: SearchResult, want: SearchResult) -> Optional[int]:
    """A brief-mode result (doc ranks off the device, no snippets) held
    against `want`: None if success, error, words, the found pages (id,
    positions, rank) or the docs' order differ, else the largest float32
    ulp between two doc ranks."""
    g, w = result_fields(got), result_fields(want)
    if ((g["success"], g["error"], g["words"])
            != (w["success"], w["error"], w["words"])
            or [p[:3] for p in g["pages"]] != [p[:3] for p in w["pages"]]
            or [d[0] for d in g["docs"]] != [d[0] for d in w["docs"]]):
        return None
    return max((f32_ulps(a[1], b[1]) for a, b in zip(g["docs"], w["docs"])),
               default=0)


class ErrorSearchResult(SearchResult):
    def __init__(self, error: str):
        super().__init__()
        self.success = False
        self.error = error


def prepare_search_result(coords: np.ndarray, page_table, doc_filter,
                          located=None) -> SearchResult:
    """Coordinate stream -> found pages/docs (ref Search.cs:365-420).

    `coords` ascending uint64; `doc_filter` list of regex strings a doc
    name must match (any) to enter found_docs. `located` optionally
    carries a precomputed (page_idx, pos) pair — batch callers locate
    MANY queries' coordinates in one page-table pass and slice.
    """
    result = SearchResult()
    if coords is None or len(coords) == 0 or len(page_table) == 0:
        return result
    coords = np.asarray(coords, dtype=np.uint64)
    page_idx, pos = (
        located if located is not None else page_table.locate(coords)
    )
    # runs of equal page index
    n = page_idx.size
    change = np.empty(n, dtype=bool)
    change[0] = True
    np.not_equal(page_idx[1:], page_idx[:-1], out=change[1:])
    run_starts = np.flatnonzero(change)
    run_ends = np.append(run_starts[1:], n)

    # page ranks VECTORIZED across all runs (1 + sum(30 // max(5, gap))
    # + ln(n_pos), ref Search.cs:99-111 integer division) — but only
    # for BIG results: measured 9.9 us (python per-page loops) vs
    # 13.4 us (always-vectorized) per call on the serving mix whose
    # results average ~5 positions — the numpy op overhead beats short
    # loops, and long position lists invert the trade. Threshold from
    # that A/B (the JAX package's benchmarks/profile_serve.py).
    big = n >= 64
    if big:
        pos64 = pos.astype(np.int64)
        d = np.empty(n, dtype=np.int64)
        d[0] = 5
        np.subtract(pos64[1:], pos64[:-1], out=d[1:])
        bonus = np.where(change, 0, 30 // np.maximum(5, d))
        run_bonus = np.add.reduceat(bonus, run_starts)
        run_counts = run_ends - run_starts
        run_ranks = 1.0 + run_bonus + np.log(run_counts)

    filters = [re.compile(f) for f in doc_filter]
    last_doc: Optional[ResultDocument] = None
    prev_doc_idx = -1
    page_doc_arr = page_table.page_doc
    page_ids = page_table.page_ids
    for ri, (a, b) in enumerate(zip(run_starts.tolist(),
                                    run_ends.tolist())):
        pg = int(page_idx[a])
        page = ResultDocPage(page_ids[pg], pos[a:b].tolist(),
                             rank=float(run_ranks[ri]) if big else None)
        result.found_pages.append(page)
        doc_idx = int(page_doc_arr[pg])
        if doc_idx != prev_doc_idx or last_doc is None:
            doc = ResultDocument(page_table.doc_names[doc_idx])
            if len(result.found_docs) < MAX_FOUND_DOCS:
                matched = not filters or any(
                    f.search(doc.name) for f in filters
                )
                if matched:
                    result.found_docs.append(doc)
            last_doc = doc
            prev_doc_idx = doc_idx
        last_doc.pages.append(page)
        last_doc.rank += page.rank
        if len(result.found_pages) > MAX_FOUND_PAGES:
            break
    return result


def finalize_doc_ranks(result: SearchResult) -> SearchResult:
    """Rank-only half of doc materialization (no snippet IO): doc rank =
    1 + ln(sum of page ranks), x10 when the header page "0" leads, docs
    ascending by rank (ref Search.cs:552-557, 599 incl. the ascending-
    sort quirk). Used by brief serving modes on every device path so
    ranks/order match the host engine regardless of materialization."""
    for doc in result.found_docs:
        total = doc.rank
        doc.rank = 1 + math.log(total) if total > 0 else 1.0
        if doc.pages and doc.pages[0].id == "0":
            doc.rank *= DOC_RANK_MULTIPLY
    result.found_docs.sort(key=lambda d: d.rank)
    return result


def combine_search_results(res1: SearchResult, res2: SearchResult) -> SearchResult:
    """Keep only docs present in both results (ref Search.cs:423-428)."""
    names = {d.name for d in res2.found_docs}
    res1.found_docs = [d for d in res1.found_docs if d.name in names]
    return res1


# ---------------------------------------------------------------------------
# snippets / highlighting (ref Search.cs:619-751)
# ---------------------------------------------------------------------------

_WORD_END_RE = re.compile(r"(?<=\w)\b")


def _units_to_codepoints(text: str, positions: List[int]) -> List[int]:
    """Translate UTF-16 code-unit offsets (the engine's coordinate unit,
    matching C# string indexing) into Python code-point offsets.

    Identity for BMP-only text (the overwhelmingly common case); with
    astral characters each one occupies two units but one code point,
    so positions after it must shift left."""
    n_units = len(text.encode("utf-16-le")) // 2
    if n_units == len(text):
        return positions
    # cumulative unit offset at the START of each code point
    widths = np.fromiter(
        ((2 if ord(c) > 0xFFFF else 1) for c in text),
        dtype=np.int64, count=len(text),
    )
    unit_starts = np.concatenate([[0], np.cumsum(widths)[:-1]])
    idx = np.searchsorted(
        unit_starts, np.asarray(positions, dtype=np.int64), side="right"
    ) - 1
    return [int(i) for i in idx]


def _spans_from_positions(text: str, positions: List[int]):
    """Split `text` into (fragment, format) spans, marking the word starting
    at each position (ref SpannableString.Builder.Add, Search.cs:705-717)."""
    spans = []
    last = 0
    for p in positions:
        if p < last or p > len(text):
            continue
        spans.append((text[last:p], 0))
        # search from an offset, not a slice: text[p:] copies the tail
        # per position (quadratic on big pages). The lookbehind sees
        # text[p-1], but positions are word STARTS (preceded by a
        # non-word char or the text start), so the first match is the
        # current word's end either way.
        m = _WORD_END_RE.search(text, p)
        wordend = (m.start() - p) if m else 0
        spans.append((text[p: p + wordend], 1))
        last = p + wordend
    spans.append((text[last:], 0))
    return spans


def _spans_substring(spans, start: int, length: int):
    """Substring over spans, keeping highlighted spans whole
    (ref Search.cs:627-670)."""
    res = []
    l = 0
    for text, fmt in spans:
        l += len(text)
        if not res and l > start:
            if fmt != 0:
                res.append((text, fmt))
            else:
                res.append((text[start - l + len(text):], 0))
        elif res:
            if l >= start + length:
                if fmt != 0:
                    res.append((text, fmt))
                else:
                    res.append((text[: start + length - l + len(text)], 0))
                break
            res.append((text, fmt))
    return res


_CLEANUPS = [
    (re.compile(r"\b\W*\.+\W*\b"), ". "),
    (re.compile(r"\b\W*\?+\W*\b"), "? "),
    (re.compile(r"\b\W*!+\W*\b"), "! "),
    (re.compile(r"\b\W*:+\W*\b"), ": "),
    (re.compile(r"\b\W*,+\W*\b"), ", "),
]


def _spans_to_string(spans) -> str:
    out = []
    for text, fmt in spans:
        if fmt != 0:
            out.append(BEGIN_MATCHED_SYMBOL + text + END_MATCHED_SYMBOL)
        else:
            out.append(text)
    return "".join(out)


def highlight_positions(text: str, positions: List[int]) -> str:
    """Whole-text highlight (used for header pages, ref Search.cs:571-573)."""
    positions = _units_to_codepoints(text, positions)
    return _spans_to_string(_spans_from_positions(text, positions))


def prepare_page_text(page: ResultDocPage, text: str, max_len: int) -> tuple:
    """Snippet window around the hits with highlights.

    Returns (snippet, matched_words) — matched words feed doc.found_words.
    """
    if not page.pos or not text:
        return "", []
    # engine coordinates are UTF-16 units; Python strings index by code
    # point — translate when the page contains astral characters
    pos = _units_to_codepoints(text, page.pos)
    spans = _spans_from_positions(text, pos)
    lo = min(max(0, min(pos) - max_len // 4), len(text))
    hi = min(min(max(pos) + max_len // 4, len(text)), lo + max_len)
    res = _spans_substring(spans, lo, hi - lo)
    cleaned = []
    for t, fmt in res:
        for pat, rep in _CLEANUPS:
            t = pat.sub(rep, t)
        cleaned.append((t, fmt))
    matched = [t for t, fmt in cleaned if fmt != 0]
    return _spans_to_string(cleaned), matched
