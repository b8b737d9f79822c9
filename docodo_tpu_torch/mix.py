"""The query mixes of the benchmarks: copies of
benchmarks/common.standard_mix and wide_mix for the port, which imports
nothing of the benchmarks or the JAX package; and the request strings a
server is sent (benchmarks/serve_qps.py's recipe, and a wide one beside
it)."""

from __future__ import annotations

import random

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


W_WIDE = 4
V_WIDE = 8


def wide_mix(counts: np.ndarray, id_to_term, n_queries: int,
             seed: int = 77):
    """The second recorded mix, the reference's own request surface
    (ref XUnitDocodoTest/IndexTest.cs:164-226): 3-4-word phrases, nested
    OR variant groups, wildcard-style variant unions and field rows.

    Returns (terms int32[R, 4, 8], rs int32[R, 4], qid int32[R]): row r
    belongs to logical query qid[r]. A field query emits two rows (the
    main pair and the field row), so R >= n_queries."""
    rng = np.random.default_rng(seed)
    eligible = np.flatnonzero(counts >= 2)
    by_freq = eligible[np.argsort(counts[eligible])]
    # wildcard expansions hit mostly rare terms plus a few frequent ones
    rare = by_freq[: max(8, int(by_freq.size * 0.8))]
    rows_t, rows_r, rows_q = [], [], []

    def wlen(t):
        return len(id_to_term[int(t)])

    def emit(words, ordered, qid):
        """words: list of per-word variant lists."""
        t = np.full((W_WIDE, V_WIDE), -1, np.int32)
        r = np.ones(W_WIDE, np.int32)
        for w, vs in enumerate(words):
            t[w, : len(vs)] = vs
            ml = max(wlen(v) for v in vs)
            r[w] = -(ml + 4) if ordered else 255 + ml
        rows_t.append(t)
        rows_r.append(r)
        rows_q.append(qid)

    for i in range(n_queries):
        kind = i % 7
        picks = rng.choice(eligible, size=4, replace=False)
        if kind == 0:    # single word
            emit([[picks[0]]], False, i)
        elif kind == 1:  # 2-word proximity (continuity with standard)
            emit([[picks[0]], [picks[1]]], False, i)
        elif kind == 2:  # 3-word exact phrase
            emit([[p] for p in picks[:3]], True, i)
        elif kind == 3:  # 4-word proximity AND
            emit([[p] for p in picks], False, i)
        elif kind == 4:  # nested OR: w1 (a|b|c), ref "old (lady|ladies)"
            emit([[picks[0]], list(picks[1:4])], False, i)
        elif kind == 5:  # wildcard-style union: one word, 8 variants
            vs = rng.choice(rare, size=V_WIDE, replace=False)
            emit([list(vs)], False, i)
        else:            # field query: main pair + separate field row
            emit([[picks[0]], [picks[1]]], False, i)
            emit([[picks[2]]], False, i)
    return (np.stack(rows_t), np.stack(rows_r),
            np.asarray(rows_q, np.int32))


def mix_queries(terms: np.ndarray, rs: np.ndarray, id_to_term):
    """Mix rows (term ids [R, W, V] or [R, W], -1 padded; windows
    [R, W]) as search_batch_full's queries: per row a list of (codes, r)
    groups, codes a term key or a tuple of variant keys."""
    if terms.ndim == 2:
        terms = terms[:, :, None]
    out = []
    for trow, rrow in zip(terms, rs):
        groups = []
        for vs, r in zip(trow, rrow):
            keys = tuple(id_to_term[int(t)] for t in vs if t >= 0)
            if keys:
                groups.append((keys[0] if len(keys) == 1 else keys, int(r)))
        out.append(groups)
    return out


def serve_words(index) -> list:
    """The words serve_qps.py draws its requests from (:70-72): the 1000
    terms of most stored posting volume (Index.calc_histogram, ranked by
    the words their varint lists take), alphabetic and of 4 letters or
    more, ranked 50-400."""
    arr = index.arr
    vol = np.array([arr.enc_count(t) for t in range(len(arr))])
    top = np.argsort(-vol, kind="stable")[:1000]
    words = [arr.terms[t] for t in top.tolist()]
    return [w for w in words if w[0].isalpha() and len(w) >= 4][50:400]


def serve_requests(index, n: int, seed: int = 7) -> list:
    """benchmarks/serve_qps.py's requests (:73-84): with random.Random(7)
    over serve_words, request i is a word, a "quoted phrase" of two or
    a proximity AND of two, by i % 3."""
    words = serve_words(index)
    rng = random.Random(seed)
    reqs = []
    for i in range(n):
        kind = i % 3
        if kind == 0:
            reqs.append(rng.choice(words))
        elif kind == 1:
            reqs.append(f'"{rng.choice(words)} {rng.choice(words)}"')
        else:
            reqs.append(f"{rng.choice(words)} {rng.choice(words)}")
    return reqs


def wide_requests(index, n: int, seed: int = 77) -> list:
    """Wide request strings over the same words, by i % 8: `c (a|b)` and
    `a|b` alternations, a `?` wildcard (inside a word of 6 letters or
    more: few full forms match) alone and in an AND, 3- and 4-word
    phrases, a 3-word proximity AND, and a {name=...} field request of a
    document's header page alone or with a word; every 25th request
    instead holds a `~` (host-served: the reference gives it no
    meaning), every 20th a `-filter:` doc-name regex."""
    words = serve_words(index)
    long_words = [w for w in words if len(w) >= 6]
    docs = [d.split(":", 1)[1] for d in index.pages.doc_names]
    rng = random.Random(seed)
    pick = lambda k: [rng.choice(words) for _ in range(k)]
    reqs = []
    for i in range(n):
        if i % 25 == 24:
            a, b = pick(2)
            reqs.append(f"{a} ~{b}")
            continue
        kind = i % 8
        if kind == 0:
            a, b, c = pick(3)
            req = f"{c} ({a}|{b})"
        elif kind == 1:
            a, b = pick(2)
            req = f"{a}|{b}"
        elif kind in (2, 3):
            w = rng.choice(long_words)
            req = w[:2] + "?" + w[3:]
            if kind == 3:
                req = f"{req} {rng.choice(words)}"
        elif kind == 4:
            req = '"' + " ".join(pick(3)) + '"'
        elif kind == 5:
            req = '"' + " ".join(pick(4)) + '"'
        elif kind == 6:
            req = " ".join(pick(3))
        else:
            req = "{name=" + rng.choice(docs) + "}"
            if i % 16 == 15:
                req = f"{rng.choice(words)} {req}"
        if i % 20 == 19:
            req += f" -filter:{rng.choice(docs)[:-1]}.*"
        reqs.append(req)
    return reqs
