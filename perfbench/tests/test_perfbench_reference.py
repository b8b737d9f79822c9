"""The plain reference: the frozen fold against the port's host algebra,
and the whole answer against the port's search_batch_full, field for
field (the plain route on the CPU; on the card, marked `cuda`, the
kernel route)."""

import json
import os

import numpy as np
import pytest
import torch

from docodo_tpu_torch import oracle
from docodo_tpu_torch.core import postings as port_postings
from docodo_tpu_torch.index import IndexPage, ListDataSource, build_index
from docodo_tpu_torch.ops.device_index import DeviceIndex
from perfbench import corpus, harness, traffic
from perfbench.reference import fold
from perfbench.reference.search import (FIELDS, Postings, answers,
                                        fold_rows, hit_tier)


def sorted_list(rng, n, hi, dups=False):
    a = rng.integers(0, hi, size=n)
    return np.sort(a if dups else np.unique(a)).astype(np.int64)


@pytest.mark.parametrize("seed", range(6))
def test_fold_matches_the_ports_algebra(seed):
    rng = np.random.default_rng(seed)
    for _ in range(60):
        hi = int(rng.integers(50, 5000))
        dups = bool(rng.integers(0, 2))
        a = sorted_list(rng, int(rng.integers(0, 300)), hi, dups)
        b = sorted_list(rng, int(rng.integers(0, 300)), hi, dups)
        r1 = int(rng.choice([-12, -7, 0, 3, 30, 260]))
        r2 = int(rng.choice([-9, -5, 0, 4, 40, 262]))
        got, gr = fold.group_and(a, b, r1, r2)
        want, wr = port_postings.group_and(a.astype(np.uint64),
                                           b.astype(np.uint64), r1, r2)
        assert gr == wr and np.array_equal(got, want.astype(np.int64))
        got, gr = fold.or_merge(a, b, r1, r2)
        want, wr = port_postings.or_merge(a.astype(np.uint64),
                                          b.astype(np.uint64), r1, r2)
        assert gr == wr and np.array_equal(got, want.astype(np.int64))
    for _ in range(30):
        w = int(rng.integers(1, 4))
        words = [[sorted_list(rng, int(rng.integers(1, 200)), 3000)
                  for _ in range(int(rng.integers(1, 4)))] for _ in range(w)]
        rs = [int(rng.choice([-8, 259, 263])) for _ in range(w)]
        want = oracle.fold_row(
            [[v.astype(np.uint64) for v in vs] for vs in words], rs)
        assert np.array_equal(fold.fold_row(words, rs),
                              np.asarray(want, dtype=np.int64))


def test_hit_tiers():
    assert hit_tier(10, 1024) == 128
    assert hit_tier(28, 1024) == 128
    assert hit_tier(29, 1024) == 512
    assert hit_tier(200, 1024) == 1024
    assert hit_tier(10**6, 1024) == 1024
    assert hit_tier(10, 100) == 100


def small_index(name, chars, seed, device):
    with open(os.path.join(harness.HERE, "configs", f"{name}.json")) as f:
        cfg = dict(json.load(f), corpus_chars=chars)
    c = corpus.generate(cfg, seed, IndexPage)
    ind = build_index(ListDataSource("synth", c.documents), device=device)
    return c, DeviceIndex.from_index(ind, device=device)


def mixed_rows(c, rng, n):
    """Rows of every shape the reference answers: 1-3 words of 1-3
    variants over the whole vocabulary (rare words reach the small hit
    tiers and empty answers), proximity or ordered."""
    seen = np.flatnonzero(c.counts() > 0)
    wlen = np.array([len(w) for w in c.words])
    rows, queries = [], []
    for _ in range(n):
        w, v = int(rng.integers(1, 4)), int(rng.integers(1, 4))
        ids = rng.choice(seen, size=w * v, replace=False).reshape(w, v)
        ordered = bool(rng.integers(0, 2))
        q = []
        for variants in ids.tolist():
            m = int(wlen[variants].max())
            r = -(m + 4) if ordered else 255 + m
            keys = tuple(c.words[x] for x in variants)
            q.append((keys[0] if len(keys) == 1 else keys, r))
        rows.append(ids)
        queries.append(q)
    return rows, queries


def compare(c, dix, rows, queries, device, use_kernels):
    got = dix.search_batch_full(queries, topk=16, hit_cap=256,
                                want_docs=True, use_kernels=use_kernels,
                                deferred=True)()
    needed = np.concatenate([g.reshape(-1) for g in rows])
    post = Postings(c.ids, c.coords, needed, len(c.words))
    runs = fold_rows(rows, [[r for _, r in q] for q in queries], post,
                     c.page_end, 16, 256)
    ref = answers(runs, c.page_doc, c.is_header,
                  harness._log_fn(torch.device(device)))
    for f in FIELDS:
        assert not harness._field_rows(got[f], ref[f]).any(), f
    return got


@pytest.mark.parametrize("name", ["books-1g", "wiki1k-256m"])
def test_reference_matches_the_ports_plain_route(name):
    c, dix = small_index(name, 1_200_000, 21, "cpu")
    rng = np.random.default_rng(4)
    rows, queries = mixed_rows(c, rng, 120)
    got = compare(c, dix, rows, queries, "cpu", use_kernels=False)
    # the rows reach the small hit tiers, truncation and empty answers
    assert (got["n_hits"] == 0).any() and (got["n_pages"] > 16).any()
    assert ((got["n_hits"] > 0) & (got["n_hits"] < 128)).any()


@pytest.mark.parametrize("mix", ["and-high", "or-high"])
def test_reference_matches_on_the_cells_mixes(mix):
    c, dix = small_index("books-1g", 1_200_000, 22, "cpu")
    pool = traffic.draw_pool(traffic.load_mix(mix), c.counts(), c.words,
                             5, 1, 96)
    rows = [traffic.query_words(pool, 0, r) for r in range(96)]
    compare(c, dix, rows, pool.batches[0], "cpu", use_kernels=None)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["books-1g", "wiki1k-256m"])
def test_reference_matches_the_kernel_route_on_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    c, dix = small_index(name, 8_000_000, 23, "cuda")
    rng = np.random.default_rng(5)
    rows, queries = mixed_rows(c, rng, 400)
    compare(c, dix, rows, queries, "cuda", use_kernels=True)
    for mix in ("and-high", "or-high"):
        pool = traffic.draw_pool(traffic.load_mix(mix), c.counts(), c.words,
                                 6, 1, 512)
        rows = [traffic.query_words(pool, 0, r) for r in range(512)]
        compare(c, dix, rows, pool.batches[0], "cuda", use_kernels=True)


@pytest.mark.parametrize("seed", range(4))
def test_or_all_is_the_left_fold_of_or_merge(seed):
    rng = np.random.default_rng(seed)
    for _ in range(40):
        dups = bool(rng.integers(0, 2))
        vs = [sorted_list(rng, int(rng.integers(0, 200)), 2000, dups)
              for _ in range(int(rng.integers(1, 9)))]
        want = vs[0]
        for v in vs[1:]:
            want, _ = fold.or_merge(want, v, 1, 1)
        assert np.array_equal(fold.or_all(vs), want)
