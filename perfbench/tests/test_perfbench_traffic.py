"""The traffic generator: deterministic per seed, each batch holding its
classes' shares, words drawn from their bands and distinct in a query."""

import numpy as np
import pytest

from perfbench import traffic

MIXES = ("and-high", "or-high")


def corpus_counts(n=6000, seed=0):
    rng = np.random.default_rng(seed)
    counts = (1e6 / np.arange(1, n + 1) ** 1.05).astype(np.int64) + 1
    perm = rng.permutation(n)
    return counts[perm], [f"w{i}" + "x" * (i % 9) for i in range(n)]


@pytest.mark.parametrize("mix", MIXES)
def test_same_seed_same_pool(mix):
    counts, words = corpus_counts()
    m = traffic.load_mix(mix)
    a = traffic.draw_pool(m, counts, words, 2**31 + 9, 5, 200)
    b = traffic.draw_pool(m, counts, words, 2**31 + 9, 5, 200)
    c = traffic.draw_pool(m, counts, words, 2**31 + 10, 5, 200)
    assert a.batches == b.batches
    assert a.batches != c.batches
    for x, y in zip(a.words, b.words):
        assert np.array_equal(x, y)


@pytest.mark.parametrize("mix", MIXES)
def test_class_shares_and_bands(mix):
    counts, words = corpus_counts()
    m = traffic.load_mix(mix)
    batch = 500
    pool = traffic.draw_pool(m, counts, words, 77, 4, batch)
    bands = traffic.band_words(counts, m["bands"])
    shares = np.array([c["share"] for c in m["classes"]])
    want = traffic.class_rows(list(shares), batch)
    assert want.sum() == batch
    assert np.all(np.abs(want - shares / shares.sum() * batch) < 1)
    order = np.lexsort((np.arange(counts.size), -counts))
    for name, (lo, hi) in m["bands"].items():
        assert set(bands[name].tolist()) == set(order[lo - 1:hi].tolist())
    for b in range(4):
        got = np.bincount(pool.classes[b], minlength=len(shares))
        assert np.array_equal(got, want)
        for r in range(batch):
            spec = m["classes"][int(pool.classes[b, r])]
            grid = traffic.query_words(pool, b, r)
            q = pool.batches[b][r]
            assert len(q) == len(spec["words"]) == grid.shape[0]
            flat = grid[grid >= 0]
            assert flat.size == len(set(flat.tolist()))
            for word, variants, (codes, rr) in zip(spec["words"], grid, q):
                ids = variants[variants >= 0].tolist()
                assert len(ids) == len(word)
                for band, w in zip(word, ids):
                    assert w in set(bands[band].tolist())
                keys = (codes,) if isinstance(codes, str) else codes
                assert list(keys) == [words[w] for w in ids]
                n = max(len(words[w]) for w in ids)
                if spec["window"] == "proximity":
                    assert rr == 255 + n
                else:
                    assert rr == -(n + 4)


def test_a_band_past_the_vocabulary_raises():
    counts, words = corpus_counts(n=150)
    with pytest.raises(ValueError):
        traffic.band_words(counts, {"high": [11, 200]})
