"""The port's native host library (docodo_tpu_torch/native) against the JAX
package's: tokenize+intern (one interner, past 2^20 terms, on threads),
the bulk stemmers, WordCoder.prime and Vocab.prime_stems, the tables
filled from threads at once, and the g++ build (several processes at
once; a failed compile raises). Every input is seeded; every comparison
is exact."""

import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import numpy as np
import pytest

from docodo_tpu.lang import stemmers as jax_stemmers
from docodo_tpu.lang.vocab import Vocab as JaxVocab
from docodo_tpu.lang.wordcodes import WordCoder as JaxWordCoder
from docodo_tpu.native import pipeline as jpipe
from docodo_tpu_torch import native
from docodo_tpu_torch.lang import stemmers
from docodo_tpu_torch.lang.vocab import Vocab
from docodo_tpu_torch.lang.wordcodes import WordCoder
from docodo_tpu_torch.native import pipeline

ROOT = Path(__file__).resolve().parent.parent
RU_VOC = ROOT / "Dict" / "ru.voc"

# Cyrillic, accents, a surrogate pair (not a letter: it splits a word),
# digits, words of 2, 3, 32 and 33 units, capitals
PIECES = ("The", "QUICK", "Пьер", "Безухов", "шёл", "ЁЛКА", "caffè", "città",
          "ÄÖÜ", "straße", "1812", "42", "x", "ab", "abc", "a" * 32,
          "b" * 33, "Ω" * 32, "ж" * 33, "mid\U0001F600dle", "𝔘nicode",
          "née", "naïve", "12abc34", "œuvre", "İstanbul", "ǅemal")
SEPARATORS = (" ", " ", " ", ", ", "; ", "\n", "!  ", "-", "\t", "...")


def _texts(seed: int, n: int, words: int = 200):
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        if k % 7 == 3:
            out.append("")  # an empty page
            continue
        toks = [PIECES[i] for i in rng.integers(0, len(PIECES), words)]
        seps = [SEPARATORS[i] for i in rng.integers(0, len(SEPARATORS),
                                                    words)]
        out.append("".join(t + s for t, s in zip(toks, seps)))
    return out


def _long_gap_text():
    """Gaps between token starts of 4094, exactly 4095, 2 x 4095 + 7 and
    3 x 4095 units: no escape row, one, two and a remainder, three."""
    return ("alpha beta" + " " * 4090 + "gamma" + " " * 4090 + "delta"
            + " " * (2 * 4095 + 2) + "epsilon" + " " * (3 * 4095 - 7)
            + "zeta eta theta")


def test_tokenize_intern_matches_jax():
    mine, theirs = pipeline.NativeInterner(), jpipe.NativeInterner()
    py_theirs = jpipe._PyInterner()
    for text in _texts(1, 12) + [_long_gap_text(), ""]:
        got = pipeline.tokenize_intern_native(text, mine)
        want = jpipe.tokenize_intern(text, theirs)
        pwant = jpipe.tokenize_intern(text, py_theirs)
        for g, w, p in zip(got, want, pwant):
            assert g.dtype == w.dtype == np.int32
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, p)  # native == pure Python
    assert mine.terms() == theirs.terms() == py_theirs.terms()
    assert len(mine) == len(theirs) > 20
    assert mine.terms_range(3, 9) == theirs.terms_range(3, 9)
    assert "a" * 32 in mine.terms() and "b" * 33 not in mine.terms()
    mine.close()


def _distinct_words(lo: int, hi: int) -> str:
    """Distinct five-letter words lo..hi-1 (base 26), space-joined."""
    i = np.arange(lo, hi)
    letters = np.stack([(i // 26 ** k) % 26 for k in range(5)], axis=1)
    chars = (letters + ord("a")).astype(np.uint8)
    rows = np.concatenate([chars, np.full((i.size, 1), ord(" "), np.uint8)],
                          axis=1)
    return rows.tobytes().decode("ascii")


@pytest.mark.parametrize("calls", [1, 2])
def test_tokenize_intern_past_a_million_terms(calls):
    """The interner numbers terms densely past 2^20, in one call or
    across calls, and exports them in id order."""
    n = (1 << 20) + 40
    cuts = np.linspace(0, n, calls + 1).astype(int)
    it = pipeline.NativeInterner()
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        ids, starts = pipeline.tokenize_intern_native(
            _distinct_words(lo, hi), it)
        np.testing.assert_array_equal(ids, np.arange(lo, hi))
        np.testing.assert_array_equal(starts, np.arange(ids.size) * 6)
    assert len(it) == n
    assert it.terms_range(n - 2, n) == _distinct_words(n - 2, n).split()
    it.close()


@pytest.mark.parametrize("workers", [1, 3, 8, 32])
def test_parallel_tokenize_intern_matches_jax(workers):
    texts = _texts(3, 23)
    got = pipeline.parallel_tokenize_intern(texts, workers=workers)
    want = jpipe.parallel_tokenize_intern(texts, workers=workers)
    assert got[2] == want[2] and len(got[2]) > 20
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    # one interner over the texts in order: the same up to numbering
    it = pipeline.NativeInterner()
    for t, text in enumerate(texts):
        ids, starts = pipeline.tokenize_intern_native(text, it)
        terms = it.terms()
        assert [terms[k] for k in ids] == [got[2][k] for k in got[0][t]]
        np.testing.assert_array_equal(starts, got[1][t])
    it.close()


def _random_words(rng, alphabet: str, n: int):
    letters = np.array(list(alphabet))
    return ["".join(rng.choice(letters, int(rng.integers(0, 15))))
            for _ in range(n)]


def test_stem_en_bulk_matches():
    rng = np.random.default_rng(7)
    words = _random_words(rng, "abcdefgilmnorstuyz'", 4000) + [
        "skis", "skies", "dying", "early", "only", "news", "bias", "inning",
        "proceed", "succeed", "hopping", "hoping", "ties", "cries", "gas",
        "generous", "communal", "arsenic", "ugly", "atlas", "", "a" * 61,
        "café", "naïve", "ющий", "x" * 60]
    got = stemmers.stem_en_bulk(words)
    assert got == [stemmers.stem_en(w) for w in words]
    assert got == jax_stemmers.stem_en_bulk(words)
    assert got == [jax_stemmers._stem_en_py(w) for w in words]
    assert stemmers.stem_en_bulk([]) == []


def test_stem_ru_bulk_matches():
    rng = np.random.default_rng(11)
    words = _random_words(rng, "абвгдежзийклмнопрстуфхцчшщъыьэюяё", 6000) + [
        "вшись", "ость", "нн", "ь", "ёж", "делённый", "наибольшейше",
        "прослушавшись", "ція", "", "домa", "文字"]
    got = stemmers.stem_ru_bulk(words)
    assert got == [stemmers.stem_ru(w) for w in words]
    assert got == jax_stemmers.stem_ru_bulk(words)
    assert stemmers.BULK_STEMMERS == {stemmers.stem_en: stemmers.stem_en_bulk,
                                      stemmers.stem_ru: stemmers.stem_ru_bulk}


PRIME_WORDS = ("hopping", "ties", "news", "123abc", "the", "generous",
               "running", "catlike", "оружие", "домами", "straße", "fenêtre",
               "größer", "abc_def", "xyz9", "Upper", "ёлками", "ж", "", "42",
               "это", "mixedкириллица", "écoles", "nous")


@pytest.mark.parametrize("vocab", [False, True], ids=["stemmers", "ru.voc"])
def test_word_coder_prime_leaves_the_jax_cache(vocab):
    rng = np.random.default_rng(5)
    words = list(PRIME_WORDS) + _random_words(rng, "abcdeинорст", 300)
    vocs = [Vocab(RU_VOC)] if vocab else []
    jvocs = [JaxVocab(str(RU_VOC))] if vocab else []
    mine = WordCoder(vocs=vocs, stop_words={"это", "the"})
    theirs = JaxWordCoder(vocs=jvocs, stop_words={"это", "the"})
    mine.prime(iter(words))
    theirs.prime(iter(words))
    assert mine._cache == theirs._cache
    assert len(mine._cache) == (0 if vocab else len(
        {w for w in words if w and not w[0].isdigit()} - {"это", "the"}))
    if vocab:
        assert vocs[0]._stem_cache == jvocs[0]._stem_cache
        assert len(vocs[0]._stem_cache) > 50
    fresh = WordCoder(vocs=[Vocab(RU_VOC)] if vocab else [],
                      stop_words={"это", "the"})
    for w in words:
        assert mine.codes(w) == fresh.codes(w) == theirs.codes(w), w


def test_vocab_prime_stems_matches_per_word():
    voc = Vocab(RU_VOC)
    rng = np.random.default_rng(9)
    words = _random_words(rng, "абвгдеёжзийклмнопрстуфхцчшщъыьэюя", 500)
    want = [voc.stem(w) for w in words]
    voc.prime_stems(words + ["latin", "читалась"])
    assert "latin" not in voc._stem_cache
    assert [voc.stem(w) for w in words] == want
    assert voc.stem("читалась") == stemmers.stem_ru("читалась")


def test_tables_filled_from_threads_at_once(monkeypatch):
    """Eight threads ask for the tables at once: each gets both tables
    and every tokenization is the same."""
    monkeypatch.setattr(pipeline, "_TABLES", None)
    text = _texts(4, 2)[0]
    start = threading.Barrier(8)
    out = [None] * 8

    def run(k):
        start.wait(timeout=60)
        fold, cls = pipeline._tables()
        ids, starts = pipeline.tokenize_intern_native(
            text, pipeline.NativeInterner())
        out[k] = (fold, cls, ids, starts)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(k,)) for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    fold, cls = pipeline._tables()
    for f, c, ids, starts in out:
        assert f is fold and c is cls
        np.testing.assert_array_equal(ids, out[0][2])
        np.testing.assert_array_equal(starts, out[0][3])
    assert out[0][2].size > 100


def test_library_builds_from_processes_at_once(tmp_path):
    """Four processes build the library into one empty directory at once;
    each loads a whole library and tokenizes."""
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(ROOT)!r})
        from pathlib import Path
        from docodo_tpu_torch import native
        native.BUILD_DIR = Path({str(tmp_path)!r})
        from docodo_tpu_torch.native import pipeline
        ids, starts = pipeline.tokenize_intern_native(
            "alpha beta alpha", pipeline.NativeInterner())
        assert ids.tolist() == [0, 1, 0] and starts.tolist() == [0, 6, 11]
    """)
    procs = [subprocess.Popen([sys.executable, "-c", code],
                              stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    errs = [p.communicate(timeout=240)[1] for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, errs
    built = sorted(p.name for p in tmp_path.iterdir())
    assert built == [native.library_path().name]


def test_failed_compile_raises(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()
    assert list((tmp_path / "build").iterdir()) == []
