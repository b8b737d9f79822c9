"""The port's packed tokenizer and the rest of native/pipeline.py against
the JAX package's: tokenize_intern_packed (native and pure-Python
interners, escape rows, the 2^20 - 1 sentinel), split_packed and
pack_tokens_split, make_interner / tokenize_intern, NativeInterner
.term_at, varint_encode / varint_decode, and stem_en's native path
against the Python stemmer and the JAX package's _native_stem_en over a
seeded fuzz of ASCII words. Every input is seeded; every comparison is
exact."""

import random

import numpy as np
import pytest
import torch

from docodo_tpu.lang import stemmers as jax_stemmers
from docodo_tpu.native import pipeline as jpipe
from docodo_tpu.ops import device_index as jdi
from docodo_tpu_torch.lang import stemmers
from docodo_tpu_torch.native import pipeline
from docodo_tpu_torch.ops import device_index as tdi

from test_torch_native import _distinct_words, _long_gap_text, _texts


def _gap_text() -> str:
    """tests/test_native.py:95's text: a gap of two escape rows."""
    return ("The Pickwick Papers, " * 50 + " " * 9000
            + "posthumous papers of the club " * 30)


def test_tokenize_intern_packed_equals_jax():
    """tests/test_native.py:90 twinned: the C packed emitter's rows equal
    the JAX package's bit for bit and pack_tokens(tokenize_intern(...)),
    escape rows across long gaps included, over one interner."""
    mine, theirs = pipeline.make_interner(), jpipe.make_interner()
    ref = pipeline.make_interner()
    assert isinstance(mine, pipeline.NativeInterner)
    for text in [_gap_text(), _long_gap_text()] + _texts(3, 10) + [""]:
        got = pipeline.tokenize_intern_packed(text, mine)
        want = jpipe.tokenize_intern_packed(text, theirs)
        assert got.dtype == want.dtype == np.uint32
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got, tdi.pack_tokens(*pipeline.tokenize_intern(text, ref)))
    assert mine.terms() == theirs.terms() == ref.terms()
    esc = np.uint32(tdi.PACK_ESCAPE_ROW)
    again = pipeline.tokenize_intern_packed(_gap_text(), mine)
    assert (again == esc).sum() == 2


def test_split_packed_equals_jax():
    """tests/test_native.py:108 twinned: split_packed's parts equal the
    JAX package's row for row, and so do pack_tokens_split's; the parts
    of both, each built on its own by build_postings_packed, give the
    absolute starts."""
    rng = np.random.default_rng(5)
    n, t = 3000, 200
    ids = rng.integers(0, t, size=n).astype(np.int32)
    starts = np.cumsum(rng.integers(1, 60, size=n)).astype(np.int64)
    starts[2000:] += 3 * 4095 + 11  # escape rows inside a part
    packed = tdi.pack_tokens(ids, starts)
    for max_rows in (1024, 777):
        for mine, theirs in (
                (tdi.split_packed(packed, max_rows),
                 jdi.split_packed(packed, max_rows)),
                (tdi.pack_tokens_split(ids, starts, max_rows),
                 jdi.pack_tokens_split(ids, starts, max_rows))):
            assert len(mine) == len(theirs) > 1
            assert all(p.size <= max_rows for p in mine)
            for g, w in zip(mine, theirs):
                np.testing.assert_array_equal(g, w)
            got = []
            for p in mine:
                rows = torch.from_numpy(p.view(np.int32).copy())
                _, sc, off = tdi.build_postings_packed(rows, t)
                got.append(sc[: int(off[t])].numpy())
            np.testing.assert_array_equal(np.sort(np.concatenate(got)),
                                          np.sort(starts))


def test_split_packed_refuses_a_part_too_small_for_its_prefix():
    packed = tdi.pack_tokens(np.arange(4, dtype=np.int32),
                             np.array([0, 50_000, 50_001, 50_002]))
    with pytest.raises(ValueError):
        tdi.split_packed(packed, 4)


def test_python_interner_equals_jax():
    """tests/test_native.py:135 twinned: with make_interner(native=False)
    tokenize_intern and tokenize_intern_packed equal the JAX package's
    pure-Python interner's, and the native interner's."""
    mine = pipeline.make_interner(native=False)
    theirs = jpipe._PyInterner()
    native = pipeline.make_interner()
    assert isinstance(mine, pipeline._PyInterner)
    text = "alpha beta gamma " * 40 + " " * 5000 + "delta epsilon " * 20
    for t in [text, _long_gap_text()] + _texts(4, 4):
        got = pipeline.tokenize_intern_packed(t, mine)
        np.testing.assert_array_equal(
            got, jpipe.tokenize_intern_packed(t, theirs))
        np.testing.assert_array_equal(
            got, pipeline.tokenize_intern_packed(t, native))
    for t in _texts(6, 3):
        for g, w in zip(pipeline.tokenize_intern(t, mine),
                        jpipe.tokenize_intern(t, theirs)):
            assert g.dtype == w.dtype == np.int32
            np.testing.assert_array_equal(g, w)
    assert mine.terms() == theirs.terms() == native.terms()
    assert len(mine) == len(theirs)
    assert mine.terms_range(2, 5) == theirs.terms_range(2, 5)


def test_tokenize_intern_packed_raises_at_the_sentinel():
    """2^20 - 1 distinct terms fit, the JAX package's rows bit for bit;
    the next new term reaches the sentinel id and raises ValueError, with
    the native interner and with the Python one."""
    sent = tdi.PACK_SENTINEL
    text = _distinct_words(0, sent)
    mine, theirs = pipeline.make_interner(), jpipe.make_interner()
    got = pipeline.tokenize_intern_packed(text, mine)
    np.testing.assert_array_equal(got,
                                  jpipe.tokenize_intern_packed(text, theirs))
    assert int((got & np.uint32(sent)).max()) == sent - 1
    with pytest.raises(ValueError, match="2\\^20"):
        pipeline.tokenize_intern_packed(_distinct_words(sent, sent + 1),
                                        mine)
    py = pipeline.make_interner(native=False)
    py._map.update((f"w{i}", i) for i in range(sent))
    with pytest.raises(ValueError):
        pipeline.tokenize_intern_packed("zzzzz", py)
    mine.close()


def test_term_at_equals_jax():
    mine, theirs = pipeline.NativeInterner(), jpipe.NativeInterner()
    for text in _texts(8, 6):
        pipeline.tokenize_intern(text, mine)
        jpipe.tokenize_intern(text, theirs)
    assert len(mine) == len(theirs) > 20
    got = [mine.term_at(i) for i in range(len(mine))]
    assert got == [theirs.term_at(i) for i in range(len(theirs))]
    assert got == mine.terms()
    for bad in (-1, len(mine)):
        with pytest.raises(IndexError):
            mine.term_at(bad)
    mine.close()


def test_varint_names_equal_jax():
    rng = np.random.default_rng(11)
    coords = np.cumsum(rng.integers(0, 1 << 40, 500, dtype=np.int64)
                       ).astype(np.uint64)
    for c in (coords, coords[:1], coords[:0], np.array([0, 1, 32767, 32768],
                                                       dtype=np.uint64)):
        words = pipeline.varint_encode(c)
        want = jpipe.varint_encode(c)
        assert words.dtype == want.dtype == np.uint16
        np.testing.assert_array_equal(words, want)
        back = pipeline.varint_decode(words)
        assert back.dtype == np.uint64
        np.testing.assert_array_equal(back, jpipe.varint_decode(want))
        np.testing.assert_array_equal(back, c)


def _fuzz_words():
    """tests/test_stemmers.py:222's words: 5,000 seeded strings of its
    alphabet and its list of exceptions, plus words past 60 characters
    and non-ASCII ones, which the C path does not cover."""
    rng = random.Random(7)
    words = {"".join(rng.choice("abcdefgilmnorstuyz'")
                     for _ in range(rng.randint(1, 14)))
             for _ in range(5000)}
    words.update(["skis", "skies", "dying", "early", "only", "news",
                  "bias", "inning", "proceed", "succeed", "hopping",
                  "hoping", "ties", "cries", "gas", "generous",
                  "communal", "arsenic", "ugly", "atlas", "", "a", "'s",
                  "running" * 8, "x" * 60, "generously" * 7, "café",
                  "naïve", "пьер"])
    return sorted(words)


def test_stem_en_native_path_equals_python_and_jax():
    covered = 0
    for w in _fuzz_words():
        py = stemmers._stem_en_py(w)
        assert py == jax_stemmers._stem_en_py(w), w
        ns = stemmers._native_stem_en(w)
        jns = jax_stemmers._native_stem_en(w)
        assert ns == jns, w
        if w.isascii() and len(w) <= 60:
            assert ns == py, w
            covered += 1
        else:
            assert ns is None, w
        assert stemmers.stem_en(w) == py == jax_stemmers.stem_en(w), w
    assert covered > 4000


def test_stem_en_buffers_per_thread():
    """Threads stemming at once each use a buffer of their own."""
    import concurrent.futures as cf

    words = _fuzz_words()
    want = [stemmers._stem_en_py(w) for w in words]
    with cf.ThreadPoolExecutor(8) as ex:
        outs = list(ex.map(lambda _: [stemmers.stem_en(w) for w in words],
                           range(8)))
    assert all(o == want for o in outs)
