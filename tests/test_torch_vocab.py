"""Vocabularies and stop words in the port's host build, against the
JAX package: Vocab and load_stop_words on the same bytes, WordCoder
with vocabularies, the index build with Dict/ru.voc and a stop-word file
against docodo_tpu.Index array for array, the query side's word ->
(variant keys, R) rule against the batcher's, and one search_batch_full
of vocabulary-made groups against the JAX package's. Every input is
seeded; every comparison is exact except ranks (2 ulp: torch.log and
XLA's log differ by 1 ulp on about 1% of counts on the CPU)."""

import io
from pathlib import Path

import numpy as np
import pytest

import docodo_tpu
from docodo_tpu.lang.vocab import Vocab as JaxVocab
from docodo_tpu.lang.vocab import load_stop_words as jax_load_stop_words
from docodo_tpu.lang.wordcodes import WordCoder as JaxWordCoder
from docodo_tpu.lang.wordcodes import from_int as jax_from_int
from docodo_tpu.native import pipeline as npipe
from docodo_tpu.ops.device_index import DeviceIndex as JaxDeviceIndex
from docodo_tpu.query import batcher as jax_batcher
from docodo_tpu.sources.base import ListDataSource as JaxListDataSource
from docodo_tpu_torch.index import ListDataSource, build_index, word_group
from docodo_tpu_torch.lang.vocab import Vocab, load_stop_words
from docodo_tpu_torch.lang.wordcodes import WordCoder, from_int
from docodo_tpu_torch.ops.device_index import DeviceIndex
from docodo_tpu_torch.synthetic import vocabulary_documents
from docodo_tpu_torch.synthetic import vocabulary_forms as ru_forms

RU_VOC = Path(__file__).resolve().parent.parent / "Dict" / "ru.voc"
STOP_WORDS = ("это", "как", "the", "которые")
ENGLISH = ("running", "runs", "houses", "house", "walked", "papers")
UNKNOWN = ("зюзюка", "бармаглот", "кракозябры", "хливкие")
RANK_ULPS = 2

# the reference's native tokenizer fills its lazy tables on first use;
# fill them on the collecting thread (tests/test_torch_host_index.py)
npipe._tables()


@pytest.fixture(scope="module")
def stop_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("stop") / "stop.txt"
    path.write_bytes("; a comment line\r\n".encode()
                     + "\n".join(STOP_WORDS).encode("utf-8")
                     + "\r\n\n   \nне;слово\n".encode("utf-8"))
    return str(path)


@pytest.fixture(scope="module")
def built(tmp_path_factory, stop_file):
    """One corpus indexed by both packages with Dict/ru.voc and the
    stop-word file, the reference on one build thread."""
    voc = Vocab(RU_VOC)
    docs = vocabulary_documents(voc, seed=2024, extra=UNKNOWN + ENGLISH
                                + STOP_WORDS + ("1812", "42"))
    mine = build_index(ListDataSource("synth", docs), vocs=[voc],
                       stop_words=load_stop_words(stop_file), device="cpu")
    ref = docodo_tpu.Index(path=str(tmp_path_factory.mktemp("ref")),
                           in_memory=True, vocs=[JaxVocab(str(RU_VOC))])
    ref.load_stop_words(stop_file)
    ref.max_degree_of_parallelism = 1
    ref.add_data_source(JaxListDataSource("synth", docs))
    ref.create()
    return mine, ref


def test_vocab_matches_on_the_same_bytes():
    mine, theirs = Vocab(RU_VOC), JaxVocab(str(RU_VOC))
    assert mine.words == theirs.words and len(mine) == 150
    assert mine.range == theirs.range == ("а", "ш")
    assert mine.name == theirs.name == "ru"
    for w in ru_forms(mine) + ["зюзюка", "house", ""]:
        assert mine.stem(w) == theirs.stem(w)
        assert mine.search(mine.stem(w)) == theirs.search(theirs.stem(w))
    out, ref_out = io.BytesIO(), io.BytesIO()
    mine.save(out)
    theirs.save(ref_out)
    assert out.getvalue() == ref_out.getvalue() == RU_VOC.read_bytes()
    # a stream with a name, add, and the dict surface
    again = Vocab(io.BytesIO(out.getvalue()), name="ru.copy")
    assert again.words == mine.words and again.stemmer is mine.stemmer
    again.add("зюзюк", 7 | Vocab.GROUP_NOT_EXACT_WORD_MASK)
    assert "зюзюк" in again and again["зюзюк"] & Vocab.GROUP_NUMBER_MASK == 7
    with pytest.raises(ValueError, match="name required"):
        Vocab(io.BytesIO(b""))


def test_load_stop_words_matches(stop_file):
    got = load_stop_words(stop_file)
    assert got == jax_load_stop_words(stop_file) == set(STOP_WORDS)


def test_word_coder_clear_cache_matches():
    """clear_cache empties the codes cache as the JAX package's does: a
    stop word added after a word was coded takes effect only then."""
    mine = WordCoder(vocs=[Vocab(RU_VOC)], stop_words=set())
    theirs = JaxWordCoder(vocs=[JaxVocab(str(RU_VOC))], stop_words=set())
    words = list(ENGLISH) + ru_forms(Vocab(RU_VOC))[:40]
    for coder in (mine, theirs):
        before = [coder.codes(w) for w in words]
        coder.stop_words.add(words[0])
        assert coder.codes(words[0]) == before[0] != ()
        coder.clear_cache()
        assert coder._cache == {}
        assert coder.codes(words[0]) == ()
    assert [mine.codes(w) for w in words] == [theirs.codes(w) for w in words]


@pytest.mark.parametrize("setup", ["ru", "ru+en", "none+ru", "stop only"])
def test_word_coder_matches(setup):
    """The vocabulary branch of WordCoder: group keys, the last-lookup
    rule with a second vocabulary that covers a word but misses it, a
    None entry that keeps its index, stop words."""
    def vocs(cls, path):
        ru = cls(path)
        if setup == "ru":
            return [ru]
        if setup == "none+ru":
            return [None, ru]
        if setup == "stop only":
            return []
        en = cls(io.BytesIO(b""), name="en")
        en.add("hous", 3)
        en.add("paper", 4 | 0x01000000)
        en.range = ("a", "я")  # covers Russian words and knows none
        return [ru, en]

    mine = WordCoder(vocs=vocs(Vocab, RU_VOC), stop_words=set(STOP_WORDS))
    theirs = JaxWordCoder(vocs=vocs(JaxVocab, str(RU_VOC)),
                          stop_words=set(STOP_WORDS))
    words = ru_forms(Vocab(RU_VOC))[::3] + list(ENGLISH) + list(STOP_WORDS)
    words += ["зюзюка", "1812", "9lives", "mixedязык", "", "café"]
    got = [mine.codes(w) for w in words]
    assert got == [theirs.codes(w) for w in words]
    assert got == [mine.codes(w) for w in words]  # cached
    assert all(mine.codes(w) == () for w in STOP_WORDS)
    if setup != "stop only":
        assert sum(any(c[0] == "#" for c in g) for g in got) > 50
    assert from_int(0x1A2B3C) == jax_from_int(0x1A2B3C) == "#1A2B3C"


def test_host_build_with_vocabulary_matches_index(built):
    mine, ref = built
    got = DeviceIndex.from_index(mine, device="cpu")
    want = DeviceIndex.from_index(ref, device="cpu")
    gs, ws = got.state(), want.state()
    assert sorted(gs) == sorted(ws)
    for k in ws:
        assert gs[k].dtype == ws[k].dtype, k
        np.testing.assert_array_equal(gs[k], ws[k], err_msg=k)
    assert got.terms == want.terms
    assert got.page_ids == want.page_ids and got.doc_names == want.doc_names
    assert mine.arr.max_coord == ref.arr.max_coord
    groups = [t for t in got.terms if t[0] == "#"]
    assert len(groups) > 50 and any(t[0] == "$" for t in got.terms)
    assert not any(w in got._tmap for w in STOP_WORDS)


def test_word_group_matches_word_codes(built):
    """The query side's chosen keys and window against the batcher's
    _word_codes, and the wildcard expansion against Index's."""
    mine, ref = built
    forms = [t for t in mine.arr.terms if t[0].isalpha()]
    words = forms[::7] + [w.upper() for w in forms[::11]]
    words += [forms[3].capitalize(), "зюзюка", "неизвестное", "running",
              "HOUSE", "1812", "это", "ЭТО", "дом_", "_ов", "a_", "_", "qq_",
              "бо_ск"]
    kinds = set()
    for w in words:
        got = word_group(mine, w)
        assert got == jax_batcher._word_codes(ref, w), w
        if got is not None:
            kinds.add((got[0][0][0] if not got[0][0][0].isalnum() else "w",
                       len(got[0]) > 1, got[1] < 0))
    # group keys, stem keys, full forms; wildcard ORs; exact windows
    assert {k[0] for k in kinds} >= {"#", "$", "w"}
    assert any(k[1] for k in kinds) and any(k[2] for k in kinds)
    for pattern in ("дом_", "_ов", "a_", "_", "бо_ск", "нет"):
        assert mine.get_like_words(pattern) == ref.get_like_words(pattern)


def f32_ulps(a, b) -> int:
    a = np.ascontiguousarray(a, dtype=np.float32).view(np.int32)
    b = np.ascontiguousarray(b, dtype=np.float32).view(np.int32)
    return int(np.abs(a.astype(np.int64) - b).max()) if a.size else 0


def test_search_batch_full_of_vocabulary_groups_matches_jax(built):
    """Words become groups through word_group, single and paired, plus a
    wildcard OR, an exact form and a stop word; both routes of the port
    against the JAX package on the reference's index."""
    mine, ref = built
    forms = [t for t in mine.arr.terms if t[0].isalpha() and len(t) > 3]
    words = forms[::9][:10]
    single = [[word_group(mine, w)] for w in words]
    pairs = [[word_group(mine, a), word_group(mine, b)]
             for a, b in zip(words[:-1], words[1:])]
    extra = [[word_group(mine, "бо_ск")], [word_group(mine, words[0].upper())],
             [word_group(mine, "дом_"), word_group(mine, words[1])]]
    queries = [q for q in single + pairs + extra if None not in q]
    assert len(queries) >= 20 and word_group(mine, "это") is None
    assert any(len(g[0]) > 1 for q in queries for g in q)
    assert any(g[0][0][0] == "#" for q in queries for g in q)
    jdx = JaxDeviceIndex.from_index(ref)
    want = jdx.search_batch_full(queries, topk=16, hit_cap=128,
                                 use_pallas=False)
    tdx = DeviceIndex.from_index(mine, device="cpu")
    for use_kernels in (True, False):
        got = tdx.search_batch_full(queries, topk=16, hit_cap=128,
                                    use_kernels=use_kernels)
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            assert got[k].shape == w.shape and got[k].dtype == w.dtype, k
            if k in ("ranks", "doc_ranks"):
                assert f32_ulps(got[k], w) <= RANK_ULPS, k
            else:
                np.testing.assert_array_equal(got[k], w, err_msg=k)
    assert (want["n_hits"] > 0).sum() >= 15
