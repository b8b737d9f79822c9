"""The port's index files against the JAX package's: the varint codec
(docodo_tpu_torch/core/varint.py: native, and its NumPy plain version),
the `.index` stream (core/storage.py: write_postings_arrays,
read_index in both modes), the `.index.list` page table
(core/pagetable.py) and damaged files (docodo_tpu.Index's load).

Tolerance: exact everywhere; the files are held byte for byte."""

import io

import numpy as np
import pytest

import docodo_tpu
from docodo_tpu.core import storage as jax_storage
from docodo_tpu.core import varint as jax_varint
from docodo_tpu.core.pagetable import PageTable as JaxPageTable
from docodo_tpu_torch.core import storage, varint
from docodo_tpu_torch.core.pagetable import PageTable
from docodo_tpu_torch.index import Index


def _ascending(rng, n, max_delta=0xFFFF, start=0):
    return (np.uint64(start)
            + np.cumsum(rng.integers(0, max_delta, size=n)).astype(np.uint64))


def _lists(name, rng):
    """Seeded coordinate lists of one kind."""
    if name == "small":
        return [_ascending(rng, 500, 0x7FFF)]
    if name == "large deltas":
        return [_ascending(rng, 300, 1 << 40), _ascending(rng, 50, 1 << 62)]
    if name == "single":
        return [np.array([v], dtype=np.uint64)
                for v in (0, 1, 0x7FFF, 0x8000, 1 << 45, (1 << 64) - 1)]
    if name == "duplicates":
        return [np.array([5, 5, 5, 9, 9, 1 << 33, 1 << 33], dtype=np.uint64)]
    if name == "chunk boundaries":
        edges = [(1 << j) + d for j in (15, 30, 45, 60) for d in (-1, 0, 1)]
        return [np.cumsum(np.array(edges, dtype=np.uint64))]
    if name == "shifts":
        return [_ascending(rng, 200, 0x7FFF, start=s)
                for s in (1 << 20, 1 << 31, 1 << 47)]
    raise ValueError(name)


KINDS = ("small", "large deltas", "single", "duplicates", "chunk boundaries",
         "shifts")


@pytest.mark.parametrize("kind", KINDS)
def test_varint_equals_the_jax_codec(kind):
    """encode, encode_blocks, decode and encoded_len give the JAX
    package's u16 streams and coordinates, and the native codec equals
    its NumPy plain version."""
    rng = np.random.default_rng(KINDS.index(kind))
    lists = _lists(kind, rng)
    for coords in lists:
        got = varint.encode(coords)
        assert got.dtype == np.uint16
        np.testing.assert_array_equal(got, jax_varint.encode(coords))
        np.testing.assert_array_equal(got, varint.encode_numpy(coords))
        np.testing.assert_array_equal(varint.decode(got), coords)
        np.testing.assert_array_equal(varint.decode_numpy(got), coords)
        np.testing.assert_array_equal(varint.decode(got),
                                      jax_varint.decode(got))
        assert varint.encoded_len(coords) == got.size \
            == jax_varint.encoded_len(coords)
    flat = np.concatenate(lists)
    offsets = np.concatenate([[0], np.cumsum([c.size for c in lists])])
    stream, starts = varint.encode_blocks(flat, offsets)
    want_stream, want_starts = jax_varint.encode_blocks(flat, offsets)
    np.testing.assert_array_equal(stream, want_stream)
    np.testing.assert_array_equal(starts, want_starts)
    plain_stream, plain_starts = varint.encode_blocks_numpy(flat, offsets)
    np.testing.assert_array_equal(stream, plain_stream)
    np.testing.assert_array_equal(starts, plain_starts)
    f = io.BytesIO()
    for coords in lists:
        varint.write_block(f, coords)
    data = f.getvalue()
    f.seek(0)
    for coords in lists:
        np.testing.assert_array_equal(jax_varint.read_block(f), coords)
    f = io.BytesIO(data)
    for coords in lists:
        np.testing.assert_array_equal(varint.read_block(f), coords)
    with pytest.raises(EOFError):
        varint.read_block(f)
    assert varint.encode(np.zeros(0, np.uint64)).size == 0
    assert varint.decode(np.zeros(0, np.uint16)).size == 0


def _postings(seed, long_term=False):
    """(terms, offsets, coords, max_coord) of a seeded index: a few
    hundred lists of Zipf-like lengths, some deltas past 2^15, a term of
    non-ASCII letters and optionally one of 200 bytes."""
    rng = np.random.default_rng(seed)
    n = 300
    terms = sorted({f"t{rng.integers(0, 10**6):06d}" for _ in range(n)}
                   | {"ünï", "$stem", "&name", "#1a2b"}
                   | ({"x" * 200} if long_term else set()))
    lens = np.maximum(1, (rng.pareto(1.2, size=len(terms)) * 4).astype(int))
    lists = [_ascending(rng, int(k), 1 << int(rng.integers(4, 20)))
             for k in lens]
    offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    coords = np.concatenate(lists)
    return terms, offsets, coords, int(coords.max()) + 7


@pytest.mark.parametrize("long_term", [False, True],
                         ids=["short terms", "a 200-byte term"])
def test_index_stream_equals_the_jax_packages(tmp_path, long_term):
    """write_postings_arrays writes the JAX package's bytes (its
    vectorized framing, and record by record past a 127-byte term);
    read_index of either file, in memory and lazily, equals the JAX
    package's read_index."""
    terms, offsets, coords, max_coord = _postings(3, long_term)
    mine, ref = io.BytesIO(), io.BytesIO()
    storage.write_postings_arrays(mine, max_coord, terms, offsets, coords)
    jax_storage.write_postings_arrays(ref, max_coord, terms, offsets, coords)
    assert mine.getvalue() == ref.getvalue()
    stream = io.BytesIO()
    storage.write_postings_stream(stream, max_coord, (
        (t, coords[offsets[i]:offsets[i + 1]]) for i, t in enumerate(terms)))
    assert stream.getvalue() == ref.getvalue()
    path = tmp_path / ".index"
    path.write_bytes(mine.getvalue())
    for in_memory in (True, False):
        got = storage.read_index(str(path), in_memory=in_memory)
        want = jax_storage.read_index(str(path), in_memory=in_memory)
        try:
            assert got.terms == want.terms == terms
            assert got.max_coord == want.max_coord == max_coord
            np.testing.assert_array_equal(got.offsets, want.offsets)
            np.testing.assert_array_equal(got.enc_counts, want.enc_counts)
            if in_memory:
                np.testing.assert_array_equal(got.offsets, offsets)
                np.testing.assert_array_equal(got.coords, coords)
                assert got.coords.dtype == np.uint64
            else:
                assert got.coords is None
            for t in (terms[0], terms[len(terms) // 2], terms[-1], "ünï"):
                np.testing.assert_array_equal(got.get(t), want.get(t))
            assert got.get("absent") is None
        finally:
            got.close()
            want.close()
    built = storage.ArrayIndex.from_postings(terms, offsets, coords, max_coord)
    np.testing.assert_array_equal(
        built.enc_counts, jax_storage.ArrayIndex.from_postings(
            terms, offsets, coords, max_coord).enc_counts)
    storage.write_index(str(tmp_path / "again"), built)
    assert (tmp_path / "again").read_bytes() == ref.getvalue()


def test_lazy_posting_count_is_the_stored_word_count(tmp_path):
    """In the lazy mode a term's posting count is its stored u16 words
    (the reference's lazy stubs), equal to the JAX package's; in memory
    it is its coordinates."""
    terms, offsets, coords, max_coord = _postings(4)
    path = tmp_path / ".index"
    with open(path, "wb") as f:
        storage.write_postings_arrays(f, max_coord, terms, offsets, coords)
    lazy = storage.read_index(str(path), in_memory=False)
    ref = jax_storage.read_index(str(path), in_memory=False)
    full = storage.read_index(str(path))
    try:
        words = [varint.encoded_len(coords[offsets[i]:offsets[i + 1]])
                 for i in range(len(terms))]
        assert [lazy.posting_count(i) for i in range(len(terms))] == words \
            == [ref.posting_count(i) for i in range(len(terms))]
        assert [full.posting_count(i) for i in range(len(terms))] \
            == np.diff(offsets).tolist()
        assert any(w > c for w, c in zip(words, np.diff(offsets)))
        assert [lazy.enc_count(i) for i in range(len(terms))] == words
    finally:
        lazy.close()
        ref.close()


def test_page_table_file_equals_the_jax_packages():
    """PageTable.save writes the JAX package's bytes; load reads back
    what the JAX package's load reads; a document without pages is not
    written, and locate / page_base are kept."""
    bounds = np.array([10, 25, 25, 60, 3_000_000_000, 3_000_000_007],
                      dtype=np.uint64)
    page_doc = np.array([0, 0, 2, 2, 3, 3], dtype=np.int64)
    ids = ["0", "1", "0", "1", "1", "2"]
    docs = ["d:a", "d:empty", "d:ünï", "d:c"]
    mine, ref = io.BytesIO(), io.BytesIO()
    PageTable(bounds, page_doc, ids, docs).save(mine)
    JaxPageTable(bounds, page_doc, ids, docs).save(ref)
    assert mine.getvalue() == ref.getvalue()
    mine.seek(0)
    got = PageTable.load(mine)
    want = JaxPageTable.load(io.BytesIO(ref.getvalue()))
    assert got.page_ids == want.page_ids == ids
    assert got.doc_names == want.doc_names == ["d:a", "d:ünï", "d:c"]
    np.testing.assert_array_equal(got.page_doc, want.page_doc)
    np.testing.assert_array_equal(got.bounds, want.bounds)
    q = np.array([0, 9, 10, 24, 59, 61, 3_000_000_006, 9**12], np.uint64)
    for a, b in zip(got.locate(q), want.locate(q)):
        np.testing.assert_array_equal(a, b)
    assert [got.page_base(i) for i in range(6)] \
        == [want.page_base(i) for i in range(6)]


# damaged files: the index stream / the page list
DAMAGED = {
    "truncated record": ((12345).to_bytes(8, "little") + b"\x05hello",
                         b"\x01\x02"),
    "negative count": ((1).to_bytes(8, "little") + b"\x03abc"
                       + (-2).to_bytes(4, "little", signed=True), b""),
    "count past the end": ((1).to_bytes(8, "little") + b"\x03abc"
                           + (9).to_bytes(4, "little") + b"\x01\x00", b""),
    "runaway length": ((1).to_bytes(8, "little") + b"\xff" * 12, b""),
    "page list not UTF-8": ((7).to_bytes(8, "little") + b"\x03abc"
                            + (1).to_bytes(4, "little") + b"\x07\x00",
                            (7).to_bytes(8, "little") + b"\x02\xff\xfe"),
}


@pytest.mark.parametrize("damage", list(DAMAGED))
def test_damaged_files_fail_as_the_jax_package(tmp_path, damage, capsys):
    """A damaged .index / .index.list: both packages' Index(path) report
    it, cannot search, and answer a request with an error result
    (tests/test_index.py:301)."""
    index_bytes, list_bytes = DAMAGED[damage]
    (tmp_path / ".index").write_bytes(index_bytes)
    (tmp_path / ".index.list").write_bytes(list_bytes)
    mine = Index(str(tmp_path), device="cpu")
    ref = docodo_tpu.Index(path=str(tmp_path), in_memory=True)
    out = capsys.readouterr().out
    assert out.count("Can't load:") == 2
    assert not mine.can_search and not ref.can_search
    got, want = mine.search("hello"), ref.search("hello")
    assert not got.success and not want.success
    assert got.error == want.error
    assert mine.generation == 0
