"""The port's copies of the JAX package's host query stack against their
originals: PostingSeq's `*`, `&` and `+` (docodo_tpu/core/postings.py),
the request parser (query/parser.py), the result pipeline
(query/search.py) and the host engine's search (docodo_tpu.Index.search)
over one corpus built by both packages.

Tolerance: exact everywhere (both sides compute ranks with the same
Python and numpy arithmetic). The corpus keeps header words out of the
body text: the JAX package's build leaves a list unsorted for a term in
both (ROADMAP Queue C)."""

import re

import numpy as np
import pytest

import docodo_tpu
from docodo_tpu.core.pagetable import PageTable as JaxPageTable
from docodo_tpu.core.postings import PostingSeq as JaxPostingSeq
from docodo_tpu.native import pipeline as npipe
from docodo_tpu.query import parser as jax_parser
from docodo_tpu.query import search as jax_search
from docodo_tpu.sources.base import IndexPagedTextFile as JaxPagedTextFile
from docodo_tpu.sources.base import ListDataSource as JaxListDataSource
from docodo_tpu_torch.core.postings import PostingSeq
from docodo_tpu_torch.index import (
    Index,
    IndexPagedTextFile,
    ListDataSource,
    PageTable,
)
from docodo_tpu_torch.query import parser, search
from docodo_tpu_torch.query.search import result_fields
from docodo_tpu_torch.synthetic import zipf_documents

# fill the reference tokenizer's lazy tables on the collecting thread
# (ROADMAP Queue C: the first build of a process can race them)
npipe._tables()

TEXTS = [
    ("alpha", "The Pickwick club met at noon near the old tavern, and "
              "Mr. Pickwick spoke; the club listened.", "author=dickens\n"
                                                        "year=1836"),
    ("beta", "The club adjourned after dinner and wandered home, singing "
             "of the tavern and its dinner.", "author=trollope"),
    ("gamma", "Dinner at the tavern started well before noon; wandering "
              "members dined twice.", ""),
    ("delta", "Ünïcode wörds and 𝔘𝔫𝔦 astral letters sit beside the club "
              "and its tavern.", "author=nobody"),
]
REQUESTS = [
    "club", "Club", '"pickwick club"', "dinner tavern", "club | tavern",
    "dinner (club|tavern)", 'noon "the tavern"', "wandered", "clu?",
    "?avern", "d?nner", "club ?avern", "?zzzzz?", "club {author=dickens}",
    "{author=dickens}", "{author=trollope} club", "{year=1836}",
    "{author=charles dickens}", "club -filter:al.*", "club -filter:zz",
    "the club", "club ~tavern", "xy", "a | b", "mr pickwick",
    '"club listened"', "tavern wörds", "astral", "((club", "club zzqq",
    '"bank account" "old tavern"', "club {author=nobody}",
    "{name=doc00003}", "{name=doc00003} club",
]


def _docs(paged, zipf):
    return [paged(n, t, h) for n, t, h in TEXTS] + list(zipf)


@pytest.fixture(scope="module")
def indexes(tmp_path_factory):
    """(the port's Index, docodo_tpu.Index) over the same documents: the
    inline ones and a seeded Zipf text, on one build thread."""
    zipf = zipf_documents(60_000, seed=5, vocab=700, doc_chars=9_000)
    ref = docodo_tpu.Index(path=str(tmp_path_factory.mktemp("qh")),
                           in_memory=True)
    ref.max_degree_of_parallelism = 1
    ref.add_data_source(JaxListDataSource(
        "docs", _docs(JaxPagedTextFile, zipf)))
    ref.create()
    mine = Index(device="cpu")
    mine.add_data_source(ListDataSource(
        "docs", _docs(IndexPagedTextFile, zipf)))
    mine.create()
    yield mine, ref
    ref.dispose()


def _seq(rng, n, lo_r):
    coords = np.sort(rng.integers(0, 400, size=n)).astype(np.uint64)
    if n > 3:
        coords[1] = coords[0]  # a duplicate
    return coords, int(rng.choice([-1, 1]) * rng.integers(lo_r, 40))


@pytest.mark.parametrize("seed", range(12))
def test_posting_seq_ops_match(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        (a, ra), (b, rb) = (_seq(rng, int(rng.integers(0, 30)), 0)
                            for _ in range(2))
        mine = PostingSeq(a, ra), PostingSeq(b, rb)
        ref = JaxPostingSeq(a, ra), JaxPostingSeq(b, rb)
        for op in ("__mul__", "__and__", "__add__"):
            got = getattr(mine[0], op)(mine[1])
            want = getattr(ref[0], op)(ref[1])
            np.testing.assert_array_equal(got.coords, want.coords)
            assert got.R == want.R and len(got) == len(want)
    assert PostingSeq() * PostingSeq(np.arange(3), 5) == PostingSeq()


def _ast(node):
    if isinstance(node, tuple):
        return (node[0], _ast(node[1]), _ast(node[2]))
    return (node.name, node.word, node.field_name)


@pytest.mark.parametrize("req", REQUESTS)
def test_parser_copy_matches(indexes, req):
    """prepare_search_request, parse_expression and eval_ast over each
    package's own lookups."""
    mine, ref = indexes
    out = []
    for qp, ind in ((parser, mine), (jax_parser, ref)):
        thunks = []
        main, fields = qp.prepare_search_request(
            req.lower(), thunks, search_word=ind.search_word,
            search_field=ind.search_field, stop_words={"the"})
        got = [main, fields, [(t.name, t.word, t.field_name)
                              for t in thunks]]
        for expr in (main, fields):
            try:
                ast = qp.parse_expression(expr, thunks)
            except qp.QuerySyntaxError as e:
                got.append(("error", str(e)))
                continue
            seq = qp.eval_ast(ast) if ast is not None else None
            got.append(None if ast is None else (
                _ast(ast), seq.coords.tolist(), seq.R))
        got.append([(t.info.word, t.info.n_found) for t in thunks])
        out.append(got)
    assert out[0] == out[1]


@pytest.mark.parametrize("seed", range(6))
def test_result_pipeline_copy_matches(seed):
    """prepare_search_result (short and long runs: both rank forms),
    filters, combine_search_results, finalize_doc_ranks on random
    coordinates over a random page table."""
    rng = np.random.default_rng(seed)
    n_pages = int(rng.integers(3, 40))
    bounds = np.cumsum(rng.integers(20, 300, size=n_pages)).astype(np.uint64)
    page_doc = np.sort(rng.integers(0, max(1, n_pages // 3), size=n_pages))
    page_doc = np.unique(page_doc, return_inverse=True)[1].astype(np.int64)
    page_ids = [str(i % 5) for i in range(n_pages)]
    doc_names = [f"src:d{i}" if i % 2 else f"src:x{i}"
                 for i in range(int(page_doc.max()) + 1)]
    mine = PageTable(bounds, page_doc, page_ids, doc_names)
    ref = JaxPageTable(bounds, page_doc, list(page_ids), list(doc_names))
    for n, filters in ((5, []), (100, ["d.*"]), (0, []), (300, ["x1", "z"])):
        coords = np.sort(rng.integers(0, int(bounds[-1]) + 50, size=n)
                         ).astype(np.uint64)
        assert [x.tolist() for x in mine.locate(coords)] == \
            [x.tolist() for x in ref.locate(coords)]
        got = search.prepare_search_result(coords, mine, filters)
        want = jax_search.prepare_search_result(coords, ref, filters)
        assert result_fields(got) == result_fields(want)
        other = np.sort(rng.integers(0, int(bounds[-1]), size=n // 2 + 1)
                        ).astype(np.uint64)
        got = search.combine_search_results(
            got, search.prepare_search_result(other, mine, []))
        want = jax_search.combine_search_results(
            want, jax_search.prepare_search_result(other, ref, []))
        search.finalize_doc_ranks(got)
        jax_search.finalize_doc_ranks(want)
        assert result_fields(got) == result_fields(want)
    assert [mine.page_base(i) for i in range(n_pages)] == \
        [ref.page_base(i) for i in range(n_pages)]
    assert len(mine) == len(ref) == n_pages


@pytest.mark.parametrize("name,text,headers", TEXTS)
def test_snippets_and_highlights_copy_match(name, text, headers):
    """highlight_positions and prepare_page_text at word starts, astral
    characters among them, at every window length."""
    starts = [m.start() for m in re.finditer(r"\w+", text)]
    units = []
    for p in starts:  # UTF-16 unit offsets, as the engine counts
        units.append(len(text[:p].encode("utf-16-le")) // 2)
    for max_len in (20, 80, 320):
        for pos in (units[::3], units[1:4], units[-2:], []):
            page = search.ResultDocPage("1", list(pos))
            ref_page = jax_search.ResultDocPage("1", list(pos))
            assert search.prepare_page_text(page, text, max_len) == \
                jax_search.prepare_page_text(ref_page, text, max_len)
    for pos in (units[::2], units[:1]):
        assert search.highlight_positions(headers + text, pos) == \
            jax_search.highlight_positions(headers + text, pos)


@pytest.mark.parametrize("req", REQUESTS)
def test_index_search_matches(indexes, req):
    """The port's host engine against docodo_tpu.Index.search: docs,
    ranks, summaries, headers, found words, pages, positions, snippets
    and the words' posting counts."""
    mine, ref = indexes
    assert result_fields(mine.search(req)) == result_fields(ref.search(req))


def test_index_search_matches_on_frequent_words(indexes):
    """Requests of the Zipf text's most frequent words, alone, quoted in
    pairs and as proximity ANDs: results of hundreds of pages."""
    mine, ref = indexes
    counts = np.diff(mine.arr.offsets)
    words = [mine.arr.terms[t] for t in np.argsort(-counts, kind="stable")
             if mine.arr.terms[t].isalpha()][:12]
    reqs = words[:6] + [f'"{a} {b}"' for a, b in zip(words, words[1:])] + [
        f"{a} {b}" for a, b in zip(words[::2], words[1::2])]
    served = 0
    for req in reqs:
        got = result_fields(mine.search(req))
        assert got == result_fields(ref.search(req)), req
        served += len(got["pages"])
    assert served > 300


def test_index_state_and_suggestions_match(indexes):
    mine, ref = indexes
    assert (mine.count, mine.max_coord, mine.can_search, mine.status) == \
        (ref.count, ref.max_coord, ref.can_search, ref.status)
    for req in ("cl", "pick", "the ta", "din", "d", "zz", "au"):
        assert mine.get_suggestions(req) == ref.get_suggestions(req), req
    assert mine.get_like_words("clu_") == ref.get_like_words("clu_")
