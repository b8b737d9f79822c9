"""A configuration's `layout` on the CPU at the tests' size: one shard
reads as no layout; four shards stage through the port's sharded index
and stop before the window, with no result; a cell whose chips differ
from its layout's cards is refused; the trace's reading by card on
made-up intervals; and the check on global int64 hits past 2^31."""

import json

import numpy as np
import pytest
import torch

from docodo_tpu_torch import ShardedDeviceIndex
from perfbench import harness, span_run, trace, work
from perfbench.reference.search import (FIELDS, HIT_PAD, Postings, answers,
                                        fold_rows)
from perfbench.tests.conftest import SMALL_CONFIG, SMALL_PARAMS
from perfbench.tests.test_perfbench_trace import EVENTS, Ev, Prof

CELL = "books-1g.and-high"
SEED = 2**31 + 57


def layout(shards, cards):
    return dict(SMALL_CONFIG, layout={"shards": shards, "cards": cards})


def test_one_shard_reads_as_no_layout():
    """The same seed with no layout and with one shard on one card: the
    same answers to the pool's batches and the same metric keys, end to
    end and traced."""
    spec = harness.cell(CELL)
    got = []
    for cfg in (SMALL_CONFIG, layout(1, 1)):
        ix = harness.set_up(dict(spec.config, **cfg), SEED, "cpu")
        tf = harness.draw(ix, spec.mix, dict(spec.params, **SMALL_PARAMS),
                          SEED)
        got.append([ix.dix.search_batch_full(
            b, topk=harness.TOPK, hit_cap=harness.HIT_CAP, want_docs=True,
            fused=True, deferred=True)() for b in tf.pool.batches[:2]])
        assert ix.cards == (torch.device("cpu"),)
        assert ("layout" in ix.notes) == (cfg is not SMALL_CONFIG)
    for a, b in zip(*got):
        for f in FIELDS:
            assert np.array_equal(a[f], b[f]), f
    for traced in (False, True):
        res = [harness.run_cell(CELL, SEED, 0.5, traced, device="cpu",
                                config=cfg, params=SMALL_PARAMS,
                                note=lambda d: None)
               for cfg in (SMALL_CONFIG, layout(1, 1))]
        assert all(r["correct"] for r in res)
        assert set(res[0]["metrics"]) == set(res[1]["metrics"])
        assert res[0]["device"]["count"] == res[1]["device"]["count"] == 1
        if traced:
            assert res[1]["device"]["busy_s_by_card"] == [0.0]


def test_four_shards_stage_through_the_sharded_index_and_stop():
    notes = []
    with pytest.raises(SystemExit) as stop:
        harness.run_cell(CELL, SEED, 0.5, False, device="cpu",
                         config=layout(4, 1), params=SMALL_PARAMS,
                         note=notes.append)
    assert "ShardedDeviceIndex has no search_batch_full" in str(
        stop.value.code)
    # the set-up note came, and nothing after it
    assert [list(n) for n in notes] == [["setup"]]
    setup = notes[0]["setup"]
    assert setup["layout"] == {"shards": 4, "cards": 1}
    assert len(setup["shard_gib"]) == 4 and min(setup["shard_gib"]) > 0
    assert setup["index_gib_by_card"] == [0.0]  # no card to read
    assert {"mesh.reshard", "mesh.build", "mesh.tables"} <= set(
        setup["mesh_phases_s"])
    assert setup["stage_s"] > 0
    json.dumps(notes)
    ix = harness.set_up(dict(harness.cell(CELL).config, **layout(4, 1)),
                        SEED, "cpu")
    assert isinstance(ix.dix, ShardedDeviceIndex)
    assert len(ix.dix.mesh) == 4
    with pytest.raises(SystemExit, match="ShardedDeviceIndex"):
        span_run.run(CELL, SEED, 0.5, device="cpu", config=layout(4, 1),
                     params=SMALL_PARAMS)


def test_chips_must_match_the_layouts_cards(monkeypatch):
    real = harness._load
    lay = {}

    def load(path):
        d = real(path)
        return dict(d, layout=lay["v"]) if path.endswith(
            "books-1g.json") else d
    monkeypatch.setattr(harness, "_load", load)
    for v in ({"shards": 4, "cards": 1}, {"shards": 1, "cards": 1}):
        lay["v"] = v
        assert harness.cell(CELL).chips == 1
    for v in ({"shards": 4, "cards": 4}, {"shards": 2, "cards": 2}):
        lay["v"] = v
        with pytest.raises(SystemExit, match="laid out over"):
            harness.cell(CELL)
    for bad in ({"shards": 2, "cards": 4}, {"shards": 0, "cards": 0}):
        with pytest.raises(ValueError):
            harness.layout({"layout": bad})
    assert harness.layout({}) is None
    assert harness.layout({"layout": {"shards": 8, "cards": 4}}) == (8, 4)


def two_cards():
    """EVENTS' host spans (0-300) with card 0 running [10, 80] (a copy
    [120, 140]) and card 1 running [100, 200] (a copy [200, 210])."""
    host = [e for e in EVENTS if e.device_type().endswith("CPU")]
    return host + [
        Ev("k_a", "CUDA", 10, 60, card=0),
        Ev("k_b", "CUDA", 40, 80, card=0),
        Ev("Memcpy DtoH (Device -> Pinned)", "CUDA", 120, 140, card=0),
        Ev("k_a", "CUDA", 100, 200, card=1),
        Ev("Memcpy HtoD (Pageable -> Device)", "CUDA", 200, 210, card=1),
    ]


def test_trace_groups_device_operations_by_card():
    tr = trace.read(Prof(two_cards()), [0, 1])
    assert tr.cards == [0, 1]
    assert np.allclose(tr.busy_s_by_card, [90e-9, 110e-9])
    assert np.isclose(tr.busy_s, 100e-9)
    # kernels: card 0 [10, 80] = 70, card 1 [100, 200] = 100, summed
    assert np.isclose(tr.kernel_busy_s, 170e-9)
    assert np.isclose(dict(tr.ops)["k_a"], 150e-9)
    # each card's idle seconds by span, averaged: card 0 idles [0, 10],
    # [80, 120], [140, 300]; card 1 [0, 100], [210, 300]
    assert np.isclose(sum(tr.idle.values()), tr.window_s - tr.busy_s)
    assert np.isclose(tr.idle["bench.between"], (10 + 0) / 2 * 1e-9)
    assert np.isclose(tr.idle["bench.finish"], (20 + 10 + 0) / 2 * 1e-9)
    # the longest gaps name their card
    assert tr.gaps[0] == ("bench.dispatch", pytest.approx(160e-9), 0)
    assert tr.gaps[1][2] == 1
    bd = trace.breakdown(tr)
    assert bd["idle_gaps"][-len(tr.gaps)][0] == (
        "longest gap in bench.dispatch on card 0")
    run = harness.Run(setup_s=1.0, build_s=0.5, stage_s=0.2,
                      index_bytes=2**30, batches=[], window_s=1.0,
                      peak_bytes=2**31, bytes_moved=int(3.35e12 * 85e-9),
                      trace=tr, peaks=work.peaks(), device="cuda")
    # the same least bytes over both cards' kernel-busy seconds
    assert np.isclose(harness.reader("query_roofline_pct")(run), 50.0)
    # the mean of the cards' idle shares: 210 / 300 and 190 / 300
    assert np.isclose(harness.reader("device_idle_pct")(run),
                      100 * (210 + 190) / 2 / 300)
    # a card of the layout that ran nothing reads idle throughout
    idle3 = trace.read(Prof(two_cards()), [0, 1, 2])
    assert idle3.busy_s_by_card[2] == 0.0
    assert np.isclose(idle3.busy_s, 200e-9 / 3)


def test_one_card_reads_as_today():
    """Every event on card 0, with or without the cards named: the
    readings test_perfbench_trace holds."""
    for cards in ((), [0]):
        tr = trace.read(Prof(EVENTS), cards)
        assert tr == trace.read(Prof(EVENTS))
        assert tr.cards == [0]
        assert np.isclose(tr.busy_s, (70 + 20 + 50) * 1e-9)
        assert tr.busy_s_by_card == [tr.busy_s]
        assert np.isclose(tr.kernel_busy_s, (70 + 50) * 1e-9)
        assert all(not n.endswith("card 0")
                   for n, _ in trace.breakdown(tr)["idle_gaps"])


def test_check_compares_int64_hits_past_2_31():
    """The reference over coordinates past 2^31 keeps them, and a program
    that answers them as global uint64 hits (its pad uint64's maximum)
    agrees field for field; one moved hit makes its row differ."""
    base = 3 * 2**31
    rng = np.random.default_rng(3)
    n = 4000
    ids = rng.integers(0, 3, size=n).astype(np.int32)
    coords = base + np.cumsum(rng.integers(1, 9, size=n)).astype(np.int64)
    page_end = np.arange(base + 300, int(coords[-1]) + 300, 300,
                         dtype=np.int64)
    n_pages = page_end.size
    page_doc = np.arange(n_pages) // 4
    rows = [np.array([[0], [1]]), np.array([[2]]),
            np.array([[0, 2], [1, -1]])]
    rs = [[30, 30], [5], [-8, 40]]
    post = Postings(ids, coords, [0, 1, 2], 3)
    runs = fold_rows(rows, rs, post, page_end, 16, 256)
    hits = runs["hits"]
    assert hits.dtype == np.int64
    real = hits != HIT_PAD
    assert real[:, 0].all() and (hits[real] > 2**32).all()
    assert set(hits[1][real[1]].tolist()) <= set(coords[ids == 2].tolist())
    ref = answers(runs, page_doc, np.zeros(n_pages, dtype=bool),
                  harness._log_fn(torch.device("cpu")))
    got = {f: ref[f].copy() for f in FIELDS}
    got["hits"] = np.where(real, hits, 0).astype(np.uint64)
    got["hits"][~real] = np.iinfo(np.uint64).max
    assert not harness._rows_differing(got, ref).any()
    got["hits"][1, 0] += np.uint64(1)
    assert harness._rows_differing(got, ref).tolist() == [False, True,
                                                          False]
    # an int32 answer padded with INT32_MAX against the same reference
    # where its coordinates fit: the pads compare equal, the hits exactly
    small = np.where(real, hits - base, 2**31 - 1).astype(np.int32)
    assert not harness._field_rows(
        small, np.where(real, hits - base, HIT_PAD)).any()
    small[2, 0] = 2**31 - 1
    assert harness._field_rows(
        small, np.where(real, hits - base, HIT_PAD)).tolist() == [
        False, False, True]
