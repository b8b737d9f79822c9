"""The four-shard configuration on the CPU at the tests' size: its cell
runs through ShardedDeviceIndex.search_batch_full and its answers pass
the check; the readers of card_skew_pct, shard_merge_ms and
reserve_rows_pct on made-up readings, and None where the program keeps
no such counter or the trace names one card."""

import types

import numpy as np
import pytest

from docodo_tpu_torch.utils import profiling
from perfbench import harness
from perfbench.tests.conftest import SMALL_PARAMS

CELL = "books-4cards.and-high"
SEED = 2**31 + 91
# four shards on the CPU, the corpus cut for a test run
SMALL = {"corpus_chars": 3_000_000, "layout": {"shards": 4, "cards": 1}}


@pytest.mark.parametrize("traced", [False, True])
def test_four_shard_cell_runs_and_checks(traced):
    notes = []
    res = harness.run_cell(CELL, SEED, 0.5, traced, device="cpu",
                           config=SMALL, params=SMALL_PARAMS,
                           note=notes.append)
    assert res["correct"] and res["checks"]["rows_differing"]["value"] == 0
    assert notes[0]["setup"]["layout"] == {"shards": 4, "cards": 1}
    assert "mesh.halo" in notes[0]["setup"]["mesh_phases_s"]
    if traced:
        m = res["metrics"]
        assert m["reserve_rows_pct"]["value"] == 0.0
        assert m["shard_merge_ms"]["value"] > 0
        assert "compile_miss_pct" in m
        # one device (the CPU): no skew to read
        assert "card_skew_pct" not in m
    else:
        # the end-to-end metrics the CPU reads (no device peak there)
        assert set(res["metrics"]) == {"qps", "batch_p95_ms", "setup_s"}


def run_with(busy):
    return types.SimpleNamespace(trace=None if busy is None else
                                 types.SimpleNamespace(busy_s_by_card=busy))


def test_card_skew_reads_the_busiest_card_over_the_mean():
    read = harness.reader("card_skew_pct")
    assert np.isclose(read(run_with([1.0, 1.0, 1.0, 1.4])),
                      100 * (1.4 / 1.1 - 1))
    assert read(run_with([2.0, 2.0])) == 0.0
    assert read(run_with([2.0])) is None
    assert read(run_with([0.0, 0.0])) is None
    assert read(run_with(None)) is None


def test_counter_readers():
    merge = harness.reader("shard_merge_ms")
    reserve = harness.reader("reserve_rows_pct")
    profiling.reset()
    assert merge(None) is None and reserve(None) is None
    profiling.count("mesh.batches", 4)
    profiling.count("mesh.rows", 400)
    profiling.count("mesh.reserve_rows", 3)
    profiling.record("mesh.merge", 0.010)
    profiling.record("mesh.merge", 0.006)
    assert np.isclose(merge(None), 4.0)
    assert np.isclose(reserve(None), 0.75)
    profiling.reset()
