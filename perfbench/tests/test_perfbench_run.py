"""A whole run of each cell on the CPU at a test size (the harness's
look for a card skipped): the result line's shape, the no-JAX check,
the control coming out not correct, and the timed path broken
underneath in the ways a cell can break, each seen as not correct."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from docodo_tpu_torch.ops.device_index import INF32, DeviceIndex
from perfbench import harness
from perfbench.tests.conftest import ROOT, SMALL_CONFIG, SMALL_PARAMS

CELLS = ("books-1g.and-high", "wiki1k-256m.or-high")


def run(cell, seed=2**31 + 41, trace=False, control=False):
    return harness.run_cell(cell, seed, 1.0, trace, device="cpu",
                            config=SMALL_CONFIG, params=SMALL_PARAMS,
                            control=control, note=lambda d: None)


@pytest.mark.parametrize("cell", CELLS)
def test_result_line_and_control(cell):
    res = run(cell, control=True)
    assert res["correct"] is True
    assert res["attempted"] > 0 and res["failed"] == 0
    spec = harness.cell(cell)
    # every end-to-end metric of the cell but the card's memory, which a
    # CPU run cannot read
    assert set(res["metrics"]) == {m["name"] for m in spec.end_to_end} - {
        "device_peak_gib"}
    assert {"qps", "setup_s"} <= set(res["metrics"])
    assert res["device"]["platform"] == "cpu"
    assert list(res)[-2:] == ["checks", "control"]
    assert res["checks"]["rows_differing"] == {"value": 0, "limit": 0}
    # the control: the reference with bfloat16 ranks in the program's
    # place differs on some of the same rows
    assert res["control"]["program_rows_differing"] == 0
    assert res["control"]["control_rows_differing"] > 0


def test_traced_run_reports_per_layer_metrics():
    res = run(CELLS[0], trace=True)
    assert res["correct"] is True
    assert {"dispatch_ms", "finish_ms", "build_s", "stage_s"} <= set(
        res["metrics"])
    # no device ran: the device's readers find nothing and stay silent
    assert "query_roofline_pct" not in res["metrics"]
    assert "device_idle_pct" not in res["metrics"]
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert res["device"]["window_s"] > 0


def broken(monkeypatch, spoil):
    """search_batch_full whose finish() hands back `spoil(out)`."""
    real = DeviceIndex.search_batch_full

    def fake(self, queries, **kw):
        fin = real(self, queries, **kw)
        return lambda: spoil(fin())
    monkeypatch.setattr(DeviceIndex, "search_batch_full", fake)


def half_left_out(out):
    """Every other row unanswered: left as the empty answer."""
    for f, fill in (("pages", -1), ("ranks", 0), ("counts", 0),
                    ("n_pages", 0), ("n_hits", 0), ("hits", INF32),
                    ("docs", -1), ("doc_ranks", 0)):
        out[f][1::2] = fill
    return out


def rank_off_by_an_ulp(out):
    r = out["ranks"]
    r[:, 0] = np.nextafter(r[:, 0], np.float32(np.inf))
    return out


def hit_moved(out):
    out["hits"][:, 0] += 1
    return out


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("spoil", [half_left_out, rank_off_by_an_ulp,
                                   hit_moved])
def test_broken_timed_path_is_not_correct(monkeypatch, cell, spoil):
    broken(monkeypatch, spoil)
    res = run(cell)
    assert res["correct"] is False
    assert res["checks"]["rows_differing"]["value"] > 0


def test_forbidden_modules_compared_whole(monkeypatch):
    assert "docodo_tpu_torch" in {m.split(".")[0] for m in sys.modules}
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax", object())
    monkeypatch.setitem(sys.modules, "docodo_tpu.index", object())
    assert harness.forbidden_modules() == ["docodo_tpu", "jax"]


def test_a_dry_pass_loads_no_jax():
    """A CPU pass of the harness's set-up and window in a fresh process
    leaves no module named jax, jaxlib, flax, docodo_tpu or benchmarks."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from perfbench import harness\n"
        "res = harness.run_cell('books-1g.and-high', 7, 0.5, False, "
        "device='cpu', config=%r, params=%r, note=lambda d: None)\n"
        "print(res['correct'], sorted({m.split('.')[0] for m in "
        "sys.modules} & set(harness.FORBIDDEN)))\n"
        % (ROOT, SMALL_CONFIG, SMALL_PARAMS))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "True []"


def test_without_a_card_run_py_prints_no_result():
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "perfbench", "run.py"),
         "--workload", CELLS[0], "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    with pytest.raises(json.JSONDecodeError):
        json.loads(out.stdout or "x")
