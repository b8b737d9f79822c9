"""BENCHMARK.json against the contract's shape, and every cell, mix,
configuration and metric found by name in a file of its own."""

import json
import os
import re

import pytest

from perfbench import harness, traffic

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys_and_paths():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(b["paths"]) <= 16
    for p in b["paths"]:
        assert PATH.match(p) and ".." not in p and not p.startswith("/")
        assert os.path.isdir(os.path.join(ROOT, p))
        assert not p.endswith("_torch")
    assert 1 <= len(b["command"]) <= 32
    script = b["command"][1]
    assert any(script.startswith(p + "/") for p in b["paths"])
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_entries():
    b = bench()
    names = [c["name"] for c in b["configs"]]
    names += [w["name"] for w in b["workloads"]]
    names += [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(set(names)) == len(names)
    for n in names:
        assert NAME.match(n), n
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key)
            assert not key.endswith(("_dim", "_rank"))
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(
        1, len(b["workloads"]) // 4)
    assert 1 <= len(b["end_to_end"]) <= 16
    assert "setup_s" in {m["name"] for m in b["end_to_end"]}
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for text in ([c["why"] for c in b["configs"]]
                 + [c["source"] for c in b["configs"]]
                 + [m["layer"] for m in b["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text \
            and "\t" not in text


@pytest.mark.parametrize("name", [w["name"] for w in bench()["workloads"]])
def test_cell_resolves_to_its_files(name):
    spec = harness.cell(name)
    b = bench()
    w = [x for x in b["workloads"] if x["name"] == name][0]
    conf = [c for c in b["configs"] if c["name"] == w["config"]][0]
    assert conf["file"].startswith("perfbench/configs/")
    assert spec.config["name"] == w["config"]
    assert traffic.load_mix(w["traffic"]) == spec.mix
    # a cell's own file holds its batch and its pool, nothing else: the
    # call and the check are the same in every cell
    assert set(spec.params) == {"batch", "pool_batches"}
    for key in spec.params:
        assert int(spec.params[key]) > 0
    assert spec.mix["source"] and spec.mix["assumed"]
    # every cell reports setup_s, another end-to-end metric and a
    # per-layer one, each read by its own file
    assert "setup_s" in {m["name"] for m in spec.end_to_end}
    assert len(spec.end_to_end) >= 2 and spec.per_layer
    for m in spec.end_to_end + spec.per_layer:
        assert callable(harness.reader(m["name"]))
    # a per-layer metric moves an end-to-end metric of each of its cells
    for m in spec.per_layer:
        assert m["moves"] in {e["name"] for e in spec.end_to_end}


def test_config_files_are_distinct_and_state_their_cuts():
    b = bench()
    files = [c["file"] for c in b["configs"]]
    assert len(set(files)) == len(files)
    for c in b["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert set(c["reduced"]) == set(cfg["reduced_from"])
        assert cfg["rank_dtype"] == "float32" and cfg["guarantees"]
