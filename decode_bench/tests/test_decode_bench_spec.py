"""BENCHMARK.json and the files it names: found by name, and within the
benchmark contract's limits."""
import os
import re

import pytest

from decode_bench.harness import spec
from decode_bench.harness.streams import BENCH_DIR, REPO_DIR

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
B = spec.benchmark()


def test_top_level_keys_and_command():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert B["command"] == ["python3", "decode_bench/run.py"]
    assert B["paths"] == ["decode_bench"]
    assert 1 <= B["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(REPO_DIR, "BENCHMARK.json")) < 65536


def test_names_units_and_entries():
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k)
                                             for k in c["reduced"])
        assert c["file"] == f"decode_bench/configs/{c['name']}.json"
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and len(w["why"]) <= 200
        assert w["chips"] in (1, 4)
    for m in B["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in B["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
    for m in B["end_to_end"] + B["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in B[k]]
    assert len(names) == len(set(names))
    assert sum(w["chips"] == 4 for w in B["workloads"]) <= max(
        1, len(B["workloads"]) // 4)


@pytest.mark.parametrize("cell", [w["name"] for w in B["workloads"]])
def test_cells_find_their_parts_by_name(cell):
    c = spec.cell(cell)
    assert c["config"]["name"] == c["workload"]["config"]
    assert c["config"]["chips"] == c["workload"]["chips"]
    assert "setup_s" in c["end_to_end"] and len(c["end_to_end"]) >= 2
    assert c["per_layer"]
    e2e = {m["name"] for m in B["end_to_end"]}
    for name in c["per_layer"]:
        entry = [m for m in B["per_layer"] if m["name"] == name][0]
        mod = spec.metric(name)
        assert (mod.UNIT, mod.LAYER, mod.MOVES, mod.SOURCE) == (
            entry["unit"], entry["layer"], entry["moves"], entry["source"])
        assert mod.MOVES in e2e and mod.MOVES in c["end_to_end"]
        assert callable(mod.read)
        assert mod.read([]) is None


def test_config_files_state_their_reductions():
    for c in B["configs"]:
        f = spec.config(c["name"])
        assert f["source"] == c["source"]
        assert f["reduced"] == c["reduced"]
        assert all(k in f for k in c["reduced"])


def test_every_metric_and_file_is_found_by_name():
    for m in B["per_layer"]:
        assert os.path.exists(os.path.join(BENCH_DIR, "metrics",
                                           m["name"] + ".py"))
    with pytest.raises(KeyError):
        spec.cell("no_such.cell")
    with pytest.raises(FileNotFoundError):
        spec.traffic("no_such_mix")
