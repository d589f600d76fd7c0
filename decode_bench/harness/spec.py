"""Find a cell's parts by name: the workload in BENCHMARK.json, its
configuration (configs/<name>.json), its traffic mix (traffic/<name>.json)
and its per-layer metrics (metrics/<name>.py).

Adding a cell takes new files, and in BENCHMARK.json new entries and its
name added to lists that are there:
- the configuration, configs/<config>.json, where the cell brings a new one;
- the traffic mix, traffic/<traffic>.json;
- one sum file per stream new to the benchmark, sums/<stream>.sha256
  (harness/streams.py);
- per pool item new to the benchmark, the reference's digests,
  expected/<item>.json (tools/make_expected.py), and the frozen work,
  work/<item>.json (tools/freeze_work.py);
- one reader per new per-layer metric, metrics/<name>.py;
- the `workloads` entry, and the `configs` and metric entries it adds;
- the cell's name in the `workloads` list of each metric already there
  that the cell reports (_applies: a metric with a `workloads` key applies
  to the cells it lists, one without it to every cell).
"""
from __future__ import annotations

import importlib.util
import json
import os

from decode_bench.harness.streams import BENCH_DIR, REPO_DIR

BENCHMARK = os.path.join(REPO_DIR, "BENCHMARK.json")


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(path: str = BENCHMARK) -> dict:
    return _json(path)


def config(name: str, bench_dir: str = BENCH_DIR) -> dict:
    return _json(os.path.join(bench_dir, "configs", name + ".json"))


def traffic(name: str, bench_dir: str = BENCH_DIR) -> dict:
    return _json(os.path.join(bench_dir, "traffic", name + ".json"))


def metric(name: str, bench_dir: str = BENCH_DIR):
    """The reader module of per-layer metric `name`: read(ranks) -> value
    or None, with UNIT, LAYER, MOVES, SOURCE and RANGES ({range label:
    [(module, attribute)]}, the functions the traced run wraps)."""
    path = os.path.join(bench_dir, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "decode_bench_metric_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def cell(name: str, bench: dict | None = None,
         bench_dir: str = BENCH_DIR) -> dict:
    """{"workload", "config", "traffic", "end_to_end": [names],
    "per_layer": [names]} of the cell `name`: plain data, which a rank's
    process receives whole."""
    bench = benchmark() if bench is None else bench
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    return dict(
        workload=w, config=config(w["config"], bench_dir),
        traffic=traffic(w["traffic"], bench_dir),
        end_to_end=[m["name"] for m in bench["end_to_end"]
                    if _applies(m, name)],
        per_layer=[m["name"] for m in bench["per_layer"]
                   if _applies(m, name)])
