"""The benchmark's data, found by name.

``BENCHMARK.json`` at the checkout's root names the cells, their
configurations and traffic mixes and the metrics.  Each configuration is
``benchmark/configs/<config>.json``, each traffic mix
``benchmark/traffic/<traffic>.json``, each cell's limits of the
correctness check ``benchmark/limits/<cell>.json``, each per-layer
metric's reader ``benchmark/metrics/<metric>.py``.  Adding any of them is
adding files and entries; no code here names a cell.
"""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(path):
    with open(path) as f:
        return json.load(f)


def benchmark():
    return _json(os.path.join(ROOT, "BENCHMARK.json"))


def _applies(metric, cell_name):
    return "workloads" not in metric or cell_name in metric["workloads"]


def cell(name: str, bench=None) -> dict:
    """Everything the harness needs of one cell: its entry, configuration,
    traffic mix, limits and the metrics it reports."""
    bench = bench or benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        names = ", ".join(w["name"] for w in bench["workloads"])
        raise SystemExit(f"unknown workload {name!r}; the cells are {names}")
    conf_entry = next(c for c in bench["configs"]
                      if c["name"] == entry["config"])
    return {
        "name": name,
        "chips": int(entry["chips"]),
        "config": _json(os.path.join(ROOT, conf_entry["file"])),
        "traffic": _json(os.path.join(HERE, "traffic",
                                      entry["traffic"] + ".json")),
        "limits": _json(os.path.join(HERE, "limits", name + ".json")),
        "end_to_end": [m for m in bench["end_to_end"] if _applies(m, name)],
        "per_layer": [m for m in bench["per_layer"] if _applies(m, name)],
    }


def reader(metric_name: str):
    """The ``read(trace)`` function of ``metrics/<metric_name>.py``."""
    path = os.path.join(HERE, "metrics", metric_name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + metric_name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
