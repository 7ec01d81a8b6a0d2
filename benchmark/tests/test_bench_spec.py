"""Every configuration, cell and per-layer metric loads by name, and
BENCHMARK.json keeps to the contract's shapes."""

import json
import os
import re

import pytest

from benchmark import check, spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    for p in BENCH["paths"]:
        assert os.path.isdir(os.path.join(spec.ROOT, p))


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") \
            else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for cell in e.get("workloads", []) if section != "workloads" else []:
            assert cell in {w["name"] for w in BENCH["workloads"]}


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_cell_loads(name):
    cell = spec.cell(name)
    assert cell["config"]["name"] in name
    assert {m["name"] for m in cell["end_to_end"]} >= {"setup_s",
                                                       "steps_per_s"}
    assert cell["per_layer"]
    compared = set(cell["limits"]["limits"])
    assert {"mob_gap", "mob2_gap", "step_gap"} <= compared <= set(
        check.NUMBERS)


@pytest.mark.parametrize("name", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_loads(name):
    assert callable(spec.reader(name))


def test_config_files_are_json():
    for c in BENCH["configs"]:
        with open(os.path.join(spec.ROOT, c["file"])) as f:
            assert json.load(f)["name"] == c["name"]
