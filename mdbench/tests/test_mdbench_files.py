"""Every file BENCHMARK.json names is found by name, and the file keeps to
the shape the benchmark's contract gives it."""

import json
import re

import pytest

from mdbench import check, spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["mdbench"]
    assert (spec.ROOT / BENCH["command"][1]).is_file()
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_is_found(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"]
    cfg = spec.load_json(spec.ROOT / entry["file"])
    assert cfg["name"] == entry["name"]
    assert cfg["reduced"] == entry["reduced"]
    assert all(k in cfg for k in entry["reduced"])
    assert (spec.HERE / "data" / cfg["system"]).is_file()
    assert cfg["control_precision"] in check.DTYPES


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files_are_found(entry):
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    cell = spec.cell(entry["name"])
    assert set(spec.load_json(spec.HERE / "workloads" / f"{entry['name']}.json")) == {"limits"}
    assert set(cell.limits) == set(check.NUMBERS)
    t = cell.traffic
    assert t["chunk_steps"] % (t["save_every"] * t["obs_every"]) == 0
    assert t["save_every"] % t["sasa_every"] == 0 and t["save_every"] % t["gb_every"] == 0
    assert cell.end_to_end and cell.per_layer
    assert len(entry["why"]) <= 200


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_reader_is_found(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert callable(spec.reader(metric["name"]))


def test_names_are_unique_and_end_to_end_bounds_hold():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["name"] for w in BENCH["workloads"]] + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    bounds = {m["name"]: m["bound"] for m in BENCH["end_to_end"]}
    assert bounds["setup_s"] <= 0.25 and all(0.01 <= b <= 0.25 for b in bounds.values())
    e2e = set(bounds)
    assert all(m["moves"] in e2e for m in BENCH["per_layer"])
    assert len(json.dumps(BENCH)) < 64 * 1024
