"""Everything the harness finds by name: ``BENCHMARK.json`` at the root of the
checkout, and under ``mdbench/`` a configuration (``configs/<config>.json``),
a traffic mix (``traffic/<traffic>.json``), the limits of a cell's
comparison (``workloads/<cell>.json``; its configuration, traffic and why are
its entry in ``BENCHMARK.json``) and a reader per metric
(``metrics/<metric>.py``)."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: pathlib.Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    #: the limit of each number the comparison reads (``check.NUMBERS``)
    limits: dict
    #: the metric entries of BENCHMARK.json this cell reports, by trace mode
    end_to_end: list
    per_layer: list


def _reports(metric: dict, cell: str, e2e_names: set) -> bool:
    """Whether ``cell`` reports ``metric``: the cells its ``workloads`` list
    names, else every cell that reports the end-to-end metric it ``moves``
    (the benchmark's contract gives later entries both keys)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in e2e_names if "moves" in metric else True


def cell(name: str) -> Cell:
    """The cell ``name`` of BENCHMARK.json with its files."""
    bench = benchmark()
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(entries)}")
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(ROOT / configs[entry["config"]]["file"])
    traffic = load_json(HERE / "traffic" / f"{entry['traffic']}.json")
    limits = load_json(HERE / "workloads" / f"{name}.json")["limits"]
    e2e = [m for m in bench["end_to_end"] if _reports(m, name, set())]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _reports(m, name, e2e_names)]
    return Cell(name=name, chips=entry["chips"], config=config, traffic=traffic,
                limits=limits, end_to_end=e2e, per_layer=layer)


def reader(metric: str):
    """The ``read(run)`` function of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"mdbench_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
