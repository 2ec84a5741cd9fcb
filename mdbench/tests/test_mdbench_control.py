"""The control and the planted faults: the reference itself put in the
program's place, computed in the configuration's ``control_precision`` or in
float64 with one layer of the physics wrong, fails the cell's limits where
the program passes them. At a tiny size on the CPU here; at each cell's own
size on the card (marked ``card``), three seeds."""

import torch
import pytest

from mdbench import check, spec
from mdbench.control import limit_from, readings_for_seed


def _fails(readings: dict, limits: dict) -> list:
    return [k for k in check.NUMBERS if readings[k] > limits[k]]


@pytest.mark.parametrize("cell", ["vac104-r1024-log", "gbis104-r1024-sasa5"])
def test_control_and_faults_fail_where_the_program_passes(cell):
    c = spec.cell(cell)
    tiny = spec.Cell(**{**c.__dict__, "traffic": dict(c.traffic, replicas=4, chunk_steps=100)})
    r = readings_for_seed(tiny, 2**31 + 3, 1, 4, True, torch.device("cpu"))
    assert check.judge(r["program"], c.limits)
    assert all(r["control"][k] > c.limits[k] for k in check.NUMBERS)
    assert set(r["faults"]) == set(check.faults_for(c.config))
    for name, g in r["faults"].items():
        assert _fails(g, c.limits), name


def test_limit_lies_above_the_geometric_mean():
    for lower, upper in ((2.2e-5, 7.2e-4), (1e-6, 0.1), (1.15e-3, 2.16)):
        lim = limit_from(lower, upper)
        assert (lower * upper) ** 0.5 < lim < upper


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in spec.benchmark()["workloads"]])
def test_control_at_the_cells_size_on_the_card(cuda, cell):
    c = spec.cell(cell)
    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        r = readings_for_seed(c, seed, 5, 64, True, cuda)
        assert check.judge(r["program"], c.limits), r
        assert not check.judge(r["control"], c.limits), r
        assert all(_fails(g, c.limits) for g in r["faults"].values()), r
