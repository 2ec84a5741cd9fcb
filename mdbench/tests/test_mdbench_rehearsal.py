"""A whole run of the harness, rehearsed on the CPU at a tiny size (the
kernels' plain versions): the last line's schema, and ``correct`` false when
the timed path is broken underneath. A rehearsal writes no device metric.
On the card (marked ``card``): a short run of each cell comes out correct."""

import json
import subprocess
import sys

import pytest

from mdbench import check, spec

TINY = ["--device", "cpu", "--replicas", "4", "--chunk-steps", "100", "--seconds", "0.5"]

#: faults planted in the timed path, each beside the number that has to
#: catch it. An op fault replaces the campaign op by a lambda of the real op
#: and its arguments; a config fault builds the real op from a wrong config.
BROKEN = {
    # the campaign op hands its state back unchanged
    "state_unchanged": ("pos_gap_A", "op", "lambda real, pos, vel, frc, t0, seed: (pos, vel, frc)"),
    # half of the replicas left out: they come back as they went in
    "half_batch_left_out": ("pos_gap_A", "op", "lambda real, pos, vel, frc, t0, seed: "
                            "halve(real(pos, vel, frc, t0, seed), (pos, vel, frc))"),
    # every replica's answer written as its neighbour's where it is produced
    "answer_altered": ("pos_gap_A", "op",
                       "lambda real, pos, vel, frc, t0, seed: alter(real(pos, vel, frc, t0, seed))"),
    # every launch of a call takes the first launch's step and noise seed
    "noise_reused": ("pos_gap2_med_A", "op", "FirstLaunch()"),
    # the campaign kernel without its LCPO term, or without the salt's screening
    "lcpo_dropped": ("pos_gap_med_A", "config", "drop_sasa"),
    "salt_dropped": ("pos_gap_med_A", "config", "no_salt"),
    # the observables' energy without its LCPO term
    "lcpo_dropped_in_log": ("log_gap_med", "log", "drop_sasa"),
}

_WRAPPER = """
import dataclasses
import sys
sys.path.insert(0, {root!r})
import torch
import molecular_dynamics_tpu_torch.sim as sim


def halve(out, inp):
    h = out[0].shape[0] // 2
    return tuple(torch.cat([o[:h], i[h:]]) for o, i in zip(out, inp))


def alter(out):
    return (out[0].roll(1, 0),) + tuple(out[1:])


def drop_sasa(config):
    terms = tuple(t for t in config.energy.terms if t != "sasa")
    return dataclasses.replace(config, energy=dataclasses.replace(config.energy, terms=terms))


def no_salt(config):
    return dataclasses.replace(
        config, energy=dataclasses.replace(config.energy, ion_concentration=0.0))


class FirstLaunch:
    def __init__(self):
        self.first = None

    def __call__(self, real, pos, vel, frc, t0, seed):
        self.first = self.first or (t0, seed)
        return real(pos, vel, frc, *self.first)


class Broken:
    def __init__(self, real, fault):
        self._real, self._fault = real, fault

    def __getattr__(self, name):
        return getattr(self._real, name)

    def __call__(self, pos, vel, frc, t0, seed, noise=None):
        return self._fault(self._real, pos, vel, frc, t0, seed)


kind, fault = {kind!r}, {fault}
if kind == "op":
    make = sim._campaign_advance_fn
    sim._campaign_advance_fn = lambda *a, **k: Broken(make(*a, **k), {fault})
elif kind == "config":
    make = sim._campaign_advance_fn
    sim._campaign_advance_fn = lambda ff, every, config, bias: make(ff, every, fault(config), bias)
elif kind == "log":
    observe = sim._observables
    sim._observables = lambda state, ff, config, *a: observe(state, ff, fault(config), *a)
elif kind == "fallback":
    sim._uncovered_option = lambda flag, config: "a planted option"
sys.argv = ["mdbench/run.py"] + {argv!r}
import runpy
runpy.run_path({root!r} + "/mdbench/run.py", run_name="__main__")
"""


def _process(argv, kind=None, fault="None"):
    if kind is None:
        cmd = [sys.executable, str(spec.HERE / "run.py"), *argv]
    else:
        code = _WRAPPER.format(root=str(spec.ROOT), kind=kind, fault=fault, argv=argv)
        cmd = [sys.executable, "-c", code]
    return subprocess.run(cmd, cwd=spec.ROOT, capture_output=True, text=True, timeout=600)


def _run(argv, kind=None, fault="None"):
    out = _process(argv, kind, fault)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1]), out.stderr


@pytest.mark.parametrize("trace", [0, 1])
def test_last_line_schema(trace):
    cell = "gbis104-r1024-sasa5" if trace else "vac104-r1024-log"
    result, err = _run(["--workload", cell, "--seed", str(2**31 + 5), "--trace", str(trace),
                        *TINY])
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "check"
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] >= 4
    assert set(result["check"]) == {*check.NUMBERS, "failed_replicas", "campaign_launches"}
    # no CPU number under a device metric's name
    assert all(m["value"] is None for m in result["metrics"].values())
    names = {m["name"] for m in (spec.cell(cell).per_layer if trace else
                                  spec.cell(cell).end_to_end)}
    assert set(result["metrics"]) == names
    assert result["device"]["platform"] == "cpu"
    tail = err.strip().splitlines()[-len(result["check"]):]
    assert [ln.split()[1] for ln in tail] == list(result["check"])


@pytest.mark.parametrize("fault", sorted(BROKEN))
def test_broken_timed_path_is_not_correct(fault):
    number, kind, code = BROKEN[fault]
    result, _ = _run(["--workload", "gbis104-r1024-log", "--seed", "91", "--trace", "0", *TINY],
                     kind, code)
    assert result["correct"] is False
    assert result["check"][number]["value"] > result["check"][number]["limit"]


def test_composed_path_fallback_is_no_result():
    """Where the program would warn and run its composed path instead of the
    campaign kernel, the run fails and prints no result."""
    out = _process(["--workload", "gbis104-r1024-log", "--seed", "92", "--trace", "0", *TINY],
                   "fallback")
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "fused_campaign requested" in out.stderr


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys, torch; torch.cuda.is_available = lambda: False; "
         "sys.argv = ['run.py', '--workload', 'vac104-r1024-quiet', '--seed', '1', "
         "'--seconds', '1']; import runpy; runpy.run_path('mdbench/run.py', run_name='__main__')"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in spec.benchmark()["workloads"]])
def test_short_run_on_the_card_is_correct(cuda, cell):
    result, _ = _run(["--workload", cell, "--seed", str(2**31 + 19), "--seconds", "3",
                      "--trace", "0"])
    assert result["correct"] is True and result["device"]["platform"] == "gpu"


def test_bare_checkout_no_result(tmp_path):
    """A directory holding only BENCHMARK.json and mdbench/ has no program to
    measure: the run fails and prints no result."""
    import shutil

    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(spec.HERE, tmp_path / "mdbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "mdbench/run.py", "--workload", "vac104-r1024-log",
                          "--seed", "3", "--trace", "0", *TINY], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
