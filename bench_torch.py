#!/usr/bin/env python3
"""The port's benchmark: deca-alanine campaign throughput on one GPU.

The twin of ``bench.py`` for ``molecular_dynamics_tpu_torch``: aggregate
Langevin-SMD integration steps/s of the 104-atom full-representation
deca-alanine across 1024 replicas, every ``save_every`` segment one launch of
the campaign kernel (``simulate_ensemble`` with ``fused_campaign=True``).
Three protocols, one JSON line:

- primary: rigid X-H bonds at 2 fs, vacuum reaction field
  (``REFERENCE_CONFIG``);
- secondary ``gbis``: + GB-OBC polar solvation (``GBIS_POLAR_CONFIG``);
- secondary ``gbis_sasa``: + LCPO SASA (``GBIS_CONFIG``), the full NAMD
  GBIS protocol.

Each protocol: FIRE once (500 steps, shared), SMD bias from the measured
end-to-end distance (+22 A over 500,000 steps), one warm-up call, then
three timed calls of ``MDX_BENCH_STEPS`` steps,
frames every 50 steps, the observables once a call. ``value`` is the median
of the timed calls; ``runs`` holds each, ``min``/``max`` their spread.

Physics knobs (environment, as ``bench.py``): MDX_BENCH_REPLICAS (1024),
MDX_BENCH_STEPS (2000), MDX_BENCH_GBIS / MDX_BENCH_SASA (0: promote that
protocol to the primary metric), MDX_BENCH_CONSTRAIN (1: rigid X-H bonds),
MDX_BENCH_SASA_EVERY (5), MDX_BENCH_GB_EVERY (1), MDX_BENCH_SECONDARY (1:
also the two GBIS protocols).

Run: ``python3 bench_torch.py`` on a machine with a CUDA device (``--device
cpu`` runs the kernels' plain versions, for a check of the script only: its
numbers are no device metric).
"""

import argparse
import dataclasses
import json
import os
import statistics
import sys
import time

import torch

from molecular_dynamics_tpu_torch import (
    HarmonicSMDBias,
    maxwell_boltzmann,
    minimize_fire,
    system_init,
)
from molecular_dynamics_tpu_torch.energy import (
    GBIS_CONFIG,
    GBIS_POLAR_CONFIG,
    REFERENCE_CONFIG,
    force_fn,
)
from molecular_dynamics_tpu_torch.examples import decaalanine_full
from molecular_dynamics_tpu_torch.integrate import initialize_forces
from molecular_dynamics_tpu_torch.sim import SimulationConfig, simulate_ensemble
from molecular_dynamics_tpu_torch.system import replicate

SAVE_EVERY = 50
TIMED_CALLS = 3


@dataclasses.dataclass(frozen=True)
class Knobs:
    replicas: int
    steps: int
    gbis: bool
    sasa: bool
    constrain: bool
    sasa_every: int
    gb_every: int
    secondary: bool

    @classmethod
    def from_env(cls) -> "Knobs":
        env = os.environ.get
        return cls(
            replicas=int(env("MDX_BENCH_REPLICAS", 1024)),
            steps=int(env("MDX_BENCH_STEPS", 2000)),
            gbis=env("MDX_BENCH_GBIS", "0") == "1",
            sasa=env("MDX_BENCH_SASA", "0") == "1",
            constrain=env("MDX_BENCH_CONSTRAIN", "1") == "1",
            sasa_every=int(env("MDX_BENCH_SASA_EVERY", 5)),
            gb_every=int(env("MDX_BENCH_GB_EVERY", 1)),
            secondary=env("MDX_BENCH_SECONDARY", "1") == "1",
        )


def _synchronize(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_case(ff, pos, knobs: Knobs, gbis: bool, sasa: bool, device) -> dict:
    """Time one protocol: aggregate steps/s of each timed call."""
    n = ff.n_atoms
    e_cfg = (GBIS_CONFIG if sasa else GBIS_POLAR_CONFIG) if gbis else REFERENCE_CONFIG
    d0 = float(torch.linalg.norm(pos[-1] - pos[0]))
    bias = HarmonicSMDBias.create(
        n_atoms=n, group1=[0], group2=[n - 1],
        fk=1.0, cent_0=d0, cent_1=d0 + 22.0, T=500_000, device=device,
    )
    cfg = SimulationConfig(
        dt_fs=2.0, temperature=300.0, gamma_ps=1.0, energy=e_cfg,
        fused_campaign=True, constrain_h_bonds=knobs.constrain,
        sasa_every=knobs.sasa_every if sasa else 1,
        gb_every=knobs.gb_every if gbis else 1,
    )
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    state = system_init(pos, vel=maxwell_boltzmann(gen, ff.masses, 300.0), key=0,
                        device=device)
    seed_force = force_fn(e_cfg, external=lambda q: bias.energy(q, 0))
    state = initialize_forces(state, lambda p, box: seed_force(p, ff))
    ens = replicate(state, knobs.replicas, seed=1)
    n_saves = knobs.steps // SAVE_EVERY

    def call(states):
        return simulate_ensemble(states, ff, knobs.steps, SAVE_EVERY, cfg, bias,
                                 obs_every=n_saves)

    ens, _, _ = call(ens)  # warm-up
    _synchronize(device)
    rates = []
    for _ in range(TIMED_CALLS):
        t0 = time.perf_counter()
        ens, frames, _ = call(ens)
        _synchronize(device)
        rates.append(knobs.steps * knobs.replicas / (time.perf_counter() - t0))
        if not bool(torch.isfinite(frames).all()):
            raise RuntimeError("trajectory diverged")
    return {"median": statistics.median(rates), "min": min(rates), "max": max(rates),
            "runs": rates}


def run(device="cuda", knobs: Knobs = None) -> dict:
    """All protocols the knobs ask for; the bench record."""
    knobs = knobs or Knobs.from_env()
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: bench_torch measures on the card "
                           "(--device cpu checks the script only)")
    ff, coords, _ = decaalanine_full(device=device)
    force = force_fn(REFERENCE_CONFIG)
    pos = minimize_fire(
        torch.as_tensor(coords, dtype=torch.float32, device=device),
        lambda p: force(p, ff), n_steps=500, dt_start=0.001, dt_max=0.01,
    )
    gbis = knobs.gbis or knobs.sasa
    primary = run_case(ff, pos, knobs, gbis=gbis, sasa=knobs.sasa, device=device)
    name = (
        "decaalanine_104atom_langevin_smd"
        + ("_gbis" if gbis else "")
        + ("_sasa" if knobs.sasa else "")
        + ("_rigidbonds" if knobs.constrain else "")
        + f"_steps_per_sec_{knobs.replicas}rep"
    )
    record = {
        "metric": name,
        "value": primary["median"],
        "unit": "steps/sec (aggregate)",
        "min": primary["min"],
        "max": primary["max"],
        "runs": primary["runs"],
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "knobs": dataclasses.asdict(knobs),
        "secondary": {},
    }
    if knobs.secondary and not gbis:
        for label, sasa in (("gbis", False), ("gbis_sasa", True)):
            res = run_case(ff, pos, knobs, gbis=True, sasa=sasa, device=device)
            record["secondary"][f"{label}_steps_per_sec"] = res["median"]
            record["secondary"][f"{label}_min"] = res["min"]
            record["secondary"][f"{label}_max"] = res["max"]
            record["secondary"][f"{label}_runs"] = res["runs"]
    return record


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    print(json.dumps(run(args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
