"""The comparison that decides ``correct``: what the timed path produced,
against the plain reference in float64, on rows drawn from the seed.

Each checked chunk keeps, for its drawn replicas, the state that went in
(positions, velocities, the carried force, the step), the state that came
out, the frames at a few saves (always the first two) and the log entries
there. Each number is read per row (a kept replica of a chunk, or a logged
save of one) and taken over the rows twice: as the widest gap (a gross
fault in any row) and as the median row's gap (``_med``: a fault in most
rows, however small). The widest gap also reads the rare rows in which a
pair sat on the edge of a cutoff, where the stated potential is
discontinuous and float32 and float64 may put it on different sides; the
median does not. Each is compared with its cell's limit:

- ``pos_gap_A``, ``pos_gap_med_A``: the reference follows each kept replica
  from the chunk's input state through the first segment (``save_every``
  steps, the same noise stream); an atom's distance from the program's
  first frame, in A. It covers the force terms, the bias, SHAKE/RATTLE, the
  BAOAB update and the cadences of one launch of the campaign op.
- ``pos_gap2_med_A``: the reference goes on through the second segment,
  with that segment's own noise stream and SMD centre, to the second frame:
  a second launch within the call. The median only, since the two
  trajectories part faster from there.
- ``force_gap``, ``force_gap_med``: the difference of an atom's force
  between what a state carries and the reference's force there, over the
  median atom's force. Taken at the first chunk's input (the forces set-up
  made) and, where no cadence holds a force from an earlier step, at every
  kept state.
- ``log_gap``, ``log_gap_med``: the difference between a logged value and
  the reference's at the same save, over that key's median magnitude (the
  energies over that of ``epot``); ``ekin``, ``etot`` and ``T`` at the
  chunk's last save, whose velocities the output state holds. A logged
  step that is not the save's own makes both infinite.

``control.py`` puts the reference itself in the program's place: computed in
the configuration's ``control_precision`` (the control), or in float64 with
one layer of the physics planted wrong (``FAULTS``).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from mdbench.reference import dynamics as D
from mdbench.reference import energy as E
from mdbench.reference.observables import observables
from mdbench.reference.system import build_system

NUMBERS = ("pos_gap_A", "pos_gap_med_A", "pos_gap2_med_A", "force_gap", "force_gap_med",
           "log_gap", "log_gap_med")
#: replicas drawn in each checked chunk, logged saves kept beside the first
#: two and the last, and chunks checked at most
ROWS_PER_CHUNK = 16
MIDDLE_SAVES = 2
MAX_CHUNKS = 24
_ENERGY_KEYS = ("epot", "ekin", "etot", "colvar_energy")
DTYPES = {"float64": torch.float64, "float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def _no_sasa(cfg, s, bias):
    e = dict(cfg["energy"], terms=[t for t in cfg["energy"]["terms"] if t != "sasa"])
    return dict(cfg, energy=e), s, bias


def _no_salt(cfg, s, bias):
    return dict(cfg, energy=dict(cfg["energy"], ion_concentration=0.0)), s, bias


def _no_impropers(cfg, s, bias):
    par = s.improper_params.clone()
    par[..., 0] = 0.0
    return cfg, dataclasses.replace(s, tensors=dict(s.tensors, improper_params=par)), bias


def _no_bias(cfg, s, bias):
    bias.fk = 0.0
    return cfg, s, bias


#: the faults planted in the reference put in the program's place, each in
#: one layer the cells name, and whether a configuration has that layer:
#: (applies(cfg), plant(cfg, system, bias) -> the same, wrong). ``noise_reused``
#: plants nothing here: the second segment takes the first's step and seed.
FAULTS = {
    "lcpo_dropped": (lambda c: "sasa" in c["energy"]["terms"], _no_sasa),
    "salt_dropped": (lambda c: "gb" in c["energy"]["terms"]
                     and c["energy"].get("ion_concentration", 0.0) > 0.0, _no_salt),
    "impropers_dropped": (lambda c: "impropers" in c["energy"]["terms"], _no_impropers),
    "bias_dropped": (lambda c: c["bias"]["fk"] > 0.0, _no_bias),
    "noise_reused": (lambda c: c["integrator"]["temperature"] > 0.0, None),
}


def faults_for(cfg: dict) -> list:
    return [name for name, (applies, _) in FAULTS.items() if applies(cfg)]


def plan_chunk(rng: np.random.Generator, traffic: dict, rows: int = ROWS_PER_CHUNK) -> dict:
    """The replicas and saves one chunk keeps, drawn before it runs."""
    n_saves = traffic["chunk_steps"] // traffic["save_every"]
    obs = traffic["obs_every"]
    logged = [s for s in range(n_saves) if (s + 1) % obs == 0]
    middle = [s for s in logged if 0 < s < n_saves - 1]
    pick = sorted(rng.choice(middle, min(MIDDLE_SAVES, len(middle)), replace=False).tolist())
    saves = sorted({0, min(1, n_saves - 1), n_saves - 1, *pick})
    rows = np.sort(rng.choice(traffic["replicas"], min(rows, traffic["replicas"]),
                              replace=False))
    return {"rows": rows, "saves": saves, "logged": [s for s in saves if s in logged]}


def keep(plan: dict, t0: int, state_in: dict, state_out: dict, chunk, traffic: dict) -> dict:
    """What the check needs of one chunk."""
    rows, obs = plan["rows"], traffic["obs_every"]
    return {
        "t0": t0, "save_every": traffic["save_every"], "rows": rows,
        "in": state_in, "out": state_out,
        "saves": plan["saves"], "frames": chunk.frames[plan["saves"]][:, rows],
        "logged": plan["logged"],
        "log": {k: v[[(s + 1) // obs - 1 for s in plan["logged"]]][:, rows]
                for k, v in chunk.log.items()},
    }


def select(records: list, rng: np.random.Generator) -> list:
    """The first chunk (its input is set-up's state) and, of the rest, all or
    ``MAX_CHUNKS - 1`` drawn from the seed."""
    rest = records[1:]
    if len(rest) > MAX_CHUNKS - 1:
        idx = sorted(rng.choice(len(rest), MAX_CHUNKS - 1, replace=False).tolist())
        rest = [rest[i] for i in idx]
    return records[:1] + rest


def _force_states(records: list, traffic: dict, terms) -> list:
    """(chunk, "in"/"out") of each state whose carried force is the whole
    force at its positions: set-up's, and every one where no cadence holds
    part of the force from an earlier step."""
    cadence = (traffic["sasa_every"] > 1 and "sasa" in terms) or (
        traffic["gb_every"] > 1 and "gb" in terms)
    states = [(0, "in")]
    if not cadence:
        states = [(i, side) for i in range(len(records)) for side in ("in", "out")]
    return states


def _second(records: list) -> list:
    """The records whose second frame was kept (all, where a chunk saves
    twice or more)."""
    return [r for r in records if 1 in r["saves"]]


class Inputs:
    """The kept records as tensors of one dtype on one device."""

    def __init__(self, records, cfg, traffic, arrays, seed, device, dtype):
        self.s = build_system(arrays, device, dtype)
        t = lambda a: torch.as_tensor(np.asarray(a), device=device).to(dtype)  # noqa: E731
        cat = lambda side, k: t(np.concatenate([r[side][k] for r in records]))  # noqa: E731
        self.pos_in, self.vel_in, self.frc_in = (cat("in", k) for k in ("pos", "vel", "frc"))
        rows = np.concatenate([r["rows"] for r in records])
        self.replicas = torch.as_tensor(rows, device=device)
        t0 = np.concatenate([[r["t0"]] * len(r["rows"]) for r in records])
        self.t0 = torch.as_tensor(t0, device=device)
        self._key0 = int(D.replica_keys(seed, traffic["replicas"])[0])
        self.seeds = self.stream_seeds(t0)
        self.second = np.concatenate([[1 in r["saves"]] * len(r["rows"]) for r in records])
        b = cfg["bias"]
        p0 = records[0]["in"]["pos"][0].astype(np.float64)
        d0 = float(np.linalg.norm(p0[b["group2"]].mean(0) - p0[b["group1"]].mean(0)))
        self.bias = E.Bias(self.s.n_atoms, b["group1"], b["group2"], b["fk"], d0, b["pull"],
                           b["pull_steps"], device, dtype)

    def stream_seeds(self, starts) -> torch.Tensor:
        """Each row's segment stream seed, for segments that start at ``starts``."""
        return torch.as_tensor([D.mix_seed(self._key0, int(x)) for x in starts],
                               device=self.t0.device)


def _states(records, which):
    """(positions, carried force, step) of each state in ``which``."""
    return [(records[i][side]["pos"], records[i][side]["frc"], records[i][side]["step"])
            for i, side in which]


def outputs_program(records: list, traffic: dict, terms) -> dict:
    """The program's answers to what the check asks, as float64 numpy."""
    which = _force_states(records, traffic, terms)
    second = [r["frames"][r["saves"].index(1)] for r in _second(records)]
    return {
        "first_frame": np.concatenate([r["frames"][0] for r in records]).astype(np.float64),
        "second_frame": (np.concatenate(second).astype(np.float64) if second
                         else np.zeros((0, 0, 3))),
        "forces": np.concatenate([f for _, f, _ in _states(records, which)]).astype(
            np.float64),
        "log": {k: np.concatenate([r["log"][k] for r in records]).astype(np.float64)
                for k in records[0]["log"]},
    }


def _log_inputs(records):
    """Per logged save kept: positions (from its frame), the step, and the
    output state's velocities where the save is the chunk's last."""
    pos, vel, step, last = [], [], [], []
    for r in records:
        for s in r["logged"]:
            k = r["saves"].index(s)
            pos.append(r["frames"][k])
            is_last = s == r["saves"][-1]
            vel.append(r["out"]["vel"] if is_last else np.zeros_like(r["frames"][k]))
            last.append(np.full(len(r["rows"]), is_last))
            step.append(np.full(len(r["rows"]), r["t0"] + (s + 1) * r["save_every"]))
    return pos, vel, step, last


def outputs_reference(records, cfg, traffic, arrays, seed, device, dtype, fault=None) -> dict:
    """The same answers from the reference, computed in ``dtype`` from the
    program's states, in blocks of rows; with ``fault`` (a key of
    ``FAULTS``) planted."""
    x = Inputs(records, cfg, traffic, arrays, seed, device, dtype)
    s, bias = x.s, x.bias
    # the states compared are the configuration's, whatever a fault drops
    which = _force_states(records, traffic, cfg["energy"]["terms"])
    if fault is not None and FAULTS[fault][1] is not None:
        cfg, s, bias = FAULTS[fault][1](cfg, s, bias)
    e = cfg["energy"]
    every = traffic["save_every"]
    # the second segment's start step and stream seed, or (planted) the first's
    t1 = x.t0 if fault == "noise_reused" else x.t0 + every
    seeds1 = x.seeds if fault == "noise_reused" else x.stream_seeds(x.t0.cpu().numpy() + every)
    with torch.no_grad():
        first, second = [], []
        for lo in range(0, x.pos_in.shape[0], 128):
            sl = slice(lo, lo + 128)
            p, v, f = D.segment(x.pos_in[sl], x.vel_in[sl], x.frc_in[sl], x.t0[sl], x.seeds[sl],
                                x.replicas[sl], s, cfg, traffic, bias, every)
            first.append(p.double().cpu().numpy())
            keep2 = torch.as_tensor(x.second[sl], device=p.device)
            if bool(keep2.any()):
                p2, _, _ = D.segment(p[keep2], v[keep2], f[keep2], t1[sl][keep2],
                                     seeds1[sl][keep2], x.replicas[sl][keep2], s, cfg, traffic,
                                     bias, every)
                second.append(p2.double().cpu().numpy())
        forces = []
        for pos, _, step in _states(records, which):
            p = torch.as_tensor(pos, device=device).to(dtype)
            # a carried force is that of the step that ended at the state:
            # its SMD centre is the one of the step before (set-up's: step 0)
            st = torch.full((p.shape[0],), max(step - 1, 0), device=device)
            forces.append(E.forces(p, s, e, bias, st).double().cpu().numpy())
        pos, vel, step, _ = _log_inputs(records)
        logs = {}
        for p, v, st in zip(pos, vel, step):
            o = observables(torch.as_tensor(p, device=device).to(dtype),
                            torch.as_tensor(v, device=device).to(dtype),
                            torch.as_tensor(st, device=device), s, cfg, bias)
            for k, val in o.items():
                logs.setdefault(k, []).append(val.double().cpu().numpy())
    return {"first_frame": np.concatenate(first),
            "second_frame": np.concatenate(second) if second else np.zeros((0, 0, 3)),
            "forces": np.concatenate(forces),
            "log": {k: np.stack(v) for k, v in logs.items()}}


def _median(rows: np.ndarray) -> float:
    return float(np.median(rows)) if rows.size else 0.0


def gap_rows(cand: dict, ref: dict, records: list) -> dict:
    """Each row's gap: ``pos`` and ``pos2`` (replicas, A), ``force`` (kept
    states x replicas, over the median atom's force), ``log`` (logged saves x
    replicas, each key over its scale), or None where a logged step is not
    its save's own."""
    atom_gap = lambda a, b: np.linalg.norm(a - b, axis=-1).max(-1)  # noqa: E731
    out = {"pos": atom_gap(cand["first_frame"], ref["first_frame"]),
           "pos2": atom_gap(cand["second_frame"], ref["second_frame"])
           if ref["second_frame"].size else np.zeros(0)}
    f_scale = float(np.median(np.linalg.norm(ref["forces"], axis=-1)))
    out["force"] = atom_gap(cand["forces"], ref["forces"]) / f_scale
    _, _, step, last = _log_inputs(records)
    last = np.stack(last)
    cl = cand["log"]
    if not set(ref["log"]) <= set(cl) or not np.array_equal(cl["step"], np.stack(step)):
        out["log"] = None
        return out
    e_scale = float(np.median(np.abs(ref["log"]["epot"])))
    log = np.zeros(last.shape)
    for k, rv in ref["log"].items():
        if k == "step":
            continue
        where = last if k in ("ekin", "etot", "T") else np.ones_like(last)
        scale = e_scale if k in _ENERGY_KEYS else float(np.median(np.abs(rv[where])))
        log = np.maximum(log, np.where(where, np.abs(cl[k] - rv), 0.0) / scale)
    out["log"] = log
    return out


def gaps(cand: dict, ref: dict, records: list) -> dict:
    """The numbers of a candidate's answers against the reference's."""
    r = gap_rows(cand, ref, records)
    log = r["log"]
    return {
        "pos_gap_A": float(r["pos"].max()), "pos_gap_med_A": _median(r["pos"]),
        "pos_gap2_med_A": _median(r["pos2"]),
        "force_gap": float(r["force"].max()), "force_gap_med": _median(r["force"]),
        "log_gap": math.inf if log is None else float(log.max()),
        "log_gap_med": math.inf if log is None else _median(log),
    }


def judge(readings: dict, limits: dict) -> bool:
    return all(readings[k] <= limits[k] for k in NUMBERS)
