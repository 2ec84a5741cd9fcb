"""The work a campaign needs, counted from the system's own sizes and from
the frames a run returned, never from the program's layout or settings.

Per replica-step: every live pair once (an unexcluded pair within the
cutoff, or a bond, Urey-Bradley or 1-4 pair at any distance), every angle
and torsion term, the stated SHAKE and RATTLE sweeps over the rigid X-H
bonds, the per-atom update; under GB every pair's GB term at its cadence,
under LCPO the overlaps of the LCPO set at its cadence. Per logged save and
replica: one evaluation of the potential and the kinetic energy. Bytes: the
state read and written once a launch and every parameter read once.
"""

from __future__ import annotations

import numpy as np

from mdbench.counts import costs as C


def special_pairs(s) -> np.ndarray:
    """The unordered bond, Urey-Bradley and 1-4 pairs, each once."""
    pairs = np.concatenate([s.bonds.cpu().numpy(), s.ub_bonds.cpu().numpy(),
                            s.idx14.cpu().numpy()])
    pairs = np.sort(pairs, axis=1)
    return np.unique(pairs, axis=0)


def live_pairs(frames: np.ndarray, s, cutoff: float) -> float:
    """Unordered pairs that carry a term, averaged over ``frames`` (F, N, 3)."""
    n = s.n_atoms
    special = np.zeros((n, n), bool)
    sp = special_pairs(s)
    special[sp[:, 0], sp[:, 1]] = special[sp[:, 1], sp[:, 0]] = True
    nb = s.nb_mask.cpu().numpy()
    mask = (nb | nb.T) & ~special
    upper = np.triu(np.ones((n, n), bool), 1)
    total = 0
    for block in np.array_split(frames.astype(np.float64), max(1, len(frames) // 64)):
        d2 = np.sum((block[:, :, None] - block[:, None]) ** 2, -1)
        total += int(np.sum((d2 <= cutoff * cutoff) & mask & upper))
    return total / len(frames) + len(sp)


def lcpo_overlaps(frames: np.ndarray, s) -> tuple:
    """Per frame, averaged: the overlapping ordered pairs of the LCPO set,
    the sum over p of |N(p)|^2, and the triples (p, q, i) with q and i both
    neighbours of p and of each other."""
    r = s.sasa_radii.cpu().numpy()
    act = np.flatnonzero(r > 0)
    r = r[act]
    pairs = tri_b = tri_g = 0.0
    for block in np.array_split(frames[:, act].astype(np.float64), max(1, len(frames) // 64)):
        d = np.sqrt(np.sum((block[:, :, None] - block[:, None]) ** 2, -1))
        o = (d < r[:, None] + r[None, :]) & (d > np.abs(r[:, None] - r[None, :]))
        o &= ~np.eye(len(act), dtype=bool)
        of = o.astype(np.float64)
        nbr = of.sum(-1)
        pairs += nbr.sum()
        tri_b += (nbr * nbr).sum()
        tri_g += (np.matmul(of, of) * of).sum()
    f = len(frames)
    return pairs / f, tri_b / f, tri_g / f


def sizes(s, cfg: dict) -> dict:
    terms = (s.dihedral_term_mask.sum() + s.improper_term_mask.sum()).item()
    return {
        "atoms": s.n_atoms,
        "angles": int(s.angles.shape[0]),
        "torsions": int(s.dihedrals.shape[0] + s.impropers.shape[0]),
        "torsion_terms": int(terms),
        "constraints": s.n_constraints if cfg["integrator"]["constrain_h_bonds"] else 0,
        "special_pairs": len(special_pairs(s)),
        "lcpo_atoms": int((s.sasa_radii > 0).sum()),
    }


def work(s, cfg: dict, traffic: dict, frames: np.ndarray) -> dict:
    """Float32 operations per replica-step (``step_flops``) and per replica
    and logged save (``energy_flops``), and the bytes of one launch of
    ``save_every`` steps over all replicas (``launch_bytes``)."""
    z = sizes(s, cfg)
    e, integ = cfg["energy"], cfg["integrator"]
    n = z["atoms"]
    live = live_pairs(frames, s, e["cutoff"])
    bonded = z["angles"] * C.ANGLE + z["torsions"] * C.TORSION_BASE + (
        z["torsion_terms"] * C.TORSION_TERM)
    sweeps = 2 * integ["shake_sweeps"] + 3 * integ["rattle_sweeps"]
    step = (live * (C.PAIR_TEST + C.PAIR_TERM + 2 * C.PAIR_ACCUM) + bonded
            + z["constraints"] * C.CONSTRAINT_SWEEP * sweeps + n * C.ATOM_STEP)
    energy = live * (C.PAIR_TEST + C.PAIR_TERM + C.PAIR_ENERGY) + bonded + n * C.KINETIC_ATOM
    all_pairs = n * (n - 1) // 2
    if "gb" in e["terms"]:
        gb_force = all_pairs * (C.GB_GEOMETRY + 2 * C.GB_HCT + 2 * C.GB_HCT_DERIV + C.GB_STILL
                                + 2 * C.GB_ACCUM) + n * C.GB_ATOM
        step += gb_force / traffic["gb_every"]
        energy += all_pairs * (C.GB_GEOMETRY + 2 * C.GB_HCT + C.GB_STILL + C.GB_ENERGY) + (
            n * C.GB_ATOM)
    if "sasa" in e["terms"]:
        nc = z["lcpo_atoms"]
        pairs, tri_b, tri_g = lcpo_overlaps(frames, s)
        shared = (nc * (nc - 1) // 2 * C.SASA_GEOMETRY + tri_b * C.SASA_B + tri_g * C.SASA_G
                  + nc * C.SASA_ATOM)
        step += (shared + pairs * (C.SASA_AREA + C.SASA_PAIR)) / traffic["sasa_every"]
        energy += shared + pairs * C.SASA_AREA
    params = (n * 12 * 4 + z["special_pairs"] * 20 + (n * n + 7) // 8 + z["angles"] * 20
              + z["torsions"] * 16 + z["torsion_terms"] * 12 + z["constraints"] * 12
              + z["lcpo_atoms"] * 4)
    state = 2 * 9 * traffic["replicas"] * n * 4
    return {"step_flops": step, "energy_flops": energy, "launch_bytes": state + params,
            "live_pairs": live, **z}


def least_seconds(flops: float, nbytes: float, peaks: dict) -> float:
    """The least time the card needs: the larger of the operations over the
    float32 peak and the bytes over the memory bandwidth."""
    return max(flops / peaks["float32_flops_per_s"], nbytes / peaks["bytes_per_s"])
