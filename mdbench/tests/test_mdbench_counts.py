"""The counts of mdbench/counts/ against hand counts on the 104-atom system."""

import json

import numpy as np
import pytest

from mdbench import spec
from mdbench.counts import costs as C
from mdbench.counts import work
from mdbench.reference.system import build_system, load_arrays

ARRAYS = load_arrays(spec.HERE / "data" / "full_da.npz")
SYSTEM = build_system(ARRAYS, "cpu")
GBIS = spec.load_json(spec.HERE / "configs" / "decaala104-gbis.json")
VACUUM = spec.load_json(spec.HERE / "configs" / "decaala104-vacuum.json")
TRAFFIC = spec.load_json(spec.HERE / "traffic" / "r1024-log.json")


def test_sizes_match_the_system_file():
    z = work.sizes(SYSTEM, GBIS)
    # 103 bonds, 65 Urey-Bradley and 250 1-4 pairs, no pair in two lists
    assert z["special_pairs"] == 103 + 65 + 250 == 418
    assert (z["atoms"], z["angles"], z["torsions"]) == (104, 183, 251 + 22)
    assert z["torsion_terms"] == int(ARRAYS["ff_dihedral_term_mask"].sum()
                                     + ARRAYS["ff_improper_term_mask"].sum())
    masses = ARRAYS["ff_masses"]
    bonds = ARRAYS["ff_bonds"]
    assert z["constraints"] == int(((masses[bonds] < 3.5).any(1)).sum()) == 53
    assert z["lcpo_atoms"] == int((masses > 3.5).sum()) == 51


def test_live_pairs_by_hand():
    coords = ARRAYS["coords"][None].astype(np.float64)
    # spread 1000-fold, no plain pair lies within any cutoff: the special pairs alone
    assert work.live_pairs(coords * 1000.0, SYSTEM, 16.0) == 418
    # within any distance every unexcluded pair counts once: C(104, 2) - 536 + 418
    assert work.live_pairs(coords, SYSTEM, 1e6) == 104 * 103 // 2 - 536 + 418
    d = np.linalg.norm(coords[0, :, None] - coords[0, None], axis=-1)
    nb = ARRAYS["ff_nb_mask"]
    assert work.live_pairs(coords, SYSTEM, 9.0) == int(((d <= 9.0) & (nb | nb.T))[
        np.triu_indices(104, 1)].sum()) + 418


def test_lcpo_overlaps_by_hand():
    coords = ARRAYS["coords"][None]
    pairs, tri_b, tri_g = work.lcpo_overlaps(coords, SYSTEM)
    r = SYSTEM.sasa_radii.numpy()
    act = np.flatnonzero(r > 0)
    p = coords[0, act]
    o = np.zeros((len(act), len(act)), bool)
    for i in range(len(act)):
        for j in range(len(act)):
            d = np.linalg.norm(p[i] - p[j])
            o[i, j] = i != j and abs(r[act[i]] - r[act[j]]) < d < r[act[i]] + r[act[j]]
    assert pairs == o.sum()
    assert tri_b == sum(o[i].sum() ** 2 for i in range(len(act)))
    assert tri_g == sum(o[i, q] and o[i, k] and o[q, k] for i in range(len(act))
                        for q in range(len(act)) for k in range(len(act)))


@pytest.mark.parametrize("cfg", [VACUUM, GBIS], ids=["vacuum", "gbis"])
def test_step_work_by_hand(cfg):
    frames = ARRAYS["coords"][None]
    w = work.work(SYSTEM, cfg, TRAFFIC, frames)
    live = work.live_pairs(frames, SYSTEM, cfg["energy"]["cutoff"])
    step = (live * (C.PAIR_TEST + C.PAIR_TERM + 2 * C.PAIR_ACCUM) + 183 * C.ANGLE
            + 273 * C.TORSION_BASE + w["torsion_terms"] * C.TORSION_TERM
            + 53 * C.CONSTRAINT_SWEEP * (2 * 6 + 3 * 3) + 104 * C.ATOM_STEP)
    if "gb" in cfg["energy"]["terms"]:
        step += 5356 * (C.GB_GEOMETRY + 2 * C.GB_HCT + 2 * C.GB_HCT_DERIV + C.GB_STILL
                        + 2 * C.GB_ACCUM) + 104 * C.GB_ATOM
        pairs, tri_b, tri_g = work.lcpo_overlaps(frames, SYSTEM)
        step += (1275 * C.SASA_GEOMETRY + pairs * (C.SASA_AREA + C.SASA_PAIR)
                 + tri_b * C.SASA_B + tri_g * C.SASA_G + 51 * C.SASA_ATOM)
    assert w["step_flops"] == pytest.approx(step, rel=1e-12)
    assert w["launch_bytes"] > 2 * 9 * 1024 * 104 * 4


def test_cadence_divides_the_slow_work():
    frames = ARRAYS["coords"][None]
    every = work.work(SYSTEM, GBIS, TRAFFIC, frames)
    held = work.work(SYSTEM, GBIS, dict(TRAFFIC, sasa_every=5), frames)
    pairs, tri_b, tri_g = work.lcpo_overlaps(frames, SYSTEM)
    lcpo = (1275 * C.SASA_GEOMETRY + pairs * (C.SASA_AREA + C.SASA_PAIR) + tri_b * C.SASA_B
            + tri_g * C.SASA_G + 51 * C.SASA_ATOM)
    assert every["step_flops"] - held["step_flops"] == pytest.approx(0.8 * lcpo)


def test_peaks():
    peaks = json.loads((spec.HERE / "counts" / "peaks.json").read_text())
    assert peaks["float32_flops_per_s"] == 67e12 and peaks["bytes_per_s"] == 3.35e12
    assert work.least_seconds(67e12, 0, peaks) == 1.0
    assert work.least_seconds(0, 3.35e12, peaks) == 1.0
