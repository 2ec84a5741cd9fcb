"""PSF (protein structure file) reader, X-Plor/NAMD and CHARMM flavours.

Atoms (segment, resid, resname, name, type, charge, mass) plus the bonded
index tables (!NBOND/!NTHETA/!NPHI/!NIMPHI/!NCRTERM), converted to 0-based
numpy arrays in a :class:`~molecular_dynamics_tpu_torch.topology.Topology`.
"""

from __future__ import annotations

import re

import numpy as np

from molecular_dynamics_tpu_torch.topology import Topology

_SECTION_RE = re.compile(r"^\s*(\d+)\s+!(\w+)")


def read_psf(path: str) -> Topology:
    with open(path) as fh:
        lines = fh.readlines()
    if not lines or not lines[0].startswith("PSF"):
        raise ValueError(f"{path} is not a PSF file")

    atoms = []
    tables = {"NBOND": [], "NTHETA": [], "NPHI": [], "NIMPHI": [], "NCRTERM": []}
    widths = {"NBOND": 2, "NTHETA": 3, "NPHI": 4, "NIMPHI": 4, "NCRTERM": 8}

    i = 0
    while i < len(lines):
        m = _SECTION_RE.match(lines[i])
        if not m:
            i += 1
            continue
        count, section = int(m.group(1)), m.group(2).rstrip(":")
        i += 1
        if section == "NATOM":
            for _ in range(count):
                parts = lines[i].split()
                # idx segname resid resname name type charge mass [flags...]
                atoms.append(
                    (
                        parts[1],  # segment
                        parts[2],  # resid (may be alphanumeric in CHARMM ext)
                        parts[3],  # resname
                        parts[4],  # name
                        parts[5],  # type
                        float(parts[6]),
                        float(parts[7]),
                    )
                )
                i += 1
        elif section in tables:
            width = widths[section]
            needed = count * width
            vals = []
            while len(vals) < needed and i < len(lines):
                vals += [int(v) for v in lines[i].split()]
                i += 1
            tables[section] = np.array(vals[:needed], np.int64).reshape(-1, width) - 1
        # other sections (NTITLE, NDON, NACC, NNB, ...) are skipped

    if not atoms:
        raise ValueError(f"No NATOM section found in {path}")

    seg, resid, resname, name, atype, charge, mass = zip(*atoms)

    def _int_resid(r):
        try:
            return int(r)
        except ValueError:
            return int(re.sub(r"\D", "", r) or 0)

    return Topology(
        atom_types=np.array(atype, object),
        atom_names=np.array(name, object),
        res_names=np.array(resname, object),
        res_ids=np.array([_int_resid(r) for r in resid], np.int64),
        charges=np.array(charge),
        masses=np.array(mass),
        bonds=np.asarray(tables["NBOND"]).reshape(-1, 2),
        angles=np.asarray(tables["NTHETA"]).reshape(-1, 3),
        dihedrals=np.asarray(tables["NPHI"]).reshape(-1, 4),
        impropers=np.asarray(tables["NIMPHI"]).reshape(-1, 4),
        seg_ids=np.array(seg, object),
        cross_terms=np.asarray(tables["NCRTERM"]).reshape(-1, 8),
    )
