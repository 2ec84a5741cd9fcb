"""Assemble ``FFParams`` from a ``Topology`` + type-keyed force-field source.

The parameter-assembly semantics of torchmd's ``Parameters``, as the JAX
package's ``ff.builder`` reproduces them:

- bonded index tables are canonicalised and uniquified as torchmd does
  (bonds sorted per pair; angles oriented so idx0 < idx2; dihedrals so
  idx0 < idx3; impropers uniquified),
- per-atom charges and masses come from the topology or from the force
  field by atom *type* (``charges_from``),
- LJ A/B tables use torchmd's Lorentz-Berthelot combination
  ``sigma_ij = (sigma_i+sigma_j)/2``, ``eps_ij = sqrt(eps_i*eps_j)``,
  ``A = 4*eps*sigma^12``, ``B = 4*eps*sigma^6``, also where the YAML carries
  CHARMM-style values in swapped fields (``param_bb-*.yaml``),
- 1-4 pairs are the (0,3) atoms of each canonical dihedral, with A14/B14
  combined from the sigma14/epsilon14 entries and scnb/scee scalings.

All of it is numpy on the host; ``finalize_ff_params`` makes the tensors.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from molecular_dynamics_tpu_torch.ff.params import FFParams, finalize_ff_params
from molecular_dynamics_tpu_torch.solvent import attach_gb_params, infer_elements
from molecular_dynamics_tpu_torch.topology import Topology


def _lb_ab(sigma1, sigma2, eps1, eps2):
    """torchmd Lorentz-Berthelot A/B combination for a single pair."""
    sigma = 0.5 * (sigma1 + sigma2)
    eps = np.sqrt(eps1 * eps2)
    s6 = sigma**6
    return 4.0 * eps * s6 * s6, 4.0 * eps * s6


def build_ff_params(
    top: Topology,
    ff,
    terms: Sequence[str] = ("bonds", "angles", "dihedrals", "impropers", "1-4", "lj"),
    exclusions: Sequence[str] = ("bonds", "angles", "1-4"),
    charges_from: str = "auto",
    urey_bradley: bool = True,
    dtype=None,
    device=None,
) -> FFParams:
    """Build dense force-field parameters for one system.

    ``ff`` must expose the type-keyed getter protocol of ``YamlForceField``
    (get_charge/get_mass/get_LJ/get_bond/get_angle/get_dihedral/get_14/
    get_improper).

    ``charges_from``: "topology" takes the per-atom charge/mass columns from
    the topology (the NAMD convention); "ff" assigns them by atom *type* from
    the force field; "auto" (default) prefers the topology's charges
    whenever it carries a non-zero charge column, else the force field's.
    TorchMD's recorded energies of ``backbone-no-improp.psf`` +
    ``param_bb-3.0.yaml`` reproduce only with the PSF per-atom charges.

    ``urey_bradley=True`` (default) builds 1-3 UB springs when the force
    field exposes ``get_urey_bradley``; YAML force fields carry none.

    A parameter source that carries CMAP grids raises
    ``NotImplementedError``: the CMAP term is not ported yet, and dropping
    it silently would change the energy.

    ``dtype`` (default float32) and ``device`` (``None``: the CUDA device)
    place the tensors; the GB/SASA per-atom tables ride along
    (``solvent.attach_gb_params``).
    """
    if dtype is None:
        dtype = torch.float32
    if hasattr(ff, "get_cmap") and getattr(ff, "cmaps", None):
        raise NotImplementedError(
            "build_ff_params: this parameter source carries CMAP grids, and the "
            "CMAP term is not ported yet (ROADMAP A8: charmm_prm with CMAP)"
        )
    atom_types = np.asarray(top.atom_types, dtype=object)
    n = len(atom_types)
    uq_types, type_idx = np.unique(atom_types.astype(str), return_inverse=True)

    if charges_from not in ("auto", "topology", "ff"):
        raise ValueError(f"charges_from must be auto/topology/ff, got {charges_from!r}")
    top_charges = np.asarray(top.charges, np.float64)
    use_topology = charges_from == "topology" or (
        charges_from == "auto" and np.any(top_charges != 0.0)
    )
    if use_topology:
        charges = top_charges
        masses = np.asarray(top.masses, np.float64)
    else:
        charges = np.array([ff.get_charge(t) for t in uq_types])[type_idx]
        masses = np.array([ff.get_mass(t) for t in uq_types])[type_idx]

    # LJ per-type tables expanded to per-atom-pair matrices
    lj_a_pair = np.zeros((n, n))
    lj_b_pair = np.zeros((n, n))
    if "lj" in terms or "repulsion" in terms or "repulsioncg" in terms:
        sig = np.array([ff.get_LJ(t)[0] for t in uq_types])
        eps = np.array([ff.get_LJ(t)[1] for t in uq_types])
        a_tab, b_tab = _lb_ab(sig[:, None], sig[None, :], eps[:, None], eps[None, :])
        lj_a_pair = a_tab[type_idx[:, None], type_idx[None, :]]
        lj_b_pair = b_tab[type_idx[:, None], type_idx[None, :]]

    # bonded tables, canonicalised the torchmd way
    bonds = np.zeros((0, 2), np.int64)
    bond_params = np.zeros((0, 2))
    if "bonds" in terms and len(top.bonds):
        bonds = np.unique(np.sort(top.bonds, axis=1), axis=0)
        bond_params = np.array(
            [ff.get_bond(*(atom_types[b])) for b in bonds], dtype=np.float64
        )

    angles = np.zeros((0, 3), np.int64)
    angle_params = np.zeros((0, 2))
    if "angles" in terms and len(top.angles):
        canon = np.array([a if a[0] < a[2] else a[::-1] for a in top.angles], np.int64)
        angles = np.unique(canon, axis=0)
        angle_params = np.array(
            [ff.get_angle(*(atom_types[a])) for a in angles], dtype=np.float64
        )

    dihedrals = np.zeros((0, 4), np.int64)
    dihedral_terms = []
    if "dihedrals" in terms and len(top.dihedrals):
        canon = np.array([d if d[0] < d[3] else d[::-1] for d in top.dihedrals], np.int64)
        dihedrals = np.unique(canon, axis=0)
        dihedral_terms = [ff.get_dihedral(*(atom_types[d])) for d in dihedrals]

    idx14 = np.zeros((0, 2), np.int64)
    nb14 = np.zeros((0, 4))
    if "1-4" in terms and len(dihedrals):
        idx14 = dihedrals[:, [0, 3]]
        rows = []
        for d in dihedrals:
            scnb, scee, s1, e1, s4, e4 = ff.get_14(*(atom_types[d]))
            a14, b14 = _lb_ab(s1, s4, e1, e4)
            rows.append((a14, b14, scnb, scee))
        nb14 = np.array(rows, dtype=np.float64)

    impropers = np.zeros((0, 4), np.int64)
    improper_terms = []
    if "impropers" in terms and len(top.impropers):
        impropers = np.unique(top.impropers, axis=0)
        improper_terms = [[ff.get_improper(*(atom_types[i]))] for i in impropers]

    ub_bonds = None
    ub_params = None
    if urey_bradley and hasattr(ff, "get_urey_bradley") and len(angles):
        ub_rows, ub_pars = [], []
        for a in angles:
            ub = ff.get_urey_bradley(*(atom_types[a]))
            if ub is not None:
                ub_rows.append((a[0], a[2]))
                ub_pars.append(ub)
        if ub_rows:
            ub_bonds = np.array(ub_rows, np.int64)
            ub_params = np.array(ub_pars, np.float64)

    params = finalize_ff_params(
        masses=masses,
        charges=charges,
        bonds=bonds,
        bond_params=bond_params,
        angles=angles,
        angle_params=angle_params,
        dihedrals=dihedrals,
        dihedral_terms=dihedral_terms,
        impropers=impropers,
        improper_terms=improper_terms,
        idx14=idx14,
        nb14_params=nb14,
        lj_a_pair=lj_a_pair,
        lj_b_pair=lj_b_pair,
        exclusions=exclusions,
        ub_bonds=ub_bonds,
        ub_params=ub_params,
        dtype=dtype,
        device=device,
    )
    # GB/SASA tables ride along so implicit-solvent terms are available on
    # demand (inert until "gb"/"sasa" appear in EnergyConfig.terms)
    return attach_gb_params(params, elements=infer_elements(masses, top.atom_names))
