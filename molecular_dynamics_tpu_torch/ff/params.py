"""Dense force-field parameter container (``FFParams``)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from molecular_dynamics_tpu_torch import units

#: fields holding atom indices (int64 tensors: torch indexes with long)
INT_FIELDS = ("bonds", "angles", "dihedrals", "impropers", "idx14", "ub_bonds",
              "cmap_idx", "cmap_grid_id")
#: fields holding boolean masks
BOOL_FIELDS = ("dihedral_term_mask", "improper_term_mask", "nb_mask")


@dataclasses.dataclass(frozen=True)
class FFParams:
    """All force-field parameters for one system as dense tensors.

    Index tables are 0-based, parameters are in kcal/mol-based units, angles
    in radians. Shapes (N atoms, NB bonds, NA angles, ND dihedrals, NI
    impropers, T term padding, N14 1-4 pairs):

    - ``masses``/``charges``: (N,)
    - ``bonds`` (NB,2) + ``bond_params`` (NB,2) = [k0, d0]; E = k0 (d-d0)^2
    - ``angles`` (NA,3) + ``angle_params`` (NA,2) = [k0, theta0]
    - ``dihedrals`` (ND,4) + ``dihedral_params`` (ND,T,3) = [k0, phi0, per]
      with ``dihedral_term_mask`` (ND,T); per>0 -> AMBER periodic,
      per<=0 -> CHARMM harmonic
    - ``impropers`` (NI,4) + ``improper_params`` (NI,T,3) + mask
    - ``idx14`` (N14,2) + ``nb14_params`` (N14,4) = [A14, B14, scnb, scee]
    - ``lj_a_pair``/``lj_b_pair``/``qq_pair``: (N,N) pre-expanded pair tables;
      ``qq_pair`` already includes ELEC_FACTOR
    - ``nb_mask``: (N,N) bool, True for i<j pairs not excluded by
      bonds/angles/1-4
    - ``ub_bonds``/``ub_params``: CHARMM Urey-Bradley 1-3 springs
    - ``gb_radii``/``gb_screen``/``sasa_radii`` (N,), ``sasa_params`` (N,4):
      optional GB/SASA per-atom tables (``solvent.attach_gb_params``)
    - ``cmap_idx``/``cmap_grid_id``/``cmap_coeffs``: optional CMAP tables
    """

    masses: torch.Tensor
    charges: torch.Tensor

    bonds: torch.Tensor
    bond_params: torch.Tensor
    angles: torch.Tensor
    angle_params: torch.Tensor
    dihedrals: torch.Tensor
    dihedral_params: torch.Tensor
    dihedral_term_mask: torch.Tensor
    impropers: torch.Tensor
    improper_params: torch.Tensor
    improper_term_mask: torch.Tensor
    idx14: torch.Tensor
    nb14_params: torch.Tensor

    lj_a_pair: torch.Tensor
    lj_b_pair: torch.Tensor
    qq_pair: torch.Tensor
    nb_mask: torch.Tensor

    ub_bonds: torch.Tensor
    ub_params: torch.Tensor

    gb_radii: Optional[torch.Tensor] = None
    gb_screen: Optional[torch.Tensor] = None
    sasa_radii: Optional[torch.Tensor] = None
    sasa_params: Optional[torch.Tensor] = None

    cmap_idx: Optional[torch.Tensor] = None
    cmap_grid_id: Optional[torch.Tensor] = None
    cmap_coeffs: Optional[torch.Tensor] = None

    @property
    def n_atoms(self) -> int:
        return self.masses.shape[0]

    @property
    def has_gb(self) -> bool:
        return self.gb_radii is not None

    @property
    def has_cmap(self) -> bool:
        return self.cmap_idx is not None and self.cmap_idx.shape[0] > 0

    @property
    def device(self) -> torch.device:
        return self.masses.device

    def to(self, device=None, dtype=None) -> "FFParams":
        """Move every tensor to ``device``; cast the float ones to ``dtype``."""
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if v is None:
                continue
            if f.name in INT_FIELDS or f.name in BOOL_FIELDS:
                out[f.name] = v.to(device=device)
            else:
                out[f.name] = v.to(device=device, dtype=dtype)
        return FFParams(**out)


def _pad_terms(term_lists: Sequence[Sequence[Sequence[float]]], dtype):
    """Pad ragged per-torsion term lists to (n, max_terms, 3) + mask.

    Padding rows get per=1, k0=0 so they are inert under either torsion
    branch (an AMBER cos term with k0=0 contributes nothing even unmasked).
    """
    n = len(term_lists)
    if n == 0:
        return np.zeros((0, 1, 3), dtype), np.zeros((0, 1), bool)
    max_t = max(1, max(len(t) for t in term_lists))
    params = np.zeros((n, max_t, 3), dtype)
    params[:, :, 2] = 1.0  # per=1 on padding
    mask = np.zeros((n, max_t), bool)
    for i, terms in enumerate(term_lists):
        for j, (k0, phi0, per) in enumerate(terms):
            params[i, j] = (k0, phi0, per)
            mask[i, j] = True
    return params, mask


def _exclusion_mask(
    n_atoms: int,
    bonds: np.ndarray,
    angles: np.ndarray,
    idx14: np.ndarray,
    exclusions: Sequence[str] = ("bonds", "angles", "1-4"),
) -> np.ndarray:
    """Upper-triangular all-vs-all pair mask minus the excluded pairs: the
    bonded pairs, the angles' 1-3 pairs and the dihedrals' 1-4 pairs, each
    where ``exclusions`` names it (torchmd's exclusion set)."""
    mask = np.triu(np.ones((n_atoms, n_atoms), bool), k=1)
    pairs = []
    if "bonds" in exclusions and len(bonds):
        pairs.append(np.asarray(bonds)[:, :2])
    if "angles" in exclusions and len(angles):
        pairs.append(np.asarray(angles)[:, [0, 2]])
    if "1-4" in exclusions and len(idx14):
        pairs.append(np.asarray(idx14))
    for p in pairs:
        mask[p[:, 0], p[:, 1]] = False
        mask[p[:, 1], p[:, 0]] = False
    return np.triu(mask, k=1)


def finalize_ff_params(
    *,
    masses: np.ndarray,
    charges: np.ndarray,
    bonds: np.ndarray,
    bond_params: np.ndarray,
    angles: np.ndarray,
    angle_params: np.ndarray,
    dihedrals: np.ndarray,
    dihedral_terms: Sequence[Sequence[Sequence[float]]],
    impropers: np.ndarray,
    improper_terms: Sequence[Sequence[Sequence[float]]],
    idx14: np.ndarray,
    nb14_params: np.ndarray,
    lj_a_pair: np.ndarray,
    lj_b_pair: np.ndarray,
    exclusions: Sequence[str] = ("bonds", "angles", "1-4"),
    ub_bonds: Optional[np.ndarray] = None,
    ub_params: Optional[np.ndarray] = None,
    dtype=torch.float32,
    device=None,
) -> FFParams:
    """Assemble ``FFParams`` from host-side numpy tables.

    The tables are computed in numpy in the float type of ``dtype`` (as the
    JAX package computes them), then become tensors on ``device`` (``None``:
    the CUDA device): floats of ``dtype``, indices int64, masks bool.
    """
    # convert imports this module: its device rule is fetched at call time
    from molecular_dynamics_tpu_torch.convert import resolve_device

    device = resolve_device(device)
    np_dtype = np.dtype(str(dtype).replace("torch.", ""))
    n = len(masses)
    charges = np.asarray(charges, np_dtype)
    qq = units.ELEC_FACTOR * charges[:, None] * charges[None, :]

    dih_params, dih_mask = _pad_terms(dihedral_terms, np_dtype)
    imp_params, imp_mask = _pad_terms(improper_terms, np_dtype)

    bonds = np.asarray(bonds, np.int64).reshape(-1, 2)
    angles = np.asarray(angles, np.int64).reshape(-1, 3)
    dihedrals = np.asarray(dihedrals, np.int64).reshape(-1, 4)
    impropers = np.asarray(impropers, np.int64).reshape(-1, 4)
    idx14 = np.asarray(idx14, np.int64).reshape(-1, 2)

    nb_mask = _exclusion_mask(n, bonds, angles, idx14, exclusions)

    if ub_bonds is None:
        ub_bonds = np.zeros((0, 2), np.int64)
        ub_params = np.zeros((0, 2), np_dtype)

    def floats(a, *shape):
        a = np.asarray(a, np_dtype)
        return torch.as_tensor(a.reshape(*shape) if shape else a, device=device)

    def ints(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    def mask(a):
        return torch.as_tensor(np.asarray(a, bool), device=device)

    return FFParams(
        masses=floats(masses),
        charges=floats(charges),
        bonds=ints(bonds),
        bond_params=floats(bond_params, -1, 2),
        angles=ints(angles),
        angle_params=floats(angle_params, -1, 2),
        dihedrals=ints(dihedrals),
        dihedral_params=floats(dih_params),
        dihedral_term_mask=mask(dih_mask),
        impropers=ints(impropers),
        improper_params=floats(imp_params),
        improper_term_mask=mask(imp_mask),
        idx14=ints(idx14),
        nb14_params=floats(nb14_params, -1, 4),
        lj_a_pair=floats(lj_a_pair),
        lj_b_pair=floats(lj_b_pair),
        qq_pair=floats(qq),
        nb_mask=mask(nb_mask),
        ub_bonds=ints(ub_bonds),
        ub_params=floats(ub_params, -1, 2),
    )


def tile_ff_params(ff: FFParams, m: int) -> FFParams:
    """Tile a system ``m`` times into one composite ``FFParams``.

    Every bonded table is repeated with per-copy atom-index offsets; the
    nonbonded pair tables tile as ``(m*N, m*N)`` blocks (cross-copy entries
    are the true type-pair LJ/Coulomb values, which depend only on the two
    atoms), and the exclusion mask excludes nothing between copies. The
    GB/SASA per-atom tables tile alongside. With copies placed far apart
    the composite energy is ``m`` times the single copy's, an exact oracle
    at ``m``-fold atom count. CMAP is not ported: a force field that
    carries it raises.
    """
    if ff.has_cmap:
        raise NotImplementedError(
            "tile_ff_params: CMAP tables are not ported yet; they come with "
            "the CHARMM parameter reader (ROADMAP A8, CMAP)"
        )
    if m < 1:
        raise ValueError(f"m must be >= 1, got {m}")
    n = ff.n_atoms

    def tile_idx(tab):
        if tab.shape[0] == 0:
            return tab
        return torch.cat([tab + k * n for k in range(m)])

    def tile_rows(tab):
        return torch.cat([tab] * m) if tab.shape[0] else tab

    nb = torch.ones((m * n, m * n), dtype=torch.bool, device=ff.device).triu(1)
    for k in range(m):
        nb[k * n : (k + 1) * n, k * n : (k + 1) * n] = ff.nb_mask

    solvent = {
        name: tile_rows(getattr(ff, name))
        for name in ("gb_radii", "gb_screen", "sasa_radii", "sasa_params")
        if getattr(ff, name) is not None
    }
    return dataclasses.replace(
        ff,
        masses=tile_rows(ff.masses),
        charges=tile_rows(ff.charges),
        bonds=tile_idx(ff.bonds),
        bond_params=tile_rows(ff.bond_params),
        angles=tile_idx(ff.angles),
        angle_params=tile_rows(ff.angle_params),
        dihedrals=tile_idx(ff.dihedrals),
        dihedral_params=tile_rows(ff.dihedral_params),
        dihedral_term_mask=tile_rows(ff.dihedral_term_mask),
        impropers=tile_idx(ff.impropers),
        improper_params=tile_rows(ff.improper_params),
        improper_term_mask=tile_rows(ff.improper_term_mask),
        idx14=tile_idx(ff.idx14),
        nb14_params=tile_rows(ff.nb14_params),
        lj_a_pair=ff.lj_a_pair.tile((m, m)),
        lj_b_pair=ff.lj_b_pair.tile((m, m)),
        qq_pair=ff.qq_pair.tile((m, m)),
        nb_mask=nb,
        ub_bonds=tile_idx(ff.ub_bonds),
        ub_params=tile_rows(ff.ub_params),
        **solvent,
    )
