"""Dense force-field parameter container (``FFParams``)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

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
