"""Molecular file I/O: topology readers and trajectory codecs.

Everything here reads and writes plain numpy arrays (a ``Topology`` for
topologies, dense ``FFParams`` for a prmtop), which
``ff.builder.build_ff_params`` and ``sim`` take from there: PSF, PDB, XYZ,
DCD, AMBER prmtop (plain and chamber), CHARMM ``.prm`` with CMAP, GROMACS
xtc, mol2, sdf and NAMD xsc. ``io.native`` binds the C++ codecs
(``native/mdx_native.cpp``: DCD, xtc, ``.mdxtc``, the asynchronous sink),
built with ``g++`` at first use.
"""

from molecular_dynamics_tpu_torch.io.psf import read_psf
from molecular_dynamics_tpu_torch.io.pdb import read_pdb, write_pdb
from molecular_dynamics_tpu_torch.io.xyz import write_xyz, read_xyz
from molecular_dynamics_tpu_torch.io.prmtop import read_prmtop, prmtop_to_ff_params
from molecular_dynamics_tpu_torch.io.dcd import read_dcd, write_dcd
from molecular_dynamics_tpu_torch.io.charmm_prm import CharmmPrm
from molecular_dynamics_tpu_torch.io.xsc import read_xsc
from molecular_dynamics_tpu_torch.io.xtc import read_xtc, write_xtc
from molecular_dynamics_tpu_torch.io.mol2 import read_mol2, write_mol2
from molecular_dynamics_tpu_torch.io.sdf import read_sdf

__all__ = [
    "read_psf",
    "read_pdb",
    "write_pdb",
    "write_xyz",
    "read_xyz",
    "read_prmtop",
    "prmtop_to_ff_params",
    "read_dcd",
    "write_dcd",
    "CharmmPrm",
    "read_xsc",
    "read_xtc",
    "write_xtc",
    "read_mol2",
    "write_mol2",
    "read_sdf",
]
