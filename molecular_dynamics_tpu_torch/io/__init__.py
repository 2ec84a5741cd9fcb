"""Molecular file I/O: topology readers and trajectory codecs.

Everything here reads and writes plain numpy arrays (a ``Topology`` for
topologies), which ``ff.builder.build_ff_params`` and ``sim`` take from
there. Not ported yet (ROADMAP A8): prmtop with chamber, CHARMM ``.prm``
with CMAP, xtc, mol2, sdf, xsc and the native codec.
"""

from molecular_dynamics_tpu_torch.io.psf import read_psf
from molecular_dynamics_tpu_torch.io.pdb import read_pdb, write_pdb
from molecular_dynamics_tpu_torch.io.xyz import write_xyz, read_xyz
from molecular_dynamics_tpu_torch.io.dcd import read_dcd, write_dcd

__all__ = [
    "read_psf",
    "read_pdb",
    "write_pdb",
    "write_xyz",
    "read_xyz",
    "read_dcd",
    "write_dcd",
]
