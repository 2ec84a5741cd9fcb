"""molecular_dynamics_tpu_torch — the PyTorch/CUDA port of ``mdx``.

Same module and function names as ``molecular_dynamics_tpu`` (the JAX
reference, which this package never imports), PyTorch idiom inside:
dataclasses of tensors, plain functions on ``(..., N, 3)`` tensors, an
explicit ``device``/``dtype``, and hand-written CUDA kernels (``csrc/``,
bound in ``ops/``) where the reference used Pallas.

Ported so far: the replica SMD campaign path, the composed, differentiable
force path, and the command line with the host I/O it needs:

- ``units``, ``topology`` (``Topology``), ``build`` (angles and dihedrals
  from bonds), ``io`` (PSF, PDB, XYZ, DCD), ``ff`` (``FFParams``,
  ``YamlForceField``, ``build_ff_params``, ``finalize_ff_params``,
  ``tile_ff_params``), ``solvent``, ``examples`` (the generated 40-atom
  deca-alanine backbone, the packaged 104-atom deca-alanine and 22-atom
  di-alanine, ``tiled_decaalanine``)
- ``energy`` (bonded terms, 1-4, switched LJ, reaction-field Coulomb,
  Urey-Bradley, GB, SASA; forces through ``torch.autograd``)
- ``system``, ``bias``, ``integrate`` (with the FIRE, L-BFGS and
  steepest-descent minimisers), ``constraints``, ``sim``
- ``ops``: ``make_nonbonded_op`` and ``make_pair_ring_op`` (differentiable
  pair ops), ``bonded.make_angle_torsion_op``, ``pair_forces``,
  ``gb.gb_forces``, ``sasa.sasa_forces`` and ``make_fused_campaign_op``
  (CUDA kernels with plain PyTorch versions beside them)
- ``config``, ``log`` and ``cli`` (``python -m
  molecular_dynamics_tpu_torch.cli simulate | energy | convert | bench``)
- ``convert`` — numpy arrays into the port's objects

Not ported yet (ROADMAP.md §A): prmtop/chamber, CHARMM ``.prm`` with CMAP,
xtc, mol2, sdf, xsc, the native codec, the CMAP and repulsion terms, the
model zoo and its training, and sharding over several devices.

Entry points run on the CUDA device unless the caller passes
``device="cpu"`` (``--device cpu`` on the command line).
"""

import torch

# Reduced-precision products silently cost kcal/mol in an energy; keep every
# float32 product in full float32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from molecular_dynamics_tpu_torch import units
from molecular_dynamics_tpu_torch.topology import Topology
from molecular_dynamics_tpu_torch.ff import FFParams, build_ff_params
from molecular_dynamics_tpu_torch.energy import (
    EnergyConfig,
    GBIS_CONFIG,
    REFERENCE_CONFIG,
    energy_terms,
    total_energy,
    force_fn,
    energy_and_forces,
)
from molecular_dynamics_tpu_torch import solvent
from molecular_dynamics_tpu_torch.system import MDState, system_init
from molecular_dynamics_tpu_torch.integrate import (
    velocity_verlet_step,
    langevin_step,
    maxwell_boltzmann,
    kinetic_energy,
    temperature,
    minimize_fire,
    minimize_lbfgs,
)
from molecular_dynamics_tpu_torch.bias import HarmonicSMDBias

__version__ = "0.1.0"

__all__ = [
    "units",
    "Topology",
    "FFParams",
    "build_ff_params",
    "EnergyConfig",
    "GBIS_CONFIG",
    "REFERENCE_CONFIG",
    "solvent",
    "energy_terms",
    "total_energy",
    "force_fn",
    "energy_and_forces",
    "MDState",
    "system_init",
    "velocity_verlet_step",
    "langevin_step",
    "maxwell_boltzmann",
    "kinetic_energy",
    "temperature",
    "minimize_fire",
    "minimize_lbfgs",
    "HarmonicSMDBias",
]
