"""Unit system and physical constants (AKMA, kcal/mol based).

The whole framework works in the AKMA-like unit system the reference's energy
stack uses (TorchMD_Fix/forces.py:373-376 derives ELEC_FACTOR from scipy
constants; torchmd's integrator uses TIMEFACTOR/BOLTZMAN):

- length      : Angstrom
- energy      : kcal/mol
- mass        : g/mol (amu)
- charge      : elementary charge e
- temperature : Kelvin
- time        : fs at the API surface; internally t_AKMA = t_fs / TIMEFACTOR
                so that F/m integrates positions in Angstroms.

Constants are computed from CODATA 2018 values (same values scipy.constants
carries), hardcoded here so the compute path has zero runtime dependency on
scipy.
"""

import math

# CODATA 2018
_ELEMENTARY_CHARGE = 1.602176634e-19  # C
_EPSILON_0 = 8.8541878128e-12  # F/m
_AVOGADRO = 6.02214076e23  # 1/mol
_CALORIE = 4.184  # J
_ANGSTROM = 1e-10  # m
_BOLTZMANN_SI = 1.380649e-23  # J/K

#: Coulomb constant in kcal/mol * Angstrom / e^2.
#: Mirrors TorchMD_Fix/forces.py:373-376 (== 332.0637...).
ELEC_FACTOR = (
    1.0
    / (4.0 * math.pi * _EPSILON_0)
    * _ELEMENTARY_CHARGE**2
    / _ANGSTROM
    * _AVOGADRO
    / (1e3 * _CALORIE)
)

#: Boltzmann constant in kcal/mol/K (torchmd BOLTZMAN = 0.001987191).
BOLTZMANN = _BOLTZMANN_SI * _AVOGADRO / (1e3 * _CALORIE)

#: Conversion factor between femtoseconds and the internal (AKMA) time unit:
#: t_internal = t_fs / TIMEFACTOR. With masses in g/mol, energies in kcal/mol
#: and lengths in Angstrom, accelerations F/m then integrate correctly.
#: sqrt(g/mol * A^2 / (kcal/mol)) expressed in fs.
TIMEFACTOR = math.sqrt(1e-3 / (1e3 * _CALORIE)) / 1e-15 * _ANGSTROM  # = 48.8882...

#: Default solvent dielectric for the reaction-field approximation
#: (TorchMD_Fix/forces.py:35).
SOLVENT_DIELECTRIC = 78.5

#: AMBER prmtop stores charges pre-multiplied by 18.2223 (= sqrt of the
#: Coulomb constant AMBER uses); divide by this on read.
AMBER_CHARGE_FACTOR = 18.2223
