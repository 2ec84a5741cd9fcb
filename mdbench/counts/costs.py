"""Float32 operations of each piece of work a campaign step needs.

Copied from the port's kernel census (``chip_smoke.py``, read off
``csrc/pair_loop.cuh``, ``csrc/campaign_advance.cu``, ``csrc/gb_terms.cuh``
and ``csrc/sasa_terms.cuh``) and frozen here: a division, a square root, an
exponential or a logarithm counts as one operation. They price the work, the
counts in ``work.py`` say how much of it a configuration needs.
"""

PAIR_TEST = 9          # dx, dy, dz, d2 and the cutoff compare
PAIR_TERM = 52         # the pair term's force coefficient (LJ with switch, Coulomb, bond)
PAIR_ACCUM = 6         # f -= coeff * (dx, dy, dz) on one end; two ends a pair
PAIR_ENERGY = 12       # what the pair term adds for its energy
ANGLE = 80
TORSION_BASE = 150
TORSION_TERM = 12
CONSTRAINT_SWEEP = 40  # one constraint in one SHAKE or RATTLE sweep, scatter included
ATOM_STEP = 60         # kicks, drifts, O-step, Box-Muller, bias, per atom and step
GB_GEOMETRY = 10       # dx, dy, dz, d2, 1/sqrt, d: once a pair
GB_HCT = 30            # the HCT integral, one direction (two a pair)
GB_HCT_DERIV = 22      # its derivative, one direction
GB_STILL = 40          # the Still term with salt
GB_ACCUM = 10          # force on one end and its dE/dR share; two ends a pair
GB_ENERGY = 3
GB_ATOM = 40           # OBC tanh rescaling, self term, chain cotangent
SASA_GEOMETRY = 12     # per unordered pair of the LCPO set: distance and window test
SASA_AREA = 8          # a_pq, per overlapping ordered pair
SASA_PAIR = 30         # per overlapping ordered pair: area sum, W, da/dd, force
SASA_B = 1             # per (p, q overlapping, k in N(p))
SASA_G = 3             # per (p, q overlapping, i in N(p) and N(q))
SASA_ATOM = 10
KINETIC_ATOM = 6       # 0.5 m v^2 of one atom
