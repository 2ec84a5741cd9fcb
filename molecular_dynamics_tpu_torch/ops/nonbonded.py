"""Host-side dense pair tables for all 2-body terms.

One ``(N, N)`` float32 table per parameter, symmetric, unpadded:
``qq, lj_a, lj_b, mask, k_bond, d0_bond, a14, b14, qq14``. The pair kernels
(``ops.ring``, ``ops.fused_step``) and their plain versions read these.

- ``mask`` is the symmetrised ``nb_mask`` (``FFParams`` stores i<j only).
- Harmonic bonds and Urey-Bradley 1-3 springs share the ``k``/``d0`` tables;
  a pair that carries both is refused, because one slot cannot hold two
  springs.
- 1-4 parameters are pre-scaled by ``scnb``/``scee``; duplicate 1-4 pairs
  accumulate, identical to summing per-pair energies.
"""

from __future__ import annotations

import numpy as np

from molecular_dynamics_tpu_torch import units
from molecular_dynamics_tpu_torch.ff.params import FFParams

#: order of the tables in the tuple ``_build_pair_tables`` returns
PAIR_TABLE_NAMES = ("qq", "lj_a", "lj_b", "mask", "kb", "d0", "a14", "b14", "qq14")


def _resolve_ub(ff: FFParams, include_ub) -> bool:
    """None -> auto: UB on exactly when the FF carries 1-3 springs (matches
    ``energy.resolve_urey_bradley`` so kernels and autograd path agree)."""
    if include_ub is None:
        return bool(ff.ub_bonds.shape[0])
    return bool(include_ub)


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _build_pair_tables(ff: FFParams, include_ub=None):
    """The nine ``(N, N)`` float32 numpy tables, in ``PAIR_TABLE_NAMES`` order."""
    include_ub = _resolve_ub(ff, include_ub)
    n = ff.n_atoms

    def symmetric(table):
        # the energy reads a pair's parameters at [i, j] with i < j (nb_mask
        # is upper-triangular); mirror that triangle so both ends of a pair
        # see the same float32 number (a loader's qq_pair can differ by an
        # ulp across the diagonal)
        upper = np.triu(_np(table).astype(np.float32), 1)
        return upper + upper.T

    qq = symmetric(ff.qq_pair)
    aa = symmetric(ff.lj_a_pair)
    bb = symmetric(ff.lj_b_pair)
    msym = _np(ff.nb_mask).astype(np.float32)
    msym = msym + msym.T

    kb = np.zeros((n, n), np.float32)
    d0 = np.zeros((n, n), np.float32)
    rows = [(_np(ff.bonds), _np(ff.bond_params))]
    if include_ub and ff.ub_bonds.shape[0]:
        rows.append((_np(ff.ub_bonds), _np(ff.ub_params)))
    for idx, par in rows:
        for (i, j), (k, r0) in zip(idx, par):
            for a, b in ((i, j), (j, i)):
                if kb[a, b] != 0.0:
                    raise ValueError("harmonic pair collision in pair tables")
                kb[a, b] = k
                d0[a, b] = r0

    a14 = np.zeros((n, n), np.float32)
    b14 = np.zeros((n, n), np.float32)
    qq14 = np.zeros((n, n), np.float32)
    charges = _np(ff.charges)
    for (i, j), (a, b, scnb, scee) in zip(_np(ff.idx14), _np(ff.nb14_params)):
        # duplicates accumulate — identical to summing per-pair energies
        a14[i, j] += a / scnb
        a14[j, i] += a / scnb
        b14[i, j] += b / scnb
        b14[j, i] += b / scnb
        q = units.ELEC_FACTOR * charges[i] * charges[j] / scee
        qq14[i, j] += q
        qq14[j, i] += q
    return (qq, aa, bb, msym, kb, d0, a14, b14, qq14)
