"""Pair-terms op: energy and forces of every 2-body term of a replica batch.

``pair_forces(pos, tables, ...)`` covers reaction-field Coulomb + cubic-
switched LJ 12-6 under the cutoff mask, harmonic bonds / Urey-Bradley
springs and the pre-scaled 1-4 LJ + Coulomb in one pass, with analytic
forces. Same physics and tables as ``energy.energy_terms`` evaluates through
autograd; parity between the two is pinned by tests.

Kernel note. On a CUDA tensor ``pair_forces`` launches
``csrc/pair_forces.cu`` (CUDA C++, sm_90a). It replaces the JAX package's
``molecular_dynamics_tpu/ops/ring.py`` ``ring_pair_forces`` (the ring-shift
loop, its halved halfway row and the lane padding stay behind: they suit the
TPU's lanes, not a GPU). On an H100 the work is bound by float32 arithmetic,
not memory: a replica moves 2*N*12+4 bytes and needs N*(N-1)/2 pairs of ~60
flops (the kernel evaluates each from both ends, twice that, to avoid a
scatter). The design therefore spends its effort on the pair loop:
one CTA per replica, coordinates in shared memory, thread i sums over all j
in a fixed order (no atomics), and the nine tables are packed so that a
plain nonbonded pair costs one 16-byte load (``pack_pair_tables``).

``pair_forces_reference`` is the plain PyTorch version: it is what runs for
a CPU tensor, and what the kernel is held against on the card.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from molecular_dynamics_tpu_torch import units
from molecular_dynamics_tpu_torch.ff.params import FFParams
from molecular_dynamics_tpu_torch.ops.nonbonded import _build_pair_tables

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class PairTables:
    """The 2-body tables of one system on one device.

    ``dense`` (9, N, N) float32 in ``nonbonded.PAIR_TABLE_NAMES`` order is
    what the plain version reads; ``pack_a`` (N, N, 4), ``pack_b`` (N, N, 4)
    and ``pack_c`` (N, N) are the same numbers in the kernel's layout.
    """

    dense: Tensor
    pack_a: Tensor
    pack_b: Tensor
    pack_c: Tensor


def pack_pair_tables(dense: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Kernel layout of the nine dense tables (see ``csrc/pair_terms.cuh``):
    A = (qq, lj_a, lj_b, mask + 2*special), B = (kb, d0, a14, b14), C = qq14,
    where ``special`` marks the pairs that carry a bond/UB spring or a 1-4
    term. Entry [j, i] belongs to the pair (i, j); the tables are symmetric."""
    qq, aa, bb, msym, kb, d0, a14, b14, qq14 = dense
    special = (kb > 0) | (a14 != 0) | (b14 != 0) | (qq14 != 0)
    pack_a = np.stack([qq, aa, bb, msym + 2.0 * special], axis=-1)
    pack_b = np.stack([kb, d0, a14, b14], axis=-1)
    return (
        np.ascontiguousarray(pack_a, np.float32),
        np.ascontiguousarray(pack_b, np.float32),
        np.ascontiguousarray(qq14, np.float32),
    )


def build_pair_tables(ff: FFParams, include_ub=None) -> PairTables:
    """Tables for :func:`pair_forces`, on the device of ``ff``.
    ``include_ub=None`` takes the Urey-Bradley springs when ``ff`` has any."""
    dense = np.stack(_build_pair_tables(ff, include_ub))
    pa, pb, pc = pack_pair_tables(dense)
    return PairTables(
        dense=torch.as_tensor(dense, device=ff.device),
        pack_a=torch.as_tensor(pa, device=ff.device),
        pack_b=torch.as_tensor(pb, device=ff.device),
        pack_c=torch.as_tensor(pc, device=ff.device),
    )


def pair_constants(
    cutoff: Optional[float],
    switch_dist: Optional[float],
    rfa: bool,
    solvent_dielectric: float,
) -> Tuple[float, float, float, float, float]:
    """``(cutoff2, krf, crf, switch_dist, inv_switch_span)`` as the pair
    math takes them; no cutoff means no reaction field and no switch."""
    if cutoff is None:
        return 1e30, 0.0, 0.0, 1e15, 0.0
    if rfa:
        denom = 2.0 * solvent_dielectric + 1.0
        krf = (solvent_dielectric - 1.0) / (denom * cutoff**3)
        crf = 3.0 * solvent_dielectric / (denom * cutoff)
    else:
        krf, crf = 0.0, 0.0
    if switch_dist is None:
        return float(cutoff) ** 2, krf, crf, 1e15, 0.0
    return (
        float(cutoff) ** 2, krf, crf,
        float(switch_dist), 1.0 / (cutoff - switch_dist),
    )


def dense_pair_math(pos: Tensor, dense: Tensor, consts) -> Tuple[Tensor, Tensor]:
    """Energy ``(R,)`` and forces ``(R, N, 3)`` of every 2-body term as one
    masked ``(R, N, N)`` pass, in the dtype of ``pos``. The formulas, guards
    and their order are those of the kernel's ``pair_term``."""
    cutoff2, krf, crf, switch_dist, inv_switch_span = consts
    qq, aa, bb, msym, kb, d0, a14, b14, qq14 = dense.to(pos.dtype)

    delta_r = pos.unsqueeze(-2) - pos.unsqueeze(-3)  # (R, N, N, 3): r_i - r_j
    d2 = torch.sum(delta_r * delta_r, dim=-1)

    # the union of the active pair sets decides where a distance must exist
    mb = kb > 0.0
    m = torch.where(d2 <= cutoff2, msym, torch.zeros_like(msym))
    live = (m > 0.0) | mb | (qq14 != 0.0) | (a14 != 0.0)
    safe = torch.where(live, d2, torch.ones_like(d2))
    rinv = 1.0 / torch.sqrt(safe)  # not rsqrt: 2 ulp on a GPU, see pair_terms.cuh
    rinv2 = rinv * rinv
    d = d2 * rinv  # == sqrt(d2) where live

    # cutoff nonbonded: reaction-field Coulomb + switched LJ
    pot_e = qq * (rinv + krf * d2 - crf)
    coeff_e = qq * (2.0 * krf - rinv2 * rinv)
    rinv6 = rinv2 * rinv2 * rinv2
    a12 = aa * rinv6 * rinv6
    b6 = bb * rinv6
    pot_l = a12 - b6
    dudr = (6.0 * b6 - 12.0 * a12) * rinv
    t = (d - switch_dist) * inv_switch_span
    sw = 1.0 + t * t * t * (-10.0 + t * (15.0 - t * 6.0))
    dsw = t * t * (-30.0 + t * (60.0 - t * 30.0)) * inv_switch_span
    on = d > switch_dist
    coeff_l = torch.where(on, (dudr * sw + pot_l * dsw) * rinv, dudr * rinv)
    pot_l = torch.where(on, pot_l * sw, pot_l)
    pot = m * (pot_e + pot_l)
    coeff = m * (coeff_e + coeff_l)

    # harmonic bond / Urey-Bradley pairs: E = k (d - d0)^2
    delta = d - d0
    zero = torch.zeros_like(pot)
    pot = pot + torch.where(mb, kb * delta * delta, zero)
    coeff = coeff + torch.where(mb, 2.0 * kb * delta * rinv, zero)

    # 1-4 scaled LJ + plain Coulomb
    a14_12 = a14 * rinv6 * rinv6
    b14_6 = b14 * rinv6
    pot = pot + a14_12 - b14_6 + qq14 * rinv
    coeff = coeff + (6.0 * b14_6 - 12.0 * a14_12) * rinv2 - qq14 * rinv2 * rinv

    # F_i = -sum_j coeff_ij (r_i - r_j); every pair sits in the matrix twice
    forces = -torch.sum(coeff.unsqueeze(-1) * delta_r, dim=-2)
    energy = 0.5 * torch.sum(pot, dim=(-2, -1))
    return energy, forces


def pair_forces_reference(
    pos: Tensor,
    tables: PairTables,
    cutoff: Optional[float] = 9.0,
    switch_dist: Optional[float] = 7.5,
    rfa: bool = True,
    solvent_dielectric: float = units.SOLVENT_DIELECTRIC,
) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch version of :func:`pair_forces` (any device, any float
    dtype): ``pos (R, N, 3) -> (energy (R,), forces (R, N, 3))``."""
    consts = pair_constants(cutoff, switch_dist, rfa, solvent_dielectric)
    return dense_pair_math(pos, tables.dense, consts)


def _library():
    from molecular_dynamics_tpu_torch.ops import _build

    lib = _build.load("pair_forces")
    fn = lib.mdx_pair_forces
    if not fn.argtypes:
        fn.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2
            + [ctypes.c_float] * 5 + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return fn


def check_kernel_input(name: str, t: Tensor, shape) -> None:
    """Raise unless ``t`` is what a kernel takes: CUDA, float32, contiguous,
    of the given shape."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def pair_forces(
    pos: Tensor,
    tables: PairTables,
    cutoff: Optional[float] = 9.0,
    switch_dist: Optional[float] = 7.5,
    rfa: bool = True,
    solvent_dielectric: float = units.SOLVENT_DIELECTRIC,
) -> Tuple[Tensor, Tensor]:
    """``pos (R, N, 3) -> (energy (R,), forces (R, N, 3))`` over every 2-body
    term in ``tables``.

    A CUDA tensor goes through the kernel (float32, contiguous, or it
    raises; the launch is counted in ``pair_forces.launches``); a CPU tensor
    takes :func:`pair_forces_reference`. Not differentiable.
    """
    if not pos.is_cuda:
        return pair_forces_reference(
            pos, tables, cutoff, switch_dist, rfa, solvent_dielectric
        )
    if pos.ndim != 3 or pos.shape[-1] != 3:
        raise ValueError(f"pos must be (R, N, 3), got {tuple(pos.shape)}")
    n_rep, n = pos.shape[0], pos.shape[1]
    check_kernel_input("pos", pos, (n_rep, n, 3))
    check_kernel_input("tables.pack_a", tables.pack_a, (n, n, 4))
    check_kernel_input("tables.pack_b", tables.pack_b, (n, n, 4))
    check_kernel_input("tables.pack_c", tables.pack_c, (n, n))
    if tables.pack_a.device != pos.device:
        raise ValueError("tables and pos live on different devices")
    consts = pair_constants(cutoff, switch_dist, rfa, solvent_dielectric)
    fn = _library()
    forces = torch.empty_like(pos)
    energy = torch.empty(n_rep, dtype=torch.float32, device=pos.device)
    with torch.cuda.device(pos.device):
        err = fn(
            pos.data_ptr(), forces.data_ptr(), energy.data_ptr(),
            tables.pack_a.data_ptr(), tables.pack_b.data_ptr(),
            tables.pack_c.data_ptr(), n_rep, n, *consts,
            torch.cuda.current_stream().cuda_stream,
        )
    pair_forces.launches += 1
    if err != 0:
        raise RuntimeError(f"pair_forces kernel launch failed: CUDA error {err}")
    return energy, forces


#: launches of the CUDA kernel made by this process
pair_forces.launches = 0
