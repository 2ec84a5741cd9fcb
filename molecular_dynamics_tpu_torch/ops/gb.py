"""GB-OBC II polar solvation force of a replica batch, analytic.

``gb_forces(pos, tables, consts) -> (forces, energy, born)`` is the force of
``solvent.gb_energy`` without autograd, in four passes over all pairs (GB has
no cutoff and no exclusions, so every one of the N(N-1)/2 pairs counts):

1. Born radii: the HCT descreening integral ``I_ij`` of every ordered pair
   summed to ``psi_i``, then the OBC II tanh rescaling and ``dR_i/dpsi_i``;
2. the Still pair force at those radii, and per atom ``dE/dR_i``;
3. the Born self terms ``E_ii = -1/2 k_e q_i^2 u(R_i)`` added to ``dE/dR_i``;
4. the chain rule: ``dE/dR_i dR_i/dpsi_i dpsi_i/dd_ij`` with the exact
   piecewise-analytic ``dI_ij/dd`` of both directions of each pair.

Kernel note. On a CUDA tensor ``gb_forces`` launches ``csrc/gb_forces.cu``
(CUDA C++, sm_90a; the device functions live in ``csrc/gb_terms.cuh`` and the
campaign kernel calls the same ones). It replaces the GB half of the JAX
package's ``molecular_dynamics_tpu/ops/fused_step.py`` (``born_pass``,
``_hct_*``, ``_gb_uprime``, ``gb_chain_pass``, the Born self terms) and the
Still term of ``ops/ring.py``. What suited the TPU stays behind (the ring
shifts over lanes and their halved halfway row); what it saved stays: each
ordered pair's HCT integral is evaluated once with its derivative, and
``dI/dd / d`` waits in a shared-memory cache of N(N-1) floats (42.8 KB at 104
atoms) for the chain pass, which is then a multiply-add a direction. The
work is bound by arithmetic, much of it on the SFU: a replica moves 28 N
bytes and needs N(N-1) HCT integrals and derivatives (a logarithm and three
divisions each, beside the pair's square root), N(N-1)/2 Still terms with an
exponential or two and a square root. One CTA per replica, 256 threads: in
each pass 16 lanes share an atom's partners and meet in a fixed-order
butterfly. The Still term is evaluated from both ends of each pair: once per
unordered pair, with the partner's half handed over through shared memory,
it measured the same. No atomics: bit-reproducible.
``1/d`` is IEEE (``1.0f / sqrtf``), ``expf``/``logf``/``tanhf`` the accurate
ones: far pairs cancel to a small remainder in the HCT integral, and a 2-ulp
``rsqrtf`` shows there; the HCT integral's two other reciprocals are the
SFU's (``__fdividef``, within 2e-5 kcal/mol/A of the plain float32 forces).
The cache bounds the kernel to 236 atoms (``gb_forces_holds``); above, the
wrapper raises.

``gb_forces_reference`` is the plain PyTorch version (any device, any float
dtype): the same formulas as one dense ``(R, N, N)`` pass. It runs for a CPU
tensor and is what the kernel is held against on the card.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple

import numpy as np
import torch

from molecular_dynamics_tpu_torch import solvent, units
from molecular_dynamics_tpu_torch.ff.params import FFParams
from molecular_dynamics_tpu_torch.ops._build import SHARED_OPT_IN_BYTES, kernel_function
from molecular_dynamics_tpu_torch.ops.nonbonded import _np, check_kernel_input

Tensor = torch.Tensor

#: columns of ``GBTables.atom``
GB_ATOM_COLUMNS = ("rho", "rho_inv", "s", "radius_inv", "q_scaled")


def gb_shared_bytes(n_atoms: int) -> int:
    """Shared memory the GB passes need a replica beside the coordinates and
    forces (``gb_shared_floats`` in ``csrc/gb_terms.cuh``): three per-atom
    vectors (Born radius, its reciprocal, dR/dpsi then the chain cotangent)
    and the dI cache, N rows of an odd stride >= N - 1."""
    return 4 * (3 * n_atoms + n_atoms * ((n_atoms - 1) | 1))


def gb_forces_holds(device_type: str, dtype: torch.dtype, n_atoms: int) -> bool:
    """Whether :func:`gb_forces` answers an input of this device type, dtype
    and size: off CUDA its plain version answers any; on CUDA the kernel
    takes float32 only, and a replica's dI cache, coordinates and forces
    (``gb_shared_bytes(n) + 24 n``) must fit the shared memory a CTA may opt
    in to (236 atoms). The wrapper raises where this is false."""
    if device_type != "cuda":
        return True
    return (
        dtype == torch.float32
        and gb_shared_bytes(n_atoms) + 4 * 6 * n_atoms <= SHARED_OPT_IN_BYTES
    )


@dataclasses.dataclass(frozen=True)
class GBTables:
    """Per-atom GB constants of one system on one device: ``atom`` (N, 5)
    float32 with the columns ``GB_ATOM_COLUMNS``: ``rho = radius - offset``,
    its reciprocal, the descreening radius ``s = screen * rho``, ``1/radius``
    and ``sqrt(k_e) q`` (so a product of two is the Coulomb prefactor).
    ``atom64`` holds the same numbers in float64 for the plain version, which
    rounds them to the dtype of its positions: to ``atom`` for float32."""

    atom: Tensor
    atom64: Tensor

    @property
    def n_atoms(self) -> int:
        return int(self.atom.shape[0])


def build_gb_tables(ff: FFParams) -> GBTables:
    """Tables for :func:`gb_forces`, on the device of ``ff``."""
    if not ff.has_gb:
        raise ValueError(
            "gb=True needs GB tables on the FFParams (solvent.attach_gb_params)"
        )
    radii = _np(ff.gb_radii).astype(np.float64)
    rho = radii - solvent.GB_OFFSET
    atom = np.stack(
        [
            rho, 1.0 / rho, _np(ff.gb_screen).astype(np.float64) * rho, 1.0 / radii,
            np.sqrt(units.ELEC_FACTOR) * _np(ff.charges).astype(np.float64),
        ],
        axis=-1,
    )
    return GBTables(
        atom=torch.as_tensor(np.ascontiguousarray(atom, np.float32), device=ff.device),
        atom64=torch.as_tensor(np.ascontiguousarray(atom), device=ff.device),
    )


def gb_constants(
    solvent_dielectric: float = 80.0, ion_concentration: float = 0.0
) -> Tuple[float, float, float, float, float]:
    """``(1/eps_s, kappa, obc_alpha, obc_beta, obc_gamma)`` as the GB math
    takes them. The Debye ``kappa`` is that of 300 K, as ``gb_energy``'s
    default."""
    return (
        1.0 / solvent_dielectric,
        solvent.debye_kappa(ion_concentration, solvent_dielectric, 300.0),
        solvent.OBC_ALPHA, solvent.OBC_BETA, solvent.OBC_GAMMA,
    )


def hct_pair(d, dinv, rho_i, rho_inv_i, s_j, live) -> Tuple[Tensor, Tensor]:
    """HCT pairwise-descreening integral ``I(d)`` and its exact piecewise
    ``dI/dd``: atom i (offset radius ``rho_i``) descreened by atom j's scaled
    sphere ``s_j``. ``dinv`` must be a safe ``1/d`` (1 where the pair is
    dead); both results are zero outside ``live`` and where the sphere does
    not reach past ``rho_i``. The integral is that of ``solvent.born_radii``;
    the derivative is what autograd of it gives almost everywhere."""
    one = torch.ones_like(d)
    zero = torch.zeros_like(d)
    up = d + s_j
    dm = d - s_j
    ad = torch.abs(dm)
    use_rho = ad < rho_i
    lo = torch.where(use_rho, rho_i.expand_as(d), ad)
    contrib = live & (rho_i < up)
    up_s = torch.where(contrib, up, one)
    lo_s = torch.where(contrib, lo, one)
    ui = 1.0 / up_s
    li = 1.0 / lo_s
    s2d = s_j * s_j * dinv
    half_ln_dinv = 0.5 * torch.log(lo_s * ui) * dinv
    inside = contrib & (dm < -rho_i)  # i wholly inside j's sphere
    ui2 = ui * ui
    li2 = li * li
    dsum = ui2 - li2
    dd = d - s2d
    # this grouping is kept as it is: for far pairs the terms cancel to a
    # small remainder, and the float32 result depends on the order
    integral = li - ui + 0.25 * dd * dsum + half_ln_dinv
    integral = integral + torch.where(inside, 2.0 * (rho_inv_i - li), zero)
    integral = torch.where(contrib, integral, zero)
    # dlo/dd in {0, +1, -1}
    lop = torch.where(use_rho, zero, torch.where(dm > 0.0, one, -one))
    w = lop * li
    wli = w * li
    deriv = (
        ui2 - wli
        + 0.25 * (1.0 + s2d * dinv) * dsum
        + 0.5 * dd * (wli * li - ui2 * ui)
        + (0.5 * (w - ui) - half_ln_dinv) * dinv
    )
    deriv = deriv + torch.where(inside, 2.0 * wli, zero)
    deriv = torch.where(contrib, deriv, zero)
    return integral, deriv


def _still_u(f, finv, inv_eps_s: float, kappa: float):
    """``u(f) = (1 - exp(-kappa f)/eps_s) / f`` and ``du/df``."""
    if kappa > 0.0:
        es = inv_eps_s * torch.exp(-kappa * f)
        return (1.0 - es) * finv, (es * (1.0 + kappa * f) - 1.0) * finv * finv
    return (1.0 - inv_eps_s) * finv, (inv_eps_s - 1.0) * finv * finv


def gb_forces_reference(pos: Tensor, tables: GBTables, consts) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain PyTorch version of :func:`gb_forces`: ``pos (..., N, 3) ->
    (forces (..., N, 3), energy (...), born (..., N))`` in the dtype of
    ``pos``, the passes and formulas of the kernel as one dense pair matrix."""
    inv_eps_s, kappa, obc_a, obc_b, obc_g = consts
    rho, rho_inv, s, rad_inv, qe = tables.atom64.to(pos.dtype).unbind(-1)
    n = pos.shape[-2]

    delta = pos.unsqueeze(-2) - pos.unsqueeze(-3)  # r_i - r_j
    d2 = torch.sum(delta * delta, dim=-1)
    live = ~torch.eye(n, dtype=torch.bool, device=pos.device)
    one = torch.ones_like(d2)
    zero = torch.zeros_like(d2)
    d2s = torch.where(live, d2, one)
    dinv = 1.0 / torch.sqrt(d2s)  # not rsqrt: 2 ulp on a GPU
    d = d2s * dinv

    # 1. Born radii; row i of hct_i / hct_d is atom i descreened by each j
    hct_i, hct_d = hct_pair(d, dinv, rho[:, None], rho_inv[:, None], s[None, :], live)
    psi = 0.5 * rho * torch.sum(hct_i, dim=-1)
    th = torch.tanh(psi * (obc_a + psi * (-obc_b + obc_g * psi)))
    born_inv = rho_inv - th * rad_inv
    born = 1.0 / born_inv
    hp = obc_a + psi * (-2.0 * obc_b + 3.0 * obc_g * psi)
    dborn_dpsi = born * born * (1.0 - th * th) * hp * rad_inv

    # 2. Still pair term
    bi, bj = born.unsqueeze(-1), born.unsqueeze(-2)
    bi_inv = born_inv.unsqueeze(-1)
    qs = 0.25 * d2s
    ex = torch.exp(-qs * (bi_inv * born_inv.unsqueeze(-2)))
    f2 = d2s + bi * bj * ex
    finv = 1.0 / torch.sqrt(f2)
    u, du = _still_u(f2 * finv, finv, inv_eps_s, kappa)
    gqq = torch.where(live, qe[:, None] * qe[None, :], zero)
    nqu = -gqq * du
    coeff = nqu * (1.0 - 0.25 * ex) * finv
    der = torch.sum(nqu * (bj + qs * bi_inv) * (0.5 * ex * finv), dim=-1)

    # 3. Born self terms
    u_self, du_self = _still_u(born, born_inv, inv_eps_s, kappa)
    der = der - 0.5 * qe * qe * du_self

    # 4. descreening chain rule, both directions of each pair
    ce = der * dborn_dpsi * (0.5 * rho)
    coeff = coeff + (
        ce.unsqueeze(-1) * hct_d + ce.unsqueeze(-2) * hct_d.transpose(-1, -2)
    ) * dinv

    forces = -torch.sum(coeff.unsqueeze(-1) * delta, dim=-2)
    energy = -0.5 * torch.sum(gqq * u, dim=(-2, -1)) - 0.5 * torch.sum(
        qe * qe * u_self, dim=-1
    )
    return forces, energy, born


def gb_forces(pos: Tensor, tables: GBTables, consts) -> Tuple[Tensor, Tensor, Tensor]:
    """``pos (R, N, 3) -> (forces (R, N, 3), energy (R,), born (R, N))``,
    ``consts`` from :func:`gb_constants`.

    A CUDA tensor goes through the kernel (float32, contiguous, or it raises;
    the launch is counted in ``gb_forces.launches``); a CPU tensor takes
    :func:`gb_forces_reference`. Not differentiable.
    """
    if not pos.is_cuda:
        return gb_forces_reference(pos, tables, consts)
    if pos.ndim != 3 or pos.shape[-1] != 3:
        raise ValueError(f"pos must be (R, N, 3), got {tuple(pos.shape)}")
    n_rep, n = pos.shape[0], pos.shape[1]
    check_kernel_input("pos", pos, (n_rep, n, 3))
    check_kernel_input("tables.atom", tables.atom, (n, len(GB_ATOM_COLUMNS)))
    if tables.atom.device != pos.device:
        raise ValueError("tables and pos live on different devices")
    if not gb_forces_holds(pos.device.type, pos.dtype, n):
        raise ValueError(
            f"gb_forces: {n} atoms need {gb_shared_bytes(n) + 4 * 6 * n} bytes of "
            f"shared memory a replica (the dI cache is N(N-1) floats); the kernel "
            f"holds {SHARED_OPT_IN_BYTES}"
        )
    fn = kernel_function(
        "gb_forces", "mdx_gb_forces",
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_float] * 5 + [ctypes.c_void_p],
    )
    forces = torch.empty_like(pos)
    energy = torch.empty(n_rep, dtype=torch.float32, device=pos.device)
    born = torch.empty((n_rep, n), dtype=torch.float32, device=pos.device)
    with torch.cuda.device(pos.device):
        err = fn(
            pos.data_ptr(), forces.data_ptr(), energy.data_ptr(), born.data_ptr(),
            tables.atom.data_ptr(), n_rep, n, *consts,
            torch.cuda.current_stream().cuda_stream,
        )
    gb_forces.launches += 1
    if err != 0:
        raise RuntimeError(f"gb_forces kernel launch failed: CUDA error {err}")
    return forces, energy, born


#: launches of the CUDA kernel made by this process
gb_forces.launches = 0
