"""LCPO nonpolar solvation force of a replica batch, analytic.

``sasa_forces(pos, tables, surface_tension) -> (forces, energy)`` is the force
of ``solvent.sasa_energy`` without autograd. LCPO only involves atoms with a
nonzero SASA radius (hydrogens are united out), so everything runs on the
compact heavy-atom set (51 of deca-alanine's 104 atoms):

1. per ordered pair the overlap test ``|r_p - r_q| < d < r_p + r_q`` and the
   buried area ``a_pq`` of sphere p by sphere q (Weiser eq. 3);
2. ``B_pq = sum_k o_pk a_qk`` over p's overlapping neighbours k;
3. per atom ``A_p = P1 S_p + sum_q [P2 a_pq + (P3 o_pq + P4 a_pq) B_pq]`` and
   the gate ``g_p = gamma`` where ``A_p > 0`` else 0 (the relu in
   ``sum max(A, 0)``);
4. the cotangent ``W_pq = dE/da_pq = g_p P2_p + sum_i g_i (P3_i o_ip + P4_i
   a_ip) o_iq + g_p P4_p B_pq``, valid only with the gate applied;
5. forces ``F_p = -sum_q (c_pq + c_qp)(r_p - r_q)``, ``c = W da/dd / d``.

Kernel note. On a CUDA tensor ``sasa_forces`` launches
``csrc/sasa_forces.cu`` (CUDA C++, sm_90a; device functions in
``csrc/sasa_terms.cuh``, which the campaign kernel calls too). It replaces the
JAX package's ``molecular_dynamics_tpu/ops/fused_step.py`` ``_sasa_tables``
and ``sasa_pass``/``_sasa_chunk``. The TPU kernel is dense: 0/1 selection
matrices to gather the compact set, four (lc, lc) matrices and two (lc, lc) x
(lc, lc) products per replica on the MXU. LCPO overlaps are sparse next to
that (a heavy atom of the packaged helix overlaps about half of the others,
fewer in a bigger protein), so the kernel keeps what the math wants: each
atom's overlapping neighbours as a bit mask and as a list in ascending order
(at most ``sasa_capacity(nc)`` entries, with the buried areas a_pq and a_qp
beside each), built by a warp a row from ballots and prefix counts. The two
neighbour sums run one lane a listed pair and walk the AND of the two rows'
masks. Distances come from exact coordinate differences (a Gram matrix loses
26x in force error at |r| ~ 30 A), with IEEE ``1.0f / sqrtf``. One CTA per
replica, no atomics: every sum is a gather in a fixed order. The per-atom
scratch (coordinates, masks, counts) lies in shared memory, and so do the
lists (14 bytes an entry) where they fit beside it; else they lie in a
per-replica slice of a global workspace the wrapper allocates
(``sasa_lists_global``), which no pass reads before pass A writes it. A row
with more than ``SASA_MAX_NEIGHBOURS`` overlapping heavy atoms cannot be
listed; the kernel sets a flag in global memory and the wrapper raises
(``raise_on_overflow``). Below 65 heavy atoms no list can overflow and the
flag is not read.

``sasa_forces_reference`` is the plain PyTorch version (any device, any float
dtype), dense on the compact set. It runs for a CPU tensor and is what the
kernel is held against on the card.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from molecular_dynamics_tpu_torch import solvent
from molecular_dynamics_tpu_torch.ff.params import FFParams
from molecular_dynamics_tpu_torch.ops._build import SHARED_OPT_IN_BYTES, kernel_function
from molecular_dynamics_tpu_torch.ops.nonbonded import _np, check_kernel_input

Tensor = torch.Tensor

#: columns of ``SasaTables.atom``
SASA_ATOM_COLUMNS = ("radius", "a0", "p2", "p3", "p4")
#: the most neighbours a kernel's list holds (kSasaMaxNeighbours in
#: csrc/sasa_terms.cuh)
SASA_MAX_NEIGHBOURS = 64


@dataclasses.dataclass(frozen=True)
class SasaTables:
    """LCPO constants of the compact heavy-atom set on one device: ``idx``
    (nc,) int32, the atoms with a nonzero SASA radius in ascending order, and
    ``atom`` (nc, 5) float32 with the columns ``SASA_ATOM_COLUMNS``: the
    probe-inflated radius, ``a0 = P1 4 pi r^2``, and P2..P4. ``atom64`` holds
    the same numbers in float64 for the plain version, which rounds them to
    the dtype of its positions: to ``atom`` for float32."""

    idx: Tensor
    atom: Tensor
    atom64: Tensor
    n_atoms: int

    @property
    def n_compact(self) -> int:
        return int(self.idx.shape[0])


def build_sasa_tables(ff: FFParams) -> SasaTables:
    """Tables for :func:`sasa_forces`, on the device of ``ff``."""
    if not ff.has_gb:
        raise ValueError(
            "sasa=True needs LCPO tables on the FFParams (solvent.attach_gb_params)"
        )
    radii = _np(ff.sasa_radii).astype(np.float64)
    idx = np.flatnonzero(radii > 0.0)
    r = radii[idx]
    p = _np(ff.sasa_params).astype(np.float64)[idx]
    atom = np.stack(
        [r, p[:, 0] * 4.0 * np.pi * r * r, p[:, 1], p[:, 2], p[:, 3]], axis=-1
    )
    return SasaTables(
        idx=torch.as_tensor(idx.astype(np.int32), device=ff.device),
        atom=torch.as_tensor(np.ascontiguousarray(atom, np.float32), device=ff.device),
        atom64=torch.as_tensor(np.ascontiguousarray(atom), device=ff.device),
        n_atoms=ff.n_atoms,
    )


def sasa_overlaps(pos: Tensor, tables: SasaTables) -> Tensor:
    """Overlap matrix ``(..., nc, nc)`` (bool) of the compact set at ``pos``:
    what the kernel's neighbour bit masks hold."""
    x = pos[..., tables.idx.long(), :]
    r = tables.atom64[:, 0].to(pos.dtype)
    d = torch.linalg.norm(x.unsqueeze(-2) - x.unsqueeze(-3), dim=-1)
    off = ~torch.eye(len(r), dtype=torch.bool, device=pos.device)
    return off & (d < r[:, None] + r[None, :]) & (d > torch.abs(r[:, None] - r[None, :]))


def sasa_forces_reference(
    pos: Tensor, tables: SasaTables, surface_tension: float = solvent.SURFACE_TENSION
) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch version of :func:`sasa_forces`: ``pos (..., N, 3) ->
    (forces (..., N, 3), energy (...))`` in the dtype of ``pos``."""
    idx = tables.idx.long()
    r, a0, p2, p3, p4 = (c.unsqueeze(-1) for c in tables.atom64.to(pos.dtype).unbind(-1))
    rq = r.transpose(-1, -2)
    x = pos[..., idx, :]
    delta = x.unsqueeze(-2) - x.unsqueeze(-3)  # r_p - r_q, exact differences
    d2 = torch.sum(delta * delta, dim=-1)
    # the diagonal gets a huge distance, which the overlap window rejects
    d2s = torch.where(d2 > 0.0, d2, torch.full_like(d2, 1e12))
    dinv = 1.0 / torch.sqrt(d2s)  # not rsqrt: 2 ulp on a GPU
    d = d2s * dinv
    o_b = (d < r + rq) & (d > torch.abs(r - rq))
    o = o_b.to(pos.dtype)
    zero = torch.zeros_like(d)

    # buried area a = o (k1 - k2 d - k3 / d) and da/dd = k3 / d^2 - k2
    k1 = 2.0 * math.pi * r * r
    k2 = math.pi * r
    k3 = math.pi * r * (r * r - rq * rq)
    k3d = k3 * dinv
    a = o * (k1 - k2 * d - k3d)
    cfac = torch.where(o_b, k3d * dinv - k2, zero) * dinv

    b_mat = o @ a.transpose(-1, -2)  # B_pk = sum_q o_pq a_kq
    m34 = p3 * o + p4 * a
    area = a0.squeeze(-1) + torch.sum(p2 * a + m34 * b_mat, dim=-1)
    gate = (area > 0.0).to(pos.dtype) * surface_tension  # (..., nc)
    energy = surface_tension * torch.sum(torch.clamp_min(area, 0.0), dim=-1)

    g = gate.unsqueeze(-1)
    gp34 = g * m34
    # W_pq = dE/da_pq; the middle term is sum_i gp34_ip o_iq
    w = g * p2 + o * (gp34.transpose(-1, -2) @ o) + (g * p4) * b_mat
    c = w * cfac
    csym = c + c.transpose(-1, -2)
    f_compact = -torch.sum(csym.unsqueeze(-1) * delta, dim=-2)
    forces = torch.zeros_like(pos).index_copy(-2, idx, f_compact)
    return forces, energy


def sasa_capacity(n_compact: int) -> int:
    """Entries of each neighbour list in the kernels: every possible
    neighbour (``nc - 1``) up to ``SASA_MAX_NEIGHBOURS``."""
    return max(0, min(n_compact - 1, SASA_MAX_NEIGHBOURS))


def overflow_possible(n_compact: int) -> bool:
    """Whether a list can overflow, so that the wrapper must read the flag."""
    return sasa_capacity(n_compact) < n_compact - 1


def sasa_list_bytes(n_compact: int) -> int:
    """Bytes of a replica's neighbour lists (``sasa_list_words`` in
    ``csrc/sasa_terms.cuh``): per list entry a_pq, a_qp, B_pq (then c_pq) and
    a 16-bit neighbour index, ``sasa_capacity(nc)`` entries an atom."""
    entries = n_compact * sasa_capacity(n_compact)
    return 4 * (3 * entries + (entries + 1) // 2)


def sasa_shared_bytes(n_compact: int, lists_global: bool = False) -> int:
    """Shared memory the LCPO pass needs a replica (``sasa_shared_words`` in
    ``csrc/sasa_terms.cuh``): per atom the compact coordinates, three gate
    vectors, the count and the offset of its list; per atom and mask word
    (one 32-bit word per 32 atoms) the overlap bits and the list slots of
    the earlier words; the overflow flag; and the lists
    (``sasa_list_bytes``) unless they lie in global memory."""
    n = n_compact
    words = (n + 31) // 32
    per_atom = 4 * (6 * n + 2 * n * words + 2 * n + 2)
    return per_atom + (0 if lists_global else sasa_list_bytes(n))


def sasa_lists_global(n_atoms: int, n_compact: int) -> bool:
    """Whether the LCPO kernel keeps a replica's lists in global memory:
    where they do not fit the shared memory a CTA may opt in to beside the
    per-atom scratch and the replica's coordinates and forces (``24 n``
    bytes), from 225 heavy atoms of deca-alanine's mix."""
    return sasa_shared_bytes(n_compact) + 4 * 6 * n_atoms > SHARED_OPT_IN_BYTES


def sasa_forces_holds(device_type: str, dtype: torch.dtype, n_atoms: int, n_compact: int) -> bool:
    """Whether :func:`sasa_forces` answers an input of this device type,
    dtype and size (``n_atoms`` atoms, ``n_compact`` of them in the LCPO
    set): off CUDA its plain version answers any; on CUDA the kernel takes
    float32 only, and a replica's per-atom scratch, coordinates and forces
    (``sasa_shared_bytes(nc, lists_global=True) + 24 n``) must fit the
    shared memory a CTA may opt in to (about 800 heavy atoms of
    deca-alanine's mix; the lists go to global memory where they do not
    fit beside them). The wrapper raises where this is false."""
    if device_type != "cuda":
        return True
    return (
        dtype == torch.float32
        and sasa_shared_bytes(n_compact, lists_global=True) + 4 * 6 * n_atoms
        <= SHARED_OPT_IN_BYTES
    )


def list_workspace(n_replicas: int, n_compact: int, device) -> Tensor:
    """The global workspace of ``n_replicas`` replicas' neighbour lists,
    ``sasa_list_bytes(nc)`` bytes each (float32 words; uninitialised: the
    kernels write every entry before they read it)."""
    return torch.empty(n_replicas * sasa_list_bytes(n_compact) // 4,
                       dtype=torch.float32, device=device)


def raise_on_overflow(flag: Tensor, n_compact: int, where: str) -> None:
    """Read the kernel's overflow flag (one int; waits for the device) and
    raise if a neighbour list overflowed: the forces of that launch are
    wrong, not approximate."""
    if int(flag.reshape(-1)[0]) != 0:
        raise RuntimeError(
            f"{where}: an atom of the {n_compact}-atom LCPO set overlaps more "
            f"than {SASA_MAX_NEIGHBOURS} others, beyond what a neighbour list "
            "holds; the forces of this launch are wrong"
        )


def sasa_forces(
    pos: Tensor, tables: SasaTables, surface_tension: float = solvent.SURFACE_TENSION
) -> Tuple[Tensor, Tensor]:
    """``pos (R, N, 3) -> (forces (R, N, 3), energy (R,))``.

    A CUDA tensor goes through the kernel (float32, contiguous, or it raises;
    the launch is counted in ``sasa_forces.launches``), with the lists in a
    workspace of ``(R, sasa_list_bytes(nc))`` bytes on its device where
    ``sasa_lists_global``; a CPU tensor takes :func:`sasa_forces_reference`.
    Not differentiable.
    """
    if not pos.is_cuda:
        return sasa_forces_reference(pos, tables, surface_tension)
    if pos.ndim != 3 or pos.shape[-1] != 3:
        raise ValueError(f"pos must be (R, N, 3), got {tuple(pos.shape)}")
    n_rep, n, nc = pos.shape[0], pos.shape[1], tables.n_compact
    check_kernel_input("pos", pos, (n_rep, tables.n_atoms, 3))
    check_kernel_input("tables.atom", tables.atom, (nc, len(SASA_ATOM_COLUMNS)))
    if tables.atom.device != pos.device or tables.idx.device != pos.device:
        raise ValueError("tables and pos live on different devices")
    if not sasa_forces_holds(pos.device.type, pos.dtype, n, nc):
        need = sasa_shared_bytes(nc, lists_global=True) + 4 * 6 * n
        raise ValueError(
            f"sasa_forces: {nc} heavy atoms need {need} bytes of shared memory a "
            f"replica; the kernel holds {SHARED_OPT_IN_BYTES}"
        )
    fn = kernel_function(
        "sasa_forces", "mdx_sasa_forces",
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_float] + [ctypes.c_void_p] * 3,
    )
    forces = torch.empty_like(pos)
    energy = torch.empty(n_rep, dtype=torch.float32, device=pos.device)
    overflow = torch.zeros(1, dtype=torch.int32, device=pos.device)
    lists = list_workspace(n_rep, nc, pos.device) if sasa_lists_global(n, nc) else None
    with torch.cuda.device(pos.device):
        err = fn(
            pos.data_ptr(), forces.data_ptr(), energy.data_ptr(),
            tables.idx.data_ptr(), tables.atom.data_ptr(), n_rep, n, nc,
            float(surface_tension), overflow.data_ptr(),
            None if lists is None else lists.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    sasa_forces.launches += 1
    if err != 0:
        raise RuntimeError(f"sasa_forces kernel launch failed: CUDA error {err}")
    if overflow_possible(nc):
        raise_on_overflow(overflow, nc, "sasa_forces")
    return forces, energy


#: launches of the CUDA kernel made by this process
sasa_forces.launches = 0
