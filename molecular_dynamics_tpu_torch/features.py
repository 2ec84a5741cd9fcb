"""Differentiable geometry features shared by models and losses.

Backbone phi/psi torsions from a topology's atom names, pairwise distance
matrices with banded and spatial kNN masks, Kabsch rigid alignment and
aligned RMSD, and min-max scaling. Plain functions on ``(..., N, 3)``
tensors: every leading axis is a batch axis (where the reference maps a
single-frame function over the batch), and every function is differentiable
through ``torch.autograd``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from molecular_dynamics_tpu_torch.energy import dihedral_angles
from molecular_dynamics_tpu_torch.topology import Topology

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# backbone torsion index tables (host-side, from topology)
# ---------------------------------------------------------------------------


def phi_psi_indices(top: Topology) -> Tuple[np.ndarray, np.ndarray]:
    """Backbone phi/psi dihedral index tables from atom names.

    phi(i) = C(i-1)-N(i)-CA(i)-C(i); psi(i) = N(i)-CA(i)-C(i)-N(i+1), for
    any topology with standard backbone atom names.
    """
    by_res = {}
    for i, (r, nm) in enumerate(zip(top.res_ids, top.atom_names)):
        by_res.setdefault(int(r), {})[str(nm)] = i
    res = sorted(by_res)
    phis, psis = [], []
    for k, r in enumerate(res):
        cur = by_res[r]
        if k > 0:
            prev = by_res[res[k - 1]]
            if all(n in cur for n in ("N", "CA", "C")) and "C" in prev:
                phis.append((prev["C"], cur["N"], cur["CA"], cur["C"]))
        if k + 1 < len(res):
            nxt = by_res[res[k + 1]]
            if all(n in cur for n in ("N", "CA", "C")) and "N" in nxt:
                psis.append((cur["N"], cur["CA"], cur["C"], nxt["N"]))
    return (
        np.array(phis, np.int64).reshape(-1, 4),
        np.array(psis, np.int64).reshape(-1, 4),
    )


def phi_psi(pos: Tensor, phi_idx, psi_idx) -> Tuple[Tensor, Tensor]:
    """Backbone torsion values (rad) of ``pos`` ``(..., N, 3)``."""
    return (
        dihedral_angles(pos, torch.as_tensor(phi_idx, device=pos.device)),
        dihedral_angles(pos, torch.as_tensor(psi_idx, device=pos.device)),
    )


def per_atom_angle_rows(top: Topology):
    """Map every atom to its residue's row in the phi/psi tables.

    Returns ``(phi_idx, psi_idx, phi_row, psi_row)`` where ``phi_row[a]``
    is the row of ``phi_idx`` carrying atom ``a``'s residue's phi (or -1 at
    the terminus without one; psi likewise): the per-particle [xyz, phi,
    psi] features of the graph-conditioned sequence families.
    """
    phi_idx, psi_idx = phi_psi_indices(top)
    res = np.asarray(top.res_ids)
    # the torsion's own residue: a phi row is (C-, N, CA, C) -> CA at col 2;
    # a psi row is (N, CA, C, N+) -> CA at col 1
    phi_of_res = {int(res[r[2]]): k for k, r in enumerate(phi_idx)}
    psi_of_res = {int(res[r[1]]): k for k, r in enumerate(psi_idx)}
    phi_row = np.array([phi_of_res.get(int(r), -1) for r in res], np.int64)
    psi_row = np.array([psi_of_res.get(int(r), -1) for r in res], np.int64)
    return phi_idx, psi_idx, phi_row, psi_row


# ---------------------------------------------------------------------------
# distances
# ---------------------------------------------------------------------------


def _eye(n: int, device) -> Tensor:
    return torch.eye(n, dtype=torch.bool, device=device)


def distance_matrix(pos: Tensor) -> Tensor:
    """Dense pairwise distance matrix ``(..., N, N)``, grad-safe at the
    diagonal: the square root never sees a zero (a plain ``sqrt`` or
    ``torch.cdist`` gives a NaN gradient there)."""
    delta = pos[..., :, None, :] - pos[..., None, :, :]
    sq = torch.sum(delta * delta, dim=-1)
    eye = _eye(pos.shape[-2], pos.device)
    return torch.sqrt(torch.where(eye, torch.ones_like(sq), sq)) * (~eye)


def knn_mask(n_atoms: int, k: int, device=None) -> Tensor:
    """Banded ``|i-j| <= k`` mask without the diagonal: the sequence-local
    distance-loss mask."""
    idx = torch.arange(n_atoms, device=device)
    band = torch.abs(idx[:, None] - idx[None, :]) <= k
    return band & ~_eye(n_atoms, device)


def knn_graph_mask(pos: Tensor, k: int) -> Tensor:
    """Spatial k-nearest-neighbour adjacency ``(..., N, N)`` bool, per
    frame: each row marks its k nearest other atoms (ties included)."""
    d = distance_matrix(pos)
    d = torch.where(_eye(pos.shape[-2], pos.device), torch.full_like(d, torch.inf), d)
    kth = torch.sort(d, dim=-1).values[..., k - 1 : k]
    return d <= kth


# ---------------------------------------------------------------------------
# rigid alignment / RMSD
# ---------------------------------------------------------------------------


def kabsch_align(a: Tensor, b: Tensor) -> Tuple[Tensor, Tensor]:
    """Optimal rotation R and translation t with ``R @ a_c + t ~ b``.

    Differentiable Kabsch through the SVD of the 3 x 3 covariance, batched
    over leading axes. Returns (R ``(..., 3, 3)``, t ``(..., 3)``).
    """
    a_mean = torch.mean(a, dim=-2)
    b_mean = torch.mean(b, dim=-2)
    h = (a - a_mean[..., None, :]).transpose(-1, -2) @ (b - b_mean[..., None, :])
    u, _, vt = torch.linalg.svd(h, full_matrices=False)
    v, ut = vt.transpose(-1, -2), u.transpose(-1, -2)
    d = torch.sign(torch.linalg.det(v @ ut))
    ones = torch.ones_like(d)
    corr = torch.stack([ones, ones, d], dim=-1)  # the diagonal of diag(1, 1, d)
    r = v @ (corr[..., :, None] * ut)
    t = b_mean - (r @ a_mean[..., :, None])[..., 0]
    return r, t


def aligned_rmsd(a: Tensor, b: Tensor) -> Tensor:
    """RMSD after optimal superposition, one value per leading index."""
    r, t = kabsch_align(a, b)
    diff = (a @ r.transpose(-1, -2) + t[..., None, :]) - b
    return torch.sqrt(torch.mean(torch.sum(diff * diff, dim=-1), dim=-1) + 1e-12)


def rmsd(a: Tensor, b: Tensor) -> Tensor:
    """Plain (unaligned) RMSD."""
    diff = a - b
    return torch.sqrt(torch.mean(torch.sum(diff * diff, dim=-1), dim=-1) + 1e-12)


# ---------------------------------------------------------------------------
# normalization helpers (dataset scaling)
# ---------------------------------------------------------------------------


def minmax_fit(frames: Tensor) -> Tuple[Tensor, Tensor]:
    """Per-axis min/max over every leading axis of a trajectory batch."""
    flat = frames.reshape(-1, frames.shape[-1])
    return torch.amin(flat, dim=0), torch.amax(flat, dim=0)


def minmax_scale(x: Tensor, lo: Tensor, hi: Tensor) -> Tensor:
    return (x - lo) / (hi - lo + 1e-12)


def minmax_unscale(x: Tensor, lo: Tensor, hi: Tensor) -> Tensor:
    return x * (hi - lo + 1e-12) + lo
