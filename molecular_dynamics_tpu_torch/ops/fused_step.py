"""Campaign op: ``n_inner`` BAOAB Langevin steps of a replica batch per call.

``make_fused_campaign_op(ff, ...)`` returns ``advance(pos, vel, forces, t0,
seed) -> (pos, vel, forces)``. One call advances every replica ``n_inner``
steps: pair terms, analytic angle and torsion/improper forces, the moving
harmonic SMD bias, optional SHAKE/RATTLE on a constraint set (g-BAOAB
ordering: velocities re-projected after every kick and the O-step, positions
after every drift) and the thermostat noise. ``gb=True`` adds the GB-OBC II
polar solvation force (``ops.gb``) and ``sasa=True`` the LCPO nonpolar force
(``ops.sasa``): together the physics of NAMD's ``gbis on`` + ``sasa on``.
``sasa_every``/``gb_every`` evaluate them at the reference's r-RESPA
cadences (held force, and impulse). Simulation only: not differentiable.

Kernel note. On CUDA tensors ``advance`` launches ``csrc/campaign_advance.cu``
(CUDA C++, sm_90a). It replaces the JAX package's
``molecular_dynamics_tpu/ops/fused_step.py`` ``make_fused_campaign_op`` ->
``kernel`` with its cadence blocks; the implicit-solvent passes it calls are
described in ``ops.gb`` and ``ops.sasa``. What suited the TPU stays behind:
lane padding, the +-1 difference matrices that turned gathers and scatters
into matmuls, the atan2 polynomial, the on-core PRNG, the dense N x N pair
tables. On an H100 the work is bound by float32 arithmetic, not memory:
global memory sees the state once per launch while every step needs
N*(N-1)/2 pair tests, the pairs inside the cutoff and the bonded terms. The
design keeps one replica per CTA with its state in shared memory for all
``n_inner`` steps (128, 512 or 1024 threads by size: ``csrc/pair_loop.cuh``;
with GB or LCPO 256 threads, or 512 where the GB passes do without their
cache: ``campaign_solvent_shape``), evaluates each unordered pair once from
per-atom parameters (``nonbonded.pair_layout``, ``csrc/pair_loop.cuh``),
turns every scatter into a per-atom gather
in a fixed order (no atomics: a launch is bit-reproducible, and cutting a
campaign into launches differently does not change the trajectory), and
draws noise from Philox4x32-10 keyed on ``(seed, replica, t0 + i, atom)``.
The bonded and constraint buffers, the GB scratch and the LCPO scratch are
never live at once and share one region of shared memory; under GBIS at 104
atoms the GB scratch (its dI cache) sets the region, and a CTA takes 46.8 KB
(48.0 with a cadence), so that 4 CTAs of 256 threads fit an SM and 1024
replicas run in 1.94 waves. The cache grows as N^2 (185 KB at 208 atoms), so
the 512-thread solvent instantiation evaluates the GB derivatives again
instead of caching them, and the LCPO lists set its region: the 416-atom
GBIS system with rigid X-H bonds and a cadence takes 221 KB, one CTA an SM.
Where the lists do not fit (from about 215 heavy atoms) that instantiation
keeps them in a per-replica slice of a global workspace (14 bytes an entry,
64 entries a heavy atom; 206 KB a replica at 230 heavy atoms, which stays in
L2) and only their per-atom part in shared memory
(``campaign_sasa_lists_global``), so that it holds every GBIS system of up
to 512 atoms whose bonded buffers fit, as the JAX kernel does. The limit is
the 227 KB of shared memory a CTA may opt in to (the 416-atom unconstrained
vacuum system needs 70.5 KB, the 1,040-atom one 176.2 KB, 12 copies 211.4
KB); ``campaign_shared_bytes`` says what a system needs, ``campaign_misfit``
whether the kernel holds it.

``campaign_advance_reference`` is the plain PyTorch version (any device, any
float dtype): it runs for CPU tensors and is what the kernel is held against
on the card. It takes an optional ``noise`` tensor so that two
implementations can be fed the same normals.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from molecular_dynamics_tpu_torch import units
from molecular_dynamics_tpu_torch.ff.params import FFParams
from molecular_dynamics_tpu_torch.ops._build import SHARED_OPT_IN_BYTES, kernel_info
from molecular_dynamics_tpu_torch.ops.gb import (
    GBTables,
    build_gb_tables,
    gb_cached,
    gb_constants,
    gb_forces_reference,
    gb_shared_bytes,
)
from molecular_dynamics_tpu_torch.ops.nonbonded import (
    _np,
    PAIR_LAYOUT_SLOTS,
    PAIR_LOOP_MAX_ATOMS,
    PairTables,
    build_pair_tables,
    check_kernel_input,
    chunk_count,
    csr_lists,
    dense_pair_math,
    pair_constants,
)
from molecular_dynamics_tpu_torch.ops.sasa import (
    SasaTables,
    build_sasa_tables,
    list_workspace,
    overflow_possible,
    raise_on_overflow,
    sasa_forces_reference,
    sasa_list_bytes,
    sasa_shared_bytes,
)

Tensor = torch.Tensor

_EPS = 1e-12
#: shared memory one CTA of the campaign kernel may take (it opts in above 48 KB)
SHARED_LIMIT_BYTES = SHARED_OPT_IN_BYTES

#: order of the device pointers the kernel takes (enum Slot in the source)
TABLE_SLOTS = (
    *PAIR_LAYOUT_SLOTS,
    "ang_idx", "ang_k", "ang_t0",
    "tor_idx", "tor_k", "tor_phi0", "tor_per",
    "minv", "c2", "wdiff",
    "bias_idx", "bias_w",
    "cons_idx", "cons_wsum", "cons_winv", "cons_d0sq",
    "ang_start", "ang_src", "ang_w",
    "tor_start", "tor_src", "tor_w",
    "cons_start", "cons_src", "cons_w",
    "gb_atom", "sasa_idx", "sasa_atom",
)


#: threads a CTA of the two solvent instantiations (kSolventThreads,
#: kSolventLargeThreads in csrc/campaign_advance.cu): a chunk of 32 atoms a warp
SOLVENT_THREADS = (256, 512)


def campaign_solvent_shape(n_atoms: int) -> Tuple[int, bool]:
    """The solvent instantiation of the campaign kernel for ``n_atoms``:
    its threads a CTA and whether its GB passes keep the dI cache. It keeps
    the cache where the GB kernel does (``gb.gb_cached``): at 104 atoms x
    1024 replicas the 256-thread instantiation with the cache takes 20.6 ms
    a launch against the 512-thread one's 40.0, at 208 x 384 46.0 ms against
    34.8 (H100 80GB HBM3 at 700 W, ``chip_smoke.py``'s ``gbis_tiers``)."""
    if gb_cached(n_atoms):
        return SOLVENT_THREADS[0], True
    return SOLVENT_THREADS[1], False


def _cta_bytes(n_atoms, n_angles, n_tors, n_cons, gb, n_sasa, slow_buffer, lists_global):
    region = 4 * (6 * n_angles + 9 * n_tors + 9 * n_cons)
    if gb:
        region = max(region, gb_shared_bytes(n_atoms, campaign_solvent_shape(n_atoms)[1]))
    if n_sasa:
        region = max(region, sasa_shared_bytes(n_sasa, lists_global))
    return (4 * 9 * n_atoms + (4 * 3 * n_atoms if slow_buffer else 0)
            + 4 * 6 * chunk_count(n_atoms) + region)


def campaign_sasa_lists_global(
    n_atoms: int, n_angles: int, n_tors: int, n_cons: int,
    gb: bool = False, n_sasa: int = 0, slow_buffer: bool = False,
) -> bool:
    """Whether the campaign kernel keeps the LCPO neighbour lists in a
    global workspace: with LCPO in the 512-thread solvent instantiation,
    where the CTA with the lists in shared memory would pass what a CTA may
    opt in to. The 256-thread instantiation keeps them in shared memory (at
    most 128 atoms). Where both fit, shared memory: at 416 x 192, the one
    tier where they do, a launch of 50 steps took 61.39 ms with the lists in
    shared memory and 61.39 in the workspace, with the same bits (H100 80GB
    HBM3 at 700 W, ``chip_smoke.py``'s ``gbis_tiers``)."""
    if not n_sasa or campaign_solvent_shape(n_atoms)[1]:
        return False
    return _cta_bytes(
        n_atoms, n_angles, n_tors, n_cons, gb, n_sasa, slow_buffer, False
    ) > SHARED_LIMIT_BYTES


def campaign_shared_bytes(
    n_atoms: int, n_angles: int, n_tors: int, n_cons: int,
    gb: bool = False, n_sasa: int = 0, slow_buffer: bool = False,
) -> int:
    """Shared memory one CTA of the campaign kernel needs: the 9 state
    vectors; with a cadence > 1 (``slow_buffer``) the block's slow force; the
    pair loop's chunk bounding boxes (6 floats a chunk); and one region for
    what is never live at once, as large as the largest of the angle (2
    vectors a term), torsion (3) and constraint (3) buffers, the GB scratch
    (``gb``; with the dI cache where ``campaign_solvent_shape`` keeps it) and
    the LCPO scratch (``n_sasa`` heavy atoms; its lists only where
    ``campaign_sasa_lists_global`` leaves them in shared memory)."""
    sizes = (n_atoms, n_angles, n_tors, n_cons, gb, n_sasa, slow_buffer)
    return _cta_bytes(*sizes, campaign_sasa_lists_global(*sizes))


def campaign_max_atoms(solvent: bool) -> int:
    """Atoms the campaign kernel's instantiations for a system hold: 512
    with GB or LCPO (the 512-thread solvent instantiation, a chunk of 32
    atoms a warp), else ``PAIR_LOOP_MAX_ATOMS``. The CTA shape follows the
    system's size (``csrc/pair_loop.cuh`` ``pair_loop_shape``,
    ``campaign_solvent_shape``); the op's ``kernel_info()`` reads it back."""
    return SOLVENT_THREADS[1] if solvent else PAIR_LOOP_MAX_ATOMS


def _instantiation(n_atoms: int, solvent: bool) -> str:
    """The kernel of ``csrc/campaign_advance.cu`` that runs a system: the
    solvent one ``campaign_solvent_shape`` picks, else the vacuum one of the
    pair loop's shape (``pair_loop_shape``: 128 and 512 atoms)."""
    if solvent:
        return "campaign_solvent" if campaign_solvent_shape(n_atoms)[1] else "campaign_solvent_large"
    return ("campaign_vacuum" if n_atoms <= 128
            else "campaign_medium" if n_atoms <= 512 else "campaign_large")


def campaign_misfit(
    n_atoms: int, n_angles: int, n_tors: int, n_cons: int,
    gb: bool = False, n_sasa: int = 0, slow_buffer: bool = False,
) -> Optional[str]:
    """Why the campaign kernel cannot hold a system of these sizes, or None
    where it holds it: its shared memory (``campaign_shared_bytes``) within
    what a CTA may opt in to, and its atoms within what the instantiation
    holds (``campaign_max_atoms``). ``make_fused_campaign_op`` raises with
    the reason."""
    need = campaign_shared_bytes(n_atoms, n_angles, n_tors, n_cons, gb, n_sasa, slow_buffer)
    if need > SHARED_LIMIT_BYTES:
        return (
            f"this system needs {need} bytes of shared memory a replica ({n_atoms} "
            f"atoms, {n_angles} angles, {n_tors} torsions, {n_cons} constraints, "
            f"gb={gb}, {n_sasa} LCPO atoms); the kernel holds {SHARED_LIMIT_BYTES}"
        )
    solvent = gb or n_sasa > 0
    most = campaign_max_atoms(solvent)
    if n_atoms > most:
        return f"{n_atoms} atoms; the kernel holds {most}{' with GB or LCPO' if solvent else ''}"
    return None


@dataclasses.dataclass(frozen=True)
class CampaignTables:
    """Everything static the campaign op reads, on one device."""

    pair: PairTables
    #: name -> tensor, for every name in ``TABLE_SLOTS`` past the pair tables
    #: (int32 for indices and lists, float32 for parameters)
    tensors: dict
    n_atoms: int
    n_angles: int
    n_tors: int
    max_t: int
    n_cons: int
    n_bias: int
    #: the implicit-solvent tables, where the op was built with them
    gb: Optional[GBTables] = None
    sasa: Optional[SasaTables] = None

    def pointer_array(self):
        named = dict(self.tensors, **self.pair.layout)
        return (ctypes.c_void_p * len(TABLE_SLOTS))(
            *[named[k].data_ptr() for k in TABLE_SLOTS]
        )


def _torsion_arrays(ff: FFParams):
    """Dihedrals and impropers as one list: idx (T, 4), and masked k, phi0,
    per as (max_t, T); padding terms have k = 0 and per = 1 (inert)."""
    blocks, max_t = [], 1
    for idx, par, msk in (
        (ff.dihedrals, ff.dihedral_params, ff.dihedral_term_mask),
        (ff.impropers, ff.improper_params, ff.improper_term_mask),
    ):
        if idx.shape[0]:
            blocks.append((_np(idx), _np(par).astype(np.float64), _np(msk)))
            max_t = max(max_t, par.shape[1])
    if not blocks:
        return None
    idx_all, k_all, phi0_all, per_all = [], [], [], []
    for idx, par, msk in blocks:
        n_t, t = par.shape[0], par.shape[1]
        k = np.zeros((n_t, max_t))
        phi0 = np.zeros((n_t, max_t))
        per = np.ones((n_t, max_t))
        k[:, :t] = np.where(msk, par[:, :, 0], 0.0)
        phi0[:, :t] = par[:, :, 1]
        per[:, :t] = par[:, :, 2]
        idx_all.append(idx)
        k_all.append(k)
        phi0_all.append(phi0)
        per_all.append(per)
    cat = lambda parts: np.ascontiguousarray(np.concatenate(parts).T, np.float32)
    return (
        np.concatenate(idx_all).astype(np.int32),
        cat(k_all), cat(phi0_all), cat(per_all), max_t,
    )


def build_campaign_tables(
    ff: FFParams,
    dt_fs: float,
    temperature: float,
    gamma_ps: float,
    include_ub=None,
    bias=None,
    constraints=None,
    gb: bool = False,
    sasa: bool = False,
) -> CampaignTables:
    """Host-side table building for the campaign op (numpy, then one copy
    to the device of ``ff``)."""
    device = ff.device
    n = ff.n_atoms
    angles = _np(ff.angles).astype(np.int32)
    tor = _torsion_arrays(ff)
    if not len(angles) or tor is None:
        raise NotImplementedError(
            "the campaign op requires angle and torsion terms; use the "
            "composed path (fused_nonbonded) for systems without them"
        )
    tor_idx, tor_k, tor_phi0, tor_per, max_t = tor
    n_a, n_t = len(angles), len(tor_idx)

    dt = dt_fs / units.TIMEFACTOR
    gamma = gamma_ps * (units.TIMEFACTOR / 1000.0)
    c1 = math.exp(-gamma * dt)
    masses = _np(ff.masses).astype(np.float64)
    arrays = {
        "ang_idx": angles,
        "ang_k": _np(ff.angle_params)[:, 0].astype(np.float32),
        "ang_t0": _np(ff.angle_params)[:, 1].astype(np.float32),
        "tor_idx": tor_idx, "tor_k": tor_k, "tor_phi0": tor_phi0,
        "tor_per": tor_per,
        "minv": (1.0 / masses).astype(np.float32),
        "c2": np.sqrt(
            units.BOLTZMANN * temperature / masses * (1.0 - c1 * c1)
        ).astype(np.float32),
    }

    # angle gather lists: buffer holds f0 (slot a) and f2 (slot A + a);
    # atom0 += f0, atom1 -= f0 + f2, atom2 += f2
    ar = np.arange(n_a)
    arrays["ang_start"], arrays["ang_src"], arrays["ang_w"] = csr_lists(
        n,
        np.concatenate([angles[:, 0], angles[:, 1], angles[:, 1], angles[:, 2]]),
        np.concatenate([ar, ar, n_a + ar, n_a + ar]),
        np.concatenate([np.ones(n_a), -np.ones(n_a), -np.ones(n_a), np.ones(n_a)]),
    )
    # torsion gather lists: buffer holds f0v (q), s (T + q), f3v (2T + q);
    # atom0 -f0v, atom1 +f0v +s, atom2 -s +f3v, atom3 -f3v
    tr = np.arange(n_t)
    one = np.ones(n_t)
    arrays["tor_start"], arrays["tor_src"], arrays["tor_w"] = csr_lists(
        n,
        np.concatenate([tor_idx[:, 0], tor_idx[:, 1], tor_idx[:, 1],
                        tor_idx[:, 2], tor_idx[:, 2], tor_idx[:, 3]]),
        np.concatenate([tr, tr, n_t + tr, n_t + tr, 2 * n_t + tr, 2 * n_t + tr]),
        np.concatenate([-one, one, one, -one, one, -one]),
    )

    if bias is not None:
        wdiff = (_np(bias.group2_w) - _np(bias.group1_w)).astype(np.float32)
    else:
        wdiff = np.zeros(n, np.float32)
    bias_idx = np.flatnonzero(wdiff).astype(np.int32)
    arrays["wdiff"] = wdiff
    arrays["bias_idx"] = bias_idx
    arrays["bias_w"] = wdiff[bias_idx]

    n_c = 0 if constraints is None else int(constraints.pairs.shape[0])
    if n_c:
        pairs = _np(constraints.pairs).astype(np.int32)
        inv_mass = _np(constraints.inv_mass).astype(np.float32)
        wi, wj = inv_mass[pairs[:, 0]], inv_mass[pairs[:, 1]]
        cr = np.arange(n_c)
        arrays["cons_idx"] = pairs
        arrays["cons_wi"], arrays["cons_wj"] = wi, wj
        arrays["cons_wsum"] = wi + wj
        arrays["cons_winv"] = (1.0 / (wi + wj)).astype(np.float32)
        arrays["cons_d0sq"] = _np(constraints.lengths).astype(np.float32) ** 2
        # p[i] -= w_i corr, p[j] += w_j corr
        arrays["cons_start"], arrays["cons_src"], arrays["cons_w"] = csr_lists(
            n, np.concatenate([pairs[:, 0], pairs[:, 1]]),
            np.concatenate([cr, cr]), np.concatenate([-wi, wj]),
        )
    else:
        for k in ("cons_idx", "cons_start", "cons_src"):
            arrays[k] = np.zeros(0, np.int32)
        for k in ("cons_wsum", "cons_winv", "cons_d0sq", "cons_w",
                  "cons_wi", "cons_wj"):
            arrays[k] = np.zeros(0, np.float32)

    tensors = {
        k: torch.as_tensor(np.ascontiguousarray(v), device=device)
        for k, v in arrays.items()
    }
    gb_tab = build_gb_tables(ff) if gb else None
    sasa_tab = build_sasa_tables(ff) if sasa else None
    no_f = torch.zeros(0, dtype=torch.float32, device=device)
    tensors["gb_atom"] = gb_tab.atom if gb else no_f
    tensors["sasa_atom"] = sasa_tab.atom if sasa else no_f
    tensors["sasa_idx"] = (
        sasa_tab.idx if sasa else torch.zeros(0, dtype=torch.int32, device=device)
    )
    return CampaignTables(
        pair=build_pair_tables(ff, include_ub=include_ub),
        tensors=tensors,
        n_atoms=n, n_angles=n_a, n_tors=n_t, max_t=max_t, n_cons=n_c,
        n_bias=len(bias_idx), gb=gb_tab, sasa=sasa_tab,
    )


# ---------------------------------------------------------------------------
# thermostat noise: Philox4x32-10 in PyTorch (the kernel's philox.cuh)
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _mulhilo(m: int, x: Tensor) -> Tuple[Tensor, Tensor]:
    """High and low 32 bits of ``m * x`` for uint32 values held in int64.
    The int64 product wraps modulo 2^64, which keeps all 64 bits."""
    prod = x * m
    return (prod >> 32) & _M32, prod & _M32


def philox4x32_10(counter, key) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Philox4x32-10 on int64 tensors holding uint32 words: ``counter`` is
    four broadcastable tensors, ``key`` two Python ints."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for _ in range(10):
        hi0, lo0 = _mulhilo(0xD2511F53, c0)
        hi1, lo1 = _mulhilo(0xCD9E8D57, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + 0x9E3779B9) & _M32
        k1 = (k1 + 0xBB67AE85) & _M32
    return c0, c1, c2, c3


def philox_normals(
    seed: int, t0: int, n_inner: int, n_replicas: int, n_atoms: int,
    device=None, dtype=torch.float32,
) -> Tensor:
    """The standard normals the campaign kernel draws, ``(n_inner, R, N, 3)``:
    entry ``[i, r, a]`` is keyed on ``(seed, r, t0 + i, a)`` alone."""
    dev = torch.device("cpu" if device is None else device)
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=dev)
    step = (int(t0) + ar(n_inner)).view(-1, 1, 1)
    shape = (n_inner, n_replicas, n_atoms)
    zeros = torch.zeros(shape, dtype=torch.int64, device=dev)
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    o = philox4x32_10(
        (
            zeros + ar(n_atoms).view(1, 1, -1),
            zeros + ar(n_replicas).view(1, -1, 1),
            zeros + (step & _M32),
            zeros + ((step >> 32) & _M32),
        ),
        (seed & _M32, seed >> 32),
    )

    def uniform(bits):  # 23 bits, strictly inside (0, 1), exact in float32
        return ((bits >> 9).to(torch.float32) + 0.5) * (1.0 / 8388608.0)

    two_pi = torch.tensor(2.0 * math.pi, dtype=torch.float32, device=dev)
    r1 = torch.sqrt(-2.0 * torch.log(uniform(o[0])))
    r2 = torch.sqrt(-2.0 * torch.log(uniform(o[2])))
    a1 = two_pi * uniform(o[1])
    a2 = two_pi * uniform(o[3])
    g = torch.stack(
        [r1 * torch.cos(a1), r1 * torch.sin(a1), r2 * torch.cos(a2)], dim=-1
    )
    return g.to(dtype)


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------


def _gather_pairs(p: Tensor, idx: Tensor, a: int, b: int) -> Tensor:
    return p[..., idx[:, a], :] - p[..., idx[:, b], :]


def campaign_forces_reference(
    pos: Tensor, tab: CampaignTables, pair_consts, bias_consts, t_step,
    gb_consts=None, surface_tension: Optional[float] = None,
) -> Tensor:
    """Total force ``(R, N, 3)`` as the campaign kernel evaluates it: pair
    terms + analytic angle and torsion forces + the SMD bias at ``t_step``;
    with ``gb_consts`` the GB-OBC II force, with ``surface_tension`` the LCPO
    force (each needs its tables on ``tab``)."""
    tt = tab.tensors
    dt = pos.dtype
    _, f = dense_pair_math(pos, tab.pair.dense, pair_consts)
    f = f.clone()

    # angles: analytic 3-centre forces
    ai = tt["ang_idx"].long()
    r21 = _gather_pairs(pos, ai, 0, 1)
    r23 = _gather_pairs(pos, ai, 2, 1)
    cross = torch.linalg.cross(r21, r23)
    nrm = torch.sqrt(torch.clamp_min(torch.sum(cross * cross, -1), _EPS))
    dot = torch.sum(r21 * r23, -1)
    theta = torch.atan2(nrm, dot)
    n21i = torch.rsqrt(torch.clamp_min(torch.sum(r21 * r21, -1), _EPS))
    n23i = torch.rsqrt(torch.clamp_min(torch.sum(r23 * r23, -1), _EPS))
    cos_t = dot * n21i * n23i
    sin_t = torch.clamp_min(nrm * n21i * n23i, 1e-6)
    coef = -2.0 * tt["ang_k"].to(dt) * (theta - tt["ang_t0"].to(dt)) / sin_t
    u21 = r21 * n21i.unsqueeze(-1)
    u23 = r23 * n23i.unsqueeze(-1)
    f0 = (coef * n21i).unsqueeze(-1) * (cos_t.unsqueeze(-1) * u21 - u23)
    f2 = (coef * n23i).unsqueeze(-1) * (cos_t.unsqueeze(-1) * u23 - u21)
    f.index_add_(-2, ai[:, 0], f0)
    f.index_add_(-2, ai[:, 1], -(f0 + f2))
    f.index_add_(-2, ai[:, 2], f2)

    # dihedrals + impropers: analytic 4-centre forces
    ti = tt["tor_idx"].long()
    b1 = _gather_pairs(pos, ti, 0, 1)
    b2 = _gather_pairs(pos, ti, 1, 2)
    b3 = _gather_pairs(pos, ti, 2, 3)
    ca = torch.linalg.cross(b1, b2)
    cb = torch.linalg.cross(b2, b3)
    b2n = torch.sqrt(torch.clamp_min(torch.sum(b2 * b2, -1), _EPS))
    sin_num = torch.sum(b2 * torch.linalg.cross(ca, cb), -1) / b2n
    cos_num = torch.sum(ca * cb, -1)
    phi = -torch.atan2(sin_num, cos_num)
    coeff = torch.zeros_like(phi)
    two_pi = 2.0 * math.pi
    for m in range(tab.max_t):
        k = tt["tor_k"][m].to(dt)
        phi0 = tt["tor_phi0"][m].to(dt)
        per = tt["tor_per"][m].to(dt)
        amber = -per * k * torch.sin(per * phi - phi0)
        dp = phi - phi0
        dp = dp - two_pi * torch.round(dp / two_pi)
        coeff = coeff + torch.where(per > 0, amber, 2.0 * k * dp)
    na2 = torch.clamp_min(torch.sum(ca * ca, -1), _EPS)
    nb2 = torch.clamp_min(torch.sum(cb * cb, -1), _EPS)
    n2d2 = torch.clamp_min(b2n * b2n, _EPS)
    ff1 = torch.sum(b1 * b2, -1) / n2d2
    ff2 = torch.sum(b3 * b2, -1) / n2d2
    f0v = ((-coeff * b2n) / na2).unsqueeze(-1) * ca
    f3v = ((coeff * b2n) / nb2).unsqueeze(-1) * cb
    s = ff1.unsqueeze(-1) * f0v - ff2.unsqueeze(-1) * f3v
    f.index_add_(-2, ti[:, 0], -f0v)
    f.index_add_(-2, ti[:, 1], f0v + s)
    f.index_add_(-2, ti[:, 2], f3v - s)
    f.index_add_(-2, ti[:, 3], -f3v)

    # moving harmonic SMD bias, centre held at cent_1 past T
    if tab.n_bias:
        fk, c0, slope, tmax = bias_consts
        wdiff = tt["wdiff"].to(dt)
        com = torch.einsum("n,...nd->...d", wdiff, pos)
        dist = torch.sqrt(torch.clamp_min(torch.sum(com * com, -1), _EPS))
        center = c0 + slope * min(float(t_step), tmax)
        coefb = fk * (dist - center) / dist
        f = f - (coefb.unsqueeze(-1) * com).unsqueeze(-2) * wdiff[:, None]
    return f + campaign_solvent_forces_reference(pos, tab, gb_consts, surface_tension)


def campaign_solvent_forces_reference(
    pos: Tensor, tab: CampaignTables, gb_consts=None,
    surface_tension: Optional[float] = None,
) -> Tensor:
    """The implicit-solvent part of the campaign force: GB-OBC II where
    ``gb_consts`` is given plus LCPO where ``surface_tension`` is (zeros
    where neither is)."""
    f = torch.zeros_like(pos)
    if gb_consts is not None:
        f = f + gb_forces_reference(pos, tab.gb, gb_consts)[0]
    if surface_tension is not None:
        f = f + sasa_forces_reference(pos, tab.sasa, surface_tension)[0]
    return f


def _cons_scatter(p: Tensor, corr: Tensor, tt: dict) -> Tensor:
    ci = tt["cons_idx"].long()
    wi = tt["cons_wi"].to(p.dtype)[:, None]
    wj = tt["cons_wj"].to(p.dtype)[:, None]
    out = p.clone()
    out.index_add_(-2, ci[:, 0], -wi * corr)
    out.index_add_(-2, ci[:, 1], wj * corr)
    return out


def _rattle(vel: Tensor, pos: Tensor, tt: dict, n_iter: int) -> Tensor:
    ci = tt["cons_idx"].long()
    d = _gather_pairs(pos, ci, 0, 1)
    dhat = d * torch.rsqrt(torch.clamp_min(torch.sum(d * d, -1, keepdim=True), _EPS))
    winv = tt["cons_winv"].to(vel.dtype)[:, None]
    for _ in range(n_iter):
        lam = torch.sum(_gather_pairs(vel, ci, 0, 1) * dhat, -1, keepdim=True) * winv
        vel = _cons_scatter(vel, lam * dhat, tt)
    return vel


def _shake(pos: Tensor, ref: Tensor, tt: dict, n_iter: int) -> Tensor:
    ci = tt["cons_idx"].long()
    wsum = tt["cons_wsum"].to(pos.dtype)[:, None]
    d0sq = tt["cons_d0sq"].to(pos.dtype)[:, None]
    for _ in range(n_iter):
        d = _gather_pairs(pos, ci, 0, 1)
        diff = torch.sum(d * d, -1, keepdim=True) - d0sq
        denom = 2.0 * wsum * torch.sum(d * ref, -1, keepdim=True)
        g = diff / torch.where(
            torch.abs(denom) > 1e-12, denom, torch.full_like(denom, 1e-12)
        )
        pos = _cons_scatter(pos, g * ref, tt)
    return pos


def campaign_advance_reference(
    pos: Tensor, vel: Tensor, frc: Tensor, t0: int, seed: int,
    tab: CampaignTables, *, n_inner: int, dt_fs: float, c1: float,
    use_noise: bool, pair_consts, bias_consts,
    shake_iters: int = 6, rattle_iters: int = 3,
    gb_consts=None, surface_tension: Optional[float] = None,
    sasa_every: int = 1, gb_every: int = 1,
    noise: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain PyTorch version of the campaign kernel, step for step.

    ``gb_consts`` / ``surface_tension`` switch the GB and LCPO forces on.
    ``sasa_every = k > 1`` holds the LCPO force of each k-step block's entry
    positions through the block (the carried force stays the total).
    ``gb_every = k > 1`` is the impulse form: the slow force (GB, and LCPO
    when its cadence is k too) is taken off the incoming total force, kicks
    the velocities by ``k dt / 2`` at both ends of every block (RATTLE after
    each kick), and is put back on the way out; in between the per-step force
    is the fast one.

    ``noise`` ``(n_inner, R, N, 3)``, when given, replaces the Philox draws
    (``philox_normals(seed, t0, ...)``) of a run with ``use_noise``.
    """
    tt = tab.tensors
    dt = pos.dtype
    half = 0.5 * dt_fs / units.TIMEFACTOR
    minv = tt["minv"].to(dt)[:, None]
    c2 = tt["c2"].to(dt)[:, None]
    cons = tab.n_cons > 0
    if use_noise and noise is None:
        noise = philox_normals(
            seed, t0, n_inner, pos.shape[0], tab.n_atoms, device=pos.device, dtype=dt
        )
    use_gb = gb_consts is not None
    use_sasa = surface_tension is not None
    impulse = use_gb and gb_every > 1
    slow_sasa = use_sasa and sasa_every > 1
    held = slow_sasa and not impulse

    def fast_forces(p, i, extra=None):
        f = campaign_forces_reference(
            p, tab, pair_consts, bias_consts, t0 + i,
            gb_consts if use_gb and not impulse else None,
            surface_tension if use_sasa and not slow_sasa else None,
        )
        return f if extra is None else f + extra

    def slow_forces(p):
        return campaign_solvent_forces_reference(
            p, tab, gb_consts if impulse else None,
            surface_tension if slow_sasa else None,
        )

    def step(pos, vel, frc, i, extra=None):
        # B: half kick with the stored forces
        vel = vel + half * frc * minv
        if cons:
            vel = _rattle(vel, pos, tt, rattle_iters)
            ref = _gather_pairs(pos, tt["cons_idx"].long(), 0, 1)
        # A: half drift
        new = pos + half * vel
        pos = _shake(new, ref, tt, shake_iters) if cons else new
        # O: exact Ornstein-Uhlenbeck solve
        vel = c1 * vel
        if use_noise:
            vel = vel + c2 * noise[i].to(dt)
        if cons:
            vel = _rattle(vel, pos, tt, rattle_iters)
            ref = _gather_pairs(pos, tt["cons_idx"].long(), 0, 1)
        # A: half drift
        new = pos + half * vel
        pos = _shake(new, ref, tt, shake_iters) if cons else new
        # B: half kick with the new forces, SMD centre at the start index
        frc = fast_forces(pos, i, extra)
        vel = vel + half * frc * minv
        if cons:
            vel = _rattle(vel, pos, tt, rattle_iters)
        return pos, vel, frc

    def slow_kick(pos, vel, slow):
        vel = vel + (gb_every * half) * slow * minv
        return _rattle(vel, pos, tt, rattle_iters) if cons else vel

    if impulse:
        slow = slow_forces(pos)
        frc = frc - slow  # the carried force is the fast one in this mode
        for j in range(n_inner // gb_every):
            vel = slow_kick(pos, vel, slow)
            for i in range(gb_every):
                pos, vel, frc = step(pos, vel, frc, j * gb_every + i)
            slow = slow_forces(pos)
            vel = slow_kick(pos, vel, slow)
        frc = frc + slow
    elif held:
        for j in range(n_inner // sasa_every):
            slow = slow_forces(pos)
            for i in range(sasa_every):
                pos, vel, frc = step(pos, vel, frc, j * sasa_every + i, slow)
    else:
        for i in range(n_inner):
            pos, vel, frc = step(pos, vel, frc, i)
    return pos, vel, frc


# ---------------------------------------------------------------------------
# the op
# ---------------------------------------------------------------------------


def _library():
    from molecular_dynamics_tpu_torch.ops import _build

    lib = _build.load("campaign_advance")
    adv = lib.mdx_campaign_advance
    if not adv.argtypes:
        adv.argtypes = [ctypes.c_void_p] * 9 + [
            ctypes.c_int, ctypes.c_longlong, ctypes.c_ulonglong,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        adv.restype = ctypes.c_int
        noise = lib.mdx_campaign_noise
        noise.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_ulonglong, ctypes.c_void_p,
        ]
        noise.restype = ctypes.c_int
    return lib


def campaign_noise(
    seed: int, t0: int, n_inner: int, n_replicas: int, n_atoms: int, device=None
) -> Tensor:
    """The normals the campaign kernel draws for ``(seed, t0)``, filled by
    the kernel's own device function: ``(n_inner, R, N, 3)`` float32 on the
    CUDA device. A debugging aid; see ``philox_normals`` for the plain
    version."""
    device = torch.device("cuda" if device is None else device)
    out = torch.empty(
        (n_replicas, n_inner, n_atoms, 3), dtype=torch.float32, device=device
    )
    lib = _library()
    with torch.cuda.device(device):
        err = lib.mdx_campaign_noise(
            out.data_ptr(), n_replicas, n_inner, n_atoms, int(t0),
            int(seed) & 0xFFFFFFFFFFFFFFFF,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"campaign noise kernel launch failed: CUDA error {err}")
    return out.permute(1, 0, 2, 3).contiguous()


def campaign_advance(
    pos: Tensor, vel: Tensor, frc: Tensor, t0: int, seed: int,
    tab: CampaignTables, dims, consts,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Launch the campaign kernel on CUDA tensors ``(R, N, 3)`` (float32,
    contiguous, or it raises). ``dims`` and ``consts`` are the ctypes arrays
    ``make_fused_campaign_op`` builds; where ``dims`` puts the LCPO lists in
    global memory (its last entry) the wrapper allocates their workspace on
    the device, ``(R, sasa_list_bytes(nc))`` bytes. Does not synchronise,
    unless an LCPO neighbour list can overflow (above 65 heavy atoms): then
    it reads the kernel's flag and raises on it. Each launch is counted in
    ``campaign_advance.launches``."""
    shape = (pos.shape[0], tab.n_atoms, 3)
    for name, t in (("pos", pos), ("vel", vel), ("forces", frc)):
        check_kernel_input(name, t, shape)
        if t.device != pos.device:
            raise ValueError(f"{name} lives on another device than pos")
    if tab.pair.dense.device != pos.device:
        raise ValueError("tables and pos live on different devices")
    lib = _library()
    out = [torch.empty_like(pos) for _ in range(3)]
    overflow = torch.zeros(1, dtype=torch.int32, device=pos.device)
    lists = list_workspace(shape[0], tab.sasa.n_compact, pos.device) if dims[-1] else None
    ptrs = tab.pointer_array()
    with torch.cuda.device(pos.device):
        err = lib.mdx_campaign_advance(
            pos.data_ptr(), vel.data_ptr(), frc.data_ptr(),
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
            ptrs, dims, consts, shape[0], t0, seed & 0xFFFFFFFFFFFFFFFF,
            overflow.data_ptr(), None if lists is None else lists.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    campaign_advance.launches += 1
    if err != 0:
        raise RuntimeError(f"campaign kernel launch failed: CUDA error {err}")
    if tab.sasa is not None and overflow_possible(tab.sasa.n_compact):
        raise_on_overflow(overflow, tab.sasa.n_compact, "campaign kernel")
    return out[0], out[1], out[2]


#: launches of the CUDA kernel made by this process
campaign_advance.launches = 0


def make_fused_campaign_op(
    ff: FFParams,
    n_inner: int = 50,
    dt_fs: float = 2.0,
    temperature: float = 300.0,
    gamma_ps: float = 1.0,
    cutoff: Optional[float] = 9.0,
    switch_dist: Optional[float] = 7.5,
    rfa: bool = True,
    solvent_dielectric: float = units.SOLVENT_DIELECTRIC,
    include_ub=None,  # None -> auto: on iff ff carries UB springs
    bias=None,
    constraints=None,  # a constraints.Constraints -> SHAKE/RATTLE in the op
    shake_iters: int = 6,
    rattle_iters: int = 3,
    gb: bool = False,
    ion_concentration: float = 0.0,
    sasa: bool = False,
    surface_tension: float = 0.005,
    sasa_every: int = 1,
    gb_every: int = 1,
):
    """Build ``advance(pos, vel, forces, t0, seed, noise=None) -> (pos, vel,
    frc)``.

    Advances every replica ``n_inner`` BAOAB Langevin steps per call.
    ``bias`` (a HarmonicSMDBias or None) contributes its analytic force with
    the moving-centre schedule evaluated at ``t0 + i``. ``constraints``
    enables SHAKE/RATTLE (rigid-bond protocol); X-H star clusters converge
    geometrically, so the default sweep counts sit at the float32 noise
    floor. ``gb=True`` adds the GB-OBC II polar force (needs the GB tables
    on ``ff``; ``solvent_dielectric`` and ``ion_concentration`` feed the
    Debye-screened prefactor), ``sasa=True`` the LCPO nonpolar force with
    ``surface_tension``. ``sasa_every = k`` evaluates the LCPO force once per
    k-step block and holds it; ``gb_every = k`` applies the whole GB force
    (and the LCPO force when ``sasa_every`` is k too) as impulses at the block
    ends. Both must divide ``n_inner`` and be equal when both exceed 1.
    Arrays are ``(R, N, 3)``; ``t0`` and ``seed`` are Python ints.

    CUDA tensors (float32, contiguous) go through ``campaign_advance``, the
    kernel's wrapper, which counts its launches; CPU tensors take
    ``campaign_advance_reference``. ``noise`` is taken by the plain version
    only.
    """
    use_gb, use_sasa = bool(gb), bool(sasa)
    sasa_every = int(sasa_every) if use_sasa else 1
    if sasa_every < 1:
        raise ValueError(f"sasa_every must be >= 1, got {sasa_every}")
    if sasa_every > 1 and n_inner % sasa_every:
        raise ValueError(
            f"sasa_every={sasa_every} must divide n_inner={n_inner} "
            "(the held-force blocks tile the launch exactly)"
        )
    gb_every = int(gb_every) if use_gb else 1
    if gb_every < 1:
        raise ValueError(f"gb_every must be >= 1, got {gb_every}")
    if gb_every > 1:
        if n_inner % gb_every:
            raise ValueError(
                f"gb_every={gb_every} must divide n_inner={n_inner} "
                "(the impulse blocks tile the launch exactly)"
            )
        if use_sasa and sasa_every > 1 and sasa_every != gb_every:
            raise ValueError(
                f"combined cadences must align: sasa_every={sasa_every} "
                f"!= gb_every={gb_every} (one shared block structure)"
            )
    tab = build_campaign_tables(
        ff, dt_fs, temperature, gamma_ps, include_ub=include_ub, bias=bias,
        constraints=constraints, gb=use_gb, sasa=use_sasa,
    )
    n_sasa = tab.sasa.n_compact if use_sasa else 0
    slow_buffer = gb_every > 1 or sasa_every > 1
    sizes = (tab.n_atoms, tab.n_angles, tab.n_tors, tab.n_cons, use_gb, n_sasa, slow_buffer)
    misfit = campaign_misfit(*sizes)
    if misfit is not None:
        raise ValueError(f"campaign op: {misfit}")
    need = campaign_shared_bytes(*sizes)
    lists_global = campaign_sasa_lists_global(*sizes)
    solvent = use_gb or use_sasa
    gb_cache = solvent and campaign_solvent_shape(tab.n_atoms)[1]
    pair_consts = pair_constants(cutoff, switch_dist, rfa, solvent_dielectric)
    dt = dt_fs / units.TIMEFACTOR
    gamma = gamma_ps * (units.TIMEFACTOR / 1000.0)
    c1 = math.exp(-gamma * dt)
    use_noise = temperature > 0.0
    if bias is not None:
        bias_consts = (
            float(bias.fk), float(bias.cent_0),
            float((bias.cent_1 - bias.cent_0) / bias.T), float(bias.T),
        )
    else:
        bias_consts = (0.0, 0.0, 0.0, 0.0)

    gb_consts = gb_constants(solvent_dielectric, ion_concentration) if use_gb else None
    gamma_sasa = float(surface_tension) if use_sasa else None

    @functools.cache
    def dims():
        # built at the first launch: n_lj_types builds the pair layout,
        # which only the kernel reads
        return (ctypes.c_int * 17)(
            tab.n_atoms, tab.n_angles, tab.n_tors, tab.max_t, tab.n_cons,
            tab.n_bias, n_inner, shake_iters, rattle_iters, int(use_noise),
            int(use_gb), n_sasa, sasa_every, gb_every, tab.pair.n_lj_types,
            int(solvent and not gb_cache), int(lists_global),
        )

    consts = (ctypes.c_float * 17)(
        0.5 * dt, c1, *bias_consts, *pair_consts,
        *(gb_consts or (0.0,) * 5), gamma_sasa or 0.0,
    )
    settings = dict(
        n_inner=n_inner, dt_fs=dt_fs, c1=c1, use_noise=use_noise,
        pair_consts=pair_consts, bias_consts=bias_consts,
        shake_iters=shake_iters, rattle_iters=rattle_iters,
        gb_consts=gb_consts, surface_tension=gamma_sasa,
        sasa_every=sasa_every, gb_every=gb_every,
    )

    def advance(pos, vel, frc, t0, seed, noise=None):
        if pos.device != tab.pair.dense.device:
            raise ValueError(
                f"pos lives on {pos.device}, the op's tables on "
                f"{tab.pair.dense.device}: build the op from FFParams on the "
                "device of the state"
            )
        if not pos.is_cuda:
            return campaign_advance_reference(
                pos, vel, frc, int(t0), int(seed), tab, noise=noise, **settings
            )
        if noise is not None:
            raise ValueError(
                "the campaign kernel draws its own noise; `noise` is for "
                "campaign_advance_reference"
            )
        return campaign_advance(pos, vel, frc, int(t0), int(seed), tab, dims(), consts)

    advance.n_inner = n_inner
    advance.shared_bytes = need
    #: the kernel instantiation this op launches (csrc/campaign_advance.cu)
    advance.instantiation = _instantiation(tab.n_atoms, solvent)
    #: whether its GB passes keep the dI cache (False without GB)
    advance.gb_cached = use_gb and gb_cache
    #: where the LCPO neighbour lists live: "shared", "global" (a workspace
    #: of ``sasa_workspace_bytes`` a replica), or None without LCPO
    advance.sasa_lists = ("global" if lists_global else "shared") if use_sasa else None
    advance.sasa_workspace_bytes = sasa_list_bytes(n_sasa) if lists_global else 0
    #: build facts of that instantiation on the current CUDA device
    #: (``_build.kernel_info``): registers, shared bytes, threads and CTAs an SM
    advance.kernel_info = lambda: {
        "instantiation": advance.instantiation, "gb_cached": advance.gb_cached,
        "sasa_lists": advance.sasa_lists,
        "sasa_workspace_bytes_per_replica": advance.sasa_workspace_bytes,
        **kernel_info("campaign_advance", "mdx_campaign_kernel_info",
                      [ctypes.c_void_p], dims())}
    advance.tables = tab
    #: keyword arguments that make campaign_advance_reference this op
    advance.settings = settings
    return advance
