"""Dense pair tables, the dense pair math, and the dense pair-terms op (B5).

One ``(N, N)`` float32 table per parameter, symmetric, unpadded:
``qq, lj_a, lj_b, mask, k_bond, d0_bond, a14, b14, qq14``. The plain
versions of the pair kernels (``ops.nonbonded``, ``ops.ring``,
``ops.fused_step``) read these; the kernels read the per-atom layout built
from them (:func:`pair_layout`).

- ``mask`` is the symmetrised ``nb_mask`` (``FFParams`` stores i<j only).
- Harmonic bonds and Urey-Bradley 1-3 springs share the ``k``/``d0`` tables;
  a pair that carries both is refused, because one slot cannot hold two
  springs.
- 1-4 parameters are pre-scaled by ``scnb``/``scee``; duplicate 1-4 pairs
  accumulate, identical to summing per-pair energies.

``make_nonbonded_op(ff, ...)`` returns ``pair_terms(pos (R, N, 3)) ->
(energy (R,), forces (R, N, 3))`` over every 2-body term (reaction-field
Coulomb + switched LJ under the cutoff, bonds / Urey-Bradley, pre-scaled
1-4), differentiable: its backward is autograd of the PyTorch energy of the
same terms (``pair_terms.reference_energy``), a Hessian-vector product for
the forces' cotangent. ``ops.ring.make_pair_ring_op`` has the same contract.

Kernel note. On a CUDA tensor the op's forward is ``nonbonded_rows``, which
launches ``csrc/nonbonded_rows.cu`` (CUDA C++, sm_90a). It replaces the JAX
package's ``molecular_dynamics_tpu/ops/nonbonded.py`` ``make_nonbonded_op``
-> ``_kernel`` -> ``dense_pair_forces``: the dense pass, every pair
evaluated from both ends. Its lane padding, the ``block_r`` replica blocks,
the ``interpret`` switch and the dense (N, N) tables stay behind: the kernel
reads the per-atom layout of :func:`pair_layout`, as the campaign and
pair-forces kernels do. On an H100 the pair arithmetic bounds it. The
design: one launch, a CTA per (replica, four 32-atom row chunks), the
replica's coordinates and every chunk's bounding box in shared memory, a
lane per row atom walking the column chunks in order, skipping those whose
box lies beyond the cutoff from its chunk's, its exclusion bit and the
cutoff tested before a parameter is read, then its special pairs; each atom
summed from its own end in a fixed order (no partial buffer, no atomics,
bit-reproducible), per-row half energies summed outside the kernel as the
JAX op does. It holds up to 18,230 atoms (coordinates and boxes in the
shared memory a CTA may opt in to, ``nonbonded_rows_shared_bytes``).

``dense_pair_math`` is the plain PyTorch version of that function (and of
``ops.ring``'s kernels): it runs for CPU tensors and is what the kernels are
held against on the card.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from molecular_dynamics_tpu_torch import units
from molecular_dynamics_tpu_torch.energy import EnergyConfig, _neg_grad, energy_terms
from molecular_dynamics_tpu_torch.ff.params import FFParams
from molecular_dynamics_tpu_torch.ops._build import SHARED_OPT_IN_BYTES, kernel_function

Tensor = torch.Tensor

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


#: atoms a chunk of the pair kernels' loop holds: a warp's lanes
#: (csrc/pair_loop.cuh)
CHUNK = 32

#: order of the per-atom pair layout's arrays (struct PairLayout in
#: csrc/pair_loop.cuh): LJ type and scaled charge per atom, the (T, T, 2) LJ
#: table, the (N, chunks) exclusion words, the special pairs and their
#: per-atom lists
PAIR_LAYOUT_SLOTS = (
    "lj_type", "lj_table", "charge", "excl",
    "sp_idx", "sp_a", "sp_b", "sp_c", "sp_start", "sp_src",
)


@dataclasses.dataclass(frozen=True)
class PairTables:
    """The 2-body tables of one system on one device.

    ``dense`` (9, N, N) float32 in ``PAIR_TABLE_NAMES`` order is what the
    plain version reads; ``charges`` (N,) the system's partial charges.
    ``layout`` (name -> tensor, ``PAIR_LAYOUT_SLOTS``) is the per-atom layout
    every pair kernel reads (:func:`pair_layout`), built on first use: only
    their launches read it.
    """

    dense: Tensor
    charges: Tensor

    @functools.cached_property
    def layout(self) -> dict:
        return {
            k: torch.as_tensor(np.ascontiguousarray(v), device=self.dense.device)
            for k, v in pair_layout(self.charges, self.dense.cpu().numpy()).items()
        }

    @functools.cached_property
    def layout_pointers(self):
        """The device pointers of ``layout`` in ``PAIR_LAYOUT_SLOTS`` order,
        as the C array the pair kernels take."""
        return (ctypes.c_void_p * len(PAIR_LAYOUT_SLOTS))(
            *[self.layout[k].data_ptr() for k in PAIR_LAYOUT_SLOTS])

    @property
    def n_lj_types(self) -> int:
        return int(self.layout["lj_table"].shape[0])

    @property
    def n_special(self) -> int:
        return int(self.layout["sp_idx"].shape[0])


def chunk_count(n_atoms: int) -> int:
    """Chunks the pair loop cuts a replica into: one a 32 atoms or part."""
    return (n_atoms + CHUNK - 1) // CHUNK


def chunk_size(n_atoms: int) -> int:
    """Atoms a chunk of the pair loop (at most ``CHUNK``; the chunks as even
    as that allows: 104 atoms make 4 chunks of 26)."""
    n_chunks = chunk_count(n_atoms)
    return (n_atoms + n_chunks - 1) // n_chunks


def csr_lists(n_atoms: int, atoms: np.ndarray, src: np.ndarray, weights: np.ndarray):
    """Per-atom gather lists: for atom a, entries ``start[a]:start[a+1]`` of
    ``(src, w)`` say which buffered 3-vectors it sums and with what weight.
    A stable sort keeps each atom's entries in the order given."""
    order = np.argsort(atoms, kind="stable")
    start = np.zeros(n_atoms + 1, np.int32)
    np.cumsum(np.bincount(atoms, minlength=n_atoms), out=start[1:])
    return start, src[order].astype(np.int32), weights[order].astype(np.float32)


def lj_types(aa: np.ndarray, bb: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Factor the symmetric LJ tables into a type a atom and a (T, T, 2)
    table of ``(lj_a, lj_b)`` such that every off-diagonal entry is the same
    float32 number: ``table[t[i], t[j]] == (aa[i, j], bb[i, j])``. Two atoms
    share a type when their rows agree everywhere but at each other and at
    themselves. Raises ``ValueError`` if the tables do not factor."""
    n = aa.shape[0]
    idx = np.arange(n)
    reps, types = [], np.empty(n, np.int32)
    for i in range(n):
        for t, r in enumerate(reps):
            keep = (idx != i) & (idx != r)
            if np.array_equal(aa[i, keep], aa[r, keep]) and np.array_equal(bb[i, keep], bb[r, keep]):
                types[i] = t
                break
        else:
            types[i] = len(reps)
            reps.append(i)
    table = np.zeros((len(reps), len(reps), 2), np.float32)
    off = ~np.eye(n, dtype=bool)
    ti, tj = np.broadcast_arrays(types[:, None], types[None, :])
    table[ti[off], tj[off], 0] = aa[off]
    table[ti[off], tj[off], 1] = bb[off]
    full = table[ti, tj]
    if not (np.array_equal(full[..., 0][off], aa[off]) and np.array_equal(full[..., 1][off], bb[off])):
        raise ValueError("the LJ pair tables do not factor into per-atom types")
    return types, table


def pair_layout(charges, dense: np.ndarray) -> dict:
    """The per-atom layout every pair kernel reads (``csrc/pair_loop.cuh``),
    as numpy arrays in ``PAIR_LAYOUT_SLOTS`` order, from a system's partial
    charges and its nine dense tables ``dense``:

    - ``lj_type`` (N,) int32 and ``lj_table`` (T, T, 2): :func:`lj_types`;
    - ``charge`` (N,): q sqrt(ELEC_FACTOR) in float32, so that the product of
      two is the pair's ``qq`` to float32 rounding (``qq_pair`` is not
      exactly a product, ROADMAP C1; raises where it is not one at all);
    - ``excl`` (N, chunks) uint32 as int32: bit t of word [i, J] set where
      the pair (i, C J + t), C = :func:`chunk_size`, does not go through the
      plain pair loop: itself, past the chunk or the end, excluded (mask 0)
      or special;
    - the special pairs (a bond, Urey-Bradley or 1-4 entry), i < j in
      row-major order: ``sp_idx`` (S, 2), ``sp_a`` (S, 4) = (qq, lj_a, lj_b,
      mask), ``sp_b`` (S, 4) = (k_bond, d0, a14, b14), ``sp_c`` (S,) = qq14,
      the dense tables' own numbers; and per-atom lists ``sp_start``,
      ``sp_src`` of the special pairs each atom is part of, in that order
      (the kernels evaluate a special pair from both of its ends).
    """
    qq, aa, bb, msym, kb, d0, a14, b14, qq14 = dense
    n = qq.shape[0]
    types, table = lj_types(aa, bb)
    charge = (_np(charges).astype(np.float64) * np.sqrt(units.ELEC_FACTOR)).astype(np.float32)
    off = ~np.eye(n, dtype=bool)
    prod = charge[:, None] * charge[None, :]
    if n > 1 and np.max(np.abs(prod - qq)[off]) > 1e-5 * max(1.0, float(np.max(np.abs(qq)))):
        raise ValueError("qq_pair is not the product of the charges times ELEC_FACTOR")

    special = (kb > 0) | (a14 != 0) | (b14 != 0) | (qq14 != 0)
    cols = np.arange(chunk_count(n))[:, None] * chunk_size(n) + np.arange(CHUNK)
    inside = (np.arange(CHUNK) < chunk_size(n)) & (cols < n)
    skip = ~inside | ((msym == 0) | special | ~off)[:, np.minimum(cols, n - 1)]
    bits = skip.astype(np.uint64) << np.arange(CHUNK, dtype=np.uint64)
    excl = bits.sum(-1).astype(np.uint32).view(np.int32)

    i, j = np.nonzero(np.triu(special, 1))
    sp_idx = np.stack([i, j], axis=-1).astype(np.int32)
    s = np.arange(len(i))
    sp_start, sp_src, _ = csr_lists(
        n, np.concatenate([i, j]), np.concatenate([s, s]), np.ones(2 * len(i)))
    return {
        "lj_type": types, "lj_table": table, "charge": charge, "excl": excl,
        "sp_idx": sp_idx,
        "sp_a": np.stack([qq[i, j], aa[i, j], bb[i, j], msym[i, j]], axis=-1).astype(np.float32),
        "sp_b": np.stack([kb[i, j], d0[i, j], a14[i, j], b14[i, j]], axis=-1).astype(np.float32),
        "sp_c": qq14[i, j].astype(np.float32),
        "sp_start": sp_start, "sp_src": sp_src,
    }


def build_pair_tables(
    ff: FFParams, include_ub=None, include_bonds: bool = True, include_14: bool = True
) -> PairTables:
    """Tables for the pair kernels, on the device of ``ff``.
    ``include_ub=None`` takes the Urey-Bradley springs when ``ff`` has any;
    ``include_bonds=False`` zeroes the spring tables and ``include_14=False``
    the 1-4 ones."""
    dense = np.stack(_build_pair_tables(ff, include_ub))
    if not include_bonds:
        dense[[4, 5]] = 0.0
    if not include_14:
        dense[[6, 7, 8]] = 0.0
    return PairTables(dense=torch.as_tensor(dense, device=ff.device), charges=ff.charges)


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
    and their order are those of the kernels' ``pair_term``."""
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
    # == sqrt(d2) where live, 1 where masked: far beyond the cutoff (1,000 A)
    # the switch polynomial of a masked lane would leave float32's range
    d = safe * rinv

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


def check_pair_kernel_inputs(pos: Tensor, tables: PairTables) -> Tuple[int, int]:
    """Raise unless a pair kernel takes ``pos`` with ``tables`` (whose
    per-atom layout it reads); returns ``(replicas, atoms)``."""
    if pos.ndim != 3 or pos.shape[-1] != 3:
        raise ValueError(f"pos must be (R, N, 3), got {tuple(pos.shape)}")
    n_rep, n = pos.shape[0], pos.shape[1]
    check_kernel_input("pos", pos, (n_rep, n, 3))
    if tables.dense.shape[-1] != n:
        raise ValueError(f"tables hold {tables.dense.shape[-1]} atoms, pos {n}")
    if tables.dense.device != pos.device:
        raise ValueError("tables and pos live on different devices")
    return n_rep, n


#: atoms the pair loop's widest instantiation holds (csrc/pair_loop.cuh:
#: 1024 threads, two chunks a warp, whose row sums stay in registers)
PAIR_LOOP_MAX_ATOMS = 2048


def nonbonded_rows_shared_bytes(n_atoms: int) -> int:
    """Shared memory a CTA of the dense-row kernel takes
    (``csrc/nonbonded_rows.cu``): the replica's coordinates and every
    chunk's bounding box. It must fit what a CTA may opt in to: 4,096 atoms
    take 52 KB, 18,230 the most."""
    return 4 * (3 * n_atoms + 6 * chunk_count(n_atoms))


def nonbonded_rows(pos: Tensor, tables: PairTables, consts) -> Tuple[Tensor, Tensor]:
    """``pos (R, N, 3) -> (energy (R,), forces (R, N, 3))`` over every 2-body
    term in ``tables``, ``consts`` from :func:`pair_constants`.

    A CUDA tensor goes through the dense-row kernel (float32, contiguous,
    within :func:`nonbonded_rows_shared_bytes`, or it raises; the launch is
    counted in ``nonbonded_rows.launches``); a CPU tensor takes
    :func:`dense_pair_math`. Not differentiable: the op of
    :func:`make_nonbonded_op` is.
    """
    if not pos.is_cuda:
        return dense_pair_math(pos, tables.dense, consts)
    n_rep, n = check_pair_kernel_inputs(pos, tables)
    if nonbonded_rows_shared_bytes(n) > SHARED_OPT_IN_BYTES:
        raise ValueError(
            f"nonbonded_rows: {n} atoms need {nonbonded_rows_shared_bytes(n)} bytes of "
            f"shared memory a CTA; the kernel holds {SHARED_OPT_IN_BYTES}"
        )
    fn = kernel_function(
        "nonbonded_rows", "mdx_nonbonded_rows",
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_float] * 5 + [ctypes.c_void_p],
    )
    forces = torch.empty_like(pos)
    e_rows = torch.empty((n_rep, n), dtype=torch.float32, device=pos.device)
    with torch.cuda.device(pos.device):
        err = fn(
            pos.data_ptr(), forces.data_ptr(), e_rows.data_ptr(),
            tables.layout_pointers, tables.n_lj_types, n_rep, n, *consts,
            torch.cuda.current_stream().cuda_stream,
        )
    nonbonded_rows.launches += 1
    if err != 0:
        raise RuntimeError(f"nonbonded_rows kernel launch failed: CUDA error {err}")
    # the per-replica energy is the sum of the rows' half energies
    return e_rows.sum(dim=1), forces


#: launches of the CUDA kernel made by this process
nonbonded_rows.launches = 0


class _PairTerms(torch.autograd.Function):
    """Forward: a pair kernel (or its plain version). Backward: the vjp of
    the reference energy for the energy's cotangent and of the reference
    forces (a Hessian-vector product) for the forces' cotangent, as the JAX
    op's ``custom_vjp`` does."""

    @staticmethod
    def forward(ctx, pos, run, reference_energy):
        ctx.save_for_backward(pos)
        ctx.reference_energy = reference_energy
        return run(pos)

    @staticmethod
    @once_differentiable
    def backward(ctx, g_e, g_f):
        (pos,) = ctx.saved_tensors
        with torch.enable_grad():
            p = pos.detach().requires_grad_(True)
            e = ctx.reference_energy(p)
            (grad_e,) = torch.autograd.grad(e.sum(), p, create_graph=True)
            # forces = -grad_e
            total = torch.sum(g_e.to(e.dtype) * e) - torch.sum(g_f.to(grad_e.dtype) * grad_e)
            (g,) = torch.autograd.grad(total, p)
        return g, None, None


def make_pair_op(
    ff: FFParams,
    run,
    cutoff: Optional[float],
    switch_dist: Optional[float],
    rfa: bool,
    solvent_dielectric: float,
    include_bonds: bool,
    include_14: bool,
    include_ub,
):
    """``pair_terms(pos)`` around ``run(pos, tables, consts)``: the contract
    shared by :func:`make_nonbonded_op` and ``ops.ring.make_pair_ring_op``."""
    include_ub = _resolve_ub(ff, include_ub)
    tables = build_pair_tables(
        ff, include_ub=include_ub, include_bonds=include_bonds, include_14=include_14
    )
    consts = pair_constants(cutoff, switch_dist, rfa, solvent_dielectric)

    terms = ["electrostatics", "lj"]
    if include_bonds:
        terms.append("bonds")
    if include_14:
        terms += ["dihedrals", "1-4"]  # 1-4 requires dihedrals enabled
    ref_cfg = EnergyConfig(
        terms=tuple(terms), cutoff=cutoff, rfa=rfa,
        solvent_dielectric=solvent_dielectric, switch_dist=switch_dist,
        urey_bradley=include_ub,
    )

    def reference_energy(pos: Tensor) -> Tensor:
        """The same terms through ``energy.energy_terms``: ``(R,)``. The
        torsion energy itself is not part of the op, only the 1-4 pair terms
        folded into lj/electrostatics are."""
        t = energy_terms(pos, ff, config=ref_cfg)
        total = t["electrostatics"] + t["lj"]
        if include_bonds:
            total = total + t["bonds"]
        if include_ub and "urey_bradley" in t:
            total = total + t["urey_bradley"]
        return total

    def reference_forces(pos: Tensor) -> Tensor:
        """Autograd forces of :func:`reference_energy` (differentiable where
        ``pos`` requires grad)."""
        return _neg_grad(reference_energy, pos)

    def forward(pos: Tensor) -> Tuple[Tensor, Tensor]:
        return run(pos, tables, consts)

    def pair_terms(pos: Tensor) -> Tuple[Tensor, Tensor]:
        """``pos (R, N, 3) -> (energy (R,), forces (R, N, 3))``."""
        return _PairTerms.apply(pos, forward, reference_energy)

    pair_terms.reference_energy = reference_energy
    pair_terms.reference_forces = reference_forces
    pair_terms.tables = tables
    pair_terms.consts = consts
    return pair_terms


def make_nonbonded_op(
    ff: FFParams,
    cutoff: Optional[float] = 9.0,
    switch_dist: Optional[float] = 7.5,
    rfa: bool = True,
    solvent_dielectric: float = units.SOLVENT_DIELECTRIC,
    include_bonds: bool = True,
    include_14: bool = True,
    include_ub=None,  # None -> auto: on iff ff carries UB springs
):
    """Build ``pair_terms(pos (R, N, 3)) -> (energy (R,), forces (R, N, 3))``.

    Covers LJ + Coulomb plus (by default) bonds, Urey-Bradley springs and
    scaled 1-4 terms in one pass, differentiable (the backward is autograd
    of ``pair_terms.reference_energy``). ``include_bonds=False`` /
    ``include_14=False`` reduce it to fewer terms. The forward is the dense
    kernel on a CUDA tensor (float32, or it raises) and
    :func:`dense_pair_math` on a CPU tensor.
    """
    return make_pair_op(
        ff, nonbonded_rows, cutoff, switch_dist, rfa, solvent_dielectric,
        include_bonds, include_14, include_ub,
    )
