"""Pair terms, each unordered pair once: the standalone pair kernel (B2) and
the ring pair-terms op (B6).

``pair_forces(pos, tables, ...)`` covers reaction-field Coulomb + cubic-
switched LJ 12-6 under the cutoff mask, harmonic bonds / Urey-Bradley
springs and the pre-scaled 1-4 LJ + Coulomb in one pass, with analytic
forces. Same physics and tables as ``energy.energy_terms`` evaluates through
autograd; parity between the two is pinned by tests.

``make_pair_ring_op(ff, ...)`` returns the differentiable op of
``ops.nonbonded.make_nonbonded_op``'s contract whose forward, on a CUDA
tensor, is ``pair_tiles``. The JAX op's ``shift_chunk``, ``MDX_RING_CHUNK``,
``block_r`` and its split into a monolithic and a chunked kernel exist to
bound Mosaic's compile time on a TPU; nvcc has no such limit, so none of
them is carried over.

Kernel notes.

- ``pair_forces`` launches ``csrc/pair_forces.cu`` (CUDA C++, sm_90a), the
  standalone launch of the campaign kernel's pair loop
  (``csrc/pair_loop.cuh``). It replaces the JAX package's
  ``molecular_dynamics_tpu/ops/ring.py`` ``ring_pair_forces`` (the lane
  padding and the dense tables stay behind: they suit the TPU's lanes and
  matrix unit, not a GPU). One CTA per replica in the campaign kernel's
  shape (128, 512 or 1024 threads by size, up to 2,048 atoms), coordinates
  in shared memory, each unordered pair once: 32-atom chunks met warp by
  warp with the partner's force accumulator rotating through the lanes,
  chunk pairs whose bounding boxes lie beyond the cutoff skipped, the
  exclusion bit and the cutoff tested before any parameter is read,
  parameters from per-atom arrays (``nonbonded.pair_layout``), special
  pairs from per-atom lists; every atom's sum in a fixed order (no
  atomics).
- ``pair_tiles`` launches ``csrc/pair_tiles.cu``. It replaces the JAX
  package's ``make_pair_ring_op`` -> ``_ring_kernel`` / ``_ring_chunk_kernel``:
  every unordered pair evaluated once. On an H100 the pair arithmetic
  bounds it. The design: the pair loop's tasks (``csrc/pair_loop.cuh``, on
  the same per-atom layout, with the same box test) split into groups, the
  chunks into tiles of ``TILE_CHUNKS`` and a CTA per (replica, pair of tiles
  A <= B), so that a replica's work spreads over several CTAs and any N fits;
  a group whose chunk pairs all lie beyond the cutoff writes only its flag,
  the others their atoms' partial forces and a partial energy, and a second
  pass sums each atom's partials in a fixed order: no atomics,
  bit-reproducible. With one group (up to four chunks, 128 atoms) the CTA
  writes the result itself.

The plain PyTorch version of both is ``ops.nonbonded.dense_pair_math``: it
runs for a CPU tensor, and it is what the kernels are held against on the
card.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from molecular_dynamics_tpu_torch import units
from molecular_dynamics_tpu_torch.ff.params import FFParams
from molecular_dynamics_tpu_torch.ops._build import kernel_function
from molecular_dynamics_tpu_torch.ops.nonbonded import (
    PAIR_LOOP_MAX_ATOMS,
    PairTables,
    check_pair_kernel_inputs,
    chunk_count,
    dense_pair_math,
    make_pair_op,
    pair_constants,
)

Tensor = torch.Tensor

#: chunks a tile of the pair-tile kernel holds (csrc/pair_tiles.cu
#: kTileChunks; the wrapper sizes its scratch by what the library reports)
TILE_CHUNKS = 4


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
    n_rep, n = check_pair_kernel_inputs(pos, tables)
    if n > PAIR_LOOP_MAX_ATOMS:
        raise ValueError(f"pair_forces: {n} atoms; the kernel holds {PAIR_LOOP_MAX_ATOMS}")
    consts = pair_constants(cutoff, switch_dist, rfa, solvent_dielectric)
    fn = kernel_function(
        "pair_forces", "mdx_pair_forces",
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_float] * 5 + [ctypes.c_void_p],
    )
    forces = torch.empty_like(pos)
    energy = torch.empty(n_rep, dtype=torch.float32, device=pos.device)
    with torch.cuda.device(pos.device):
        err = fn(
            pos.data_ptr(), forces.data_ptr(), energy.data_ptr(),
            tables.layout_pointers, tables.n_lj_types, n_rep, n, *consts,
            torch.cuda.current_stream().cuda_stream,
        )
    pair_forces.launches += 1
    if err != 0:
        raise RuntimeError(f"pair_forces kernel launch failed: CUDA error {err}")
    return energy, forces


#: launches of the CUDA kernel made by this process
pair_forces.launches = 0


def tile_pair_count(n_atoms: int) -> int:
    """Groups (pairs of tiles A <= B of ``TILE_CHUNKS`` chunks) the pair-tile
    kernel runs a replica."""
    n_tiles = (chunk_count(n_atoms) + TILE_CHUNKS - 1) // TILE_CHUNKS
    return n_tiles * (n_tiles + 1) // 2


def pair_tiles(pos: Tensor, tables: PairTables, consts) -> Tuple[Tensor, Tensor]:
    """``pos (R, N, 3) -> (energy (R,), forces (R, N, 3))`` over every 2-body
    term in ``tables``, each unordered pair once; ``consts`` from
    :func:`pair_constants`.

    A CUDA tensor goes through the pair-tile kernel (float32, contiguous, or
    it raises; the launch is counted in ``pair_tiles.launches``); a CPU
    tensor takes :func:`dense_pair_math`. Not differentiable: the op of
    :func:`make_pair_ring_op` is.
    """
    if not pos.is_cuda:
        return dense_pair_math(pos, tables.dense, consts)
    n_rep, n = check_pair_kernel_inputs(pos, tables)
    # groups a replica and floats a group of the built kernel's scratch
    sizes = (ctypes.c_int * 2)()
    kernel_function("pair_tiles", "mdx_pair_tiles_scratch", [ctypes.c_int, ctypes.c_void_p])(
        n, sizes)
    n_groups, group_floats = sizes
    fn = kernel_function(
        "pair_tiles", "mdx_pair_tiles",
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_float] * 5 + [ctypes.c_void_p],
    )
    dev = pos.device
    forces = torch.empty_like(pos)
    energy = torch.empty(n_rep, dtype=torch.float32, device=dev)
    scratch, parts = None, (None, None, None)  # one group writes the result itself
    if n_groups > 1:
        # every group's partial forces (tile A's, then tile B's), then every
        # group's energy, then whether it met a pair (int32), in one buffer
        cells = n_rep * n_groups
        scratch = torch.empty(cells * (group_floats + 2), dtype=torch.float32, device=dev)
        base = scratch.data_ptr()
        parts = (base, base + 4 * cells * group_floats, base + 4 * cells * (group_floats + 1))
    with torch.cuda.device(dev):
        err = fn(
            pos.data_ptr(), forces.data_ptr(), energy.data_ptr(), *parts,
            tables.layout_pointers, tables.n_lj_types, n_rep, n, *consts,
            torch.cuda.current_stream().cuda_stream,
        )
    pair_tiles.launches += 1
    if err != 0:
        raise RuntimeError(f"pair_tiles kernel launch failed: CUDA error {err}")
    return energy, forces


#: launches of the CUDA kernel made by this process
pair_tiles.launches = 0


def make_pair_ring_op(
    ff: FFParams,
    cutoff: Optional[float] = 9.0,
    switch_dist: Optional[float] = 7.5,
    rfa: bool = True,
    solvent_dielectric: float = units.SOLVENT_DIELECTRIC,
    include_bonds: bool = True,
    include_14: bool = True,
    include_ub=None,  # None -> auto: on iff ff carries UB springs
):
    """Each-pair-once variant of ``ops.nonbonded.make_nonbonded_op`` (same
    contract, same backward): the forward is the pair-tile kernel on a CUDA
    tensor (float32, or it raises) and ``dense_pair_math`` on a CPU tensor.
    """
    return make_pair_op(
        ff, pair_tiles, cutoff, switch_dist, rfa, solvent_dielectric,
        include_bonds, include_14, include_ub,
    )
