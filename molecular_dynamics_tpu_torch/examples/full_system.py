"""Packaged full-representation example systems (npz fixtures).

``decaalanine_full()`` — the 104-atom all-atom deca-alanine (chamber prmtop
path). ``dialanine()`` — the 22-atom AMBER di-alanine side case. The ``.npz``
files under ``data/`` are this package's own copies. ``tiled_decaalanine(m)``
— ``m`` far-apart copies of the 104-atom system as one, the system-size
surface.
"""

from __future__ import annotations

import pathlib
from typing import Tuple

import numpy as np
import torch

from molecular_dynamics_tpu_torch.convert import (
    FF_ARRAY_FIELDS,
    ff_params_from_numpy,
    resolve_device,
)
from molecular_dynamics_tpu_torch.ff.params import FFParams, tile_ff_params
from molecular_dynamics_tpu_torch.solvent import attach_gb_params, infer_elements

_DATA = pathlib.Path(__file__).parent / "data"


def _load(name: str, dtype=None, device=None) -> Tuple[FFParams, np.ndarray, dict]:
    if dtype is None:
        dtype = torch.float32
    path = _DATA / f"{name}.npz"
    if not path.exists():
        raise FileNotFoundError(f"{path} missing from the package data")
    with np.load(path, allow_pickle=False) as raw:
        leaves = {k: raw[f"ff_{k}"] for k in FF_ARRAY_FIELDS}
        meta = {
            k: raw[k]
            for k in ("atom_names", "atom_types", "res_ids", "res_names")
        }
        coords = raw["coords"]
    ff = ff_params_from_numpy(leaves, device=resolve_device(device), dtype=dtype)
    ff = attach_gb_params(
        ff, elements=infer_elements(leaves["masses"], meta["atom_names"])
    )
    return ff, coords, meta


def decaalanine_full(dtype=None, device=None) -> Tuple[FFParams, np.ndarray, dict]:
    """104-atom all-atom deca-alanine: (FFParams, start coords, metadata)."""
    return _load("full_da", dtype, device)


def dialanine(dtype=None, device=None) -> Tuple[FFParams, np.ndarray, dict]:
    """22-atom AMBER di-alanine: (FFParams, start coords, metadata)."""
    return _load("diala", dtype, device)


def tiled_decaalanine(
    m: int, spacing: float = 50.0, dtype=None, device=None
) -> Tuple[FFParams, np.ndarray, dict]:
    """``m`` non-bonded copies of the 104-atom deca-alanine as ONE system.

    Copies are spaced ``spacing`` A apart along x, so with a finite cutoff
    the composite energy is ``m`` times the single copy's: an exact oracle
    at ``m``-fold atom count (``ff.params.tile_ff_params``).
    """
    ff, coords, meta = decaalanine_full(dtype, device)
    big = tile_ff_params(ff, m)
    shifted = np.concatenate([
        np.asarray(coords) + np.array([k * spacing, 0.0, 0.0], coords.dtype)
        for k in range(m)
    ])
    meta = dict(meta)
    for k in ("atom_names", "atom_types", "res_names"):
        meta[k] = list(meta[k]) * m
    rid = np.asarray(meta["res_ids"])
    span = int(rid.max()) + 1 if rid.size else 1
    meta["res_ids"] = np.concatenate([rid + k * span for k in range(m)])
    meta["tiled_copies"] = m
    return big, shifted, meta
