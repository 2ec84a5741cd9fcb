"""Numpy arrays into the port's objects.

The port never imports the JAX package, so whatever crosses between the two
(force-field tables, an MD state, a bias, a constraint set, a model's
weights) crosses as numpy arrays: the caller pulls the leaves out of the
JAX objects with ``np.asarray`` and hands them over here.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from molecular_dynamics_tpu_torch.ff.params import BOOL_FIELDS, INT_FIELDS, FFParams

#: the FFParams fields every system carries (the optional GB/CMAP tables are
#: taken too when the mapping holds them)
FF_ARRAY_FIELDS = (
    "masses", "charges", "bonds", "bond_params", "angles", "angle_params",
    "dihedrals", "dihedral_params", "dihedral_term_mask", "impropers",
    "improper_params", "improper_term_mask", "idx14", "nb14_params",
    "lj_a_pair", "lj_b_pair", "qq_pair", "nb_mask", "ub_bonds", "ub_params",
)
_FF_OPTIONAL_FIELDS = (
    "gb_radii", "gb_screen", "sasa_radii", "sasa_params",
    "cmap_idx", "cmap_grid_id", "cmap_coeffs",
)


def resolve_device(device) -> torch.device:
    """``None`` means the CUDA device: entry points run on the card unless
    the caller asks for the CPU."""
    return torch.device("cuda" if device is None else device)


def ff_params_from_numpy(
    arrays: Mapping[str, np.ndarray], device=None, dtype=torch.float32
) -> FFParams:
    """Build ``FFParams`` from a mapping of field name -> numpy array."""
    device = resolve_device(device)
    leaves = {}
    for name in FF_ARRAY_FIELDS + _FF_OPTIONAL_FIELDS:
        if name not in arrays or arrays[name] is None:
            if name in FF_ARRAY_FIELDS:
                raise KeyError(f"FFParams field {name!r} missing")
            continue
        arr = np.asarray(arrays[name])
        if name in INT_FIELDS:
            leaves[name] = torch.as_tensor(arr.astype(np.int64), device=device)
        elif name in BOOL_FIELDS:
            leaves[name] = torch.as_tensor(arr.astype(bool), device=device)
        else:
            leaves[name] = torch.as_tensor(
                arr.astype(np.float64), device=device
            ).to(dtype)
    return FFParams(**leaves)


def state_from_numpy(
    pos: np.ndarray,
    vel: Optional[np.ndarray] = None,
    forces: Optional[np.ndarray] = None,
    box: Optional[np.ndarray] = None,
    step=0,
    key=0,
    device=None,
    dtype=torch.float32,
):
    """Build an ``MDState`` (single system or ``(R, N, 3)`` ensemble).

    ``key`` is the port's thermostat seed (an integer, or one per replica);
    a JAX PRNG key has no counterpart and is not carried across.
    """
    from molecular_dynamics_tpu_torch.system import MDState

    device = resolve_device(device)

    def f(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=device).to(dtype)

    pos_t = f(pos)
    batch = pos_t.shape[:-2]
    box_t = (
        torch.zeros(batch + (3,), device=device, dtype=dtype)
        if box is None else f(box)
    )

    def i64(a):
        t = torch.as_tensor(np.asarray(a, np.int64), device=device)
        return t.expand(batch).clone() if t.ndim == 0 and batch else t

    return MDState(
        pos=pos_t,
        vel=torch.zeros_like(pos_t) if vel is None else f(vel),
        forces=torch.zeros_like(pos_t) if forces is None else f(forces),
        box=box_t,
        key=i64(key),
        step=i64(step),
    )


def bias_from_numpy(arrays: Mapping[str, np.ndarray], device=None, dtype=torch.float32):
    """Build a ``HarmonicSMDBias`` from its six leaves (``fk``, ``cent_0``,
    ``cent_1``, ``T``, ``group1_w``, ``group2_w``)."""
    from molecular_dynamics_tpu_torch.bias import HarmonicSMDBias

    device = resolve_device(device)
    return HarmonicSMDBias(
        **{
            k: torch.as_tensor(
                np.asarray(arrays[k], np.float64), device=device
            ).to(dtype)
            for k in ("fk", "cent_0", "cent_1", "T", "group1_w", "group2_w")
        }
    )


def constraints_from_numpy(
    pairs: np.ndarray, lengths: np.ndarray, inv_mass: np.ndarray,
    device=None, dtype=torch.float32,
):
    """Build a ``Constraints`` set from pairs (C, 2), lengths (C,) and
    per-atom inverse masses (N,)."""
    from molecular_dynamics_tpu_torch.constraints import Constraints

    device = resolve_device(device)
    return Constraints(
        pairs=torch.as_tensor(np.asarray(pairs, np.int64), device=device),
        lengths=torch.as_tensor(np.asarray(lengths, np.float64), device=device).to(dtype),
        inv_mass=torch.as_tensor(np.asarray(inv_mass, np.float64), device=device).to(dtype),
    )


def flax_params_to_state_dict(params: Mapping, dtype=None) -> dict:
    """A flax dense stack's params, as numpy arrays
    (``{"params": {"Dense_i": {"kernel": (in, out), "bias": (out,)}}}``),
    as the ``state_dict`` of a port module whose layers are its ``layers``
    list (``models.MLP``, ``models.Generator``, ``models.Discriminator``):
    ``layers.i.weight`` is the kernel transposed, ``(out, in)``. CPU
    tensors; ``load_state_dict`` copies them onto the module's device."""
    tree = params.get("params", params)
    out = {}
    for name, leaf in tree.items():
        prefix, _, index = name.rpartition("_")
        if prefix != "Dense" or not index.isdigit():
            raise KeyError(f"not a flax Dense layer: {name!r}")
        kernel = torch.as_tensor(np.array(leaf["kernel"]).T.copy())
        bias = torch.as_tensor(np.array(leaf["bias"]))
        if dtype is not None:
            kernel, bias = kernel.to(dtype), bias.to(dtype)
        out[f"layers.{index}.weight"] = kernel
        out[f"layers.{index}.bias"] = bias
    return out


def state_dict_to_flax_params(state_dict: Mapping) -> dict:
    """The inverse of ``flax_params_to_state_dict``: numpy arrays in flax's
    layout, ``{"params": {"Dense_i": {"kernel", "bias"}}}``."""
    tree = {}
    for key, value in state_dict.items():
        _, index, kind = key.split(".")
        arr = value.detach().cpu().numpy()
        leaf = tree.setdefault(f"Dense_{index}", {})
        if kind == "weight":
            leaf["kernel"] = arr.T.copy()
        else:
            leaf["bias"] = arr.copy()
    return {"params": tree}
