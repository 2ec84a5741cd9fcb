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


#: flax scope names -> the port's attribute names: numbered flax modules
#: sit in a ``ModuleList`` under the attribute (``Dense_i`` -> ``layers.i``,
#: ``OptimizedLSTMCell_i`` -> ``lstm.i``, ``EncoderBlock_i`` -> ``blocks.i``,
#: ...), the one ``MLP_0`` of an HNN and the one ``Embed_0`` of a SchNet are
#: attributes of their own; any other scope (``ae``, ``encoder``, ``hnn``,
#: a ``SelfAttention``'s ``query`` ...) keeps its name
_LISTS = {"Dense": "layers", "CfConv": "cfconv", "OptimizedLSTMCell": "lstm",
          "SelfAttention": "attention", "LayerNorm": "norms", "EncoderBlock": "blocks",
          "DenseGATLayer": "gat"}
_SINGLES = {"MLP_0": "mlp", "Embed_0": "embed"}
#: an ``OptimizedLSTMCell``'s gate scopes, in ``LSTMLayer``'s row order
_LSTM_INPUT = ("ii", "if", "ig", "io")
_LSTM_HIDDEN = ("hi", "hf", "hg", "ho")


def _leaves(kind: str, leaf: Mapping) -> dict:
    """One flax leaf scope of ``kind`` as the port's parameters (numpy)."""
    if kind == "Dense":  # (in, out) kernel -> (out, in) weight; no bias in a GAT layer
        out = {"weight": np.array(leaf["kernel"]).T.copy()}
        if "bias" in leaf:
            out["bias"] = np.array(leaf["bias"])
        return out
    if kind == "OptimizedLSTMCell":
        return {"weight_ih": np.concatenate([np.array(leaf[g]["kernel"]).T for g in _LSTM_INPUT]),
                "weight_hh": np.concatenate([np.array(leaf[g]["kernel"]).T for g in _LSTM_HIDDEN]),
                "bias": np.concatenate([np.array(leaf[g]["bias"]) for g in _LSTM_HIDDEN])}
    if kind == "LayerNorm":
        return {"weight": np.array(leaf["scale"]), "bias": np.array(leaf["bias"])}
    return {"weight": np.array(leaf["embedding"])}  # Embed


def flax_params_to_state_dict(params: Mapping, dtype=None) -> dict:
    """A flax params tree, as numpy arrays (``{"params": {...}}``, nested
    scopes at any depth), as the ``state_dict`` of the port module with the
    same structure. ``layers.i.weight`` is ``Dense_i``'s kernel transposed,
    ``(out, in)``; ``lstm.i`` holds an ``OptimizedLSTMCell``'s eight
    kernels and four biases as ``LSTMLayer``'s ``weight_ih``, ``weight_hh``
    and ``bias``; ``norms.i.weight`` is a ``LayerNorm``'s scale; an ``Embed``
    table is ``embed.weight``; any other array (a ``DenseGeneral`` kernel,
    ``pos_embed``) is taken as it is. CPU tensors; ``load_state_dict``
    copies them onto the module's device."""
    out = {}

    def tensor(arr):
        x = torch.as_tensor(np.array(arr))
        return x if dtype is None else x.to(dtype)

    def walk(tree, prefix):
        for name, leaf in tree.items():
            kind, _, index = name.rpartition("_")
            if name == "Embed_0" or (kind in ("Dense", "OptimizedLSTMCell", "LayerNorm")
                                     and index.isdigit()):
                where = "embed" if name == "Embed_0" else f"{_LISTS[kind]}.{index}"
                for key, arr in _leaves(kind or "Embed", leaf).items():
                    out[f"{prefix}{where}.{key}"] = tensor(arr)
            elif kind in _LISTS and index.isdigit():
                walk(leaf, f"{prefix}{_LISTS[kind]}.{index}.")
            elif isinstance(leaf, Mapping):
                walk(leaf, f"{prefix}{_SINGLES.get(name, name)}.")
            else:
                out[f"{prefix}{name}"] = tensor(leaf)

    walk(params.get("params", params), "")
    return out


def state_dict_to_flax_params(state_dict: Mapping) -> dict:
    """The inverse of ``flax_params_to_state_dict``: numpy arrays in flax's
    layout, ``{"params": {...}}`` with the same nested scopes."""
    names = {v: k for k, v in _SINGLES.items()}
    lists = {v: k for k, v in _LISTS.items()}
    tree = {}
    for key, value in state_dict.items():
        parts = key.split(".")
        arr = value.detach().cpu().numpy()
        node, kind, i = tree, "", 0
        while i < len(parts) - 1:
            part = parts[i]
            if part in lists and parts[i + 1].isdigit():
                kind = lists[part]
                node, i = node.setdefault(f"{kind}_{parts[i + 1]}", {}), i + 2
            else:
                kind = "Embed" if part == "embed" else ""
                node, i = node.setdefault(names.get(part, part), {}), i + 1
        leaf = parts[-1]
        if kind == "Dense" and leaf == "weight":
            node["kernel"] = arr.T.copy()
        elif kind == "Dense":
            node["bias"] = arr.copy()
        elif kind == "OptimizedLSTMCell":
            gates = _LSTM_INPUT if leaf == "weight_ih" else _LSTM_HIDDEN
            for gate, rows in zip(gates, np.split(arr, 4)):
                node.setdefault(gate, {})["bias" if leaf == "bias" else "kernel"] = (
                    rows.copy() if leaf == "bias" else rows.T.copy())
        elif kind == "LayerNorm":
            node["scale" if leaf == "weight" else "bias"] = arr.copy()
        elif kind == "Embed":
            node["embedding"] = arr.copy()
        else:
            node[leaf] = arr.copy()
    return {"params": tree}
