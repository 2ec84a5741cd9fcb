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


#: the leaves of the port's parameters of each flax kind that sits in a list
#: (a Dense without bias is a GAT layer's)
_KIND_LEAVES = {"Dense": ({"weight", "bias"}, {"weight"}), "LayerNorm": ({"weight", "bias"},),
                "OptimizedLSTMCell": ({"weight_ih", "weight_hh", "bias"},)}


def _named_dense(leaf) -> bool:
    """A scope holding a 2-D ``kernel`` (and a ``bias``): a ``Dense`` that a
    module names itself (``mu_head``, ``readout``, a CDE's ``embed``), as
    opposed to a ``DenseGeneral``, whose kernels are 3-D."""
    return (isinstance(leaf, Mapping) and set(leaf) in ({"kernel"}, {"kernel", "bias"})
            and np.ndim(leaf["kernel"]) == 2)


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
    ``(out, in)``, and so is the weight of a ``Dense`` a module names itself
    (``mu_head.weight``); ``lstm.i`` holds an ``OptimizedLSTMCell``'s eight
    kernels and four biases as ``LSTMLayer``'s ``weight_ih``, ``weight_hh``
    and ``bias``; ``norms.i.weight`` is a ``LayerNorm``'s scale; an ``Embed``
    table is ``embed.weight``; the ``i``-th module of a list a flax module
    sets up (``couplings_i``, ``norms_i``) is ``couplings.i``; any other
    array (a ``DenseGeneral`` kernel, ``pos_embed``, an ActNorm's
    ``log_scale``) is taken as it is. CPU tensors; ``load_state_dict``
    copies them onto the module's device."""
    out = {}

    def tensor(arr):
        x = torch.as_tensor(np.array(arr))
        return x if dtype is None else x.to(dtype)

    def put(where, kind, leaf):
        for key, arr in _leaves(kind, leaf).items():
            out[f"{where}.{key}"] = tensor(arr)

    def walk(tree, prefix):
        for name, leaf in tree.items():
            kind, _, index = name.rpartition("_")
            if name == "Embed_0" or (kind in ("Dense", "OptimizedLSTMCell", "LayerNorm")
                                     and index.isdigit()):
                where = "embed" if name == "Embed_0" else f"{_LISTS[kind]}.{index}"
                put(prefix + where, kind or "Embed", leaf)
            elif kind in _LISTS and index.isdigit():
                walk(leaf, f"{prefix}{_LISTS[kind]}.{index}.")
            elif index.isdigit() and kind[:1].islower() and isinstance(leaf, Mapping):
                walk(leaf, f"{prefix}{kind}.{index}.")  # a list the module sets up
            elif _named_dense(leaf):
                put(prefix + name, "Dense", leaf)
            elif isinstance(leaf, Mapping):
                walk(leaf, f"{prefix}{_SINGLES.get(name, name)}.")
            else:
                out[f"{prefix}{name}"] = tensor(leaf)

    walk(params.get("params", params), "")
    return out


def _flax_kind(part: str, leaves: set, last: bool) -> str:
    """The flax kind of the port scope ``part`` (a list's name, or the name
    of a scope) whose parameters are ``leaves``; "" where the scope keeps
    its name. A list name's kind holds only where the leaves are that
    kind's: a ``norms`` list of ActNorms is not one of LayerNorms."""
    kind = {v: k for k, v in _LISTS.items()}.get(part, "")
    if not last:
        return kind
    if kind in _KIND_LEAVES:
        return kind if leaves in _KIND_LEAVES[kind] else ""
    if part == "embed" and leaves == {"weight"}:
        return "Embed"
    return "Dense" if leaves in _KIND_LEAVES["Dense"] else ""


def state_dict_to_flax_params(state_dict: Mapping) -> dict:
    """The inverse of ``flax_params_to_state_dict``: numpy arrays in flax's
    layout, ``{"params": {...}}`` with the same nested scopes."""
    names = {v: k for k, v in _SINGLES.items()}
    groups = {}
    for key, value in state_dict.items():
        *path, leaf = key.split(".")
        groups.setdefault(tuple(path), {})[leaf] = value.detach().cpu().numpy()
    tree = {}
    for path, arrays in groups.items():
        node, kind, i = tree, "", 0
        while i < len(path):
            part = path[i]
            listed = i + 1 < len(path) and path[i + 1].isdigit()
            last = i + (2 if listed else 1) == len(path)
            kind = _flax_kind(part, set(arrays), last)
            if listed:
                scope = f"{kind or part}_{path[i + 1]}"
            else:
                scope = "Embed_0" if kind == "Embed" else (part if last else names.get(part, part))
            node, i = node.setdefault(scope, {}), i + (2 if listed else 1)
        if kind == "Dense":
            node["kernel"] = arrays["weight"].T.copy()
            if "bias" in arrays:
                node["bias"] = arrays["bias"].copy()
        elif kind == "OptimizedLSTMCell":
            for leaf, gates in (("weight_ih", _LSTM_INPUT), ("weight_hh", _LSTM_HIDDEN)):
                for gate, rows in zip(gates, np.split(arrays[leaf], 4)):
                    node.setdefault(gate, {})["kernel"] = rows.T.copy()
            for gate, rows in zip(_LSTM_HIDDEN, np.split(arrays["bias"], 4)):
                node[gate]["bias"] = rows.copy()
        elif kind == "LayerNorm":
            node["scale"], node["bias"] = arrays["weight"].copy(), arrays["bias"].copy()
        elif kind == "Embed":
            node["embedding"] = arrays["weight"].copy()
        else:
            for leaf, arr in arrays.items():
                node[leaf] = arr.copy()
    return {"params": tree}
