"""Configuration tree of the command line.

One dataclass tree, loadable from YAML/JSON and overridable with dotted-path
strings, over the port's ``SimulationConfig`` / ``EnergyConfig``: the same
keys and defaults as the JAX package's ``config`` (``CampaignConfig`` also
takes ``coordinates``, a PDB to start from).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

from molecular_dynamics_tpu_torch.energy import EnergyConfig
from molecular_dynamics_tpu_torch.sim import SimulationConfig


@dataclasses.dataclass
class ColvarConfig:
    """SMD colvar block: the source project's colvar dict convention. The
    default groups pull atom 0 against atom 39, the 40-atom backbone's
    ends."""

    fk: float = 1.0
    cent_0: Optional[float] = None  # None -> start at the measured colvar
    cent_1: float = 34.0
    T: float = 10000.0
    group1: tuple = (0,)
    group2: tuple = (39,)


@dataclasses.dataclass
class CampaignConfig:
    """A replica simulation campaign (the NAMD replica protocol)."""

    topology: str = ""  # psf path, or "example:backbone"/"example:full"/"example:diala"
    parameters: str = ""  # yaml path (a psf topology's force field)
    #: pdb whose (first model's) coordinates start the run; "" = the
    #: topology's own (the examples carry theirs, a psf carries none)
    coordinates: str = ""
    n_replicas: int = 50
    n_steps: int = 500_000
    save_every: int = 50
    minimize_steps: int = 500
    seed: int = 0
    out_dir: str = "out"
    #: shard the replica axis over an N-device mesh (0/1 = single device):
    #: ``parallel.get_mesh`` over the first N CUDA devices (N CPU entries with
    #: ``--device cpu``); more devices than are visible raise before any work
    devices: int = 0
    #: log the (expensive) per-term energy observables every Nth saved frame
    obs_every: int = 1
    sim: SimulationConfig = dataclasses.field(default_factory=SimulationConfig)
    colvar: Optional[ColvarConfig] = dataclasses.field(
        default_factory=ColvarConfig
    )


@dataclasses.dataclass
class TrainRunConfig:
    """A model-training run."""

    family: str = "cgan"  # cgan | pretrain | hnn | lstm | seq2seq | flow | vae
    data: str = ""  # npy glob of trajectories
    topology: str = "example:backbone"
    parameters: str = ""
    epochs: int = 10
    batch_size: int = 32
    seed: int = 0
    out_dir: str = "runs"


def _from_dict(cls, data: dict):
    """Recursively build a dataclass from a plain dict."""
    if not dataclasses.is_dataclass(cls):
        return data
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in (data or {}).items():
        if k not in fields:
            raise KeyError(f"unknown config key: {cls.__name__}.{k}")
        ftype = fields[k].type
        target = {
            "SimulationConfig": SimulationConfig,
            "EnergyConfig": EnergyConfig,
            "Optional[ColvarConfig]": ColvarConfig,
            "ColvarConfig": ColvarConfig,
        }.get(str(ftype).split(".")[-1])
        if isinstance(v, dict) and target is not None:
            if target is SimulationConfig and "energy" in v:
                v = dict(v)
                v["energy"] = EnergyConfig(**{
                    **v["energy"],
                    "terms": tuple(v["energy"].get("terms", EnergyConfig().terms)),
                })
            kwargs[k] = target(**v) if not dataclasses.is_dataclass(v) else v
        elif isinstance(v, list):
            kwargs[k] = tuple(v)
        else:
            kwargs[k] = v
    return cls(**kwargs)


def load_config(path: str, cls=CampaignConfig):
    """Load a YAML or JSON config file into a dataclass tree (a ``.json``
    file needs no YAML parser)."""
    with open(path) as fh:
        if path.endswith(".json"):
            data = json.load(fh)
        else:
            import yaml

            data = yaml.safe_load(fh)
    return _from_dict(cls, data)


def apply_overrides(cfg, overrides):
    """Apply ``a.b.c=value`` dotted overrides to a dataclass tree; each value
    is parsed as YAML (``1.0``, ``true``, ``[103]``), else kept as text.
    Frozen nodes (``SimulationConfig``, ``EnergyConfig``) are rebuilt with
    ``dataclasses.replace`` up to the first mutable parent."""
    import yaml

    for ov in overrides:
        path, _, raw = ov.partition("=")
        try:
            value = yaml.safe_load(raw)
        except Exception:
            value = raw
        parts = path.split(".")
        node_path = []
        node = cfg
        for p in parts[:-1]:
            node_path.append((node, p))
            node = getattr(node, p)
        leaf = parts[-1]
        if dataclasses.is_dataclass(node) and getattr(
            type(node), "__dataclass_params__"
        ).frozen:
            node = dataclasses.replace(node, **{leaf: value})
            for parent, name in reversed(node_path):
                if dataclasses.is_dataclass(parent) and getattr(
                    type(parent), "__dataclass_params__"
                ).frozen:
                    node = dataclasses.replace(parent, **{name: node})
                else:
                    setattr(parent, name, node)
                    node = parent
                    break
            else:
                cfg = node
        else:
            setattr(node, leaf, value)
    return cfg
