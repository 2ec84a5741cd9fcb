"""Meshes and sharding helpers: one leading axis split over devices.

A ``Mesh`` is a list of devices and the name of the axis split over them.
Each entry holds one shard: a contiguous, equal block of the leading
(replica or batch) axis. Entries may repeat a device, so that two shards
share one card or the CPU. Work on the shards is launched on every device
before anything synchronises, so N cards run at once.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D device mesh: ``devices[k]`` holds shard k of ``axis_name``."""

    devices: Tuple[torch.device, ...]
    axis_name: str = "replica"

    def __post_init__(self):
        devices = tuple(indexed(d) for d in self.devices)
        if not devices:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices", devices)

    @property
    def size(self) -> int:
        return len(self.devices)


def indexed(device) -> torch.device:
    """``device`` as a ``torch.device``, a bare ``cuda`` as the current CUDA
    device with its index (as tensors there name it)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def visible_cuda_devices() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def get_mesh(
    n_devices: Optional[int] = None, axis_name: str = "replica", device=None
) -> Mesh:
    """A 1-D mesh over the first ``n_devices`` CUDA devices (all visible ones
    when None), or, with ``device="cpu"``, ``n_devices`` entries of the CPU
    (one when None). Asking for more CUDA devices than are visible raises
    ``ValueError`` with both counts."""
    kind = torch.device("cuda" if device is None else device).type
    if kind == "cpu":
        return Mesh((torch.device("cpu"),) * (n_devices or 1), axis_name)
    if kind != "cuda":
        raise ValueError(f"a mesh is built over cuda or cpu devices, not {kind!r}")
    visible = visible_cuda_devices()
    if n_devices is None:
        n_devices = visible
    if visible < n_devices or n_devices < 1:
        raise ValueError(
            f"requested a {n_devices}-device mesh but only {visible} CUDA devices are "
            "visible (pass device='cpu', --device cpu on the command line, for a CPU mesh)"
        )
    return Mesh(tuple(torch.device("cuda", k) for k in range(n_devices)), axis_name)


def to_device(x, device, copy: bool = False):
    """``x`` with every tensor inside it moved to ``device`` (copied there
    with ``copy``, even where it lies already): tensors, dataclasses of
    tensors (``MDState``, ``FFParams``, a bias), named tuples, lists, tuples
    and dicts of them; anything else as it is."""
    if isinstance(x, torch.Tensor):
        return x.to(device, copy=copy)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: to_device(getattr(x, f.name), device, copy)
            for f in dataclasses.fields(x) if f.init})
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to_device(v, device, copy) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(to_device(v, device, copy) for v in x)
    if isinstance(x, dict):
        return {k: to_device(v, device, copy) for k, v in x.items()}
    return x


def _split_rows(x, k: int, n: int):
    """Block k of n equal blocks of ``x``'s leading axis (every tensor of
    ``x``, as ``to_device`` walks it)."""
    if isinstance(x, torch.Tensor):
        if x.ndim == 0:
            return x
        if x.shape[0] % n:
            raise ValueError(
                f"a leading axis of {x.shape[0]} does not split into {n} equal shards")
        m = x.shape[0] // n
        return x[k * m:(k + 1) * m]
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: _split_rows(getattr(x, f.name), k, n)
            for f in dataclasses.fields(x) if f.init})
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_split_rows(v, k, n) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_split_rows(v, k, n) for v in x)
    if isinstance(x, dict):
        return {key: _split_rows(v, k, n) for key, v in x.items()}
    return x


def shard_ensemble(states, mesh: Mesh, axis_name: str = "replica") -> List:
    """Split the leading replica axis of ``states`` (an ``MDState``, a tensor,
    or a dataclass, tuple or dict of them) into ``mesh.size`` contiguous
    equal shards, shard k on ``mesh.devices[k]``: a list of shards in
    replica order. A replica count the mesh size does not divide raises.
    ``axis_name`` is the JAX signature's; the mesh has one axis."""
    n = mesh.size
    return [to_device(_split_rows(states, k, n), dev) for k, dev in enumerate(mesh.devices)]


def shard_batch(batch, mesh: Mesh, axis_name: str = "replica") -> List:
    """Split the leading (batch) axis of ``batch`` over the mesh, as
    ``shard_ensemble`` does."""
    return shard_ensemble(batch, mesh, axis_name)


def gather(shards: Sequence, device=None, dim: int = 0):
    """The shards of ``shard_ensemble`` joined back in order along ``dim`` on
    ``device`` (the first shard's device when None)."""
    first = shards[0]
    if isinstance(first, torch.Tensor):
        device = first.device if device is None else device
        if len(shards) == 1:
            return first.to(device)
        return torch.cat([s.to(device) for s in shards], dim=dim)
    if dataclasses.is_dataclass(first) and not isinstance(first, type):
        return dataclasses.replace(first, **{
            f.name: gather([getattr(s, f.name) for s in shards], device, dim)
            for f in dataclasses.fields(first) if f.init})
    if isinstance(first, dict):
        return {k: gather([s[k] for s in shards], device, dim) for k in first}
    raise TypeError(f"cannot gather shards of {type(first).__name__}")


def replicate_params(params, mesh: Mesh) -> List:
    """One copy of ``params`` a mesh entry, on that entry's device: a module
    (deep-copied), a state dict, or tensors as ``to_device`` walks them. An
    entry that repeats a device gets its own copy all the same."""
    if isinstance(params, torch.nn.Module):
        return [copy.deepcopy(params).to(dev) for dev in mesh.devices]
    return [to_device(params, dev, copy=True) for dev in mesh.devices]


def shard_campaign_advance(advance, mesh: Mesh, axis_name: str = "replica"):
    """The campaign op over the mesh: ``sharded(pos, vel, frc, t0, seed)``
    takes and returns lists of shards, shard k on ``mesh.devices[k]``, and
    launches the op on every shard before anything synchronises.
    ``advance`` is one op (``ops.fused_step.make_fused_campaign_op``) where
    every mesh entry lies on its tables' device, or a dict of one op a mesh
    device, each built from that device's force field and bias.

    The kernel keys its thermostat noise on ``(seed, local replica, step,
    atom)``, so shard k runs with ``seed + k * n_local`` (``n_local`` its
    replica count): without the offset every shard would replay shard 0's
    noise. It is JAX's ``seed + axis_index * n_programs`` with the local
    replica count for the program count. At zero temperature the sharded op
    equals the unsharded one. ``sharded.n_inner`` is the op's."""
    ops = advance if isinstance(advance, dict) else {dev: advance for dev in mesh.devices}
    ops = {indexed(dev): op for dev, op in ops.items()}
    missing = sorted({str(dev) for dev in mesh.devices if dev not in ops})
    if missing:
        raise ValueError(f"no campaign op for the mesh devices {missing}")
    n_inner = {ops[dev].n_inner for dev in mesh.devices}
    if len(n_inner) != 1:
        raise ValueError(f"the ops' n_inner differ: {sorted(n_inner)}")

    def sharded(pos, vel, frc, t0, seed):
        if not len(pos) == len(vel) == len(frc) == mesh.size:
            raise ValueError(f"expected {mesh.size} shards of pos, vel and forces")
        out = [ops[dev](p, v, f, t0, int(seed) + k * p.shape[0])
               for k, (dev, p, v, f) in enumerate(zip(mesh.devices, pos, vel, frc))]
        return tuple(list(col) for col in zip(*out))

    sharded.n_inner = n_inner.pop()
    return sharded
