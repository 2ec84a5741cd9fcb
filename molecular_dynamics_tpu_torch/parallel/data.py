"""Data-parallel ranks: ``torch.distributed`` processes over one global batch.

JAX trains data-parallel as one program over the global batch (replicated
weights, the batch sharded over the mesh, the gradient's sum inserted by
the compiler). The port runs ``world`` processes instead, rank r on its own
device: NCCL on ``cuda:r``, or gloo where the caller asks for the CPU (or
places two ranks on one card). Every rank draws the global batch's rows,
latents and noise from identically seeded generators and keeps its own
contiguous block of rows; ``DistributedDataParallel`` averages the
gradients over the ranks, which equals the gradient of the global batch
mean when each rank's loss is the mean over its rows and the blocks are
equal (``DataParallel.rows`` splits only into equal blocks). So a run
equals the one-process run up to the order of summation.
"""

from __future__ import annotations

import socket
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from molecular_dynamics_tpu_torch.parallel.mesh import indexed, visible_cuda_devices


class DataParallel:
    """This rank's place in a data-parallel run: ``rank`` of ``world``, on
    ``device``. Rank 0 alone writes files (``writer``)."""

    def __init__(self, rank: int, world: int, device):
        self.rank, self.world = int(rank), int(world)
        self.device = torch.device(device)

    @property
    def writer(self) -> bool:
        return self.rank == 0

    def wrap(self, module: torch.nn.Module) -> torch.nn.Module:
        """``module`` in ``DistributedDataParallel``. Its forward is the
        wrapper's; its gradients come from ``loss.backward()``, which
        all-reduces them (``train.common.descend`` does that for an
        optimizer built with ``backward=True``)."""
        ids = [self.device] if self.device.type == "cuda" else None
        return torch.nn.parallel.DistributedDataParallel(
            module, device_ids=ids, broadcast_buffers=False)

    def rows(self, x):
        """This rank's contiguous block of ``x``'s leading axis (a tensor or
        a numpy array), one of ``world`` equal blocks: a row count that
        ``world`` does not divide raises."""
        n = len(x)
        if n % self.world:
            raise ValueError(f"{n} rows do not split into {self.world} equal blocks")
        m = n // self.world
        return x[self.rank * m:(self.rank + 1) * m]

    def mean(self, value: torch.Tensor) -> torch.Tensor:
        """The mean over the ranks of a 0-dim tensor (every rank calls it):
        a logged loss becomes the global batch's."""
        out = value.detach().clone()
        dist.all_reduce(out)
        return out / self.world


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_devices(world: int, device=None) -> list:
    """Where each of ``world`` ranks runs: ``cuda:r`` (raises ``ValueError``
    where fewer CUDA devices are visible) or, for the CPU, the CPU."""
    kind = torch.device("cuda" if device is None else device).type
    if kind == "cpu":
        return [torch.device("cpu")] * world
    visible = visible_cuda_devices()
    if visible < world:
        raise ValueError(
            f"requested {world} data-parallel ranks, one a CUDA device, but only "
            f"{visible} CUDA devices are visible (--device cpu runs the ranks on the CPU)")
    return [torch.device("cuda", r) for r in range(world)]


def rank_main(rank, fn, devices, backend, port, args, threads=1):
    """The body of rank ``rank`` of ``len(devices)``: joins the process
    group (``backend``, at ``tcp://127.0.0.1:port``) on ``devices[rank]``
    (a CPU rank with ``threads`` threads), runs ``fn(dp, *args)``, meets the
    other ranks at a barrier and destroys the group on every exit."""
    world = len(devices)
    device = devices[rank]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(threads)
    dist.init_process_group(
        backend, init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank)
    try:
        fn(DataParallel(rank, world, device), *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, device=None, args: Sequence = (),
          devices: Optional[Sequence] = None, backend: Optional[str] = None):
    """Run ``fn(dp, *args)`` on ``world`` ranks (``torch.multiprocessing``,
    start method ``spawn``; ``fn`` must be importable by name; a world of
    one runs its rank in this process; ranks on the CPU split this
    process's threads between them). ``devices`` places the ranks
    (default ``rank_devices(world, device)``); ``backend`` defaults to NCCL
    where every rank has a card of its own and gloo otherwise. A rank's
    exception raises here once every rank has ended; each rank meets the
    others at a barrier before it returns, and destroys its process group
    on every exit (``rank_main``)."""
    import torch.multiprocessing as mp

    devices = [indexed(d) for d in (devices or rank_devices(world, device))]
    if len(devices) != world:
        raise ValueError(f"{len(devices)} devices for {world} ranks")
    if backend is None:
        distinct = len(set(devices)) == world
        backend = "nccl" if all(d.type == "cuda" for d in devices) and distinct else "gloo"
    # CPU ranks share the threads this process has
    rank_args = (fn, devices, backend, free_port(), tuple(args),
                 max(1, torch.get_num_threads() // world))
    if world == 1:
        threads = torch.get_num_threads()
        try:
            rank_main(0, *rank_args)
        finally:
            torch.set_num_threads(threads)
        return
    mp.spawn(rank_main, args=rank_args, nprocs=world)
