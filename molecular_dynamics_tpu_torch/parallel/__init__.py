"""Several devices: replica sharding and data-parallel training.

- **replica parallelism**: ``get_mesh`` and ``shard_ensemble`` split the
  leading replica axis of an ensemble over devices, each device integrating
  its shard with no communication between replicas;
  ``sim.simulate_ensemble(mesh=)`` and ``cli simulate --devices N`` take
  it, and ``shard_campaign_advance`` runs the campaign kernel on every
  shard with decorrelated thermostat streams;
- **data parallelism for training**: ``train.drivers.run_training(
  devices=N)`` (``cli train --devices N``) runs N ranks of
  ``torch.distributed``, each on its rows of every batch, with the models
  wrapped in ``DistributedDataParallel`` (``parallel.data``);
- ``dryrun_multichip`` (``parallel.dryrun``) drives both at once.
"""

from molecular_dynamics_tpu_torch.parallel.mesh import (
    Mesh,
    get_mesh,
    shard_ensemble,
    shard_batch,
    shard_campaign_advance,
    replicate_params,
)
from molecular_dynamics_tpu_torch.parallel.dryrun import dryrun_multichip


__all__ = [
    "Mesh",
    "get_mesh",
    "shard_ensemble",
    "shard_batch",
    "shard_campaign_advance",
    "replicate_params",
    "dryrun_multichip",
]
