"""What each data-parallel rank of ``tests/test_torch_parallel.py`` runs.

A module of its own (torch and the port only, no JAX), so that the ranks
(``parallel.data.rank_main``, started by the test module's fixture) import
it quickly. ``jobs`` runs, on
every rank, the informed-loss gradient of given weights over the global
batch, then ``run_training``'s rank body for ``pretrain`` and ``lstm``;
rank 0 writes the gradients into ``root``.
"""

import numpy as np
import torch

from molecular_dynamics_tpu_torch.examples import BACKBONE_FF_PRM, decaalanine_backbone
from molecular_dynamics_tpu_torch.ff import YamlForceField, build_ff_params
from molecular_dynamics_tpu_torch.train import drivers


def informed_grads(dp, root):
    """The gradient of the cGAN's informed loss (potential + 200 x bias) at
    the weights, latents and times in ``root/informed.npz``, float64, each
    rank on its rows, the gradients all-reduced by the generator's
    ``DistributedDataParallel`` wrapper."""
    from molecular_dynamics_tpu_torch.bias import HarmonicSMDBias
    from molecular_dynamics_tpu_torch.models.cgan import Discriminator, Generator
    from molecular_dynamics_tpu_torch.train.cgan import CGANTrainer

    data = dict(np.load(root / "informed.npz"))
    top, _ = decaalanine_backbone()
    ff = build_ff_params(top, YamlForceField(BACKBONE_FF_PRM), dtype=torch.float64, device="cpu")
    n = ff.n_atoms
    bias = HarmonicSMDBias.create(n_atoms=n, group1=[0], group2=[n - 1], fk=1.0, cent_0=12.0,
                                  cent_1=34.0, T=10000.0, dtype=torch.float64, device="cpu")
    gen = Generator(n_atoms=n, hidden=(int(data["hidden"]),), device="cpu", dtype=torch.float64)
    gen.load_state_dict({k[len("w:"):]: torch.as_tensor(v) for k, v in data.items()
                         if k.startswith("w:")})
    disc = Discriminator(in_features=n * 3, hidden=(4,), device="cpu", dtype=torch.float64)
    trainer = CGANTrainer(dp.wrap(gen), disc, ff, bias=bias)
    z, t = (torch.as_tensor(dp.rows(data[k])) for k in ("z", "t"))
    trainer.informed_loss(z, t).backward()
    if dp.writer:
        np.savez(root / "port_grads.npz", **{k: p.grad.numpy() for k, p in gen.named_parameters()})


def jobs(dp, root, train_kwargs):
    informed_grads(dp, root)
    for kwargs in train_kwargs:
        drivers._train_rank(dp, kwargs)
