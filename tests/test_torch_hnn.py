"""Port parity: the Hamiltonian dynamics line's models (``models.hnn``,
``models.schnet``, ``models.autoencoder``) and their weights carried
between the two packages.

Float64 on the CPU, with flax's initialised weights carried into the port
through ``convert`` (cast to float64 on both sides): ``HNN``'s fields,
``time_derivative`` for each ``field_type`` and ``rollout`` equal JAX's to
1e-10 relative; ``SchNetHNN`` at 40 atoms (``rbf`` 0 and 32) its fields,
its time derivative and the weights' gradient of an L2 on it (a second
derivative through the dense filters and the distance matrix, whose
diagonal is every atom's distance to itself) to 1e-9; ``SchNet``,
``MLPAutoencoder``, ``LatentHNN``, ``LatentDiscriminator`` and
``aae_losses`` to 1e-10. Every nested tree goes torch -> flax -> torch
exactly. A fresh port module starts as flax's does: orthogonal kernels
(Q^T Q = I on the short side, entries of standard deviation
1 / sqrt(max(in, out)), held to 5 % at the published widths beside flax's
own), zero biases, and SchNet's atom-type table a normal truncated at two
standard deviations of sqrt(1 / features).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molecular_dynamics_tpu.models import autoencoder as jae
from molecular_dynamics_tpu.models import hnn as jhnn
from molecular_dynamics_tpu.models import schnet as jschnet
from molecular_dynamics_tpu_torch import convert as tconvert
from molecular_dynamics_tpu_torch.models import autoencoder as tae
from molecular_dynamics_tpu_torch.models import hnn as thnn
from molecular_dynamics_tpu_torch.models import schnet as tschnet
from molecular_dynamics_tpu_torch.models.common import TRUNCATED_NORMAL_STD

from torch_parity import t

F64 = torch.float64
N_ATOMS = 40
B = 3


def close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-300)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def f64_tree(params):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), params)


def carried(jmodule, tmodule, init_args, seed=0):
    """(float64 flax params, the port module holding the same weights)."""
    params = f64_tree(jax.jit(jmodule.init)(jax.random.PRNGKey(seed), *init_args))
    tmodule.load_state_dict(tconvert.flax_params_to_state_dict(params, F64))
    return jax.tree.map(jnp.asarray, params), tmodule


@pytest.fixture(scope="module")
def phase_rows():
    rng = np.random.default_rng(5)
    pos = rng.uniform(0.0, 12.0, (B, N_ATOMS, 3))
    vel = 0.1 * rng.standard_normal((B, N_ATOMS, 3))
    return np.concatenate([pos.reshape(B, -1), vel.reshape(B, -1)], axis=1)


# -- HNN ---------------------------------------------------------------------------


@pytest.mark.parametrize("field_type", ["solenoidal", "conservative", "both"])
def test_hnn_time_derivative(field_type, phase_rows):
    dim = phase_rows.shape[1]
    jm = jhnn.HNN(hidden=(32, 16), field_type=field_type)
    params, tm = carried(jm, thnn.HNN(dim, (32, 16), field_type, dtype=F64, device="cpu"),
                         (jnp.zeros((dim,)),))
    x = jnp.asarray(phase_rows)
    close(tm(t(phase_rows)).detach(), jax.jit(jax.vmap(lambda r: jm.apply(params, r)))(x), 1e-10)
    want = jax.jit(lambda p, r: jhnn.time_derivative(jm, p, r))(params, x)
    close(thnn.time_derivative(tm, t(phase_rows)).detach(), want, 1e-10)
    with torch.no_grad():  # generation: runs under no_grad too, detached
        got = thnn.time_derivative(tm, t(phase_rows), create_graph=False)
    assert not got.requires_grad
    close(got, want, 1e-10)


def test_hnn_rollout(phase_rows):
    dim = phase_rows.shape[1]
    jm = jhnn.HNN(hidden=(32,))
    params, tm = carried(jm, thnn.HNN(dim, (32,), dtype=F64, device="cpu"), (jnp.zeros((dim,)),))
    run = jax.jit(lambda p, x0: jhnn.rollout(jm, p, x0, n_steps=6, dt=0.5, max_step=0.02))
    got = thnn.rollout(tm, t(phase_rows), n_steps=6, dt=0.5, max_step=0.02)
    close(got, run(params, jnp.asarray(phase_rows)), 1e-10)
    assert not got.requires_grad and got.shape == (6, B, dim)
    # one row alone is the same rollout as that row of a batch
    close(thnn.rollout(tm, t(phase_rows[1]), n_steps=6, dt=0.5, max_step=0.02), got[:, 1], 1e-12)
    # noise from an explicit generator: the same seed, the same rollout
    noisy = [thnn.rollout(tm, t(phase_rows), 3, noise_std=0.01,
                          generator=torch.Generator().manual_seed(7)) for _ in range(2)]
    assert torch.equal(noisy[0], noisy[1]) and not torch.equal(noisy[0], got[:3])


def test_hnn_field_type_is_checked():
    with pytest.raises(ValueError, match="field_type"):
        thnn.HNN(8, (4,), field_type="symplectic", device="cpu")


# -- SchNet ------------------------------------------------------------------------


@pytest.mark.parametrize("rbf", [0, 32])
def test_schnet_hnn_and_its_second_derivative(rbf, phase_rows):
    dim = phase_rows.shape[1]
    jm = jschnet.SchNetHNN(n_atoms=N_ATOMS, features=16, n_interactions=2, rbf=rbf)
    params, tm = carried(jm, tschnet.SchNetHNN(N_ATOMS, 16, 2, rbf, dtype=F64, device="cpu"),
                         (jnp.zeros((dim,)),))
    x = jnp.asarray(phase_rows)
    close(tm(t(phase_rows)).detach(), jax.jit(jax.vmap(lambda r: jm.apply(params, r)))(x), 1e-9)
    close(thnn.time_derivative(tm, t(phase_rows)).detach(),
          jax.jit(lambda p, r: jhnn.time_derivative(jm, p, r))(params, x), 1e-9)
    # the weights' gradient of an L2 on the time derivative: double backward
    # through the filters and the distance matrix's diagonal
    target = 0.01 * np.random.default_rng(2).standard_normal(phase_rows.shape)

    def jloss(p):
        return jnp.mean((jhnn.time_derivative(jm, p, x) - target) ** 2)

    want = tconvert.flax_params_to_state_dict(
        jax.tree.map(np.asarray, jax.jit(jax.grad(jloss))(params)), F64)
    loss = torch.mean((thnn.time_derivative(tm, t(phase_rows)) - t(target)) ** 2)
    grads = torch.autograd.grad(loss, list(tm.parameters()), materialize_grads=True)
    for (name, _), g in zip(tm.named_parameters(), grads):
        assert torch.isfinite(g).all(), name
        close(g, want[name], 1e-9)


def test_distance_diagonal_under_double_backward():
    """Every atom's distance to itself (the diagonal of ``distance_matrix``,
    a zero under a square root) leaves the first and the second derivative
    finite: the input gradient of the fields, and the gradient of a loss on
    it with respect to the weights and the input."""
    tm = tschnet.SchNetHNN(3, 8, 1, rbf=4, dtype=F64, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    pos = torch.tensor([[0.0, 0.0, 0.0, 1.5, 0.0, 0.0, 0.0, 1.5, 0.0],
                        [0.2, -0.1, 0.3, 4.0, 1.0, 0.0, -2.0, 0.5, 1.0]], dtype=F64)
    x = torch.cat([pos, 0.1 * torch.ones_like(pos)], dim=1).requires_grad_(True)
    dx = thnn.time_derivative(tm, x)
    grads = torch.autograd.grad(dx.pow(2).sum(), [x, *tm.parameters()], materialize_grads=True)
    assert torch.isfinite(dx).all() and all(torch.isfinite(g).all() for g in grads)
    assert float(grads[0].abs().max()) > 0.0


@pytest.mark.parametrize("readout", ["sum", "atoms"])
def test_schnet(readout):
    rng = np.random.default_rng(4)
    pos = rng.uniform(0.0, 8.0, (B, 12, 3))
    types = rng.integers(0, 64, (B, 12))
    jm = jschnet.SchNet(features=16, n_interactions=2, out_dim=3, readout=readout)
    params, tm = carried(jm, tschnet.SchNet(16, 2, 3, readout, dtype=F64, device="cpu"),
                         (jnp.zeros((12, 3)), jnp.zeros((12,), jnp.int32)))
    want = jax.jit(jax.vmap(lambda p, a: jm.apply(params, p, a)))(jnp.asarray(pos),
                                                                  jnp.asarray(types))
    close(tm(t(pos), torch.as_tensor(types)).detach(), want, 1e-10)


# -- autoencoders ------------------------------------------------------------------


def test_latent_hnn():
    x = np.random.default_rng(6).standard_normal((B, 30))
    jm = jae.LatentHNN(in_dim=30, latent_dim=6, ae_hidden=(16, 8), hnn_hidden=(12,))
    params, tm = carried(jm, tae.LatentHNN(30, 6, (16, 8), (12,), dtype=F64, device="cpu"),
                         (jnp.zeros((1, 30)),))
    xj = jnp.asarray(x)
    for got, want in zip(tm(t(x)), jax.jit(jm.apply)(params, xj)):
        close(got.detach(), want, 1e-10)
    z = jm.apply(params, xj, method=jae.LatentHNN.encode)
    close(tm.encode(t(x)).detach(), z, 1e-10)
    close(tm.decode(t(np.asarray(z))).detach(), jm.apply(params, z, method=jae.LatentHNN.decode),
          1e-10)
    # the inner HNN's field in the latent phase space
    inner = {"params": params["params"]["hnn"]}
    close(thnn.time_derivative(tm.hnn, t(np.asarray(z))).detach(),
          jhnn.time_derivative(jhnn.HNN(hidden=(12,)), inner, z), 1e-10)
    with pytest.raises(ValueError, match="even"):
        tae.LatentHNN(30, 5, device="cpu")


def test_conditional_autoencoder_and_critic():
    rng = np.random.default_rng(8)
    x, c = rng.standard_normal((B, 30)), rng.uniform(0, 1, (B, 2))
    jm = jae.MLPAutoencoder(in_dim=30, latent_dim=4, hidden=(16,), cond_dim=2)
    params, tm = carried(jm, tae.MLPAutoencoder(30, 4, (16,), 2, dtype=F64, device="cpu"),
                         (jnp.zeros((1, 30)), jnp.zeros((1, 2))))
    for got, want in zip(tm(t(x), t(c)), jax.jit(jm.apply)(params, jnp.asarray(x), jnp.asarray(c))):
        close(got.detach(), want, 1e-10)
    jd = jae.LatentDiscriminator(hidden=(8, 6))
    dparams, td = carried(jd, tae.LatentDiscriminator(4, (8, 6), dtype=F64, device="cpu"),
                          (jnp.zeros((1, 4)),))
    z, prior = rng.standard_normal((5, 4)), rng.standard_normal((5, 4))
    fake, real = jd.apply(dparams, jnp.asarray(z)), jd.apply(dparams, jnp.asarray(prior))
    close(td(t(z)).detach(), fake, 1e-10)
    recon = rng.standard_normal((5, 30))
    target = rng.standard_normal((5, 30))
    want = jae.aae_losses(jnp.asarray(recon), jnp.asarray(target), fake, real)
    got = tae.aae_losses(t(recon), t(target), td(t(z)), td(t(prior)))
    for a, b in zip(got, want):
        close(a.detach(), b, 1e-10)
    rec, g_adv, none = tae.aae_losses(t(recon), t(target), td(t(z)))
    assert none is None and float(g_adv.detach()) == pytest.approx(float(want[1]), rel=1e-10)


# -- the weight carry and the initialisation ---------------------------------------


TREES = {
    "hnn": (lambda: jhnn.HNN(hidden=(8,)), lambda: thnn.HNN(6, (8,), device="cpu"),
            (jnp.zeros((6,)),)),
    "schnet_hnn": (lambda: jschnet.SchNetHNN(n_atoms=3, features=8, n_interactions=2, rbf=5),
                   lambda: tschnet.SchNetHNN(3, 8, 2, 5, device="cpu"), (jnp.zeros((18,)),)),
    "schnet": (lambda: jschnet.SchNet(features=8, n_interactions=1),
               lambda: tschnet.SchNet(8, 1, device="cpu"),
               (jnp.zeros((3, 3)), jnp.zeros((3,), jnp.int32))),
    "latent_hnn": (lambda: jae.LatentHNN(in_dim=9, latent_dim=4, ae_hidden=(8,), hnn_hidden=(6,)),
                   lambda: tae.LatentHNN(9, 4, (8,), (6,), device="cpu"), (jnp.zeros((1, 9)),)),
    "latent_discriminator": (lambda: jae.LatentDiscriminator(hidden=(5,)),
                             lambda: tae.LatentDiscriminator(4, (5,), device="cpu"),
                             (jnp.zeros((1, 4)),)),
}


@pytest.mark.parametrize("name", sorted(TREES))
def test_nested_trees_round_trip(name):
    make_j, make_t, init_args = TREES[name]
    template = jax.tree.map(np.asarray, jax.jit(make_j().init)(jax.random.PRNGKey(0), *init_args))
    tm = make_t()
    flax_tree = tconvert.state_dict_to_flax_params(tm.state_dict())
    assert jax.tree.structure(flax_tree) == jax.tree.structure(template)
    for a, b in zip(jax.tree.leaves(flax_tree), jax.tree.leaves(template)):
        assert a.shape == b.shape
    back = tconvert.flax_params_to_state_dict(flax_tree)
    assert back.keys() == tm.state_dict().keys()
    assert all(torch.equal(back[k], v) for k, v in tm.state_dict().items())


def test_orthogonal_init_statistics():
    """The published widths: HNN (200, 200) on 240 inputs, the latent HNN's
    autoencoder (256, 128) on 120 inputs; both packages."""
    gen = torch.Generator().manual_seed(0)
    models = [thnn.HNN(240, (200, 200), generator=gen, device="cpu"),
              tae.LatentHNN(120, 16, generator=gen, device="cpu")]
    jtrees = [jax.jit(jhnn.HNN(hidden=(200, 200)).init)(jax.random.PRNGKey(0), jnp.zeros((240,))),
              jax.jit(jae.LatentHNN(in_dim=120).init)(jax.random.PRNGKey(1), jnp.zeros((1, 120)))]
    for tm, jtree in zip(models, jtrees):
        jstate = tconvert.flax_params_to_state_dict(jax.tree.map(np.asarray, jtree))
        assert jstate.keys() == tm.state_dict().keys()
        for key, value in tm.state_dict().items():
            if key.endswith(".bias"):
                assert not value.any() and not jstate[key].any()
                continue
            for m in (value.double().numpy().T, jstate[key].double().numpy().T):  # (in, out)
                short = m.T @ m if m.shape[0] >= m.shape[1] else m @ m.T
                np.testing.assert_allclose(short, np.eye(len(short)), atol=2e-6)
                if m.size >= 1000:
                    target = 1.0 / math.sqrt(max(m.shape))
                    assert abs(m.std() / target - 1.0) < 0.05, (key, m.shape, m.std(), target)


def test_schnet_init_statistics():
    tm = tschnet.SchNetHNN(40, 64, 3, rbf=32, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    plain = tschnet.SchNet(64, 3, generator=torch.Generator().manual_seed(1), device="cpu")
    table = plain.embed.weight.detach().numpy()
    std = math.sqrt(1.0 / 64)
    assert abs(table.std() / std - 1.0) < 0.05
    assert np.abs(table).max() <= 2.0 * std / TRUNCATED_NORMAL_STD * (1 + 1e-6)
    for layer in [*tm.layers, *(lay for c in tm.cfconv for lay in c.layers)]:
        w = layer.weight.detach().numpy()
        lecun = math.sqrt(1.0 / w.shape[1])
        assert np.abs(w).max() <= 2.0 * lecun / TRUNCATED_NORMAL_STD * (1 + 1e-6)
        assert not layer.bias.detach().any()
