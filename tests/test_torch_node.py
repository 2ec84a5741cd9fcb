"""Port parity: the ODE solvers (``models.node``) and the HNN trainer
(``train.hnn``).

Float64 on the CPU, from flax's weights carried through ``convert``.
``rk4_rollout`` (with its displacement and state clamps) and ``hnn_field``
equal JAX's to 1e-10 relative. ``odeint_field``, the port's own
Dormand-Prince 5(4) with ``jax.experimental.ode.odeint``'s step control,
meets it on a linear decay field and on an HNN field: the states to 1e-6
relative, the gradients (the port's autograd through the accepted steps
against JAX's adjoint) to 1e-5. Three rounds of an L2, a
potential-informed and a 3-step unroll update of ``make_hnn_trainer``, on
the 40-atom backbone (an MLP HNN and a SchNet HNN), give losses within
1e-9 relative and weights within 1e-9 of the largest weight.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.ode import odeint as jodeint

from molecular_dynamics_tpu.models import hnn as jhnn
from molecular_dynamics_tpu.models import node as jnode
from molecular_dynamics_tpu.models import schnet as jschnet
from molecular_dynamics_tpu.train import hnn as jtrain
from molecular_dynamics_tpu_torch import convert as tconvert
from molecular_dynamics_tpu_torch.models import hnn as thnn
from molecular_dynamics_tpu_torch.models import node as tnode
from molecular_dynamics_tpu_torch.models import schnet as tschnet
from molecular_dynamics_tpu_torch.train import hnn as ttrain

from torch_parity import ff_to_numpy, t

F64 = torch.float64
STEP_RTOL = 1e-9


def close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-300)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def carried(jmodule, tmodule, dim, seed=0):
    params = jax.tree.map(lambda a: np.asarray(a, np.float64),
                          jax.jit(jmodule.init)(jax.random.PRNGKey(seed), jnp.zeros((dim,))))
    tmodule.load_state_dict(tconvert.flax_params_to_state_dict(params, F64))
    return jax.tree.map(jnp.asarray, params), tmodule


@pytest.fixture(scope="module")
def small_hnn():
    dim = 8
    jm = jhnn.HNN(hidden=(16,))
    params, tm = carried(jm, thnn.HNN(dim, (16,), dtype=F64, device="cpu"), dim)
    x0 = np.random.default_rng(3).standard_normal((2, dim))
    return jm, params, tm, x0


# -- RK4 ---------------------------------------------------------------------------


def test_rk4_rollout(small_hnn):
    jm, params, tm, x0 = small_hnn
    lo, hi = x0.min(axis=0) - 0.3, x0.max(axis=0) + 0.3

    def jrun(p, x):
        return jnode.rk4_rollout(jnode.hnn_field(jm, p), x, n_steps=8, dt=0.25, max_step=0.05,
                                 state_bounds=(jnp.asarray(lo), jnp.asarray(hi)))

    want = jax.jit(jrun)(params, jnp.asarray(x0))
    got = tnode.rk4_rollout(tnode.hnn_field(tm), t(x0), n_steps=8, dt=0.25, max_step=0.05,
                            state_bounds=(t(lo), t(hi)))
    close(got.detach(), want, 1e-10)
    # the generation field: the same states, no graph
    plain = tnode.rk4_rollout(tnode.hnn_field(tm, create_graph=False), t(x0), 8, 0.25,
                              max_step=0.05, state_bounds=(t(lo), t(hi)))
    assert not plain.requires_grad
    close(plain, want, 1e-10)
    # a corrector sees every state
    seen = []
    tnode.rk4_rollout(lambda x, _t: -x, t(x0), 3, 0.1, corrector=lambda x: seen.append(x) or x)
    assert len(seen) == 3


# -- Dormand-Prince ----------------------------------------------------------------


def test_odeint_decay_field():
    rate = np.array([0.5, 1.0, 2.0])
    y0 = np.array([1.0, -2.0, 0.5])
    ts = np.linspace(0.0, 2.0, 5)

    def jsolve(y):
        return jnode.odeint_field(lambda x, _t: -jnp.asarray(rate) * x, y, jnp.asarray(ts))

    want = jax.jit(jsolve)(jnp.asarray(y0))
    close(want, y0 * np.exp(-rate * ts[:, None]), 1e-6)
    y = t(y0).requires_grad_(True)
    got = tnode.odeint_field(lambda x, _t: -t(rate) * x, y, t(ts))
    close(got.detach(), want, 1e-6)
    (grad,) = torch.autograd.grad(got[-1].pow(2).sum(), y)
    close(grad, jax.jit(jax.grad(lambda q: jnp.sum(jsolve(q)[-1] ** 2)))(jnp.asarray(y0)), 1e-5)


def test_odeint_hnn_field(small_hnn):
    jm, params, tm, x0 = small_hnn
    ts = np.linspace(0.0, 1.0, 4)

    def jloss(p):
        ys = jnode.odeint_field(jnode.hnn_field(jm, p), jnp.asarray(x0), jnp.asarray(ts))
        return jnp.sum(ys ** 2), ys

    (_, want), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    got = tnode.odeint_field(tnode.hnn_field(tm), t(x0), t(ts))
    close(got.detach(), want, 1e-6)
    grads = torch.autograd.grad(got.pow(2).sum(), list(tm.parameters()), materialize_grads=True)
    want_grads = tconvert.flax_params_to_state_dict(jax.tree.map(np.asarray, jgrad), F64)
    for (name, _), g in zip(tm.named_parameters(), grads):
        close(g, want_grads[name], 1e-5)
    # and JAX's odeint itself on the same field, at a looser tolerance
    loose = jodeint(lambda x, _t: jhnn.time_derivative(jm, params, x), jnp.asarray(x0),
                    jnp.asarray(ts), rtol=1e-5, atol=1e-5)
    close(tnode.odeint_field(tnode.hnn_field(tm, create_graph=False), t(x0), t(ts), rtol=1e-5,
                             atol=1e-5), loose, 1e-6)


# -- the trainer -------------------------------------------------------------------


@pytest.fixture(scope="module")
def backbone(backbone_system):
    top, jff, coords = backbone_system
    tff = tconvert.ff_params_from_numpy(ff_to_numpy(jff), device="cpu", dtype=F64)
    rng = np.random.default_rng(17)
    b, dim = 4, 2 * 40 * 3
    pos = np.asarray(coords, np.float64).reshape(-1)[None] + 0.1 * rng.standard_normal((b, 120))
    x = np.concatenate([pos, 0.05 * rng.standard_normal((b, 120))], axis=1)
    dx = 0.01 * rng.standard_normal((b, dim))
    dx_seq = 0.01 * rng.standard_normal((b, 3, dim))
    return jff, tff, x, dx, dx_seq


BACKBONES = {
    "mlp": (lambda: jhnn.HNN(hidden=(32,)), lambda: thnn.HNN(240, (32,), dtype=F64, device="cpu")),
    "schnet": (lambda: jschnet.SchNetHNN(n_atoms=40, features=8, n_interactions=1, rbf=4),
               lambda: tschnet.SchNetHNN(40, 8, 1, 4, dtype=F64, device="cpu")),
}


@pytest.mark.parametrize("backbone_kind", sorted(BACKBONES))
def test_hnn_trainer_steps(backbone_kind, backbone):
    jff, tff, x, dx, dx_seq = backbone
    jm = BACKBONES[backbone_kind][0]()
    params, tm = carried(jm, BACKBONES[backbone_kind][1](), 240)
    opt, l2_step, informed_step, unroll_step = jtrain.make_hnn_trainer(jm, jff)
    opt_state = opt.init(params)
    _, tl2, tinformed, tunroll = ttrain.make_hnn_trainer(tm, tff)
    xj, dxj, seqj = jnp.asarray(x), jnp.asarray(dx), jnp.asarray(dx_seq)

    def same_weights():
        want = tconvert.flax_params_to_state_dict(jax.tree.map(np.asarray, params), F64)
        scale = max(float(v.abs().max()) for v in want.values())
        for key, value in tm.state_dict().items():
            assert float((value - want[key]).abs().max()) <= STEP_RTOL * scale, key

    for _ in range(3):
        params, opt_state, jl = l2_step(params, opt_state, xj, dxj)
        close(tl2(t(x), t(dx)), jl, STEP_RTOL)
        same_weights()
        params, opt_state, jl, jparts = informed_step(params, opt_state, xj, dxj)
        tloss, tparts = tinformed(t(x), t(dx))
        close(tloss, jl, STEP_RTOL)
        for a, b in zip(tparts, jparts):
            close(a, b, STEP_RTOL)
        same_weights()
        params, opt_state, jl = unroll_step(params, opt_state, xj, seqj)
        close(tunroll(t(x), t(dx_seq)), jl, STEP_RTOL)
        same_weights()
