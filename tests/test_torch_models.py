"""Port parity: the flagship models (``models.MLP``, ``Generator``,
``Discriminator``) and the carry of weights between the two packages.

With the same weights, carried from flax into torch by
``convert.flax_params_to_state_dict`` and back by
``convert.state_dict_to_flax_params``, the port's forwards equal the flax
modules' to 1e-12 relative in float64, for per-sample and scalar times. A
fresh port module starts as flax's ``Dense`` does: every bias zero, every
kernel a normal truncated at two standard deviations with standard
deviation sqrt(1 / fan_in) (held to 5 %, the sampling error of the
smallest layer being about 1 %), as flax's own init measures.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molecular_dynamics_tpu.models import cgan as jcgan
from molecular_dynamics_tpu.models import common as jcommon
from molecular_dynamics_tpu_torch import convert as tconvert
from molecular_dynamics_tpu_torch.models import Discriminator, Generator, MLP
from molecular_dynamics_tpu_torch.models.common import TRUNCATED_NORMAL_STD

from torch_parity import t

RTOL = 1e-12
N_ATOMS = 40
B = 5


def close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * float(np.abs(want).max()))


def numpy_tree(params):
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(21)
    return rng.standard_normal((B, 31)), rng.uniform(0.0, 1.0, B), rng.standard_normal((B, 120))


CASES = {
    "generator": (lambda: jcgan.Generator(n_atoms=N_ATOMS),
                  lambda: Generator(N_ATOMS, dtype=torch.float64, device="cpu")),
    "generator_narrow": (lambda: jcgan.Generator(n_atoms=N_ATOMS, latent_dim=7, hidden=(32,)),
                         lambda: Generator(N_ATOMS, 7, (32,), dtype=torch.float64, device="cpu")),
    "discriminator": (lambda: jcgan.Discriminator(),
                      lambda: Discriminator(120, dtype=torch.float64, device="cpu")),
}


def _forward_pair(name, jmod, tmod, inputs):
    z, times, feats = inputs
    if name.startswith("generator"):
        z = z[:, : tmod.latent_dim]
        return (lambda p, tt: jmod.apply(p, jnp.asarray(z), tt, method=jcgan.Generator.coords),
                lambda tt: tmod.coords(t(z), tt), (jnp.asarray(z), jnp.asarray(times)))
    return (lambda p, tt: jmod.apply(p, jnp.asarray(feats), tt),
            lambda tt: tmod(t(feats), tt), (jnp.asarray(feats), jnp.asarray(times)))


@pytest.mark.parametrize("name", sorted(CASES))
def test_flax_weights_into_torch(name, inputs):
    jmod, tmod = CASES[name][0](), CASES[name][1]()
    jfwd, tfwd, init_args = _forward_pair(name, jmod, tmod, inputs)
    params = jmod.init(jax.random.PRNGKey(3), *init_args)
    tmod.load_state_dict(tconvert.flax_params_to_state_dict(numpy_tree(params), torch.float64))
    times = inputs[1]
    with torch.no_grad():
        close(tfwd(t(times)), jax.jit(jfwd)(params, jnp.asarray(times)))
        close(tfwd(0.25), jax.jit(jfwd)(params, 0.25))  # one time for the whole batch


@pytest.mark.parametrize("name", sorted(CASES))
def test_torch_weights_into_flax(name, inputs):
    jmod, tmod = CASES[name][0](), CASES[name][1]()
    jfwd, tfwd, init_args = _forward_pair(name, jmod, tmod, inputs)
    template = jmod.init(jax.random.PRNGKey(0), *init_args)
    params = tconvert.state_dict_to_flax_params(tmod.state_dict())
    assert jax.tree.structure(params) == jax.tree.structure(numpy_tree(template))
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(template)):
        assert a.shape == b.shape
    params = jax.tree.map(jnp.asarray, params)
    with torch.no_grad():
        close(tfwd(t(inputs[1])), jax.jit(jfwd)(params, jnp.asarray(inputs[1])))
    # and back: the round trip is exact
    back = tconvert.flax_params_to_state_dict(numpy_tree(params), torch.float64)
    for key, value in tmod.state_dict().items():
        assert torch.equal(back[key], value)


def test_mlp_matches_flax(inputs):
    z = inputs[0]
    jmlp = jcommon.MLP(features=(16, 8, 3), final_activation=jnp.tanh)
    params = jmlp.init(jax.random.PRNGKey(5), jnp.asarray(z))
    tmlp = MLP(31, (16, 8, 3), final_activation=torch.tanh, dtype=torch.float64, device="cpu")
    tmlp.load_state_dict(tconvert.flax_params_to_state_dict(numpy_tree(params), torch.float64))
    with torch.no_grad():
        close(tmlp(t(z)), jax.jit(jmlp.apply)(params, jnp.asarray(z)))


def _flax_kernels(params):
    tree = params["params"]
    return [np.asarray(tree[f"Dense_{i}"]["kernel"]) for i in range(len(tree))]


def test_init_statistics():
    """Zero biases, and kernels with flax's LeCun-normal spread and cut, in
    both packages, at the published widths."""
    gen = torch.Generator().manual_seed(0)
    tg = Generator(104, generator=gen, device="cpu")
    td = Discriminator(312, generator=gen, device="cpu")
    jg = jcgan.Generator(n_atoms=104).init(jax.random.PRNGKey(0), jnp.zeros((1, 31)), jnp.zeros((1,)))
    jd = jcgan.Discriminator().init(jax.random.PRNGKey(1), jnp.zeros((1, 312)), jnp.zeros((1,)))
    assert [tuple(lay.weight.shape) for lay in tg.layers] == [(128, 32), (256, 128), (512, 256), (312, 512)]
    assert [tuple(lay.weight.shape) for lay in td.layers] == [(512, 313), (256, 512), (128, 256), (1, 128)]
    for tmod, jparams in ((tg, jg), (td, jd)):
        for layer, jkernel in zip(tmod.layers, _flax_kernels(jparams)):
            w = layer.weight.detach().numpy()
            assert w.shape == jkernel.T.shape
            assert not layer.bias.detach().any()
            fan_in = w.shape[1]
            target = math.sqrt(1.0 / fan_in)
            cut = 2.0 * target / TRUNCATED_NORMAL_STD
            assert np.abs(w).max() <= cut * (1 + 1e-6) and np.abs(jkernel).max() <= cut * (1 + 1e-6)
            if w.size >= 1000:
                assert abs(w.std() / target - 1.0) < 0.05, (w.shape, w.std(), target)
                assert abs(jkernel.std() / target - 1.0) < 0.05
                assert abs(w.mean()) < 0.05 * target * 10
