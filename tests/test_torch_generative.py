"""Port parity: the generative line's models, optimizers and trainer steps
against JAX's, float64.

The conditional VAE, the RealNVP flow (forward, inverse, log-density,
sampling), the SDE generator and the CDE critic equal flax's from JAX's
weights to 1e-10, fed the draws JAX makes inside its modules. The
optimizers the line adds (bare Adam, a zero clip, Adadelta) equal optax's.
The trainer steps (the flow's NLL, the VAE's MSE + KLD, the SDE-GAN's
generator step with its moment and quantile terms, its critic step with
the gradient penalty and with each clamp, its potential-injection step and
the weight average) take one step from JAX's weights with JAX's draws: the
losses and the parameters after it agree to 1e-9. Each new model's weight
tree goes through ``convert`` and back unchanged.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from molecular_dynamics_tpu.models import flows as jflows
from molecular_dynamics_tpu.models import sde as jsde
from molecular_dynamics_tpu.models import vae as jvae
from molecular_dynamics_tpu.train import generative as jgenerative
from molecular_dynamics_tpu.train import sde as jtrain_sde
from molecular_dynamics_tpu_torch import convert as tconvert
from molecular_dynamics_tpu_torch.models import flows as tflows
from molecular_dynamics_tpu_torch.models import sde as tsde
from molecular_dynamics_tpu_torch.models import vae as tvae
from molecular_dynamics_tpu_torch.train import common as tcommon
from molecular_dynamics_tpu_torch.train import generative as tgenerative
from molecular_dynamics_tpu_torch.train import sde as ttrain_sde

from torch_parity import jax_system, t, torch_system

F64 = torch.float64
FWD_TOL = 1e-10
TOL = 1e-9
KEY = jax.random.PRNGKey(3)
TS = np.linspace(0.0, 1.0, 5)


def to64(params):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)


def state(params):
    return tconvert.flax_params_to_state_dict(jax.tree.map(np.asarray, params), F64)


def carried(cls, params, *args, **kw):
    """The port's ``cls`` in float64 on the CPU with JAX's ``params``."""
    module = cls(*args, device="cpu", dtype=F64, **kw)
    module.load_state_dict(state(params))
    return module


def assert_params(module, params, tol=TOL):
    want = state(params)
    got = module.state_dict()
    assert got.keys() == want.keys()
    for name, value in got.items():
        np.testing.assert_allclose(value.numpy(), want[name].numpy(), rtol=tol, atol=tol,
                                   err_msg=name)


def close(got, want, tol=FWD_TOL):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want), rtol=tol, atol=tol)


def round_trip(params):
    """``convert`` there and back: the same tree, array for array."""
    host = jax.tree.map(np.asarray, params)
    back = tconvert.state_dict_to_flax_params(tconvert.flax_params_to_state_dict(host))
    assert jax.tree.structure(back) == jax.tree.structure(host)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(host)):
        assert a.shape == b.shape and np.array_equal(a, b)


def sde_draws(key, batch, noise_dim, init_noise_dim=16, ts=TS):
    """The draws ``SDEGenerator.__call__`` makes from ``key``: ``z0`` and
    the increments scaled by ``sqrt(dt)``."""
    k_init, k_noise = jax.random.split(key)
    z0 = jax.random.normal(k_init, (batch, init_noise_dim))
    dts = jnp.diff(jnp.asarray(ts))
    dw = jax.random.normal(k_noise, (len(dts), batch, noise_dim)) * jnp.sqrt(dts)[:, None, None]
    return t(z0), t(dw)


# -- models -------------------------------------------------------------------


@pytest.fixture(scope="module")
def vae():
    jmodel = jvae.ConditionalVAE(out_dim=12, latent_dim=4, enc_hidden=(16, 8), dec_hidden=(8, 16))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((6, 12))
    bucket = np.array([0, 3, 9, 5, 5, 1])
    params = to64(jax.jit(jmodel.init)(KEY, jnp.zeros((1, 12)), jnp.zeros((1,), jnp.int32), KEY))
    tmodel = carried(tvae.ConditionalVAE, params, 12, latent_dim=4, enc_hidden=(16, 8),
                     dec_hidden=(8, 16))
    return jmodel, tmodel, params, x, bucket


def test_vae_forward_matches_flax(vae):
    jmodel, tmodel, params, x, bucket = vae
    eps = jax.random.normal(KEY, (6, 4))
    recon, mu, logvar = jax.jit(jmodel.apply)(params, x, bucket, KEY)
    got = tmodel(t(x), t(bucket), t(eps))
    for g, w in zip(got, (recon, mu, logvar)):
        close(g, w)
    close(tvae.vae_loss(*got[:1], t(x), *got[1:], beta=0.5),
          jvae.vae_loss(recon, x, mu, logvar, beta=0.5))
    dec = jax.jit(lambda p, z, b: jmodel.apply(p, z, b, method=jvae.ConditionalVAE.decode))
    close(tmodel.decode(t(eps), t(bucket)), dec(params, eps, bucket))
    round_trip(params)


@pytest.fixture(scope="module")
def flow():
    jmodel = jflows.RealNVP(dim=6, n_coupling=3, hidden=(8, 8), cond_dim=3)
    params = to64(jax.jit(jmodel.init)(KEY, jnp.zeros((1, 6)), jnp.zeros((1, 3))))
    # zero-initialised ActNorms would leave half the bijection untested
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: a + 0.1 * rng.standard_normal(a.shape)
        if "norms" in jax.tree_util.keystr(path) else a, params)
    tmodel = carried(tflows.RealNVP, params, 6, n_coupling=3, hidden=(8, 8), cond_dim=3)
    x = rng.standard_normal((5, 6))
    cond = rng.standard_normal((5, 3))
    return jmodel, tmodel, params, x, cond


def test_flow_matches_flax(flow):
    jmodel, tmodel, params, x, cond = flow
    z, log_det = jax.jit(lambda p, a, c: jmodel.apply(p, a, c, method=jflows.RealNVP.forward))(
        params, x, cond)
    got_z, got_ld = tmodel(t(x), t(cond))
    close(got_z, z)
    close(got_ld, log_det)
    inverse = jax.jit(lambda p, a, c: jmodel.apply(p, a, c, method=jflows.RealNVP.inverse))
    close(tmodel.inverse(t(np.asarray(z)), t(cond)), inverse(params, z, cond))
    close(tmodel.inverse(got_z, t(cond)), x)  # a bijection
    close(tmodel.log_prob(t(x), t(cond)), jax.jit(jmodel.apply)(params, x, cond))
    sample = jax.jit(lambda p, k, c: jmodel.apply(p, k, c, 4, method=jflows.RealNVP.sample))
    zs = jax.random.normal(KEY, (4, 6))
    close(tmodel.sample(t(zs), t(cond[:1])), sample(params, KEY, cond[:1]))
    round_trip(params)
    # the ActNorms are norms.i (log_scale, bias), not LayerNorms
    back = tconvert.state_dict_to_flax_params(tmodel.state_dict())["params"]
    assert set(back["norms_1"]) == {"log_scale", "bias"}
    assert set(back["couplings_2"]) == {"Dense_0", "Dense_1", "Dense_2", "Dense_3"}


@pytest.fixture(scope="module")
def sde_models():
    gen_kw = dict(latent_dim=8, noise_dim=3, hidden=(16,), cond_dim=3)
    disc_kw = dict(hidden_dim=8, f_hidden=(16,), cond_dim=3)
    jgen = jsde.SDEGenerator(data_dim=6, **gen_kw)
    jdisc = jsde.CDEDiscriminator(data_dim=6, **disc_kw)
    cond = np.random.default_rng(2).standard_normal((4, 3))
    g_params = to64(jax.jit(jgen.init, static_argnums=3)(KEY, KEY, TS, 4, cond))
    paths = jax.jit(jgen.apply, static_argnums=3)(g_params, KEY, TS, 4, cond)
    d_params = to64(jax.jit(jdisc.init)(KEY, paths, TS, cond))
    return (jgen, carried(tsde.SDEGenerator, g_params, 6, **gen_kw), g_params,
            jdisc, carried(tsde.CDEDiscriminator, d_params, 6, **disc_kw), d_params, cond)


def test_sde_models_match_flax(sde_models):
    jgen, tgen, g_params, jdisc, tdisc, d_params, cond = sde_models
    key = jax.random.PRNGKey(11)
    paths = jax.jit(jgen.apply, static_argnums=3)(g_params, key, TS, 4, cond)
    got = tgen(t(TS), *sde_draws(key, 4, 3), t(cond))
    assert got.shape == (4, len(TS), 6)
    close(got, paths)
    score = jax.jit(jdisc.apply)(d_params, paths, TS, cond)
    close(tdisc(t(np.asarray(paths)), t(TS), t(cond)), score)
    np.testing.assert_allclose(tsde.lipswish(t(np.linspace(-3, 3, 7))).numpy(),
                               jsde.lipswish(jnp.linspace(-3, 3, 7)), rtol=1e-15)
    for params in (g_params, d_params):
        round_trip(params)
    # named Dense scopes load transposed: readout, embed (a Dense, not an Embed)
    assert tuple(tdisc.embed.weight.shape) == (8, 6 + 1 + 3)
    assert tuple(tgen.readout.weight.shape) == (6, 8)


def test_convert_maps_named_dense_scopes():
    """A ``Dense`` a module names itself loads as ``(out, in)``, both ways; a
    ``DenseGeneral``'s 3-D kernel and a bare ``Embed`` keep their forms."""
    rng = np.random.default_rng(3)
    tree = {"params": {
        "readout": {"kernel": rng.standard_normal((5, 2)), "bias": rng.standard_normal(2)},
        "head": {"Dense_0": {"kernel": rng.standard_normal((3, 4)), "bias": np.zeros(4)}},
        "query": {"kernel": rng.standard_normal((4, 2, 2)), "bias": np.zeros((2, 2))},
        "Embed_0": {"embedding": rng.standard_normal((7, 3))},
        "embed": {"kernel": rng.standard_normal((3, 6)), "bias": np.ones(6)},
        "norms_0": {"log_scale": np.ones(3), "bias": np.zeros(3)},
    }}
    sd = tconvert.flax_params_to_state_dict(tree)
    np.testing.assert_array_equal(sd["readout.weight"].numpy(), tree["params"]["readout"]["kernel"].T)
    np.testing.assert_array_equal(sd["embed.weight"].numpy(), tree["params"]["embed"]["kernel"].T)
    assert tuple(sd["query.kernel"].shape) == (4, 2, 2)
    assert tuple(sd["norms.0.log_scale"].shape) == (3,)
    assert "head.layers.0.weight" in sd
    readout = torch.nn.Linear(5, 2, dtype=F64)
    readout.load_state_dict({"weight": sd["readout.weight"], "bias": sd["readout.bias"]})
    x = rng.standard_normal((3, 5))
    np.testing.assert_allclose(readout(t(x)).detach().numpy(),
                               x @ tree["params"]["readout"]["kernel"] + tree["params"]["readout"]["bias"])
    # "embed" is the Embed_0 table here, a named Dense where it has a bias
    back = tconvert.state_dict_to_flax_params(
        {k: v for k, v in sd.items() if not k.startswith("embed.")})["params"]
    assert "embed" not in back and "Embed_0" not in back
    round_trip({"params": {k: v for k, v in tree["params"].items() if k != "Embed_0"}})
    round_trip({"params": {k: v for k, v in tree["params"].items() if k != "embed"}})


# -- optimizers ---------------------------------------------------------------


def _one_update(opt_torch, optax_tx, steps=1):
    rng = np.random.default_rng(4)
    p0 = rng.standard_normal((3, 4))
    grads = [rng.standard_normal((3, 4)) for _ in range(steps)]
    p = torch.nn.Parameter(t(p0))
    opt = opt_torch([p])
    params, state_ = jnp.asarray(p0), optax_tx.init(jnp.asarray(p0))
    update = jax.jit(lambda g, s, p: optax_tx.update(g, s, p))
    for g in grads:
        opt.step([t(g)])
        updates, state_ = update(jnp.asarray(g), state_, params)
        params = params + updates
    np.testing.assert_allclose(p.detach().numpy(), params, rtol=TOL, atol=TOL)
    return p.detach().numpy() - p0


def test_optimizers_match_optax():
    # bare Adam: clip_norm None skips the clip (SDEGANConfig(adam=True))
    _one_update(lambda ps: tcommon.ClippedAdam(ps, lr=1e-2, clip_norm=None), optax.adam(1e-2), 3)
    # a zero clip zeroes every update, as optax's clip_by_global_norm(0)
    moved = _one_update(lambda ps: tcommon.ClippedAdam(ps, lr=1e-2, clip_norm=0.0),
                        optax.chain(optax.clip_by_global_norm(0.0), optax.adam(1e-2)))
    assert not moved.any()
    # Adadelta with weight decay (the SDE-GAN's default optimizer), three steps
    _one_update(lambda ps: tcommon.Adadelta(ps, 5e-2, weight_decay=0.01),
                optax.adadelta(5e-2, weight_decay=0.01), 3)


# -- trainer steps --------------------------------------------------------------


def test_flow_and_vae_steps_match_jax(flow, vae):
    jmodel, tmodel, params, x, cond = flow
    tmodel = carried(tflows.RealNVP, params, 6, n_coupling=3, hidden=(8, 8), cond_dim=3)
    opt, step = jgenerative.make_flow_trainer(jmodel)
    new, _, loss = step(params, opt.init(params), x, cond)
    _, tstep = tgenerative.make_flow_trainer(tmodel)
    close(tstep(t(x), t(cond)), loss, TOL)
    assert_params(tmodel, new)

    jmodel, _, params, x, bucket = vae
    tmodel = carried(tvae.ConditionalVAE, params, 12, latent_dim=4, enc_hidden=(16, 8),
                     dec_hidden=(8, 16))
    opt, step = jgenerative.make_vae_trainer(jmodel, beta=0.5)
    new, _, loss = step(params, opt.init(params), KEY, x, bucket)
    _, tstep = tgenerative.make_vae_trainer(tmodel, beta=0.5)
    eps = jax.random.normal(KEY, (len(x), 4), jnp.float64)
    close(tstep(t(eps), t(x), t(bucket)), loss, TOL)
    assert_params(tmodel, new)


@pytest.fixture(scope="module")
def sde_setup():
    """Generator and critic on dialanine's 22 atoms (66 features), their
    JAX weights, a real batch and its conditions, and both force fields."""
    jff, _ = jax_system("diala")
    tff, _ = torch_system("diala")
    gen_kw = dict(latent_dim=8, noise_dim=3, hidden=(16,), cond_dim=3)
    disc_kw = dict(hidden_dim=8, f_hidden=(16,), cond_dim=3)
    jgen = jsde.SDEGenerator(data_dim=66, **gen_kw)
    jdisc = jsde.CDEDiscriminator(data_dim=66, **disc_kw)
    rng = np.random.default_rng(5)
    real = 0.3 * rng.standard_normal((4, len(TS), 66))
    cond = rng.standard_normal((4, 3))
    g_params = to64(jax.jit(jgen.init, static_argnums=3)(KEY, KEY, TS, 4, cond))
    d_params = to64(jax.jit(jdisc.init)(KEY, jnp.asarray(real), TS, cond))
    return jff, tff, jgen, jdisc, gen_kw, disc_kw, g_params, d_params, real, cond


STEP_CASES = {
    "g_adadelta_moment_quantile": ("g", dict(moment_weight=1.0, quantile_weight=0.5)),
    "d_gp_adam": ("d", dict(gp_weight=10.0, adam=True, lr_d=1e-2)),
    "d_clamp_adadelta": ("d", dict(weight_clip=0.05)),
    "d_per_layer_clamp_adam": ("d", dict(per_layer_clip=True, adam=True)),
    "informed_adam": ("informed", dict(adam=True, lr_g=1e-3, potential_weight=1e-4)),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_sde_steps_match_jax(sde_setup, case):
    jff, tff, jgen, jdisc, gen_kw, disc_kw, g_params, d_params, real, cond = sde_setup
    kind, kw = STEP_CASES[case]
    cfg = jtrain_sde.SDEGANConfig(**kw)
    _, (opt_g, opt_d), g_step, d_step, informed_step, _ = jtrain_sde.make_sde_gan_trainer(
        jgen, jdisc, jnp.asarray(TS), ff=jff, config=cfg)
    tgen = carried(tsde.SDEGenerator, g_params, 66, **gen_kw)
    tdisc = carried(tsde.CDEDiscriminator, d_params, 66, **disc_kw)
    _, _, tg_step, td_step, tinformed_step, _ = ttrain_sde.make_sde_gan_trainer(
        tgen, tdisc, t(TS), ff=tff, config=ttrain_sde.SDEGANConfig(**kw))
    key = jax.random.PRNGKey(7)
    if kind == "g":
        new, _, loss = g_step(g_params, opt_g.init(g_params), d_params, key, real, cond)
        got, module = tg_step(*sde_draws(key, 4, 3), t(real), t(cond)), tgen
    elif kind == "d":
        new, _, loss = d_step(d_params, opt_d.init(d_params), g_params, key, real, cond)
        k_fake, k_eps = jax.random.split(key)
        eps = jax.random.uniform(k_eps, (4, 1, 1))
        got, module = td_step(*sde_draws(k_fake, 4, 3), t(eps), t(real), t(cond)), tdisc
    else:
        new, _, loss = informed_step(g_params, opt_g.init(g_params), key, 4, cond)
        got, module = tinformed_step(*sde_draws(key, 4, 3), t(cond)), tgen
    close(got, loss, TOL)
    assert_params(module, new)
    if "clamp" in case:  # the clamp bit: a weight sits at its limit
        weights = [p for p in module.parameters() if p.ndim == 2]
        assert any(float(p.detach().abs().max()) == (1.0 / p.shape[0] if "per_layer" in case else 0.05)
                   for p in weights)


def test_sde_init_scaling_and_weight_average(sde_setup):
    jff, tff, jgen, jdisc, gen_kw, disc_kw, g_params, d_params, real, cond = sde_setup
    cfg = dict(init_mult_initial=3.0, init_mult_func=0.5)
    init_fn, _, _, _, _, swa = jtrain_sde.make_sde_gan_trainer(
        jgen, jdisc, jnp.asarray(TS), config=jtrain_sde.SDEGANConfig(**cfg))
    cond32 = jnp.asarray(cond, jnp.float32)
    scaled, _ = jax.jit(init_fn, static_argnums=1)(KEY, 4, cond32)
    kg = jax.random.split(KEY)[0]
    unscaled = jax.jit(jgen.init, static_argnums=3)(kg, kg, jnp.asarray(TS), 4, cond32)
    tgen = carried(tsde.SDEGenerator, to64(unscaled), 66, **gen_kw)
    ttrain_sde.scale_init(tgen, ttrain_sde.SDEGANConfig(**cfg))
    assert_params(tgen, to64(scaled), tol=1e-6)
    # the uniform running average, in place
    other = carried(tsde.SDEGenerator, g_params, 66, **gen_kw)
    avg = jax.jit(swa)(to64(scaled), g_params, 2)
    ttrain_sde.swa_update(tgen, other, 2)
    assert_params(tgen, avg, tol=1e-6)
