"""Port parity: the sequence and graph models against their flax twins.

Each flax model (``LSTMPredictor``, ``LSTMNLLPredictor``,
``SequenceDiscriminator``, ``Seq2Seq``, ``Seq2SeqNLL``,
``TrajectoryTransformer`` with its ``EncoderBlock``s, ``DenseGATLayer``,
``GATSimulator``, ``LSTMGAT``, ``GraphSeq2Seq``) is initialised at small
widths, its weights cast to float64 and carried into the port's module
through ``convert.flax_params_to_state_dict``; both forwards on the same
inputs agree to 1e-10, the decoders fed JAX's own noise draws. The weight
trees cross both ways exactly (``load_state_dict`` is strict, and the port's
state dict goes back to the flax tree bit for bit). The LSTM keeps one trainable bias a gate,
and the models' batched forwards equal their rows one at a time.

The LSTM models cast their input to float32 as flax's do, so the inputs
are float32 values (held in float64); flax's LSTM carries start as float64
zeros (``torch_parity.float64_lstm_carries``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molecular_dynamics_tpu.models import gat as jgat
from molecular_dynamics_tpu.models import seq as jseq
from molecular_dynamics_tpu.models import transformer as jtransformer
from molecular_dynamics_tpu_torch import convert as tconvert
from molecular_dynamics_tpu_torch.models import gat as tgat
from molecular_dynamics_tpu_torch.models import seq as tseq
from molecular_dynamics_tpu_torch.models import transformer as ttransformer

from torch_parity import float64_lstm_carries, t

F64 = torch.float64
TOL = 1e-10
KEY = jax.random.PRNGKey(3)


@pytest.fixture(autouse=True)
def _carries(monkeypatch):
    float64_lstm_carries(monkeypatch)


def f32(rng, *shape):
    """Standard normals rounded to float32, held in float64."""
    return rng.standard_normal(shape).astype(np.float32).astype(np.float64)


def numpy64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


def carried(jmodel, init_args, tmodule):
    """flax params (float64) and the port module carrying them (an integer
    argument of ``init``, a decode length, is static)."""
    static = tuple(i + 1 for i, a in enumerate(init_args) if isinstance(a, int))
    params = numpy64(jax.jit(jmodel.init, static_argnums=static)(KEY, *init_args))
    tmodule.load_state_dict(tconvert.flax_params_to_state_dict(params, F64))  # strict
    # and back: every leaf of the flax tree, bit for bit
    back = tconvert.state_dict_to_flax_params(tmodule.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)
    return params, tmodule


def close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def cpu64(cls, *args, **kw):
    return cls(*args, generator=torch.Generator().manual_seed(0), device="cpu", dtype=F64, **kw)


# -- the LSTM models ----------------------------------------------------------------


CASES = {
    "lstm": (lambda: jseq.LSTMPredictor(out_dim=6, hidden_size=16, n_layers=2),
             lambda: cpu64(tseq.LSTMPredictor, 5, 6, 16, 2)),
    "nll": (lambda: jseq.LSTMNLLPredictor(out_dim=6, hidden_size=16),
            lambda: cpu64(tseq.LSTMNLLPredictor, 5, 6, 16)),
    "critic": (lambda: jseq.SequenceDiscriminator(hidden_size=16),
               lambda: cpu64(tseq.SequenceDiscriminator, 5, 16)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_window_models_match_flax(name):
    rng = np.random.default_rng(0)
    jmodel, tmodule = CASES[name][0](), CASES[name][1]()
    window = f32(rng, 3, 4, 5)
    params, tmodule = carried(jmodel, (jnp.zeros((1, 4, 5)),), tmodule)
    want = jax.jit(jmodel.apply)(params, window)
    got = tmodule(t(window))
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        close(g, w)
    # the same rows one at a time: the batch axis is a batch axis
    close(tmodule(t(window[1]))[0] if name == "nll" else tmodule(t(window[1])),
          (want[0] if name == "nll" else want)[1])


def test_gaussian_nll_matches_jax():
    rng = np.random.default_rng(1)
    mu, target = f32(rng, 4, 6), f32(rng, 4, 6)
    sigma = np.abs(f32(rng, 4, 6)) + 0.1
    close(tseq.gaussian_nll(t(mu), t(sigma), t(target)), jseq.gaussian_nll(mu, sigma, target))


@pytest.mark.parametrize("nll", [False, True], ids=["seq2seq", "seq2seq_nll"])
def test_seq2seq_matches_flax(nll):
    """The decoder fed JAX's draw: ``normal(key, (B, L, noise_dim))``."""
    rng = np.random.default_rng(2)
    cls_j, cls_t = (jseq.Seq2SeqNLL, tseq.Seq2SeqNLL) if nll else (jseq.Seq2Seq, tseq.Seq2Seq)
    jmodel = cls_j(out_dim=6, hidden_size=16, noise_dim=4)
    params, tmodule = carried(jmodel, (jnp.zeros((1, 4, 5)), KEY, 3),
                              cpu64(cls_t, 5, 6, 16, 4))
    window, key = f32(rng, 3, 4, 5), jax.random.PRNGKey(7)
    want = jax.jit(jmodel.apply, static_argnums=3)(params, window, key, 3)
    noise = jax.random.normal(key, (3, 3, 4), jnp.float32)
    got = tmodule(t(window), t(noise, F64))
    for g, w in zip(got if nll else (got,), want if nll else (want,)):
        close(g, w)
    assert tmodule.noise_shape((3,), 3) == (3, 3, 4)


def test_lstm_layer_keeps_one_bias_and_flax_init():
    """Three parameters a layer (the input bias is a zero buffer outside
    the state dict), gates initialised as flax's: LeCun-normal input
    kernels, orthogonal recurrent ones, zero bias."""
    layer = tseq.LSTMLayer(300, 64, generator=torch.Generator().manual_seed(0), device="cpu")
    assert [n for n, _ in layer.named_parameters()] == ["weight_ih", "weight_hh", "bias"]
    assert list(layer.state_dict()) == ["weight_ih", "weight_hh", "bias"]
    assert not layer.bias.any() and not layer.zero_bias.any()
    for g in range(4):
        block = layer.weight_hh.detach()[g * 64: (g + 1) * 64].double()
        np.testing.assert_allclose(block @ block.T, np.eye(64), atol=1e-5)
        kernel = layer.weight_ih.detach()[g * 64: (g + 1) * 64]
        assert abs(float(kernel.std()) - (1 / 300) ** 0.5) < 0.1 * (1 / 300) ** 0.5
        assert float(kernel.abs().max()) <= 2 * (1 / 300) ** 0.5 / 0.8796 + 1e-6


# -- the transformer ----------------------------------------------------------------


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_transformer_matches_flax(causal):
    """flax's LayerNorm epsilon, tanh GELU and SelfAttention layout."""
    rng = np.random.default_rng(3)
    jmodel = jtransformer.TrajectoryTransformer(out_dim=6, d_model=8, n_heads=2, n_layers=2,
                                                d_ff=16, causal=causal)
    tmodule = cpu64(ttransformer.TrajectoryTransformer, 6, 6, d_model=8, n_heads=2, n_layers=2,
                    d_ff=16, history=5, causal=causal)
    params, tmodule = carried(jmodel, (jnp.zeros((1, 5, 6)),), tmodule)
    # trained-looking LayerNorm weights, so that scale and bias are both read
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: a + 0.1 * rng.standard_normal(a.shape)
        if "LayerNorm" in jax.tree_util.keystr(path) else a, params)
    tmodule.load_state_dict(tconvert.flax_params_to_state_dict(params, F64))
    window = rng.standard_normal((3, 5, 6))
    close(tmodule(t(window)), jax.jit(jmodel.apply)(params, window))


# -- the graph models ---------------------------------------------------------------


def test_dense_gat_layer_matches_flax():
    """A row with no edge gives zeros."""
    rng = np.random.default_rng(4)
    jmodel = jgat.DenseGATLayer(out_dim=8)
    h = rng.standard_normal((2, 6, 4))
    adj = rng.random((2, 6, 6)) < 0.5
    adj[0, 2] = False
    params, tmodule = carried(jmodel, (h[0], adj[0]), cpu64(tgat.DenseGATLayer, 4, 8))
    got = tmodule(t(h), t(adj))
    close(got, jax.jit(jax.vmap(jmodel.apply, (None, 0, 0)))(params, h, adj))
    assert not got[0, 2].any()


def test_gat_simulator_and_gns_rollout_match_flax():
    """k = 3 of 6 atoms (a real kNN graph) and k = 40 (complete, capped at
    N - 1); the rollout's velocity history oldest first."""
    rng = np.random.default_rng(5)
    pos, vel = rng.standard_normal((2, 6, 3)), rng.standard_normal((2, 2, 6, 3))
    nodes = np.concatenate([pos, vel[:, 0], vel[:, 1]], axis=-1)
    for k in (3, 40):
        jmodel = jgat.GATSimulator(latent=8, n_processors=2, k=k)
        params, tmodule = carried(jmodel, (nodes[0], pos[0]),
                                  cpu64(tgat.GATSimulator, 9, latent=8, n_processors=2, k=k))
        close(tmodule(t(nodes), t(pos)),
              jax.jit(jax.vmap(jmodel.apply, (None, 0, 0)))(params, nodes, pos))
    want = jax.jit(lambda p, x, v: jgat.gns_rollout(jmodel, p, x, v, 3, dt=0.5))(
        params, pos[0], vel[0])
    close(tgat.gns_rollout(tmodule, t(pos[0]), t(vel[0]), 3, dt=0.5), want)


def test_lstm_gat_matches_flax():
    rng = np.random.default_rng(6)
    history, pos = f32(rng, 2, 6, 4, 3), rng.standard_normal((2, 6, 3))
    jmodel = jgat.LSTMGAT(hidden_size=8, latent=8, n_processors=2, k=3)
    params, tmodule = carried(jmodel, (history[0], pos[0]),
                              cpu64(tgat.LSTMGAT, 3, 3, 8, 8, 2, 3))
    close(tmodule(t(history), t(pos)),
          jax.jit(jax.vmap(jmodel.apply, (None, 0, 0)))(params, history, pos))


def test_graph_seq2seq_matches_flax():
    """Two rows, each with its own key as JAX's graph trainer splits them,
    the noise ``normal(key_b, (L, N, F))``; batched in the port."""
    rng = np.random.default_rng(7)
    window = f32(rng, 2, 6, 4, 5)
    jmodel = jgat.GraphSeq2Seq(hidden_size=8, k=2)
    params, tmodule = carried(jmodel, (window[0], KEY, 3), cpu64(tgat.GraphSeq2Seq, 5, 8, 2))
    keys = jax.random.split(jax.random.PRNGKey(11), 2)
    want = jax.jit(jax.vmap(lambda w, k: jmodel.apply(params, w, k, 3)))(window, keys)
    noise = np.stack([np.asarray(jax.random.normal(k, (3, 6, 5), jnp.float32)) for k in keys])
    close(tmodule(t(window), t(noise, F64)), want)
