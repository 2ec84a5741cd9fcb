"""Port parity: the generation maps of ``gat``, ``hnn-schnet`` and
``seq2seq-graph`` from the JAX package's trained weights.

The committed ``runs_r3/<family>/best.ckpt`` is read by the JAX package's
``checkpoint.load`` (its model's ``init`` the template) and carried into the
port by ``convert.flax_params_to_state_dict``. Both drivers then run at
``epochs=0`` (no update, no fine-tune): the rollouts at their full length,
with the clamps, the stride, the kNN graphs and ``max_step`` that trained
weights drive, and the evaluator. Every eval.json key agrees within
``TOL`` = 2e-3 A, float32. ``seq2seq-graph``'s rollout draws replay the JAX
driver's key splits. Two rollout starts a family (``torch_trained.DATA``),
never shorter rollouts.

The weights, the draws and JAX's eval.json are also kept in
``tests/goldens/trained_generation/`` for ``chip_smoke.py``, which runs the
same maps on the card without JAX; each test asserts that those files equal
a fresh conversion and JAX's fresh numbers, so that they cannot go stale.
``JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_trained_generation.py``
writes them anew, with JAX's default float32; under the suite's x64 setting
(``conftest.py``) the fresh JAX numbers lie within the same tolerance.
"""

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import molecular_dynamics_tpu.log as jlog
from molecular_dynamics_tpu.models import gat as jgat
from molecular_dynamics_tpu.models import hnn as jhnn
from molecular_dynamics_tpu.models import schnet as jschnet
from molecular_dynamics_tpu.train import checkpoint as jcheckpoint
from molecular_dynamics_tpu.train import drivers as jdrivers
from molecular_dynamics_tpu_torch import convert as tconvert

import torch_parity  # one torch thread a test worker
import torch_trained

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: family -> the JAX package's model class
JAX_MODELS = {"gat": jgat.GATSimulator, "hnn-schnet": jschnet.SchNetHNN,
              "seq2seq-graph": jgat.GraphSeq2Seq}
#: seq2seq-graph's decode length (the driver's)
GSEQ_DECODE = 5


def _loading(init, path, loaded):
    """``init``, jitted, as the template of ``checkpoint.load(path)``; what
    it loads is returned and recorded in ``loaded``."""
    def load(self, *args, **kw):
        static = tuple(i for i, a in enumerate(args) if isinstance(a, int))
        template = jax.jit(lambda *a: init(self, *a, **kw), static_argnums=static)(*args)
        loaded["params"] = jcheckpoint.load(str(path), template)
        return loaded["params"]
    return load


def gseq_noise(n_starts, n_segments, n_atoms, feat=5, seed=0):
    """The JAX seq2seq-graph driver's rollout draws at ``epochs=0``: a
    subkey split off the run's key for each start, then one split a segment
    (``graph_chained_decode_rollout``) and the decoder's normal of
    ``(decode, N, feat)``; as ``(segments, starts, decode, N, feat)``."""
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(n_starts):
        key, k = jax.random.split(key)
        segs = []
        for _ in range(n_segments):
            k, s = jax.random.split(k)
            segs.append(np.asarray(
                jax.random.normal(s, (GSEQ_DECODE, n_atoms, feat), jnp.float32)))
        out.append(np.stack(segs))
    return torch.as_tensor(np.stack(out, axis=1))


def jax_generation(family, out_dir):
    """The JAX driver at ``epochs=0`` from ``runs_r3/<family>/best.ckpt``:
    its eval.json, the weights as the port's state dict, and (seq2seq-graph)
    the rollout draws."""
    loaded = {}
    _, _, env = torch_trained.FAMILIES[family]
    cls = JAX_MODELS[family]
    with pytest.MonkeyPatch.context() as mp:
        for k, v in env.items():
            mp.setenv(k, v)
        ckpt = ROOT / "runs_r3" / family / "best.ckpt"
        mp.setattr(cls, "init", _loading(cls.init, ckpt, loaded))
        mp.setattr(jhnn, "rollout", torch_parity.jitted_rollout(jhnn.rollout))
        mp.setattr(jlog, "plot_losses", lambda *a, **k: None)
        assert jdrivers.run_training(family=family, data=torch_trained.DATA, epochs=0,
                                     batch_size=32, out_dir=str(out_dir), seed=0) == 0
    state = tconvert.flax_params_to_state_dict(jax.tree.map(np.asarray, loaded["params"]),
                                               torch.float32)
    noise = None
    if family == "seq2seq-graph":
        frames = np.load(sorted(pathlib.Path(torch_trained.DATA).parent.glob(
            pathlib.Path(torch_trained.DATA).name))[0])
        noise = gseq_noise(2, len(frames) // GSEQ_DECODE, frames.shape[1])
    return json.loads((pathlib.Path(out_dir) / family / "eval.json").read_text()), state, noise


@pytest.fixture(scope="module", params=sorted(torch_trained.FAMILIES))
def jax_run(request, tmp_path_factory):
    family = request.param
    return (family, *jax_generation(family, tmp_path_factory.mktemp(f"jax-{family}")))


def test_trained_generation_matches_jax(jax_run, tmp_path):
    """Every eval.json key of the port's map within 2e-3 A of JAX's."""
    family, want, state, noise = jax_run
    got = torch_trained.port_generation(family, tmp_path, "cpu", state, noise)
    assert sorted(got) == sorted(want)
    for key in want:
        assert abs(got[key] - want[key]) <= torch_trained.TOL, (family, key, got[key], want[key])


def test_trained_generation_goldens_are_fresh(jax_run):
    """The weights and draws kept for ``chip_smoke.py`` equal a fresh
    conversion of best.ckpt and the JAX driver's keys, and the kept eval.json
    lies within the tolerance of JAX's fresh one."""
    family, want, state, noise = jax_run
    kept = torch_trained.golden(family)
    assert sorted(kept["state_dict"]) == sorted(state)
    for name, value in state.items():
        assert torch.equal(kept["state_dict"][name], value), (family, name)
    if noise is None:
        assert kept["noise"] is None
    else:
        assert torch.equal(kept["noise"], noise)
    golden = torch_trained.golden_eval()[family]
    assert sorted(golden) == sorted(want)
    for key in want:
        assert abs(golden[key] - want[key]) <= torch_trained.TOL, (family, key)


def write_goldens(tmp):
    torch_trained.GOLDENS.mkdir(parents=True, exist_ok=True)
    evals = {}
    for family in sorted(torch_trained.FAMILIES):
        evals[family], state, noise = jax_generation(family, pathlib.Path(tmp) / family)
        torch.save({"state_dict": state, "noise": noise}, torch_trained.GOLDENS / f"{family}.pt")
    torch_trained.GOLDEN_EVAL.write_text(json.dumps(evals, indent=1, sort_keys=True) + "\n")


if __name__ == "__main__":
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        write_goldens(tmp)
