"""Shared helpers of the ``test_torch_*.py`` parity tests.

The JAX package is the reference; the port (``molecular_dynamics_tpu_torch``)
never imports it. Whatever crosses between the two crosses here, as numpy
arrays, through the port's ``convert`` module.
"""

import dataclasses
import functools
import pathlib

import numpy as np
import jax
import jax.numpy as jnp
import torch

from molecular_dynamics_tpu_torch import convert as tconvert

# The tests run in several worker processes at once; torch's intra-op pool,
# one thread per core in each of them, would oversubscribe the cores many
# times over for tensors of a few hundred atoms.
torch.set_num_threads(1)

SYSTEMS = ("full_da", "diala")


def ff_to_numpy(ff) -> dict:
    """Leaves of a JAX ``FFParams`` as numpy arrays (None leaves dropped)."""
    return {
        f.name: np.asarray(getattr(ff, f.name))
        for f in dataclasses.fields(ff)
        if getattr(ff, f.name) is not None
    }


@functools.lru_cache(maxsize=None)
def jax_system(name: str, f64: bool = True):
    """(FFParams, coords) of a packaged system from the JAX loader."""
    from molecular_dynamics_tpu.examples import decaalanine_full, dialanine

    loader = {"full_da": decaalanine_full, "diala": dialanine}[name]
    ff, coords, _ = loader(dtype=jnp.float64 if f64 else jnp.float32)
    return ff, np.asarray(coords)


@functools.lru_cache(maxsize=None)
def torch_system(name: str, f64: bool = True):
    """The same system carried across through ``convert`` (CPU tensors)."""
    ff, coords = jax_system(name, f64)
    tff = tconvert.ff_params_from_numpy(
        ff_to_numpy(ff), device="cpu",
        dtype=torch.float64 if f64 else torch.float32,
    )
    return tff, coords


#: ``fire_full_da()``'s result, kept so that the test workers read it
#: instead of each minimising again (seconds each); ``JAX_PLATFORMS=cpu
#: PYTHONPATH=. python tests/torch_parity.py`` writes it anew
MINIMIZED_FULL_DA = pathlib.Path(__file__).parent / "goldens" / "full_da_fire500.npy"


def fire_full_da() -> np.ndarray:
    """FIRE-minimised float32 coordinates of the 104-atom system (500 steps,
    the campaign's settings) from the port's own minimiser; its parity with
    the JAX minimiser has a test of its own."""
    from molecular_dynamics_tpu_torch.energy import force_fn
    from molecular_dynamics_tpu_torch.integrate import minimize_fire

    tff, coords = torch_system("full_da", f64=False)
    force = force_fn()
    pos = minimize_fire(
        torch.as_tensor(coords, dtype=torch.float32),
        lambda p: force(p, tff), n_steps=500, dt_start=1e-3, dt_max=1e-2,
    )
    return pos.numpy()


@functools.lru_cache(maxsize=None)
def minimized_full_da() -> np.ndarray:
    """``fire_full_da()``, as kept in ``MINIMIZED_FULL_DA``: the start of
    the 104-atom parity tests (both packages start from it)."""
    return np.load(MINIMIZED_FULL_DA)


def thermal_velocities(masses: np.ndarray, n_replicas: int, seed: int = 0) -> np.ndarray:
    """Maxwell-Boltzmann velocities at 300 K from numpy, ``(R, N, 3)`` f32."""
    from molecular_dynamics_tpu_torch import units

    rng = np.random.default_rng(seed)
    std = np.sqrt(units.BOLTZMANN * 300.0 / np.asarray(masses, np.float64))
    return (std[None, :, None] * rng.normal(size=(n_replicas, len(masses), 3))).astype(np.float32)


def t(x, dtype=None):
    """numpy -> CPU torch tensor."""
    out = torch.as_tensor(np.array(x))
    return out if dtype is None else out.to(dtype)


def float64_lstm_carries(monkeypatch):
    """Give flax's ``OptimizedLSTMCell`` float64 zero carries: ``nn.RNN``
    scans the cell from ``initialize_carry``, whose zeros follow the
    float32 ``param_dtype``, and a scan over weights cast to float64 would
    otherwise change its carry's type. The zeros are the same numbers."""
    import flax.linen as nn

    initialize = nn.OptimizedLSTMCell.initialize_carry

    def carry64(self, rng, input_shape):
        return jax.tree.map(lambda c: c.astype(jnp.float64), initialize(self, rng, input_shape))

    monkeypatch.setattr(nn.OptimizedLSTMCell, "initialize_carry", carry64)


if __name__ == "__main__":
    np.save(MINIMIZED_FULL_DA, fire_full_da())
