"""The plain reference: its float32 forces against its float64 forces, its
forces against finite differences of its own energy, and (the one place the
program is imported beside it) its energy, forces and noise against the
port's plain versions on the CPU."""

import numpy as np
import pytest
import torch

from mdbench import spec
from mdbench.reference import dynamics as D
from mdbench.reference import energy as E
from mdbench.reference.system import build_system, load_arrays

ARRAYS = load_arrays(spec.HERE / "data" / "full_da.npz")
CONFIGS = {n: spec.load_json(spec.HERE / "configs" / f"{n}.json")
           for n in ("decaala104-gbis", "decaala104-vacuum")}


def _positions(dtype=torch.float64, rows=3):
    gen = torch.Generator().manual_seed(5)
    pos = torch.as_tensor(ARRAYS["coords"], dtype=torch.float64)
    return (pos + 0.05 * torch.randn((rows, 104, 3), generator=gen, dtype=torch.float64)).to(
        dtype)


def _bias(dtype):
    return E.Bias(104, [0], [103], 1.0, 20.0, 22.0, 500000, "cpu", dtype)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_float32_forces_agree_with_float64(name):
    e = CONFIGS[name]["energy"]
    pos = _positions()
    step = torch.tensor([0, 1000, 499999])
    f64 = E.forces(pos, build_system(ARRAYS, "cpu", torch.float64), e, _bias(torch.float64), step)
    f32 = E.forces(pos.float(), build_system(ARRAYS, "cpu", torch.float32), e,
                   _bias(torch.float32), step)
    scale = float(f64.norm(dim=-1).median())
    assert float((f32.double() - f64).norm(dim=-1).max()) / scale < 1e-4


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forces_are_minus_the_gradient_of_the_energy(name):
    e = CONFIGS[name]["energy"]
    s = build_system(ARRAYS, "cpu", torch.float64)
    bias, step = _bias(torch.float64), torch.tensor([200])
    pos = _positions(rows=1)
    f = E.forces(pos, s, e, bias, step)
    h = 1e-5
    for atom, axis in ((0, 0), (37, 1), (103, 2), (60, 0)):
        dp = torch.zeros_like(pos)
        dp[0, atom, axis] = h
        up = E.potential(pos + dp, s, e) + bias.energy(pos + dp, step)
        down = E.potential(pos - dp, s, e) + bias.energy(pos - dp, step)
        fd = -float(up - down) / (2 * h)
        assert fd == pytest.approx(float(f[0, atom, axis]), rel=1e-6, abs=1e-6)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_energy_and_forces_match_the_port_in_float64(name):
    from molecular_dynamics_tpu_torch.energy import GBIS_CONFIG, REFERENCE_CONFIG, force_fn
    from molecular_dynamics_tpu_torch.energy import total_energy
    from molecular_dynamics_tpu_torch.examples import decaalanine_full

    ff, _, _ = decaalanine_full(dtype=torch.float64, device="cpu")
    port_cfg = GBIS_CONFIG if "gb" in CONFIGS[name]["energy"]["terms"] else REFERENCE_CONFIG
    e = CONFIGS[name]["energy"]
    s = build_system(ARRAYS, "cpu", torch.float64)
    pos = _positions()
    assert torch.allclose(E.potential(pos, s, e), total_energy(pos, ff, config=port_cfg),
                          rtol=1e-12, atol=1e-9)
    assert torch.allclose(E.forces(pos, s, e), force_fn(port_cfg)(pos, ff), rtol=1e-10,
                          atol=1e-9)


def test_noise_matches_the_port():
    from molecular_dynamics_tpu_torch.integrate import mix_seed
    from molecular_dynamics_tpu_torch.ops.fused_step import philox_normals
    from molecular_dynamics_tpu_torch.system import replicate, system_init

    seed = 2**31 + 77
    keys = D.replica_keys(seed, 8)
    state = replicate(system_init(torch.zeros(104, 3), device="cpu"), 8, seed=seed)
    assert torch.equal(keys, state.key)
    assert D.mix_seed(int(keys[0]), 4000) == mix_seed(int(keys[0]), 4000)
    stream = D.mix_seed(int(keys[0]), 4000)
    want = philox_normals(stream, 4000, 3, 8, 104)  # (steps, R, N, 3)
    rows = torch.tensor([0, 5, 7])
    for i in range(3):
        got = D.normals(torch.full((3,), stream), rows, torch.full((3,), 4000 + i), 104)
        assert torch.equal(got, want[i, rows])


def test_reference_segment_follows_the_ports_plain_campaign():
    """One segment of the reference from a state, against the port's plain
    campaign op on the same state (float64 both), under the held cadence."""
    from molecular_dynamics_tpu_torch import HarmonicSMDBias
    from molecular_dynamics_tpu_torch.examples import decaalanine_full
    from molecular_dynamics_tpu_torch.integrate import mix_seed
    from molecular_dynamics_tpu_torch.sim import SimulationConfig, _campaign_advance_fn
    from molecular_dynamics_tpu_torch.energy import GBIS_CONFIG

    cfg = CONFIGS["decaala104-gbis"]
    traffic = {"sasa_every": 5, "gb_every": 1}
    ff, coords, _ = decaalanine_full(dtype=torch.float64, device="cpu")
    bias = HarmonicSMDBias.create(104, [0], [103], 1.0, 20.0, 42.0, 500000.0,
                                  dtype=torch.float64, device="cpu")
    sim = SimulationConfig(energy=GBIS_CONFIG, fused_campaign=True, constrain_h_bonds=True,
                           sasa_every=5)
    advance = _campaign_advance_fn(ff, 10, sim, bias)
    pos = _positions(rows=2)
    gen = torch.Generator().manual_seed(3)
    vel = 0.01 * torch.randn(pos.shape, generator=gen, dtype=torch.float64)
    s = build_system(ARRAYS, "cpu", torch.float64)
    rbias = E.Bias(104, [0], [103], 1.0, 20.0, 22.0, 500000, "cpu", torch.float64)
    frc = E.forces(pos, s, cfg["energy"], rbias, torch.tensor([99, 99]))
    stream = mix_seed(1234, 100)
    p_port, v_port, f_port = advance(pos, vel, frc, 100, stream)
    p_ref, v_ref, f_ref = D.segment(pos, vel, frc, torch.tensor([100, 100]),
                                    torch.tensor([stream, stream]), torch.tensor([0, 1]), s, cfg,
                                    traffic, rbias, 10)
    assert float((p_port - p_ref).abs().max()) < 1e-5
    assert float((v_port - v_ref).abs().max()) < 1e-5
    assert np.isfinite(p_ref.numpy()).all()
