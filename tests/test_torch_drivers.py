"""Port parity: the training drivers, ``cli train`` and the SMD
data-generation twin, end to end on the CPU at tiny sizes.

``run_training`` for ``pretrain`` and ``cgan`` on synthetic backbone data
(two trajectories of 60 frames, 1 epoch, batch 8, as the JAX package's
driver test runs them) writes the log, the best checkpoint, the generated
``.xyz`` / ``.pdb`` and an ``eval.json`` whose every value equals the JAX
driver's epilogue on the same generated structures (float32: 1e-5
relative). A diverged informed loss rolls the generator back to the
snapshot of the best probe. ``_bootstrap_dataset`` runs at 2 replicas x
200 steps. ``regenerate_smd`` and ``scripts/regenerate_smd.py`` run at the
same 2 replicas x 130 steps in vacuum on the composed path: the twin writes
the script's files and ``summary.json`` keys, its FIRE minimum, bias,
chunks and logged colvar centres equal the script's, and its summary of
the script's own frames and log equals the script's summary.
"""

import contextlib
import csv
import io
import json
import pathlib
import runpy
import sys

import jax
import numpy as np
import pytest
import torch

from molecular_dynamics_tpu.train import drivers as jdrivers
from molecular_dynamics_tpu.train import datasets as jdata
from molecular_dynamics_tpu_torch import cli as tcli
from molecular_dynamics_tpu_torch import regenerate_smd
from molecular_dynamics_tpu_torch.examples import BACKBONE_FF_PRM, decaalanine_backbone
from molecular_dynamics_tpu_torch.ff import YamlForceField, build_ff_params
from molecular_dynamics_tpu_torch.io import read_dcd, read_xyz
from molecular_dynamics_tpu_torch.train import cgan as tcgan
from molecular_dynamics_tpu_torch.train import drivers as tdrivers

import torch_parity  # noqa: F401  (one torch thread a test worker)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARTIFACTS = {
    "pretrain": ("train_log.csv", "best.ckpt", "pretrain_generated.xyz", "pretrain_generated.pdb",
                 "eval.json"),
    "cgan": ("train_log.csv", "best.ckpt", "cGAN_generated.xyz", "cGAN_generated.pdb", "eval.json"),
}


@pytest.fixture(scope="module")
def data_glob(tmp_path_factory):
    top, coords = decaalanine_backbone()
    rng = np.random.default_rng(0)
    root = tmp_path_factory.mktemp("data")
    for r in range(2):
        frames = np.asarray(coords)[None] + 0.3 * rng.standard_normal(
            (60, top.n_atoms, 3)).astype(np.float32)
        np.save(root / f"traj-{r}.npy", frames.astype(np.float32))
    return str(root / "*.npy")


@pytest.mark.parametrize("family", sorted(ARTIFACTS))
def test_run_training(family, data_glob, tmp_path):
    assert tdrivers.run_training(family=family, data=data_glob, epochs=1, batch_size=8,
                                 out_dir=str(tmp_path), seed=0, device="cpu") == 0
    run = tmp_path / family
    for name in ARTIFACTS[family]:
        assert (run / name).exists(), name
    with open(run / "eval.json") as fh:
        metrics = json.load(fh)
    assert all(np.isfinite(v) for v in metrics.values())
    assert metrics["mean_abs_error"] < 100.0
    with open(run / "train_log.csv") as fh:
        rows = fh.read().splitlines()
    assert rows[0] == "epoch,step,loss,wall_s" and len(rows) > 1
    # the epilogue equals the JAX driver's on the same generated structures
    generated = read_xyz(str(run / ARTIFACTS[family][2]))
    traj = jdata.TrajectoryData.from_npy_glob(data_glob)
    jdir = tmp_path / "jax"
    jdir.mkdir()
    want = jdrivers._eval_generated(str(jdir), family, generated, traj)
    got = tdrivers._eval_generated(str(tmp_path), family, generated, traj)
    assert got.keys() == want.keys() == metrics.keys()
    for key in want:
        assert got[key] == pytest.approx(want[key], rel=1e-5, abs=1e-6), key


def test_cli_train_cgan(data_glob, tmp_path, capsys):
    assert tcli.main(["train", "cgan", "--device", "cpu", "--data", data_glob, "--epochs", "1",
                      "--batch-size", "8", "--stride", "2", "--out-dir", str(tmp_path)]) == 0
    assert "cgan eval:" in capsys.readouterr().out
    assert (tmp_path / "cgan" / "eval.json").exists()


def test_unported_families_and_devices_raise(data_glob, tmp_path, monkeypatch):
    """The generative families run (they raised until they were ported; the
    SDE at narrow widths); several devices run the data-parallel families
    since the multi-device layer was ported, and raise for the others."""
    for knob, value in (("MDX_SDE_HIDDEN", "16"), ("MDX_SDE_LATENT", "8"),
                        ("MDX_SDE_NOISE", "4"), ("MDX_FLOW_HIDDEN", "32")):
        monkeypatch.setenv(knob, value)
    for family in ("vae", "sde", "flow"):
        assert tdrivers.run_training(family=family, data=data_glob, epochs=1, batch_size=8,
                                     out_dir=str(tmp_path), device="cpu") == 0
        assert (tmp_path / family / f"{tdrivers.GENERATED[family]}.xyz").exists()
        assert (tmp_path / family / "eval.json").exists()
    with pytest.raises(ValueError, match="'vae' trains on one device"):
        tdrivers.run_training(family="vae", data=data_glob, devices=2, device="cpu")


def test_cgan_rollback_restores_the_best_snapshot(data_glob, tmp_path, monkeypatch):
    """An informed loss that turns NaN rolls the generator back to the
    weights of the best probe, cloned when it was taken (not an alias of
    the live weights), and restarts the G and informed optimizers."""
    clones, at_reset, calls = [], [], [0]
    clone = tdrivers._clone_state
    monkeypatch.setattr(tdrivers, "_clone_state", lambda m: clones.append(clone(m)) or clones[-1])
    informed = tcgan.CGANTrainer.informed_step

    def failing_informed(self, z, t):
        loss = informed(self, z, t)
        calls[0] += 1
        return loss if calls[0] < 15 else torch.tensor(float("nan"))

    reset = tcgan.CGANTrainer.reset_generator_optimizers

    def checked_reset(self):
        if clones:
            at_reset.append(all(torch.equal(v, clones[-1][k])
                                for k, v in self.generator.state_dict().items()))
        reset(self)

    monkeypatch.setattr(tcgan.CGANTrainer, "informed_step", failing_informed)
    monkeypatch.setattr(tcgan.CGANTrainer, "reset_generator_optimizers", checked_reset)
    # 60 pretrain updates, then 30 GAN rounds: probes at 70 (finite), 80 and 90 (NaN)
    tdrivers.run_training(family="cgan", data=data_glob, epochs=2, batch_size=8,
                          out_dir=str(tmp_path), seed=0, device="cpu")
    assert len(clones) == 2 and at_reset == [True, True]
    with open(tmp_path / "cgan" / "eval.json") as fh:
        assert np.isfinite(json.load(fh)["mean_abs_error"])


def _jax_cgan_run(data_glob, out_dir):
    """The JAX driver's ``cgan`` run (2 epochs, batch 8, seed 0) with its
    initial weights and the latents of every update recorded, in the order
    the updates ran (each step draws its own from its key)."""
    import jax

    from molecular_dynamics_tpu.train import cgan as jcgan

    rec = {"z": [], "losses": []}
    make_pretrain, make_trainer = jcgan.make_pretrain_step, jcgan.make_cgan_trainer
    normal = jax.jit(jax.random.normal, static_argnums=1)

    def recorded(step, phase, loss_at):
        def run(*args):
            key, t = args[loss_at[0]], args[loss_at[1]]
            rec["z"].append(np.asarray(normal(key, (t.shape[0], 31))))
            out = step(*args)
            rec["losses"].append((phase, float(out[2])))
            return out
        return run

    def make_pretrain_step(*args, **kw):
        opt, step = make_pretrain(*args, **kw)
        return opt, recorded(step, "pretrain", (2, 4))

    def make_cgan_trainer(*args, **kw):
        init_fn, opts, g_step, d_step, i_step = make_trainer(*args, **kw)

        def init(key):
            rec["init"] = jax.jit(init_fn)(key)
            return rec["init"]

        return (init, opts, recorded(g_step, "g", (3, 4)), recorded(d_step, "d", (3, 5)),
                recorded(i_step, "informed", (2, 3)))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcgan, "make_pretrain_step", make_pretrain_step)
        mp.setattr(jcgan, "make_cgan_trainer", make_cgan_trainer)
        assert jdrivers.run_training(family="cgan", data=data_glob, epochs=2, batch_size=8,
                                     out_dir=str(out_dir), seed=0) == 0
    return rec


def _log_rows(path):
    with open(path) as fh:
        return [(int(r["epoch"]), int(r["step"]), float(r["loss"])) for r in csv.DictReader(fh)]


def test_cgan_driver_matches_jax(data_glob, tmp_path, monkeypatch):
    """The port's ``cgan`` driver loop against the JAX driver's, from JAX's
    initial weights and with JAX's latents fed through ``_latents``: the
    same batches, alpha curriculum, order of the updates and probe cadence
    give the same logged losses (60 pretrain updates, then 30 GAN rounds;
    9 rows within 1e-3 relative: the port's float32 drifts from the JAX
    driver's float64 arithmetic on float32 weights by up to 2e-4 there)."""
    from molecular_dynamics_tpu_torch import convert as tconvert
    from molecular_dynamics_tpu_torch.models import cgan as tmodels

    rec = _jax_cgan_run(data_glob, tmp_path / "jax")
    g_init, d_init = (tconvert.flax_params_to_state_dict(
        jax.tree.map(np.asarray, params), torch.float32) for params in rec["init"])
    queue = list(rec["z"])

    def carried(cls, state):
        def build(*args, **kw):
            module = cls(*args, **kw)
            module.load_state_dict(state)
            return module
        return build

    def latents(gen, n, latent_dim):
        if not queue:  # the generation sweep after training, not compared
            return torch.zeros((n, latent_dim))
        z = queue.pop(0)
        assert z.shape == (n, latent_dim)
        return torch.tensor(z, dtype=torch.float32)

    losses = []

    def recorded(phase, step):
        def run(self, *args):
            out = step(self, *args)
            losses.append((phase, float(out[0] if phase == "pretrain" else out)))
            return out
        return run

    monkeypatch.setattr(tcgan.PretrainStep, "__call__", recorded("pretrain", tcgan.PretrainStep.__call__))
    for phase in ("g", "d", "informed"):
        step = getattr(tcgan.CGANTrainer, f"{phase}_step")
        monkeypatch.setattr(tcgan.CGANTrainer, f"{phase}_step", recorded(phase, step))
    monkeypatch.setattr(tmodels, "Generator", carried(tmodels.Generator, g_init))
    monkeypatch.setattr(tmodels, "Discriminator", carried(tmodels.Discriminator, d_init))
    monkeypatch.setattr(tdrivers, "_latents", latents)
    tdrivers.run_training(family="cgan", data=data_glob, epochs=2, batch_size=8,
                          out_dir=str(tmp_path / "torch"), seed=0, device="cpu")
    assert not queue and len(rec["z"]) == 60 + 3 * 30
    want = _log_rows(tmp_path / "jax" / "cgan" / "train_log.csv")
    got = _log_rows(tmp_path / "torch" / "cgan" / "train_log.csv")
    assert [r[:2] for r in got] == [r[:2] for r in want] and len(want) == 9
    np.testing.assert_allclose([r[2] for r in got], [r[2] for r in want], rtol=1e-3)
    # the updates in the same order, each on a finite loss
    phases = [phase for phase, _ in rec["losses"]]
    assert [phase for phase, _ in losses] == phases == ["pretrain"] * 60 + ["g", "d", "informed"] * 30
    assert np.isfinite([value for _, value in losses]).all()


def test_bootstrap_dataset(tmp_path, monkeypatch):
    import molecular_dynamics_tpu_torch as tmdx

    # the start's FIRE at 100 of its 1000 steps: no assert reads the minimum
    fire = tmdx.minimize_fire
    monkeypatch.setattr(tmdx, "minimize_fire", lambda *a, **kw: fire(*a, **{**kw, "n_steps": 100}))
    top, coords = decaalanine_backbone()
    ff = build_ff_params(top, YamlForceField(BACKBONE_FF_PRM), device="cpu")
    frames = tdrivers._bootstrap_dataset(ff, coords, str(tmp_path), n_replicas=2, n_steps=200,
                                         device="cpu")
    assert frames.shape == (2, 4, 40, 3) and np.isfinite(frames).all()
    for r in range(2):
        assert np.array_equal(np.load(tmp_path / f"raw-traj_rep-{r}.npy"), frames[r])


#: both SMD scripts' arguments in the tests below: vacuum, the composed path,
#: 130 steps cut to 120 (the quantum is save_every x obs_every = 40 steps),
#: in three chunks of 40 (--chunk-steps 50 rounded down to the quantum)
SMD_ARGS = ["--replicas", "2", "--steps", "130", "--save-every", "20", "--obs-every", "2",
            "--chunk-steps", "50", "--no-fused", "--forces", "--max-dump", "2"]


def _recorded_run(pkg, sim, run):
    """``run()`` with what it passes to ``system_init`` (FIRE's result),
    ``HarmonicSMDBias.create`` and each ``simulate_ensemble`` call recorded,
    and the last line it printed."""
    rec = {"start": [], "bias": [], "chunks": []}
    init, create, simulate = pkg.system_init, pkg.HarmonicSMDBias.create, sim.simulate_ensemble

    def system_init(pos, *args, **kw):
        rec["start"].append(np.array(pos.detach() if torch.is_tensor(pos) else pos))
        return init(pos, *args, **kw)

    def bias_create(cls, **kw):
        rec["bias"].append(kw)
        return create(**kw)

    def simulate_ensemble(states, ff, n_steps, save_every, *args, **kw):
        rec["chunks"].append((n_steps, save_every, kw["obs_every"]))
        return simulate(states, ff, n_steps, save_every, *args, **kw)

    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(buf):
        mp.setattr(pkg, "system_init", system_init)
        mp.setattr(pkg.HarmonicSMDBias, "create", classmethod(bias_create))
        mp.setattr(sim, "simulate_ensemble", simulate_ensemble)
        run()
    return rec, json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.fixture(scope="module")
def smd_runs(tmp_path_factory):
    """``scripts/regenerate_smd.py`` (JAX) and the port's twin at ``SMD_ARGS``:
    for each its output directory, printed summary and recorded calls."""
    import molecular_dynamics_tpu as jmdx
    import molecular_dynamics_tpu.sim as jsim
    import molecular_dynamics_tpu_torch as tmdx
    import molecular_dynamics_tpu_torch.sim as tsim

    root = tmp_path_factory.mktemp("smd")
    script = ROOT / "scripts" / "regenerate_smd.py"

    def run_jax():
        import molecular_dynamics_tpu.integrate as jintegrate

        init_forces = jintegrate.initialize_forces
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(sys, "argv", [str(script), *SMD_ARGS, "--out", str(root / "jax")])
            # the script's seed forces, jitted (op by op they take seconds)
            mp.setattr(jintegrate, "initialize_forces",
                       lambda state, force_fn: init_forces(state, jax.jit(force_fn)))
            runpy.run_path(str(script), run_name="__main__")

    def run_torch():
        argv = [*SMD_ARGS, "--out", str(root / "torch"), "--device", "cpu"]
        assert regenerate_smd.main(argv) == 0

    runs = {}
    for side, pkg, sim, run in (("jax", jmdx, jsim, run_jax), ("torch", tmdx, tsim, run_torch)):
        rec, summary = _recorded_run(pkg, sim, run)
        runs[side] = {"out": root / side, "summary": summary, **rec}
    return runs


def test_regenerate_smd_twin(smd_runs):
    run = smd_runs["torch"]
    out, printed = run["out"], run["summary"]
    with open(out / "summary.json") as fh:
        summary = json.load(fh)
    assert summary == printed
    assert list(summary) == list(smd_runs["jax"]["summary"])
    assert summary["frames_shape"] == [6, 2, 104, 3] and summary["all_finite"]
    assert summary["physics"] == "vacuum(rfa)" and summary["steps"] == 130
    for r in range(2):
        frames = np.load(out / f"raw-traj_rep-{r}.npy")
        forces = np.load(out / f"raw-forces_rep-{r}.npy")
        assert frames.shape == forces.shape == (6, 104, 3) and np.isfinite(forces).all()
    dcd, _ = read_dcd(str(out / "rep0.dcd"))
    assert np.array_equal(dcd, np.load(out / "raw-traj_rep-0.npy"))
    log = np.load(out / "full_log.npz")
    assert log["T"].shape == (3, 2) and {"colvar_value", "colvar_center"} <= set(log.files)
    with open(out / "sim_log.csv") as fh:
        assert len(fh.read().splitlines()) == 1 + 2  # the first logged save of both replicas


def test_regenerate_smd_steps_match_jax_script(smd_runs):
    """The twin's deterministic steps against the JAX script's on the same
    start coordinates: FIRE's 1000 steps (float32 in both: positions within
    2e-3 A), the bias from the measured end-to-end distance (its centres
    within 1e-3 A), the chunks, and the logged centre and step at every
    logged save."""
    jax_run, torch_run = smd_runs["jax"], smd_runs["torch"]
    (j_start,), (t_start,) = jax_run["start"], torch_run["start"]
    np.testing.assert_allclose(t_start, j_start, atol=2e-3)
    (j_bias,), (t_bias,) = jax_run["bias"], torch_run["bias"]
    t_bias = {k: v for k, v in t_bias.items() if k != "device"}
    assert sorted(t_bias) == sorted(j_bias)
    for key in ("n_atoms", "group1", "group2", "fk", "T"):
        assert t_bias[key] == j_bias[key], key
    d0 = float(np.linalg.norm(t_start[-1] - t_start[0]))
    assert t_bias["cent_0"] == pytest.approx(d0, abs=1e-5)
    for key in ("cent_0", "cent_1"):
        assert t_bias[key] == pytest.approx(j_bias[key], abs=1e-3), key
    assert t_bias["cent_1"] - t_bias["cent_0"] == pytest.approx(22.0, abs=1e-5)
    assert torch_run["chunks"] == jax_run["chunks"] == [(40, 20, 2)] * 3
    j_log, t_log = np.load(jax_run["out"] / "full_log.npz"), np.load(torch_run["out"] / "full_log.npz")
    assert sorted(t_log.files) == sorted(j_log.files)
    np.testing.assert_array_equal(t_log["step"], j_log["step"])
    np.testing.assert_allclose(t_log["colvar_center"], j_log["colvar_center"], atol=1e-3)
    for key in ("replicas", "physics", "steps", "sim_ns_per_replica", "frames_shape"):
        assert torch_run["summary"][key] == jax_run["summary"][key], key


#: one unit in the last place the JAX script rounds each summary value to
SUMMARY_UNIT = {"rg_mean_A": 1e-3, "rg_std_A": 1e-3, "e2e_mean_A": 1e-2, "e2e_final_mean_A": 1e-2,
                "colvar_start_A": 1e-2, "colvar_end_A": 1e-2, "colvar_target_end_A": 1e-2,
                "colvar_mean_lag_A": 1e-2, "temperature_mean_K": 1e-1}


def test_regenerate_smd_summary_matches_jax_script(smd_runs):
    """``regenerate_smd.summarize`` on the JAX script's own frames and log
    gives its summary.json: every value within one unit of the place it is
    rounded to (the timings aside)."""
    from molecular_dynamics_tpu_torch.examples import decaalanine_full

    out, want = smd_runs["jax"]["out"], smd_runs["jax"]["summary"]
    frames = np.stack([np.load(out / f"raw-traj_rep-{r}.npy") for r in range(2)], axis=1)
    log = dict(np.load(out / "full_log.npz"))
    masses = decaalanine_full(device="cpu")[0].masses.numpy()
    got = regenerate_smd.summarize(regenerate_smd.parse_args(SMD_ARGS), frames, log, masses,
                                   elapsed=1.0, dt_fs=2.0)
    assert list(got) == list(want)
    for key, value in want.items():
        if key in ("wall_s", "aggregate_steps_per_sec"):
            continue
        if key in SUMMARY_UNIT:
            assert abs(got[key] - value) <= SUMMARY_UNIT[key] * (1 + 1e-9), (key, got[key], value)
        else:
            assert got[key] == value, key
