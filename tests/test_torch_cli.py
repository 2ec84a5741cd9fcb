"""Port parity: ``config``, ``log``, ``cli`` and ``bench_torch.py``.

The configuration trees equal the JAX package's for the same JSON files and
overrides. ``cli simulate`` on the CPU writes the files the JAX CLI writes,
with its shapes, on both the composed and the campaign path (on CPU tensors
the campaign op takes its plain version). ``cli energy`` prints the JAX
CLI's energies (both round float32 values to 4 decimals), ``cli convert``
writes the JAX CLI's files. The options not ported yet raise, naming their
ROADMAP item.
"""

import ast
import csv
import dataclasses
import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

from molecular_dynamics_tpu import cli as jcli
from molecular_dynamics_tpu import config as jconfig
from molecular_dynamics_tpu import io as jio
from molecular_dynamics_tpu import log as jlog
from molecular_dynamics_tpu_torch import cli as tcli
from molecular_dynamics_tpu_torch import config as tconfig
from molecular_dynamics_tpu_torch import io as tio
from molecular_dynamics_tpu_torch import log as tlog

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDENS = ROOT / "tests" / "goldens"
PSF = str(GOLDENS / "backbone-no-improp.psf")
PDB = str(GOLDENS / "backbone.pdb")
YAML = str(GOLDENS / "param_bb-3.0.yaml")

GBIS_ENERGY = {
    "terms": ["electrostatics", "lj", "bonds", "angles", "dihedrals", "1-4", "impropers",
              "gb", "sasa"],
    "cutoff": 16.0, "rfa": False, "switch_dist": 15.0, "solvent_dielectric": 80.0,
    "ion_concentration": 0.1,
}

CONFIG_CASES = {
    "defaults": ("CampaignConfig", {}, []),
    "gbis_json": ("CampaignConfig",
                  {"topology": "example:full", "n_replicas": 8,
                   "sim": {"dt_fs": 2.0, "fused_campaign": True, "constrain_h_bonds": True,
                           "energy": GBIS_ENERGY}},
                  ["sim.sasa_every=5", "colvar.group2=[103]", "n_steps=2000"]),
    "frozen_leaf": ("CampaignConfig", {"colvar": {"fk": 2.0, "cent_1": 30.0}},
                    ["sim.energy.cutoff=12.0", "sim.fused_campaign=true", "seed=3",
                     "sim.dt_fs=1.0", "out_dir=runs/x"]),
    "no_colvar": ("CampaignConfig", {"colvar": None, "save_every": 25}, ["minimize_steps=0"]),
    "train": ("TrainRunConfig", {"family": "hnn", "epochs": 2}, ["batch_size=16"]),
}


def _tree(cfg, drop):
    """``asdict`` of a config tree without the keys ``drop`` names, where
    the tree has them."""
    tree = dataclasses.asdict(cfg)
    for path in drop:
        node = tree
        for key in path[:-1]:
            node = node.get(key, {})
        node.pop(path[-1], None)
    return tree


@pytest.mark.parametrize("case", sorted(CONFIG_CASES))
def test_config_trees_match_jax(tmp_path, case):
    cls_name, data, overrides = CONFIG_CASES[case]
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(data))
    j = jconfig.apply_overrides(jconfig.load_config(str(path), getattr(jconfig, cls_name)),
                                overrides)
    t = tconfig.apply_overrides(tconfig.load_config(str(path), getattr(tconfig, cls_name)),
                                overrides)
    # the JAX SimulationConfig's TPU block knob is not carried; the port's
    # CampaignConfig also takes a PDB to start from
    jtree = _tree(j, [("sim", "kernel_block_r")])
    ttree = _tree(t, [("coordinates",)])
    assert ttree == jtree
    if cls_name == "CampaignConfig":
        assert t.coordinates == ""


def test_config_unknown_key_raises(tmp_path):
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({"n_replica": 2}))
    with pytest.raises(KeyError, match="CampaignConfig.n_replica"):
        tconfig.load_config(str(path))


def test_simulation_log_and_csv_logger(tmp_path):
    log = {"T": np.arange(6.0).reshape(3, 2), "step": np.array([50, 100, 150])}
    tlog.write_simulation_log(str(tmp_path / "t.csv"), log)
    jlog.write_simulation_log(str(tmp_path / "j.csv"), log)
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()
    logger = tlog.CSVLogger(str(tmp_path / "sub" / "train.csv"), ["epoch", "loss"])
    logger.write_row(epoch=1, loss=0.5)
    logger.close()
    logger = tlog.CSVLogger(str(tmp_path / "sub" / "train.csv"), ["epoch", "loss"])
    logger.write_row(epoch=2)
    logger.close()
    assert tlog.CSVLogger.last_value(str(tmp_path / "sub" / "train.csv"), "epoch") == 2.0
    assert tlog.CSVLogger.last_value(str(tmp_path / "sub" / "train.csv"), "loss") is None


@pytest.mark.parametrize("fused_campaign", [False, True])
def test_simulate_writes_the_jax_files(tmp_path, capsys, fused_campaign):
    out = tmp_path / "out"
    rc = tcli.main([
        "simulate", "--device", "cpu",
        "-o", "n_replicas=2", "-o", "n_steps=100", "-o", "save_every=50",
        "-o", "minimize_steps=200", "-o", "sim.dt_fs=1.0",
        "-o", f"sim.fused_campaign={str(fused_campaign).lower()}",
        "-o", f"out_dir={out}",
    ])
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["replicas"] == 2 and line["steps"] == 100
    assert line["frames"] == [2, 2, 40, 3] and line["out_dir"] == str(out)
    assert line["steps_per_sec"] > 0
    trajs = [np.load(out / f"raw-traj_rep-{r}.npy") for r in range(2)]
    assert all(tr.shape == (2, 40, 3) and np.isfinite(tr).all() for tr in trajs)
    assert not np.array_equal(trajs[0], trajs[1])
    dcd, _ = jio.read_dcd(str(out / "rep0.dcd"))
    assert np.array_equal(dcd, trajs[0])
    np.testing.assert_allclose(tio.read_xyz(str(out / "rep0.xyz")), trajs[0], atol=5e-7)
    with open(out / "sim_log.csv") as fh:
        rows = list(csv.DictReader(fh))
    assert len(rows) == 4 and {"T", "epot", "colvar_value", "colvar_center"} <= set(rows[0])
    temps = [float(r["T"]) for r in rows]
    assert all(50.0 < temp < 600.0 for temp in temps)


def test_simulate_from_psf_yaml_pdb(tmp_path, capsys):
    """A PSF topology carries no coordinates: ``coordinates=`` gives them
    from a PDB (the JAX CLI has no way to); without it the run stops with
    exit code 2, as the JAX CLI's does."""
    base = ["simulate", "--device", "cpu", "-o", f"topology={PSF}", "-o", f"parameters={YAML}",
            "-o", "n_replicas=2", "-o", "n_steps=50", "-o", "save_every=50",
            "-o", "minimize_steps=0", "-o", "sim.dt_fs=1.0", "-o", f"out_dir={tmp_path}/out"]
    assert tcli.main(base) == 2
    assert tcli.main([*base, "-o", f"coordinates={PDB}"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["frames"] == [1, 2, 40, 3]
    traj = np.load(tmp_path / "out" / "raw-traj_rep-0.npy")
    assert np.isfinite(traj).all()
    assert np.abs(traj[0] - tio.read_pdb(PDB)[0]).max() < 1.0


ENERGY_CASES = {
    "example_backbone": (["--topology", "example:backbone"], ["--topology", "example:backbone"]),
    "example_full": (["--topology", "example:full"], ["--topology", "example:full"]),
    # the JAX CLI reads a psf's coordinates from --frames only
    "psf_yaml_pdb": (["--topology", PSF, "--parameters", YAML, "--coordinates", PDB],
                     ["--topology", PSF, "--parameters", YAML, "--frames", "{frames}"]),
}


@pytest.mark.parametrize("case", sorted(ENERGY_CASES))
def test_energy_prints_the_jax_energies(tmp_path, capsys, case):
    targs, jargs = ENERGY_CASES[case]
    frames = tmp_path / "frames.npy"
    np.save(frames, tio.read_pdb(PDB)[0][None])
    assert tcli.main(["energy", "--device", "cpu", *targs]) == 0
    got = ast.literal_eval(capsys.readouterr().out.strip().splitlines()[-1])
    assert jcli.main(["energy", *[a.format(frames=frames) for a in jargs]]) == 0
    want = ast.literal_eval(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(got) == set(want)
    for k, v in want.items():
        assert abs(got[k] - v) <= max(1e-3 * abs(v), 1e-3), (k, got[k], v)


CONVERT_CASES = {
    "dcd_to_npy": ("in.dcd", "out.npy", []),
    "xyz_to_pdb": ("in.xyz", "out.pdb", []),
    "dcd_to_pdb_backbone_aligned": ("in.dcd", "out.pdb",
                                    ["--topology", PSF, "--selection", "backbone", "--align"]),
    "npy_to_npy_aligned": ("in.npy", "out.npy", ["--align"]),
}


@pytest.mark.parametrize("case", sorted(CONVERT_CASES))
def test_convert_writes_the_jax_files(tmp_path, capsys, case):
    src_name, dst_name, extra = CONVERT_CASES[case]
    frames = np.random.default_rng(3).normal(0.0, 5.0, (3, 40, 3)).round(3)
    src = str(tmp_path / src_name)
    if src.endswith(".dcd"):
        jio.write_dcd(src, frames)
    elif src.endswith(".xyz"):
        jio.write_xyz(src, frames)
    else:
        np.save(src, frames.astype(np.float32))
    outs = {}
    for name, main in (("jax", jcli.main), ("torch", tcli.main)):
        outs[name] = tmp_path / f"{name}_{dst_name}"
        assert main(["convert", src, str(outs[name]), *extra]) == 0
    assert outs["torch"].read_bytes() == outs["jax"].read_bytes()
    capsys.readouterr()


def test_unported_options_raise(tmp_path, capsys):
    # train vae runs since the generative line was ported (it raised before)
    data = pathlib.Path(__file__).resolve().parents[1] / "datasets" / "backbone_smd"
    assert tcli.main(["train", "vae", "--device", "cpu", "--data",
                      str(data / "raw-traj_rep-1.npy"), "--stride", "10", "--epochs", "1",
                      "--batch-size", "8", "--out-dir", str(tmp_path)]) == 0
    assert "vae eval:" in capsys.readouterr().out
    # --devices runs since the multi-device layer was ported (it raised
    # NotImplementedError before); more devices than are visible raise
    with pytest.raises(ValueError, match=r"requested a 64-device mesh but only \d+ CUDA"):
        tcli.main(["simulate", "--devices", "64"])
    # xtc, mdxtc and prmtop run since the host I/O was ported (they raised before)
    from molecular_dynamics_tpu_torch.io import native

    frames = np.random.default_rng(4).normal(0.0, 5.0, (2, 12, 3)).astype(np.float32)
    for codec in ("xtc", "mdxtc"):
        getattr(native, f"{codec}_write")(str(tmp_path / f"t.{codec}"), frames)
        assert tcli.main(["convert", str(tmp_path / f"t.{codec}"),
                          str(tmp_path / f"{codec}.npy")]) == 0
        assert np.abs(np.load(tmp_path / f"{codec}.npy") - frames).max() < 0.011
    import torch_files

    tables, names, types, res_ids, res_names = torch_files.chain_tables(6)
    torch_files.write_prmtop(tmp_path / "x.prmtop", tables, names, types, res_ids, res_names)
    np.save(tmp_path / "x.npy", frames[:1, :6])
    capsys.readouterr()
    assert tcli.main(["energy", "--device", "cpu", "--topology", str(tmp_path / "x.prmtop"),
                      "--frames", str(tmp_path / "x.npy")]) == 0
    printed = ast.literal_eval(capsys.readouterr().out.strip().splitlines()[-1])
    assert {"bonds", "angles", "urey_bradley"} <= set(printed)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            tcli.main(["energy"])


def test_bench_command_runs_bench_torch(monkeypatch):
    calls = []
    monkeypatch.setattr("subprocess.call", lambda cmd: calls.append(cmd) or 0)
    assert tcli.main(["bench", "--device", "cpu"]) == 0
    (cmd,) = calls
    assert pathlib.Path(cmd[1]) == ROOT / "bench_torch.py" and cmd[2:] == ["--device", "cpu"]


def test_bench_torch_prints_one_record(monkeypatch, capsys):
    """bench_torch.py at 2 replicas x 50 steps on the CPU, through its knobs:
    one JSON line in bench.py's form, with the spread of the timed calls.
    Its FIRE start is cut from 500 to 100 steps: no assert reads it."""
    spec = importlib.util.spec_from_file_location("bench_torch", ROOT / "bench_torch.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    fire = bench.minimize_fire
    monkeypatch.setattr(bench, "minimize_fire",
                        lambda *args, **kw: fire(*args, **{**kw, "n_steps": 100}))
    monkeypatch.setenv("MDX_BENCH_REPLICAS", "2")
    monkeypatch.setenv("MDX_BENCH_STEPS", "50")
    assert bench.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    record = json.loads(lines[0])
    assert {"metric", "value", "unit", "secondary"} <= set(record)
    assert record["metric"].endswith("_rigidbonds_steps_per_sec_2rep")
    assert len(record["runs"]) == 3 and record["min"] <= record["value"] <= record["max"]
    assert {"gbis_steps_per_sec", "gbis_sasa_steps_per_sec"} <= set(record["secondary"])
    assert record["device"] == "cpu"
