"""Port parity: several devices (``parallel``), on the CPU.

The twins of ``tests/test_parallel.py``: a mesh that asks for more CUDA
devices than are visible raises; the sharded composed step and the
sharded campaign op equal the unsharded ones (float64: 1e-12 A), and at
300 K the campaign's shards draw distinct noise streams; the data-parallel
informed-loss gradients equal the JAX package's on its 8-device mesh from
the same weights (float64 on both sides: 1e-9 of the largest entry); a
two-rank ``run_training`` (gloo on the CPU) logs the one-process run's
losses (float32: 1e-6 relative) and writes its files once; the
``divisible`` and family raises; ``cli simulate --devices 2``;
``dryrun_multichip(2)``.

Two process spawns in all: the module fixture ``ranks`` (the gradients
and both training runs, on two ranks, while this process computes JAX's
gradients and the one-process runs) and ``dryrun_multichip``.
"""

import csv
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molecular_dynamics_tpu_torch import cli as tcli
from molecular_dynamics_tpu_torch import convert as tconvert
from molecular_dynamics_tpu_torch.examples import decaalanine_backbone
from molecular_dynamics_tpu_torch.ops import fused_step
from molecular_dynamics_tpu_torch.parallel import (
    Mesh,
    dryrun_multichip,
    get_mesh,
    replicate_params,
    shard_batch,
    shard_campaign_advance,
    shard_ensemble,
)
from molecular_dynamics_tpu_torch.parallel import data as pdata
from molecular_dynamics_tpu_torch.sim import SimulationConfig, simulate_ensemble
from molecular_dynamics_tpu_torch.train import drivers as tdrivers

import torch_parity
import torch_ranks

HIDDEN = 16           # the informed-gradient generator's one hidden layer
JAX_DEVICES = 8       # tests/conftest.py's virtual CPU devices
TOL_SHARDED = 1e-12   # A, float64: sharded against unsharded
TOL_GRADS = 1e-9      # of the largest entry of each gradient, float64 on both sides
TOL_LOGGED = 1e-6     # relative, float32: two ranks against one process
#: two trajectories of 41 frames: ten updates of batch 4 and one logged
#: row (pretrain at stride 2), lstm's twelve and eight fine-tune updates
TRAIN = {"families": ("pretrain", "lstm"), "frames": 41, "batch": 4,
         "stride": {"pretrain": 2, "lstm": 1}}


def _ensemble(n_rep, temperature_k=300.0):
    """A float64 104-atom ensemble (the packaged start, one velocity draw,
    per-replica keys) and its force field."""
    import molecular_dynamics_tpu_torch as mdx
    from molecular_dynamics_tpu_torch.integrate import initialize_forces
    from molecular_dynamics_tpu_torch.system import replicate

    tff, coords = torch_parity.torch_system("full_da")
    pos = torch.as_tensor(coords, dtype=torch.float64)
    gen = torch.Generator()
    gen.manual_seed(0)
    state = mdx.system_init(pos, vel=mdx.maxwell_boltzmann(gen, tff.masses, temperature_k),
                            dtype=torch.float64, device="cpu")
    force = mdx.force_fn(mdx.REFERENCE_CONFIG)
    state = initialize_forces(state, lambda p, box: force(p, tff))
    return tff, replicate(state, n_rep, seed=1)


def test_get_mesh_rejects_oversubscription():
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match=f"requested a {visible + 1}-device mesh but only "
                                         f"{visible} CUDA devices are visible"):
        get_mesh(visible + 1)
    mesh = get_mesh(3, axis_name="dp", device="cpu")
    assert mesh.devices == (torch.device("cpu"),) * 3 and mesh.axis_name == "dp"
    with pytest.raises(ValueError, match="do not split|does not split"):
        shard_batch(torch.zeros(4, 2), mesh)
    # one copy a mesh entry, equal but not shared
    copies = replicate_params({"w": torch.ones(2)}, Mesh(("cpu", "cpu")))
    copies[0]["w"].add_(1.0)
    assert float(copies[1]["w"][0]) == 1.0


@pytest.mark.parametrize("fused", [False, True], ids=["composed", "campaign"])
def test_sharded_ensemble_step_matches_unsharded(fused):
    """The composed path keeps one noise stream over the shards, so it
    equals the unsharded run at 300 K; the campaign op equals it at 0 K."""
    tff, ens = _ensemble(4)
    mesh = get_mesh(2, device="cpu")
    cfg = SimulationConfig(dt_fs=1.0, temperature=0.0 if fused else 300.0,
                           fused_campaign=fused)
    shards = shard_ensemble(ens, mesh)
    assert [s.pos.shape[0] for s in shards] == [2, 2]
    got = simulate_ensemble(shards, tff, 2, 1, cfg, mesh=mesh, save_forces=True)
    want = simulate_ensemble(ens, tff, 2, 1, cfg, save_forces=True)
    for name, a, b in (("frames", got[1], want[1]), ("forces", got[3], want[3]),
                       ("final pos", got[0].pos, want[0].pos),
                       ("final vel", got[0].vel, want[0].vel)):
        assert a.shape == b.shape, name
        assert float((a - b).abs().max()) <= TOL_SHARDED, name
    assert got[2].keys() == want[2].keys()
    for key in want[2]:
        assert float((got[2][key] - want[2][key]).abs().max()) <= TOL_SHARDED * 1e3, key


def test_sharded_campaign_shards_draw_distinct_streams():
    """At 300 K from identical replicas, replica j of shard 1 parts from
    replica j of shard 0, and shard 1 is the op at ``seed + n_local``."""
    tff, ens = _ensemble(4, temperature_k=0.0)
    op = fused_step.make_fused_campaign_op(tff, n_inner=2, dt_fs=1.0, temperature=300.0)
    mesh = get_mesh(2, device="cpu")
    sharded = shard_campaign_advance(op, mesh)
    assert sharded.n_inner == 2
    pos, vel, frc = (shard_ensemble(x.contiguous(), mesh) for x in (ens.pos, ens.vel, ens.forces))
    out = sharded(pos, vel, frc, 0, 7)
    assert float((out[0][1][0] - out[0][0][0]).abs().max()) > 1e-4
    alone = op(pos[1], vel[1], frc[1], 0, 7 + 2)
    assert torch.equal(out[0][1], alone[0]) and torch.equal(out[1][1], alone[1])
    same = op(pos[0], vel[0], frc[0], 0, 7)
    assert torch.equal(out[0][0], same[0])
    # one op a mesh device, as simulate_ensemble builds them; a device
    # without one raises
    by_device = shard_campaign_advance({torch.device("cpu"): op}, mesh)(pos, vel, frc, 0, 7)
    assert all(torch.equal(a, b) for a, b in zip(by_device[0], out[0]))
    with pytest.raises(ValueError, match="no campaign op"):
        shard_campaign_advance({torch.device("meta"): op}, mesh)


def _write_data(root):
    top, coords = decaalanine_backbone()
    rng = np.random.default_rng(0)
    root.mkdir()
    for r in range(2):
        frames = np.asarray(coords)[None] + 0.3 * rng.standard_normal(
            (TRAIN["frames"], top.n_atoms, 3))
        np.save(root / f"traj-{r}.npy", frames.astype(np.float32))
    return str(root / "*.npy")


def _jax_informed(root):
    """JAX's informed loss at a generator near the real structure: its
    weights, latents and times go to ``root/informed.npz`` for the ranks.
    Returns ``grads()``, the loss's gradient on JAX's 8-device mesh."""
    from molecular_dynamics_tpu.bias import HarmonicSMDBias
    from molecular_dynamics_tpu.energy import REFERENCE_CONFIG
    from molecular_dynamics_tpu.examples import BACKBONE_FF_PRM
    from molecular_dynamics_tpu.examples import decaalanine_backbone as jbackbone
    from molecular_dynamics_tpu.ff import YamlForceField, build_ff_params
    from molecular_dynamics_tpu.models.cgan import Generator
    from molecular_dynamics_tpu.parallel import get_mesh as jmesh, replicate_params as jrep
    from molecular_dynamics_tpu.parallel import shard_batch as jshard
    from molecular_dynamics_tpu.train.losses import bias_energy_loss, potential_loss

    top, _ = jbackbone()
    ff = build_ff_params(top, YamlForceField(BACKBONE_FF_PRM), dtype=jnp.float64)
    n = top.n_atoms
    bias = HarmonicSMDBias.create(n_atoms=n, group1=[0], group2=[n - 1], fk=1.0, cent_0=12.0,
                                  cent_1=34.0, T=10000.0, dtype=jnp.float64)
    gen = Generator(n_atoms=n, hidden=(HIDDEN,))
    batch = 2 * JAX_DEVICES
    z = jax.random.normal(jax.random.PRNGKey(0), (batch, 31), jnp.float64)
    t = jnp.linspace(0.0, 1.0, batch, dtype=jnp.float64)
    params = jax.jit(gen.init)(jax.random.PRNGKey(1), z, t)
    # a generator near the real structure, so that the potential is physical
    # (a random one collapses the atoms, and its gradients reach 1e18)
    last = params["params"]["Dense_1"]
    last["kernel"] = 0.01 * last["kernel"]
    last["bias"] = jnp.asarray(jbackbone()[1], jnp.float32).reshape(-1)
    # float64 weights (flax keeps them float32, and their gradients with them)
    params = jax.tree.map(lambda x: x.astype(jnp.float64), params)
    weights = tconvert.flax_params_to_state_dict(jax.device_get(params), dtype=torch.float64)
    np.savez(root / "informed.npz", z=np.asarray(z), t=np.asarray(t), hidden=HIDDEN,
             **{f"w:{k}": v.numpy() for k, v in weights.items()})

    def loss(p, z, t):
        coords = gen.apply(p, z, t, method=Generator.coords)
        return (potential_loss(coords, ff, config=REFERENCE_CONFIG)
                + 200.0 * bias_energy_loss(coords, bias, t * 10000.0))

    def grads():
        mesh = jmesh(JAX_DEVICES, axis_name="dp")
        g = jax.jit(jax.grad(loss))(jrep(params, mesh), jshard(z, mesh, "dp"),
                                    jshard(t, mesh, "dp"))
        return tconvert.flax_params_to_state_dict(jax.device_get(g), dtype=torch.float64)

    return grads


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """One spawn of two gloo ranks: the informed gradients, then
    ``run_training``'s rank body for pretrain and lstm. While they run, this
    process computes JAX's gradients and the one-process training runs.
    Returns the root, the training runs' keyword arguments and JAX's
    gradients."""
    import torch.multiprocessing as mp

    root = tmp_path_factory.mktemp("ranks")
    data = _write_data(root / "data")
    jax_grads = _jax_informed(root)
    kwargs = {f: dict(family=f, data=data, data_stride=TRAIN["stride"][f],
                      topology="example:backbone", parameters="", epochs=1,
                      batch_size=TRAIN["batch"], out_dir=str(root / "two"), seed=0)
              for f in TRAIN["families"]}
    # the ranks' bodies as ``pdata.spawn`` runs them, left running meanwhile
    ctx = mp.start_processes(
        pdata.rank_main, nprocs=2, join=False, start_method="spawn",
        args=(torch_ranks.jobs, [torch.device("cpu")] * 2, "gloo", pdata.free_port(),
              (root, list(kwargs.values()))))
    try:
        want = jax_grads()
        for family, kw in kwargs.items():
            assert tdrivers.run_training(**{**kw, "out_dir": str(root / "one")},
                                         devices=1, device="cpu") == 0, family
        while not ctx.join():
            pass
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.terminate()
    return root, kwargs, want


def test_data_parallel_grads_match_jax(ranks):
    root, _, jax_grads = ranks
    port = dict(np.load(root / "port_grads.npz"))
    assert port.keys() == jax_grads.keys()
    for key, want in jax_grads.items():
        want = want.numpy()
        scale = np.abs(want).max()
        assert scale > 0.0, key
        assert np.abs(port[key] - want).max() <= TOL_GRADS * scale, key


@pytest.mark.parametrize("family", TRAIN["families"])
def test_run_training_with_devices(ranks, family):
    """The two-rank run against ``run_training(devices=1)``'s (the fixture
    runs both)."""
    root, _, _ = ranks
    one, two = root / "one" / family, root / "two" / family
    assert sorted(p.name for p in two.iterdir()) == sorted(p.name for p in one.iterdir())
    with open(two / "eval.json") as fh:
        assert np.isfinite(json.load(fh)["mean_abs_error"])
    logged = {}
    for name, run in (("one", one), ("two", two)):
        with open(run / "train_log.csv") as fh:
            logged[name] = [(int(r["step"]), float(r["loss"])) for r in csv.DictReader(fh)]
    assert [s for s, _ in logged["two"]] == [s for s, _ in logged["one"]] and logged["one"]
    for (_, a), (_, b) in zip(logged["two"], logged["one"]):
        assert a == pytest.approx(b, rel=TOL_LOGGED)


def test_run_training_devices_raises(tmp_path):
    with pytest.raises(ValueError, match="divisible"):
        tdrivers.run_training(family="lstm", data="", epochs=1, batch_size=3,
                              out_dir=str(tmp_path), devices=2, device="cpu")
    with pytest.raises(ValueError, match="trains on one device"):
        tdrivers.run_training(family="vae", data="", epochs=1, batch_size=4,
                              out_dir=str(tmp_path), devices=2, device="cpu")
    with pytest.raises(ValueError, match="3 rows do not split into 2 equal blocks"):
        pdata.DataParallel(0, 2, "cpu").rows(np.zeros(3))
    # batch 8 on 8 ranks leaves the lstm fine-tune's 4 rows short of a rank
    with pytest.raises(ValueError, match="fine-tune's batch of .* = 4 rows must be divisible"):
        tdrivers.run_training(family="lstm", data="", epochs=1, batch_size=8,
                              out_dir=str(tmp_path), devices=8, device="cpu")
    with pytest.raises(ValueError, match="but only 0 CUDA devices are visible"):
        tdrivers.run_training(family="lstm", data="", epochs=1, batch_size=4,
                              out_dir=str(tmp_path), devices=2)


def test_cli_simulate_devices(tmp_path, capsys):
    common = ["-o", "n_replicas=2", "-o", "n_steps=20", "-o", "save_every=10",
              "-o", "minimize_steps=50", "-o", "sim.dt_fs=1.0", "-o", "sim.temperature=0.0",
              "-o", "sim.fused_campaign=true"]
    for devices in (1, 2):
        assert tcli.main(["simulate", "--device", "cpu", "--devices", str(devices), *common,
                          "-o", f"out_dir={tmp_path / str(devices)}"]) == 0
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert line["frames"] == [2, 2, 40, 3]
    for r in range(2):
        a, b = (np.load(tmp_path / d / f"raw-traj_rep-{r}.npy") for d in ("1", "2"))
        assert np.abs(a - b).max() <= 1e-6
    with pytest.raises(ValueError, match="requested a 2-device mesh but only 0"):
        tcli.main(["simulate", "--devices", "2"])


def test_dryrun_multichip():
    res = dryrun_multichip(2)
    assert res["device"] == "cpu" and res["campaign_shards"]["gbis_sasa"] == ["cpu", "cpu"]
