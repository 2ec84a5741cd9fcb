"""Port parity: the API as a whole.

Every module of the JAX package has its twin in the port, and every public
top-level function, class and upper-case constant of a JAX module is bound
at the top level of its twin, or stands in ``ACCOUNTED`` with the name that
carries it in the port or the reason it is not carried (ROADMAP §A, "Not
carried, by design"). Both packages are read with ``ast``; neither is
imported. The port imports nothing of JAX and nothing of the JAX package.
"""

import ast
import pathlib

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_PKG = ROOT / "molecular_dynamics_tpu"
PORT_PKG = ROOT / "molecular_dynamics_tpu_torch"

#: TPU layout, not carried (ROADMAP §A and its rule 1, "port the physics,
#: not the TPU layout")
TPU_LAYOUT = "not carried, by design: TPU layout"

#: (JAX module, name) -> the port's twin of the name (a top-level name of the
#: twin module), or why the port does not carry it
ACCOUNTED = {
    ("constraints.py", "make_matmul_projectors"):
        TPU_LAYOUT + " (MXU difference-matrix projections; the port projects with index lists)",
    ("ops/fused_step.py", "fused_campaign_fits"):
        TPU_LAYOUT + " (the 512-padded-atom Mosaic gate; the port dispatches by "
        "sim.campaign_holds)",
    ("ops/nonbonded.py", "LANE"): TPU_LAYOUT + " (lane padding to 128)",
    ("ops/nonbonded.py", "dense_pair_forces"): "dense_pair_math",
    ("ops/ring.py", "build_ring_tables"):
        TPU_LAYOUT + " (the ring-shift pairing and its halved halfway row)",
    ("ops/ring.py", "ring_pair_forces"): "pair_forces",
    ("train/cgan.py", "make_cgan_trainer"): "CGANTrainer",
    ("train/cgan.py", "make_pretrain_step"): "PretrainStep",
    ("train/common.py", "make_state"): "ClippedAdam",
}

#: top-level packages the port never imports
JAX_WORLD = ("jax", "jaxlib", "flax", "optax", "molecular_dynamics_tpu")


def _modules(pkg: pathlib.Path):
    return sorted(p.relative_to(pkg).as_posix() for p in pkg.rglob("*.py"))


def _tree(path: pathlib.Path) -> ast.Module:
    return ast.parse(path.read_text(), filename=str(path))


def _public(tree: ast.Module) -> set:
    """Public top-level functions, classes and upper-case constants."""
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            names.update(n.id for t in targets for n in ast.walk(t)
                         if isinstance(n, ast.Name) and n.id.isupper())
    return {n for n in names if not n.startswith("_")}


def _bound(tree: ast.Module) -> set:
    """Every name a module binds at its top level, imports included, also
    under a top-level ``if`` or ``try``."""
    names = set()
    for top in tree.body:
        nodes = ast.walk(top) if isinstance(top, (ast.If, ast.Try)) else [top]
        for node in nodes:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                names.add(node.name)
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = node.targets if isinstance(node, ast.Assign) else [node.target]
                names.update(n.id for t in targets for n in ast.walk(t) if isinstance(n, ast.Name))
            elif isinstance(node, (ast.Import, ast.ImportFrom)):
                names.update((a.asname or a.name).split(".")[0] for a in node.names)
    return names


def test_every_jax_module_has_its_twin():
    port = set(_modules(PORT_PKG))
    assert [m for m in _modules(JAX_PKG) if m not in port] == []


def test_every_public_jax_name_is_in_its_twin_or_accounted_for():
    missing, stale = [], []
    for module in _modules(JAX_PKG):
        bound = _bound(_tree(PORT_PKG / module))
        for name in sorted(_public(_tree(JAX_PKG / module))):
            twin = ACCOUNTED.get((module, name))
            if name in bound:
                if twin is not None:
                    stale.append((module, name))  # the port now carries it as it is
            elif twin is None:
                missing.append((module, name))
            elif not twin.startswith("not carried") and twin not in bound:
                missing.append((module, f"{name} -> {twin}"))
    assert missing == [], "public JAX names the port neither carries nor accounts for"
    assert stale == [], "ACCOUNTED lists names the port's twin binds as they are"
    # every entry of the table names a public name of a JAX module
    assert all(name in _public(_tree(JAX_PKG / module)) for module, name in ACCOUNTED)


def test_port_imports_nothing_of_jax():
    """No module of the port, nor ``chip_smoke.py`` or ``bench_torch.py``,
    imports JAX, its libraries or the JAX package."""
    found = []
    for path in [PORT_PKG / m for m in _modules(PORT_PKG)] + [ROOT / "chip_smoke.py", ROOT / "bench_torch.py"]:
        for node in ast.walk(_tree(path)):
            if isinstance(node, ast.Import):
                imported = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                imported = [node.module]
            else:
                continue
            found += [(path.relative_to(ROOT).as_posix(), m) for m in imported
                      if m.split(".")[0] in JAX_WORLD]
    assert found == []
