"""No benchmark process loads the JAX side, compared by whole top-level
name; the reference and the yardstick load nothing of the program."""

import subprocess
import sys

from mdbench import spec
from mdbench.guard import forbidden_modules


def test_whole_top_level_names():
    loaded = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "molecular_dynamics_tpu",
              "molecular_dynamics_tpu.sim", "molecular_dynamics_tpu_torch",
              "molecular_dynamics_tpu_torch.sim", "jaxtyping", "numpy", "flaxen"]
    assert forbidden_modules(loaded) == ["flax.linen", "jax", "jax.numpy", "jaxlib.xla_client",
                                         "molecular_dynamics_tpu", "molecular_dynamics_tpu.sim"]


def _loaded_after(code: str) -> list:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint(sorted(sys.modules))"],
                         cwd=spec.ROOT, capture_output=True, text=True, timeout=300, check=True)
    return eval(out.stdout.strip().splitlines()[-1])


def test_harness_and_program_load_no_jax():
    loaded = _loaded_after(
        "import sys; sys.path.insert(0, '.')\n"
        "from mdbench import campaign, check, spec, tracing, guard\n"
        "import mdbench.run\n"
        "import molecular_dynamics_tpu_torch.sim, molecular_dynamics_tpu_torch.ops.fused_step\n")
    assert forbidden_modules(loaded) == []


def test_reference_and_counts_load_nothing_of_the_program():
    loaded = _loaded_after(
        "import sys; sys.path.insert(0, '.')\n"
        "from mdbench import check\n"
        "from mdbench.counts import work\n"
        "from mdbench.reference import dynamics, energy, observables, system\n")
    assert not [m for m in loaded if m.split(".")[0].startswith("molecular_dynamics_tpu")]
