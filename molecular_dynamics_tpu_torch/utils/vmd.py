"""VMD visualisation glue.

Writes a ``loadall.tcl`` that loads the topology plus generated or
training ``.xyz`` trajectories for inspection (``vmd -e loadall.tcl``).
"""

from __future__ import annotations

from typing import Optional, Sequence


def write_vmd_loader(
    path: str,
    trajectories: Sequence[str],
    topology: Optional[str] = None,
    representation: str = "Licorice",
):
    """Write a ``loadall.tcl``: with a topology, the first trajectory is
    added to its molecule and each later one is a molecule of its own.
    Returns ``path``."""
    lines = []
    if topology:
        lines.append(f"mol new {{{topology}}} waitfor all")
    for i, traj in enumerate(trajectories):
        cmd = "mol addfile" if (topology and i == 0) else "mol new"
        lines.append(f"{cmd} {{{traj}}} waitfor all")
    lines += [
        "mol delrep 0 top",
        f"mol representation {representation}",
        "mol addrep top",
        "display projection Orthographic",
        "color Display Background white",
    ]
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return path
