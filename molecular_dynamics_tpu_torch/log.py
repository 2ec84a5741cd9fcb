"""Metrics logging: CSV simulation logs.

``CSVLogger`` is an append-mode CSV with a fixed column set and resume
support; ``write_simulation_log`` writes a campaign's log in one file (the
torchmd ``LogWriter`` columns and the colvar centre/value traces). Numpy
only. ``plot_losses`` comes with the training slice.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, Optional, Sequence

import numpy as np


class CSVLogger:
    """Append-mode CSV with a fixed column set and resume support."""

    def __init__(self, path: str, keys: Sequence[str]):
        self.path = path
        self.keys = list(keys)
        exists = os.path.exists(path) and os.path.getsize(path) > 0
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._fh = open(path, "a", newline="")
        self._writer = csv.DictWriter(self._fh, fieldnames=self.keys)
        if not exists:
            self._writer.writeheader()
            self._fh.flush()

    def write_row(self, **values) -> None:
        self._writer.writerow({k: values.get(k, "") for k in self.keys})
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()

    @staticmethod
    def last_value(path: str, key: str) -> Optional[float]:
        """Read the final value of a column (epoch-resume helper)."""
        if not os.path.exists(path):
            return None
        with open(path) as fh:
            rows = list(csv.DictReader(fh))
        if not rows or key not in rows[-1] or rows[-1][key] == "":
            return None
        return float(rows[-1][key])


def write_simulation_log(path: str, log: Dict[str, np.ndarray]) -> None:
    """Dump a ``sim.simulate`` / ``sim.simulate_ensemble`` log dict (numpy
    arrays of shape (n_saves,) or (n_saves, R)) as CSV: one row a save, or a
    save and replica, with the energies, temperature and colvar traces."""
    keys = list(log)
    arrs = {k: np.asarray(v) for k, v in log.items()}
    n = len(next(iter(arrs.values())))
    multi = any(a.ndim > 1 for a in arrs.values())
    with open(path, "w", newline="") as fh:
        w = csv.writer(fh)
        if multi:
            r = next(a.shape[1] for a in arrs.values() if a.ndim > 1)
            w.writerow(["save", "replica"] + keys)
            for i in range(n):
                for j in range(r):
                    w.writerow(
                        [i, j]
                        + [
                            arrs[k][i, j] if arrs[k].ndim > 1 else arrs[k][i]
                            for k in keys
                        ]
                    )
        else:
            w.writerow(["save"] + keys)
            for i in range(n):
                w.writerow([i] + [arrs[k][i] for k in keys])

