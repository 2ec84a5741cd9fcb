"""Connectivity utilities: derive angles/dihedrals from a bond graph.

Enumerates every angle (i-j-k over bonded pairs sharing centre j) and every
proper dihedral (i-j-k-l over each central bond j-k): exactly the bonded sets
a standard PSF lists for acyclic molecules. Pure numpy.
"""

from __future__ import annotations

from collections import defaultdict
import numpy as np


def _adjacency(bonds: np.ndarray, n_atoms: int):
    adj = defaultdict(set)
    for i, j in np.asarray(bonds, np.int64):
        adj[int(i)].add(int(j))
        adj[int(j)].add(int(i))
    return adj


def angles_from_bonds(bonds: np.ndarray, n_atoms: int) -> np.ndarray:
    """All unique angles (i, j, k) with i-j and j-k bonded, i < k."""
    adj = _adjacency(bonds, n_atoms)
    out = []
    for j in sorted(adj):
        nbrs = sorted(adj[j])
        for a in range(len(nbrs)):
            for b in range(a + 1, len(nbrs)):
                out.append((nbrs[a], j, nbrs[b]))
    return np.array(out, np.int64).reshape(-1, 3)


def dihedrals_from_bonds(bonds: np.ndarray, n_atoms: int) -> np.ndarray:
    """All unique proper dihedrals (i, j, k, l) around each central bond j-k."""
    adj = _adjacency(bonds, n_atoms)
    out = []
    for j, k in np.asarray(np.sort(np.asarray(bonds, np.int64), axis=1), np.int64):
        j, k = int(j), int(k)
        for i in sorted(adj[j]):
            if i == k:
                continue
            for l in sorted(adj[k]):
                if l == j or l == i:
                    continue
                out.append((i, j, k, l))
    return np.array(out, np.int64).reshape(-1, 4)
