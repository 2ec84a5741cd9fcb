"""Generation-quality evaluators.

End-to-end distance statistics of generated ensembles against the data
along the reaction coordinate, marginal histograms, radius of gyration,
RMSF, RMSD to a reference and whitening. Numpy on the host; the
end-to-end distances and the Kabsch alignment of
``ensemble_rmsd_to_reference`` go through the port's tensor functions on
CPU tensors.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from molecular_dynamics_tpu_torch.bias import end_to_end_distance
from molecular_dynamics_tpu_torch.features import aligned_rmsd


def _e2e(frames, i: int, j: int) -> np.ndarray:
    return end_to_end_distance(torch.as_tensor(np.asarray(frames)), i, j).numpy()


def e2e_statistics(
    frames: np.ndarray, i: int = 0, j: int = -1, n_buckets: int = 10
) -> Dict[str, np.ndarray]:
    """End-to-end distance mean/std per reaction-coordinate bucket.

    ``frames`` is (n_frames, N, 3) ordered along the trajectory/reaction
    coordinate; returns the per-bucket statistics and every distance.
    """
    d = _e2e(frames, i, j)
    buckets = np.array_split(d, n_buckets)
    return {
        "mean": np.array([b.mean() for b in buckets]),
        "std": np.array([b.std() for b in buckets]),
        "all": d,
    }


def e2e_time_buckets(
    trajectories, i: int = 0, j: int = -1, n_buckets: int = 10
) -> Dict[str, np.ndarray]:
    """Time-resolved e2e statistics over a trajectory *ensemble*.

    Each trajectory is bucketed along its own normalized time and bucket
    statistics pool across trajectories. Bucketing a concatenation instead
    (``e2e_statistics`` on stacked data) flattens the reaction-coordinate
    profile to its overall mean whenever more than one trajectory is
    stacked.
    """
    # trajectories shorter than n_buckets would leave trailing buckets
    # empty (NaN means); coarsen to the shortest trajectory instead
    n_buckets = max(1, min(n_buckets, min(len(t) for t in trajectories)))
    per_bucket = [[] for _ in range(n_buckets)]
    for t_arr in trajectories:
        d = _e2e(t_arr, i, j)
        for k, b in enumerate(np.array_split(d, n_buckets)):
            per_bucket[k].append(b)
    pooled = [np.concatenate(b) for b in per_bucket]
    return {
        "mean": np.array([b.mean() for b in pooled]),
        "std": np.array([b.std() for b in pooled]),
    }


def compare_e2e(
    generated: np.ndarray,
    data: np.ndarray,
    i: int = 0,
    j: int = -1,
    n_buckets: int = 10,
    data_trajectories=None,
    generated_trajectories=None,
) -> Dict[str, float]:
    """Per-bucket e2e discrepancy between generated and data ensembles.

    ``generated`` is ordered along its reaction coordinate / rollout time.
    Pass ``data_trajectories`` (a list of (F, N, 3) arrays) to bucket the
    data reference per trajectory by normalized time; otherwise ``data`` is
    bucketed along its frame order. ``generated_trajectories`` does the same
    for an ensemble of generated rollouts.
    """
    # both ensembles must bucket at the same resolution: coarsen to the
    # shortest trajectory on either side (avoids empty buckets -> NaN)
    for ts in (generated_trajectories, data_trajectories):
        if ts is not None:
            n_buckets = max(1, min(n_buckets, min(len(t) for t in ts)))
    if generated_trajectories is None:
        n_buckets = max(1, min(n_buckets, len(generated)))
    if data_trajectories is None:
        n_buckets = max(1, min(n_buckets, len(data)))
    if generated_trajectories is not None:
        g = e2e_time_buckets(generated_trajectories, i, j, n_buckets)
    else:
        g = e2e_statistics(generated, i, j, n_buckets)
    if data_trajectories is not None:
        d = e2e_time_buckets(data_trajectories, i, j, n_buckets)
    else:
        d = e2e_statistics(data, i, j, n_buckets)
    return {
        "mean_abs_error": float(np.mean(np.abs(g["mean"] - d["mean"]))),
        "max_abs_error": float(np.max(np.abs(g["mean"] - d["mean"]))),
        "std_abs_error": float(np.mean(np.abs(g["std"] - d["std"]))),
    }


def marginal_histograms(
    generated: np.ndarray, data: np.ndarray, n_bins: int = 16
) -> Dict[str, float]:
    """Per-feature marginal distribution discrepancy between two path sets.

    Accepts paths ``(B, T, D)`` or samples ``(B, D)``; returns the mean/max
    total-variation distance over the D feature marginals (0 = identical,
    1 = disjoint). Finite-sample TV has a noise floor of about
    ``sqrt(n_bins / n_samples)`` even for identical distributions: compare
    against a data-vs-data split and keep the generated sample count high.
    """
    g = np.asarray(generated).reshape(-1, np.shape(generated)[-1])
    d = np.asarray(data).reshape(-1, np.shape(data)[-1])
    k = min(g.shape[-1], d.shape[-1])
    tvs = np.empty(k)
    for f in range(k):
        lo = min(g[:, f].min(), d[:, f].min())
        hi = max(g[:, f].max(), d[:, f].max()) + 1e-12
        hg, _ = np.histogram(g[:, f], bins=n_bins, range=(lo, hi))
        hd, _ = np.histogram(d[:, f], bins=n_bins, range=(lo, hi))
        hg = hg / max(hg.sum(), 1)
        hd = hd / max(hd.sum(), 1)
        tvs[f] = 0.5 * np.abs(hg - hd).sum()
    return {
        "marginal_tv_mean": float(tvs.mean()),
        "marginal_tv_max": float(tvs.max()),
    }


def radius_of_gyration(frames: np.ndarray, masses=None) -> np.ndarray:
    """Mass-weighted radius of gyration per frame, (n_frames,)."""
    frames = np.asarray(frames)
    if masses is None:
        w = np.ones(frames.shape[-2], frames.dtype) / frames.shape[-2]
    else:
        masses = np.asarray(masses)
        w = masses / np.sum(masses)
    com = np.einsum("a,fac->fc", w, frames)
    d2 = np.sum((frames - com[:, None, :]) ** 2, axis=-1)
    return np.sqrt(np.einsum("a,fa->f", w, d2))


def rmsf(frames: np.ndarray) -> np.ndarray:
    """Per-atom root-mean-square fluctuation about the mean structure after
    Kabsch alignment to the first frame, (n_atoms,), in float64."""
    frames = np.asarray(frames, np.float64)
    ref = frames[0]
    ref_c = ref - ref.mean(axis=0)
    aligned = np.empty_like(frames)
    for k, f in enumerate(frames):
        f_c = f - f.mean(axis=0)
        u, _, vt = np.linalg.svd(f_c.T @ ref_c, full_matrices=False)
        d = np.sign(np.linalg.det(vt.T @ u.T))
        corr = np.diag([1.0, 1.0, d])
        r = vt.T @ corr @ u.T
        aligned[k] = f_c @ r.T + ref.mean(axis=0)
    mean = aligned.mean(axis=0)
    return np.sqrt(np.mean(np.sum((aligned - mean) ** 2, axis=-1), axis=0))


def ensemble_rmsd_to_reference(frames: np.ndarray, reference: np.ndarray) -> np.ndarray:
    """Kabsch-aligned RMSD of every frame to a reference structure."""
    frames = torch.as_tensor(np.asarray(frames))
    ref = torch.as_tensor(np.asarray(reference), dtype=frames.dtype)
    with torch.no_grad():
        return aligned_rmsd(frames, ref.expand_as(frames)).numpy()


# ---------------------------------------------------------------------------
# whitening (the "whitened" / "unwhitened" dataset variants)
# ---------------------------------------------------------------------------


def whiten_fit(frames: np.ndarray):
    """Per-feature mean/std over a trajectory set; returns (mean, std)."""
    flat = np.asarray(frames).reshape(len(frames), -1)
    return flat.mean(axis=0), flat.std(axis=0) + 1e-8


def whiten(frames: np.ndarray, mean: np.ndarray, std: np.ndarray):
    shape = frames.shape
    flat = np.asarray(frames).reshape(len(frames), -1)
    return ((flat - mean) / std).reshape(shape)


def unwhiten(frames: np.ndarray, mean: np.ndarray, std: np.ndarray):
    shape = frames.shape
    flat = np.asarray(frames).reshape(len(frames), -1)
    return (flat * std + mean).reshape(shape)
