"""Trajectory dataset utilities (host-side numpy).

(frame, time) pairs for the cGAN, strided loading of ``raw-traj_rep-*.npy``
arrays, history/lead windows for the sequence models, phase-space (x, dx)
pairs for HNNs, per-atom min-max scaling and the overlapping training
buckets. Every shuffle is drawn from the caller's ``np.random.Generator``,
so the same seed gives the same batches as the reference. The batches are
numpy arrays; the training loop moves them to its device.
"""

from __future__ import annotations

import dataclasses
import glob as globlib
from typing import Iterator, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class TrajectoryData:
    """A set of trajectories with a common (n_frames, n_atoms, 3) shape."""

    trajectories: List[np.ndarray]

    @classmethod
    def from_npy_glob(
        cls, pattern: str, stride: int = 1, limit: Optional[int] = None
    ) -> "TrajectoryData":
        """Load ``raw-traj_rep-*.npy``-style files, sorted by name."""
        paths = sorted(globlib.glob(pattern))[:limit]
        if not paths:
            raise FileNotFoundError(f"no trajectories match {pattern}")
        return cls([np.load(p)[::stride].astype(np.float32) for p in paths])

    @classmethod
    def from_array(cls, frames: np.ndarray, stride: int = 1) -> "TrajectoryData":
        frames = np.asarray(frames)
        if frames.ndim == 3:
            frames = frames[None]
        return cls([t[::stride].astype(np.float32) for t in frames])

    @property
    def n_frames(self) -> int:
        return sum(len(t) for t in self.trajectories)

    @property
    def n_atoms(self) -> int:
        return self.trajectories[0].shape[1]

    def stacked(self) -> Tuple[np.ndarray, np.ndarray]:
        """All frames + normalized times t in [0, 1] per frame."""
        frames = np.concatenate(self.trajectories)
        times = np.concatenate(
            [np.arange(len(t)) / max(len(t) - 1, 1) for t in self.trajectories]
        ).astype(np.float32)
        return frames, times


def frame_time_batches(
    data: TrajectoryData,
    batch_size: int,
    rng: np.random.Generator,
    drop_last: bool = True,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Shuffled (frames (B, N, 3), times (B,)) batches."""
    frames, times = data.stacked()
    order = rng.permutation(len(frames))
    end = len(frames) - (len(frames) % batch_size if drop_last else 0)
    for i in range(0, end, batch_size):
        sel = order[i : i + batch_size]
        yield frames[sel], times[sel]


def window_batches(
    data: TrajectoryData,
    history: int,
    lead: int,
    batch_size: int,
    rng: np.random.Generator,
    flatten: bool = True,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """(window (B, history, F), target (B, F)) batches: the history/lead
    dataset of the sequence models."""
    windows, targets = [], []
    for traj in data.trajectories:
        flat = traj.reshape(len(traj), -1) if flatten else traj
        for s in range(len(flat) - history - lead + 1):
            windows.append(flat[s : s + history])
            targets.append(flat[s + history + lead - 1])
    windows = np.stack(windows)
    targets = np.stack(targets)
    order = rng.permutation(len(windows))
    for i in range(0, len(order) - batch_size + 1, batch_size):
        sel = order[i : i + batch_size]
        yield windows[sel], targets[sel]


def phase_space_pairs(
    data: TrajectoryData, dt: float = 1.0
) -> Tuple[np.ndarray, np.ndarray]:
    """(x, dx) phase-space dataset: q = positions, p = finite-difference
    momenta; dx by forward difference. Returns x (M, 2*N*3), dx (M, 2*N*3)."""
    xs, dxs = [], []
    for traj in data.trajectories:
        flat = traj.reshape(len(traj), -1)
        q = flat[:-1]
        p = (flat[1:] - flat[:-1]) / dt
        x = np.concatenate([q, p], axis=1)
        dx = np.diff(x, axis=0)
        xs.append(x[:-1])
        dxs.append(dx)
    return np.concatenate(xs), np.concatenate(dxs)


class PerAtomMinMaxScaler:
    """Per-atom-per-coordinate min-max scaling to [0, 1], invertible: two
    reductions over the frame axis and broadcast affine maps. Degenerate
    channels (min == max) transform to 0 and invert exactly."""

    def __init__(self, frames: np.ndarray):
        frames = np.asarray(frames)
        if frames.ndim != 3:
            raise ValueError(f"expected (frames, atoms, 3), got {frames.shape}")
        self.lo = frames.min(axis=0)  # (N, 3)
        span = frames.max(axis=0) - self.lo
        self.span = np.where(span > 0, span, 1.0)

    def transform(self, frames: np.ndarray) -> np.ndarray:
        return (np.asarray(frames) - self.lo) / self.span

    def inverse(self, scaled: np.ndarray) -> np.ndarray:
        return np.asarray(scaled) * self.span + self.lo


def bucket_bounds(chunk: int, bucket_size: int = 1000, overlap: int = 20) -> Tuple[int, int]:
    """Frame bounds of overlapping training buckets: bucket 1 is
    ``[0, bucket_size)``; every later bucket starts ``overlap`` frames
    before its nominal boundary (chunk 2 of size 1000 = frames 980..2000)."""
    if chunk < 1:
        raise ValueError(f"chunk is 1-based, got {chunk}")
    start = (chunk - 1) * bucket_size - (overlap if chunk > 1 else 0)
    return int(start), int(chunk * bucket_size)
