"""Port parity: ``features``, ``evaluate`` and ``log.plot_losses``.

The same float64 inputs, made from a numpy seed, go through the JAX
functions (jitted; a per-frame function mapped over the batch with
``jax.vmap``) and the port's batched ones. Values agree to 1e-10 relative
(index tables and masks exactly), the gradients of ``distance_matrix``,
``aligned_rmsd`` and ``torsion_loss`` to 1e-8. The Kabsch gradient is held
on non-degenerate inputs; on a degenerate covariance (a collinear frame
against a generic one: two zero singular values, where the gradient is not
defined) both packages' SVD backward are finite and differ, which the last
Kabsch test records.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molecular_dynamics_tpu import evaluate as jev
from molecular_dynamics_tpu import features as jf
from molecular_dynamics_tpu import log as jlog
from molecular_dynamics_tpu.examples import decaalanine_backbone as jbackbone
from molecular_dynamics_tpu.train import losses as jlosses
from molecular_dynamics_tpu_torch import evaluate as tev
from molecular_dynamics_tpu_torch import features as tf
from molecular_dynamics_tpu_torch import log as tlog
from molecular_dynamics_tpu_torch.examples import decaalanine_backbone as tbackbone
from molecular_dynamics_tpu_torch.train import losses as tlosses

from torch_parity import t

RTOL = 1e-10
GRAD_RTOL = 1e-8
B = 6


def close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-300)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


@pytest.fixture(scope="module")
def frames():
    """(B, 40, 3) float64 backbone frames: the generated start, jittered."""
    _, coords = jbackbone()
    rng = np.random.default_rng(7)
    return np.asarray(coords, np.float64)[None] + 0.3 * rng.standard_normal((B, 40, 3))


@pytest.fixture(scope="module")
def targets(frames):
    rng = np.random.default_rng(8)
    return frames + 0.5 * rng.standard_normal(frames.shape)


def torch_grad(fn, x):
    xt = t(x).requires_grad_(True)
    return torch.autograd.grad(fn(xt), xt)[0].numpy()


def test_phi_psi_tables_and_rows():
    jtop, _ = jbackbone()
    ttop, _ = tbackbone()
    for jarr, tarr in zip(jf.per_atom_angle_rows(jtop), tf.per_atom_angle_rows(ttop)):
        assert tarr.dtype == np.int64 and np.array_equal(tarr, np.asarray(jarr))
    phi, psi = tf.phi_psi_indices(ttop)
    assert phi.shape == (9, 4) and psi.shape == (9, 4)


def test_phi_psi_values(frames):
    phi, psi = tf.phi_psi_indices(tbackbone()[0])
    jphi, jpsi = jax.jit(jax.vmap(lambda p: jf.phi_psi(p, phi, psi)))(jnp.asarray(frames))
    tphi, tpsi = tf.phi_psi(t(frames), phi, psi)
    close(tphi, jphi)
    close(tpsi, jpsi)


def test_distance_matrix_and_its_gradient(frames):
    w = np.random.default_rng(9).standard_normal((B, 40, 40))
    close(tf.distance_matrix(t(frames)), jax.jit(jf.distance_matrix)(jnp.asarray(frames)))
    jg = jax.jit(jax.grad(lambda p: jnp.sum(jf.distance_matrix(p) * w)))(jnp.asarray(frames))
    tg = torch_grad(lambda p: torch.sum(tf.distance_matrix(p) * t(w)), frames)
    assert np.isfinite(tg).all()
    close(tg, jg, GRAD_RTOL)


def test_knn_masks(frames):
    for k in (1, 3):
        assert np.array_equal(tf.knn_mask(40, k).numpy(), np.asarray(jf.knn_mask(40, k)))
        assert np.array_equal(
            tf.knn_graph_mask(t(frames), k).numpy(),
            np.asarray(jax.jit(jf.knn_graph_mask, static_argnums=1)(jnp.asarray(frames), k)))


def test_kabsch_rmsd_values(frames, targets):
    jr, jt = jax.jit(jax.vmap(jf.kabsch_align))(jnp.asarray(frames), jnp.asarray(targets))
    tr, tt = tf.kabsch_align(t(frames), t(targets))
    close(tr, jr)
    close(tt, jt)
    close(tf.aligned_rmsd(t(frames), t(targets)),
          jax.jit(jax.vmap(jf.aligned_rmsd))(jnp.asarray(frames), jnp.asarray(targets)))
    close(tf.rmsd(t(frames), t(targets)),
          jax.jit(jax.vmap(jf.rmsd))(jnp.asarray(frames), jnp.asarray(targets)))
    # a rotated, shifted copy aligns back to zero
    rot = np.linalg.qr(np.random.default_rng(3).standard_normal((3, 3)))[0]
    rot *= np.sign(np.linalg.det(rot))
    moved = frames @ rot.T + 2.0
    assert float(tf.aligned_rmsd(t(moved), t(frames)).max()) < 1e-5


def test_aligned_rmsd_gradient(frames, targets):
    """Non-degenerate covariances: the SVD backward of both packages is
    finite and equal."""
    jg = jax.jit(jax.grad(lambda p: jnp.sum(jax.vmap(jf.aligned_rmsd)(p, jnp.asarray(targets)))))(
        jnp.asarray(frames))
    tg = torch_grad(lambda p: torch.sum(tf.aligned_rmsd(p, t(targets))), frames)
    assert np.isfinite(tg).all() and np.isfinite(np.asarray(jg)).all()
    close(tg, jg, GRAD_RTOL)


def test_aligned_rmsd_gradient_degenerate(targets):
    """A collinear frame against a generic one: two zero singular values.
    Both packages' gradients are finite (the port's wherever JAX's is), and
    they need not agree: the gradient is not defined there."""
    line = np.outer(np.arange(40.0), [1.0, 2.0, 3.0]) / 10.0
    jg = np.asarray(jax.jit(jax.grad(jf.aligned_rmsd))(jnp.asarray(line), jnp.asarray(targets[0])))
    tg = torch_grad(lambda p: tf.aligned_rmsd(p, t(targets[0])), line)
    assert np.isfinite(jg).all() and np.isfinite(tg).all()


def test_torsion_loss_and_gradient(frames, targets):
    phi, _ = tf.phi_psi_indices(tbackbone()[0])
    jfn = jax.jit(lambda p: jlosses.torsion_loss(p, jnp.asarray(targets), jnp.asarray(phi)))
    close(tlosses.torsion_loss(t(frames), t(targets), t(phi)), jfn(jnp.asarray(frames)))
    tg = torch_grad(lambda p: tlosses.torsion_loss(p, t(targets), t(phi)), frames)
    close(tg, jax.jit(jax.grad(jfn))(jnp.asarray(frames)), GRAD_RTOL)


def test_minmax(frames):
    jlo, jhi = jf.minmax_fit(jnp.asarray(frames))
    tlo, thi = tf.minmax_fit(t(frames))
    close(tlo, jlo)
    close(thi, jhi)
    close(tf.minmax_scale(t(frames), tlo, thi), jf.minmax_scale(jnp.asarray(frames), jlo, jhi))
    close(tf.minmax_unscale(t(frames), tlo, thi),
          jf.minmax_unscale(jnp.asarray(frames), jlo, jhi))


@pytest.fixture(scope="module")
def ensembles():
    """Three data trajectories of 30 frames and two generated ones of 12,
    with a pulled end-to-end distance."""
    rng = np.random.default_rng(11)
    base = np.asarray(jbackbone()[1], np.float64)
    ramp = np.linspace(0.0, 1.0, 30)[:, None, None] * np.linspace(0.0, 4.0, 40)[None, :, None]

    def traj(n_frames, sigma):
        return base[None] + ramp[:n_frames] + sigma * rng.standard_normal((n_frames, 40, 3))

    return [traj(30, 0.2) for _ in range(3)], [traj(12, 0.4) for _ in range(2)]


def test_e2e_evaluators(ensembles):
    data, gen = ensembles
    stacked = np.concatenate(data)
    for key in ("mean", "std", "all"):
        close(tev.e2e_statistics(stacked, n_buckets=7)[key],
              jev.e2e_statistics(stacked, n_buckets=7)[key])
    for key in ("mean", "std"):
        close(tev.e2e_time_buckets(data, i=1, j=-2)[key], jev.e2e_time_buckets(data, i=1, j=-2)[key])
    cases = (
        dict(),
        dict(data_trajectories=data),
        dict(data_trajectories=data, generated_trajectories=gen),
        dict(n_buckets=40),
    )
    for kw in cases:
        tres = tev.compare_e2e(np.concatenate(gen), stacked, **kw)
        jres = jev.compare_e2e(np.concatenate(gen), stacked, **kw)
        assert tres.keys() == jres.keys()
        for key in jres:
            close(tres[key], jres[key])


def test_ensemble_statistics(ensembles):
    data, gen = ensembles
    stacked = np.concatenate(data)
    masses = np.random.default_rng(12).uniform(1.0, 16.0, 40)
    close(tev.radius_of_gyration(stacked), jev.radius_of_gyration(stacked))
    close(tev.radius_of_gyration(stacked, masses), jev.radius_of_gyration(stacked, masses))
    close(tev.rmsf(stacked), jev.rmsf(stacked))
    close(tev.ensemble_rmsd_to_reference(stacked, data[0][0]),
          jev.ensemble_rmsd_to_reference(stacked, data[0][0]))
    tres = tev.marginal_histograms(gen[0].reshape(12, -1), data[0].reshape(30, -1))
    jres = jev.marginal_histograms(gen[0].reshape(12, -1), data[0].reshape(30, -1))
    assert tres == jres
    mean, std = tev.whiten_fit(stacked)
    jmean, jstd = jev.whiten_fit(stacked)
    close(mean, jmean)
    close(std, jstd)
    white = tev.whiten(stacked, mean, std)
    close(white, jev.whiten(stacked, jmean, jstd))
    close(tev.unwhiten(white, mean, std), stacked)


def test_plot_losses(tmp_path, monkeypatch):
    curves = {"loss": [3.0, 2.0, 1.5], "aux": [1.0, 0.5, 0.25]}
    tpath, jpath = tmp_path / "t.png", tmp_path / "j.png"
    assert tlog.plot_losses(str(tpath), curves) == jlog.plot_losses(str(jpath), curves)
    assert tpath.exists() == jpath.exists()
    # without matplotlib: False, no file, no error
    monkeypatch.setitem(__import__("sys").modules, "matplotlib", None)
    assert tlog.plot_losses(str(tmp_path / "none.png"), curves) is False
    assert not (tmp_path / "none.png").exists()
