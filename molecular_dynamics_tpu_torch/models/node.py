"""Neural-ODE solvers around a learned vector field.

- ``odeint_field``: adaptive Dormand-Prince 5(4) integration with the step
  control of ``jax.experimental.ode.odeint`` (its initial step, error
  norm, step-size update and 4th-order dense output, ``rtol = atol =
  1.4e-8``), written in PyTorch. The gradient is autograd through the
  accepted steps, with the step sizes held as constants (the JAX solver's
  is an adjoint: the two agree within the solver's tolerance).
- ``rk4_step`` / ``rk4_rollout``: fixed-step RK4, with optional clamps and
  a per-state corrector.

A field is ``field(x, t) -> dx/dt``; ``hnn_field`` wraps an HNN.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

Tensor = torch.Tensor
Field = Callable[[Tensor, Tensor], Tensor]  # (x, t) -> dx/dt

#: Dormand-Prince 5(4): nodes, stage weights, 5th-order solution, error
#: weights (5th - 4th order) and the midpoint weights of the dense output
_ALPHA = (1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0)
_BETA = (
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
)
_C_SOL = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)
_C_ERR = (35 / 384 - 1951 / 21600, 0.0, 500 / 1113 - 22642 / 50085, 125 / 192 - 451 / 720,
          -2187 / 6784 - -12231 / 42400, 11 / 84 - 649 / 6300, -1.0 / 60.0)
_C_MID = (6025192743 / 30085553152 / 2, 0.0, 51252292925 / 65400821598 / 2,
          -2691868925 / 45128329728 / 2, 187940372067 / 1594534317056 / 2,
          -1776094331 / 19743644256 / 2, 11237099 / 235043384 / 2)


def _combine(coeffs, k) -> Tensor:
    """sum_i coeffs[i] * k[i] over the stages with a non-zero weight."""
    return sum(c * ki for c, ki in zip(coeffs, k) if c != 0.0)


def _dopri_step(func, y0: Tensor, f0: Tensor, t0: float, dt: float):
    """One Dormand-Prince step: (y1, f1, error estimate, stages)."""
    k = [f0]
    for i in range(6):
        k.append(func(y0 + dt * _combine(_BETA[i], k), t0 + dt * _ALPHA[i]))
    y1 = dt * _combine(_C_SOL, k) + y0
    return y1, k[-1], dt * _combine(_C_ERR, k), k


def _interp_fit(y0, y1, k, dt):
    """The 4th-order polynomial through the step (coefficients a..e of
    a s^4 + b s^3 + c s^2 + d s + e, s in [0, 1])."""
    y_mid = y0 + dt * _combine(_C_MID, k)
    dy0, dy1 = k[0], k[-1]
    a = -2.0 * dt * dy0 + 2.0 * dt * dy1 - 8.0 * y0 - 8.0 * y1 + 16.0 * y_mid
    b = 5.0 * dt * dy0 - 3.0 * dt * dy1 + 18.0 * y0 + 14.0 * y1 - 32.0 * y_mid
    c = -4.0 * dt * dy0 + dt * dy1 - 11.0 * y0 - 5.0 * y1 + 16.0 * y_mid
    return a, b, c, dt * dy0, y0


def _initial_step(func, t0, y0, f0, order, rtol, atol) -> float:
    """Hairer, Norsett and Wanner, Solving ODEs I, Sec. II.4."""
    with torch.no_grad():
        scale = atol + torch.abs(y0) * rtol
        d0 = float(torch.linalg.norm(y0 / scale))
        d1 = float(torch.linalg.norm(f0 / scale))
        h0 = 1e-6 if (d0 < 1e-5 or d1 < 1e-5) else 0.01 * d0 / d1
        f1 = func(y0 + h0 * f0, t0 + h0)
        d2 = float(torch.linalg.norm((f1 - f0) / scale)) / h0
    if d1 <= 1e-15 and d2 <= 1e-15:
        h1 = max(1e-6, h0 * 1e-3)
    else:
        h1 = (0.01 / max(d1, d2)) ** (1.0 / (order + 1.0))
    return min(100.0 * h0, h1)


def _error_ratio(err, rtol, atol, y0, y1) -> float:
    with torch.no_grad():
        tol = atol + rtol * torch.maximum(torch.abs(y0), torch.abs(y1))
        return float(torch.sqrt(torch.mean((err / tol) ** 2)))


def _optimal_step(last: float, ratio: float, safety=0.9, ifactor=10.0, dfactor=0.2,
                  order=5.0) -> float:
    if ratio == 0.0:
        return last * ifactor
    dfactor = 1.0 if ratio < 1.0 else dfactor
    return last * min(ifactor, max(ratio ** (-1.0 / order) * safety, dfactor))


def odeint_field(field: Field, x0: Tensor, ts, rtol: float = 1.4e-8,
                 atol: float = 1.4e-8) -> Tensor:
    """Adaptive-step integration of dx/dt = field(x, t); returns the states
    at the times ``ts`` (strictly increasing), ``(len(ts), *x0.shape)``.
    ``rtol`` / ``atol`` are ``jax.experimental.ode.odeint``'s, with its
    defaults.

    The JAX solver's algorithm on the flattened state: error norms over the
    whole state, a step accepted where the error ratio is at most 1, the
    output at each time from the dense output of the step that passed it.
    The step sizes and the accept decisions are host numbers (one
    synchronisation a step)."""
    ts = [float(t) for t in ts]
    shape = x0.shape

    def func(y, t):
        return field(y.reshape(shape), torch.as_tensor(t, dtype=y.dtype, device=y.device)
                     ).reshape(-1)

    y = x0.reshape(-1)
    f = func(y, ts[0])
    t = ts[0]
    dt = _initial_step(func, t, y, f, 4, rtol, atol)
    last_t, coeffs = t, (y, y, y, y, y)
    out = [y]
    for target in ts[1:]:
        while t < target and dt > 0:
            next_y, next_f, err, k = _dopri_step(func, y, f, t, dt)
            ratio = _error_ratio(err, rtol, atol, y, next_y)
            new_dt = max(_optimal_step(dt, ratio), 0.0)
            if ratio <= 1.0:
                coeffs = _interp_fit(y, next_y, k, dt)
                y, f, last_t, t = next_y, next_f, t, t + dt
            dt = new_dt
        s = (target - last_t) / (t - last_t)
        a, b, c, d, e = coeffs
        out.append(((((a * s + b) * s + c) * s + d) * s + e))
    return torch.stack(out).reshape(len(ts), *shape)


def rk4_step(field: Field, x: Tensor, t, dt: float) -> Tensor:
    """Classic RK4."""
    k1 = field(x, t)
    k2 = field(x + 0.5 * dt * k1, t + 0.5 * dt)
    k3 = field(x + 0.5 * dt * k2, t + 0.5 * dt)
    k4 = field(x + dt * k3, t + dt)
    return x + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)


def rk4_rollout(
    field: Field,
    x0: Tensor,
    n_steps: int,
    dt: float,
    t0: float = 0.0,
    max_step: Optional[float] = None,
    state_bounds=None,
    corrector: Optional[Callable[[Tensor], Tensor]] = None,
) -> Tensor:
    """Fixed-step RK4 rollout; returns the ``(n_steps, ...)`` states.

    ``max_step`` clamps the per-step displacement componentwise and
    ``state_bounds=(lo, hi)`` clamps the state to the training data's
    support; ``corrector`` relaxes each generated state. Differentiable
    through every step (a field that detaches, as a generation field does,
    makes it a plain rollout)."""
    x, t = x0, t0
    frames = []
    for _ in range(n_steps):
        x_new = rk4_step(field, x, t, dt)
        if max_step is not None:
            x_new = x + torch.clamp(x_new - x, -max_step, max_step)
        if state_bounds is not None:
            x_new = torch.clamp(x_new, state_bounds[0], state_bounds[1])
        if corrector is not None:
            x_new = corrector(x_new)
        x, t = x_new, t + dt
        frames.append(x)
    return torch.stack(frames)


def hnn_field(model, create_graph: bool = True) -> Field:
    """Wrap an HNN as an autonomous ODE field. ``create_graph=False`` gives
    the generation field: detached states, no graph across steps."""
    from molecular_dynamics_tpu_torch.models.hnn import time_derivative

    def field(x, t):
        del t
        return time_derivative(model, x, create_graph=create_graph)

    return field
