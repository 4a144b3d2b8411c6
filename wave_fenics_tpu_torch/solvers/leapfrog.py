"""Leapfrog (velocity-Verlet) time integration with semi-implicit diagonal
damping: one force evaluation per step.

Port of ``wave_fenics_tpu.solvers.leapfrog``. The wave system is
du/dt = v, dv/dt = F(t, u) - D v with D diagonal (the absorbing
boundary); one kick-drift-kick step is

    v+ = (v + dt/2 F(t, u)) / (1 + dt/2 D)     (implicit half-kick)
    u' = u + dt v+
    v' = (1 - dt/2 D) v+ + dt/2 F(t + dt, u')  (its adjoint, explicit)

2nd order, stable for dt up to about 0.71x the RK4 CFL step; the damping
part is unconditionally stable. F(t + dt, u') is carried to the next step.
PyTorch runs eagerly, so the JAX package's ``lax.scan`` becomes a Python
loop and t a Python float; the traced-count form is not ported (a traced
step count has no use in eager PyTorch).
"""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ["leapfrog_step", "leapfrog_solve_n", "leapfrog_solve_n_recording"]


def leapfrog_step(
    force: Callable,
    damp: torch.Tensor | None,
    u: torch.Tensor,
    v: torch.Tensor,
    F: torch.Tensor,
    t: float,
    dt: float,
):
    """One leapfrog step. ``F`` must equal ``force(t, u)`` (carried across
    steps); returns (u', v', F', t + dt)."""
    dt2 = dt * 0.5
    if damp is None:
        vh = v + dt2 * F
    else:
        vh = (v + dt2 * F) / (1.0 + dt2 * damp)
    u = u + dt * vh
    t = t + dt
    F = force(t, u)
    if damp is None:
        v = vh + dt2 * F
    else:
        v = (1.0 - dt2 * damp) * vh + dt2 * F
    return u, v, F, t


def leapfrog_solve_n(
    force: Callable,
    damp: torch.Tensor | None,
    u0: torch.Tensor,
    v0: torch.Tensor,
    t0: float,
    dt: float,
    nsteps: int,
):
    """Integrate exactly ``nsteps`` fixed steps. ``force(t, u)`` is the
    mass-normalised acceleration, ``damp`` a diagonal damping tensor (or
    None). Returns (u, v)."""
    t = float(t0)
    u, v, F = u0, v0, force(t, u0)
    for _ in range(nsteps):
        u, v, F, t = leapfrog_step(force, damp, u, v, F, t, dt)
    return u, v


def leapfrog_solve_n_recording(
    force: Callable,
    damp: torch.Tensor | None,
    u0: torch.Tensor,
    v0: torch.Tensor,
    t0: float,
    dt: float,
    nsteps: int,
    sample: Callable,
):
    """Like :func:`leapfrog_solve_n`, also recording ``sample(t, u, v)``
    after each step (mirrors ``rk4_solve_n_recording``). Returns (u, v,
    series[nsteps, ...]), the series preallocated on the state's device and
    filled with no host read per step."""
    t = float(t0)
    u, v, F = u0, v0, force(t, u0)
    first = sample(t, u, v)  # shape and dtype of one sample
    series = first.new_empty((nsteps, *first.shape))
    for i in range(nsteps):
        u, v, F, t = leapfrog_step(force, damp, u, v, F, t, dt)
        series[i] = sample(t, u, v)
    return u, v, series
