"""Classic 4th-order Runge-Kutta time integration (plain Python loop).

Port of ``wave_fenics_tpu.solvers.rk4`` (the reference RK4 loop,
common/LinearGLL.hpp:198-287). PyTorch runs eagerly, so the JAX package's
``lax.scan`` over steps becomes a Python loop; time ``t`` is a Python
float (float64), as the JAX package carries it at full precision.

The reference clamps the last step (``dt = min(dt, tf - t)``,
LinearGLL.hpp:242); here the partial final step is taken explicitly after
the full steps.
"""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ["rk4_step", "rk4_solve_n", "rk4_solve"]

# Butcher tableau of the reference (LinearGLL.hpp:233-236)
_A = (0.0, 0.5, 0.5, 1.0)
_B = (1.0 / 6.0, 1.0 / 3.0, 1.0 / 3.0, 1.0 / 6.0)
_C = (0.0, 0.5, 0.5, 1.0)


def rk4_step(
    f0: Callable,
    f1: Callable,
    u: torch.Tensor,
    v: torch.Tensor,
    t: float,
    dt: float,
):
    """One RK4 step of the coupled system du/dt = f0(t,u,v), dv/dt = f1(t,u,v).

    Matches LinearGLL.hpp:249-266 (stage structure, update order); the
    reference's a_0 = 0 makes the stale ku/kv it carries into stage 0
    irrelevant, so carrying no k state across steps is equivalent.
    """
    u0, v0 = u, v
    ku, kv = u, v  # values unused at stage 0 (a_0 = 0)
    for i in range(4):
        un = u0 + dt * _A[i] * ku
        vn = v0 + dt * _A[i] * kv
        tn = t + _C[i] * dt
        ku = f0(tn, un, vn)
        kv = f1(tn, un, vn)
        u = u + dt * _B[i] * ku
        v = v + dt * _B[i] * kv
    return u, v


def rk4_solve_n(
    f0: Callable,
    f1: Callable,
    u0: torch.Tensor,
    v0: torch.Tensor,
    t0: float,
    dt: float,
    nsteps: int,
):
    """Integrate exactly ``nsteps`` fixed steps from t0; returns (u, v)."""
    u, v, _ = _steps(f0, f1, u0, v0, t0, dt, nsteps)
    return u, v


def _steps(f0, f1, u, v, t0, dt, nsteps):
    t = float(t0)
    for _ in range(nsteps):
        u, v = rk4_step(f0, f1, u, v, t, dt)
        t = t + dt
    return u, v, t


def rk4_solve(
    f0: Callable,
    f1: Callable,
    u0: torch.Tensor,
    v0: torch.Tensor,
    t0: float,
    tf: float,
    dt: float,
):
    """Integrate from t0 to tf with fixed step dt (+ one clamped final step).

    Returns (u, v, nsteps).
    """
    span = tf - t0
    nfull = int(span / dt)  # full steps of size dt
    rem = span - nfull * dt
    u, v, t = _steps(f0, f1, u0, v0, t0, dt, nfull)
    nsteps = nfull
    if rem > 1e-12 * max(abs(span), 1.0):
        u, v = rk4_step(f0, f1, u, v, t, rem)
        nsteps += 1
    return u, v, nsteps
