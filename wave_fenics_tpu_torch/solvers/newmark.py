"""Implicit Newmark-beta time integration with matrix-free PCG.

Port of ``wave_fenics_tpu.solvers.newmark``: Newmark-beta (beta = 1/4,
gamma = 1/2 by default: the trapezoidal rule, 2nd order, A-stable) on

    M u'' = -c0^2 K u + c0^2 g(t) W1 - c0 W2 u'

Each step solves the SPD system

    A a = rhs,   A = M + gamma dt c0 W2 + beta dt^2 c0^2 K

for the new acceleration with Jacobi(M)-preconditioned CG (``solvers.cg``),
warm-started from the previous acceleration. K is the model's positive
stiffness, ``-model.ops.stiffness(x, 1.0)``: on a card one launch of
kernel F (``ops.stiffness``) per apply, so a step launches F once for the
right-hand side and once per CG matvec (the start's residual and one per
iteration), and the solve once more for the initial acceleration.

The JAX package runs the steps inside one ``lax.scan`` with CG's predicate
on the device. The port's CG decides convergence on the host: each
predicate read is one host sync (``cg``'s ``bool()``), so a step syncs
once per iteration and once more where CG stops on ``rtol`` before
``kmax``; ``stats`` records both counts.
"""

from __future__ import annotations

import torch

from .cg import cg

__all__ = ["newmark_solve_n"]


def newmark_solve_n(
    model,
    dt: float,
    nsteps: int,
    u0: torch.Tensor,
    v0: torch.Tensor,
    beta: float = 0.25,
    gamma: float = 0.5,
    cg_kmax: int = 40,
    cg_rtol: float = 1e-9,
    t0: float = 0.0,
    stats: dict | None = None,
):
    """Integrate ``nsteps`` implicit Newmark steps of a ``LinearWave``
    model (grid representation). Returns (u, v, a) at the final time.
    ``stats`` (optional), a dict, receives ``cg_iterations`` (one count a
    step) and ``host_syncs`` (the CG predicate reads of the whole solve)."""
    c0 = model.c0
    m, inv_m, W1, W2 = model.m, model.inv_m, model.W1, model.W2

    def K_pos(x):
        # positive stiffness K x (ops.stiffness returns -c0^2 K x at c0 = 1)
        return -model.ops.stiffness(x, 1.0)

    def A(x):
        return (m * x + (gamma * dt * c0) * (W2 * x)
                + (beta * dt * dt * c0 * c0) * K_pos(x))

    def precond(r):
        return inv_m * r

    def rhs(t_new, u_star, v_star):
        return (-(c0 * c0) * K_pos(u_star)
                + (c0 * c0) * model.g_amplitude(t_new) * W1
                - c0 * (W2 * v_star))

    iters = []
    u, v = u0, v0
    a = inv_m * rhs(float(t0), u0, v0)
    t = float(t0)
    for _ in range(nsteps):
        t_new = t + dt
        u_star = u + dt * v + (0.5 - beta) * dt * dt * a
        v_star = v + (1.0 - gamma) * dt * a
        a, k, _ = cg(A, rhs(t_new, u_star, v_star), x0=a, kmax=cg_kmax,
                     rtol=cg_rtol, precond=precond)
        iters.append(k)
        u = u_star + beta * dt * dt * a
        v = v_star + gamma * dt * a
        t = t_new
    if stats is not None:
        stats["cg_iterations"] = iters
        stats["host_syncs"] = sum(k + (k < cg_kmax) for k in iters)
    return u, v, a
