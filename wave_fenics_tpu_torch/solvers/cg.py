"""Matrix-free (preconditioned) conjugate gradient.

Port of ``wave_fenics_tpu.solvers.cg`` (the reference's distributed CG,
demo/gpu_cg/CUDA/cg.hpp:37-121, on one device). The iteration is a Python
loop whose predicate reads one scalar from the device per iteration, as
the reference's host loop does (cg.hpp:68,110): ``bool()`` of the residual
ratio waits for the iteration's queued work, so the host cannot run ahead
of the device by more than one iteration. The JAX package keeps the
predicate on the device under ``lax.while_loop`` instead.

Semantics kept: the start r0 = b - A x0 (one matvec even when x0 = 0), the
stopping rule rnorm / rnorm0 < rtol^2 on squared norms (rtol^2 formed in
the residual's dtype), the cap kmax, the standard p <- z + beta p update
(the reference adds p into r at cg.hpp:116-117; that slip is not copied).

Spans (``utils/profiling.py``, recorded only under a ``torch.profiler``):
``wave.cg.solve`` around the call, ``wave.cg.iter`` around each iteration
from its stopping test on (an early-converged last test is an iteration
span that holds only that test), ``wave.cg.stop_test`` around the host's
read of the predicate and ``wave.cg.matvec`` around the matvec.

``dot`` replaces the inner product: the distributed CG of
``parallel.sharded_wave`` passes its ownership-weighted, all-reduced dot
and runs on ``parallel.partition.Blocks`` vectors (with ``x0`` given).
"""

from __future__ import annotations

from typing import Callable

import torch

from ..ops.la import inner_product
from ..utils.profiling import annotate

__all__ = ["cg"]


def cg(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    x0: torch.Tensor | None = None,
    kmax: int = 50,
    rtol: float = 1e-8,
    precond: Callable[[torch.Tensor], torch.Tensor] | None = None,
    dot: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] | None = None,
):
    """Solve A x = b with (preconditioned) CG. Returns (x, k, rnorm2): the
    solution, the iterations taken (a Python int) and the last squared
    residual norm (a 0-d tensor).

    ``precond`` is an SPD preconditioner z = M^-1 r (e.g. Jacobi). The
    stopping rule stays on the true residual norm, as cg.hpp:110.
    """
    with annotate("wave.cg.solve"):
        x = torch.zeros_like(b) if x0 is None else x0
        M = precond if precond is not None else (lambda r: r)
        inner = inner_product if dot is None else dot

        r = b - matvec(x)
        z = M(r)
        p = z
        rnorm0 = inner(r, r)
        rz = inner(r, z)
        rnorm = rnorm0
        rtol2 = torch.tensor(rtol, dtype=rnorm0.dtype) ** 2
        k = 0
        while k < kmax:
            with annotate("wave.cg.iter"):
                with annotate("wave.cg.stop_test"):
                    go = bool(rnorm / rnorm0 >= rtol2)
                if not go:
                    break
                with annotate("wave.cg.matvec"):
                    y = matvec(p)
                alpha = rz / inner(p, y)
                x = x + alpha * p
                r = r - alpha * y
                z = M(r)
                rnorm = inner(r, r)
                rz_new = inner(r, z)
                beta = rz_new / rz
                rz = rz_new
                p = z + beta * p
                k += 1
        return x, k, rnorm
