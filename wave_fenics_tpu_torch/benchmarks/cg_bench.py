"""Matrix-free CG benchmark (the reference's ``gpu_cg`` CEED BP1 demo).

Port of ``wave_fenics_tpu.benchmarks.cg_bench`` on one device. Reference:
E = 2^s hex cells, the degree-p mass system, CG with kmax = 50 and
rtol = 1e-4; metric Dofs*iteration/second = ndofs / (t / iters)
(demo/gpu_cg/main.cpp:104-120, utils.hpp:58-64).

Operators:

- ``--op bp1`` (default): the consistent Gauss mass (bp1.ufl:20-21, p+2
  points; ``--q`` sets the exactness degree), one launch of kernel G per
  matvec on a card (``ops.mass``). CG runs entirely in the zero-padded
  layout: the padding of every matvec is exactly zero, so axpy and dot run
  on padded vectors.
- ``--op spectral``: the diagonal (GLL-collocated) mass.
- ``--op general``: the reference's gpu_cg operator is the explicit-dofmap
  MassOperator (gather -> element kernel -> scatter-add,
  common/cuda/mass.hpp:74-95): the Gauss-rule mass of ``GeneralOperators``
  on the box as a ``HexMesh`` (``--q`` as for bp1, default 2p: p+1
  points), one apply of kernel K in its ``mass_gauss`` mode per matvec on a
  card.

``--precond``: Jacobi (bp1: the Kronecker product of the assembled 1D mass
diagonals; spectral and general: the inverse lumped mass).

``--ndev N`` (N > 1; ``--op`` bp1 or spectral, as the JAX bench takes
them): the spectral mass on ``parallel.sharded_wave.ShardedLinearWave``,
``decompose3d(N)`` blocks (all on the card with one card) with the
ownership-weighted dot (the gpu_cg distributed CG, cg.hpp:37-121), checked
against the same CG on one device: iterations within 1 and solutions
within 10 rtol (the record's ``iters_single_device``,
``iteration_parity``, ``max_rel_solution_diff``). ``--op general --ndev N``
is the gpu_cg configuration itself, an arbitrary dofmap with a
VectorUpdater exchange each iteration, on the box as a ``HexMesh``:
``parallel.sharded_general.ShardedGeneralWave.cg_solve`` of (diag(m) +
tau K) x = b on N RCB parts (kernel K's stiffness on each; Jacobi by 1/m
always, tau = (h / (4 c0 p^2))^2, the JAX bench's), checked against the
same CG on one device: iterations within 1 and solutions within 1e-6 (f64)
or 1e-2 (f32) relative (the record also has ``exchange``).

``--dtype bf16``: the vectors and the operator's tables bf16 (kernels G
and K in their bf16 forms), the dots, alpha and beta float32. CG cannot
reach rtol 1e-4 in bf16 (in either package) and runs to kmax; on one
device the record adds ``sol_rel_vs_f64``, the largest difference from
the same CG in float64 on the same b (its bf16 values) after the same
kmax, over the largest |value| of the latter, and ``iters_f64``.

Timing: ``reps`` and ``reps // 4`` back-to-back solves of the same b,
differenced (``common.two_point_time``; CUDA events on a card). The JAX
package chains the solves through b + eps x with eps = 0 so that XLA
cannot hoist the loop; eager PyTorch hoists nothing.

Run: python -m wave_fenics_tpu_torch.benchmarks.cg_bench --size 64 --p 4
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..convert import tables_from_numpy, to_numpy
from ..core.dofmap import build_dofmap
from ..core.mesh import box_mesh
from ..ops.mass import bp1_setup, mass_apply
from ..models.general_wave import GeneralLinearWave
from ..models.linear_wave import LinearWave
from ..ops.operators import GeneralOperators, StructuredOperators
from ..parallel.partition import Blocks, decompose3d
from ..parallel.sharded_general import ShardedGeneralWave
from ..parallel.sharded_wave import ShardedLinearWave
from ..solvers.cg import cg
from ..utils.timing import sync
from .common import (bench_dtype, cells_from_args, device_name, make_parser,
                     report, resolve_device, two_point_time)

def run(op: str = "bp1", size: int = 32, degree: int = 2, s: int | None = None,
        reps: int = 8, dtype: str = "f32", device: str = "cuda",
        kmax: int = 50, rtol: float = 1e-4, ndev: int = 1,
        q: int | None = None, precond: bool = False) -> dict:
    """One CG benchmark record (the keys of the JAX bench's, plus
    ``device``, ``timing``, ``solves``: the number of solves run, each of
    1 + iters matvecs, and ``setup_s``: the seconds that built the
    operator and b, before the first solve, the device synchronised)."""
    if op not in ("bp1", "spectral", "general"):
        raise ValueError(f"--op {op!r}: bp1, spectral or general")
    if ndev < 1:
        raise ValueError(f"--ndev {ndev}: at least 1")
    dev = resolve_device(device)
    dt = bench_dtype(dtype)
    t0 = time.perf_counter()
    mesh = box_mesh(cells_from_args(size, s), (1.0, 1.0, 1.0))
    p = degree
    grid = tuple(n * p + 1 for n in mesh.shape)
    ndofs = int(np.prod(grid))
    sw = sg = None
    if ndev > 1 and op == "general":
        rng = np.random.default_rng(0)
        gm = GeneralLinearWave(mesh.to_hex_mesh(), p, facet_tags={}, dtype=dt, device=dev)
        tau = (0.25 / mesh.shape[0] / (gm.c0 * p * p)) ** 2
        sg = ShardedGeneralWave(gm, ndev).prepare()
        b = sg.from_global(rng.standard_normal(gm.ndofs))
        pre = dot = None
    elif ndev > 1:
        sw = ShardedLinearWave(LinearWave(mesh, p, dtype=dt, device=dev),
                               decompose3d(ndev))
        b = sw.from_global(np.random.default_rng(0).standard_normal(grid))
        matvec, dot, pre = sw.spectral_mass, sw.dot, None
        if precond:
            pre = lambda r: Blocks(i * x for i, x in zip(sw.inv_m, r))  # noqa: E731
    else:
        b, matvec, pre = _single_device(op, mesh, p, dt, dev, precond, q)
        dot = None

    sync(dev)
    setup_s = time.perf_counter() - t0

    x0 = None if sw is None else Blocks(torch.zeros_like(x) for x in b)

    def solve():
        if sg is not None:
            return sg.cg_solve(b, tau, kmax=kmax, rtol=rtol)
        return cg(matvec, b, x0=x0, kmax=kmax, rtol=rtol, precond=pre, dot=dot)

    x, iters, rnorm = solve()
    t, timing, calls = two_point_time(solve, reps, dev)
    metric = (f"CG {op if sw is None else 'spectral sharded'} mass "
              "(Dofs*iteration/s, utils.hpp:58-64)")
    if sg is not None:
        metric = ("CG general distributed (diag(m)+tau*K, cg.hpp:37-121 + "
                  "VectorUpdater halo per iteration)")
    out = dict(
        metric=metric,
        s=s, degree=p, ndofs=ndofs, iters=iters, ndev=ndev, dtype=dtype,
        precond=bool(precond) or sg is not None, q=q, device=device_name(dev),
        rnorm2=float(rnorm),
        ms_total=t * 1e3, timing=timing, solves=1 + calls, setup_s=setup_s,
        dofs_iter_per_s=ndofs * iters / t,
        gdofs_iter_per_s=ndofs * iters / t / 1e9,
    )
    if sw is not None:
        out.update(_single_device_parity(sw, x, iters, grid, dt, dev, kmax, rtol,
                                         precond))
    if sg is not None:
        out.update(_general_parity(sg, x, iters, tau, dtype, dev, kmax, rtol))
    if dtype == "bf16" and ndev == 1:
        b64, matvec64, pre64 = _single_device(op, mesh, p, torch.float64, dev, precond, q,
                                              b.double())
        x64, k64, _ = cg(matvec64, b64, kmax=kmax, rtol=rtol, precond=pre64)
        out.update(iters_f64=k64, sol_rel_vs_f64=float(
            (x.double() - x64).abs().max() / x64.abs().max()))
    return out


def _single_device(op, mesh, p, dt, dev, precond, q, b=None):
    """(b, matvec, precond) of ``op`` on one device in ``dt``; b the seeded
    right-hand side (unpadded), or ``b`` (padded for bp1) converted."""
    rng = np.random.default_rng(0)
    grid = tuple(n * p + 1 for n in mesh.shape)
    pre = None
    if op == "general":
        hm = mesh.to_hex_mesh()
        gops = GeneralOperators(hm, build_dofmap(hm, p, device=dev), dtype=dt,
                                rule="gauss", q=q, device=dev)
        b = torch.as_tensor(rng.standard_normal(gops.ndofs) if b is None else b,
                            dtype=dt, device=dev)
        if precond:
            inv_m = 1.0 / gops.lumped_mass_on(dev)
            pre = lambda r: inv_m * r  # noqa: E731
        return b, gops.mass, pre
    if op == "bp1":
        layout, tables, pre = bp1_setup(mesh, p, dt, dev, precond, q)
        b = (layout.pad(torch.as_tensor(rng.standard_normal(grid), dtype=dt, device=dev))
             if b is None else b.to(dt))
        return b, lambda v: mass_apply(v, layout, tables), pre
    ops = StructuredOperators(mesh, p, dtype=dt)
    b = torch.as_tensor(rng.standard_normal(grid) if b is None else b, dtype=dt,
                        device=dev)
    if precond:
        (inv_diag,) = tables_from_numpy((1.0 / ops.lumped_mass,), dev, dt)
        pre = lambda r: inv_diag * r  # noqa: E731
    return b, ops.spectral_mass, pre


def _general_parity(sg, x, iters, tau, dtype, dev, kmax, rtol) -> dict:
    """The sharded general CG against the same CG on one device from the
    same b (the JAX bench's rule: iterations within 1, solutions within
    1e-6 relative in f64 and 1e-2 in f32)."""
    gm = sg.model
    b1 = torch.as_tensor(np.random.default_rng(0).standard_normal(gm.ndofs), dtype=gm.dtype,
                         device=dev)

    def matvec(z):
        return gm.m * z - tau * gm.ops.stiffness(z, gm.c0)

    x1, k1, _ = cg(matvec, b1, kmax=kmax, rtol=rtol, precond=lambda r: r / gm.m)
    x1n = to_numpy(x1)
    rel = float(np.abs(sg.to_global(x) - x1n).max() / np.abs(x1n).max())
    if abs(k1 - iters) > 1 or rel >= (1e-6 if dtype == "f64" else 1e-2):
        raise RuntimeError(f"sharded general CG: {iters} iterations and a solution "
                           f"{rel:.3e} from one device's ({k1} iterations)")
    return dict(exchange=sg.exchange_mode, iters_single_device=k1,
                iteration_parity=k1 == iters, max_rel_solution_diff=rel)


def _single_device_parity(sw, x, iters, grid, dt, dev, kmax, rtol, precond) -> dict:
    """The sharded CG against the same CG on one device from the same b:
    its dots sum in another order, which CG amplifies past the residual
    plateau, so the iterations may differ by one (the JAX bench's rule);
    the solutions agree to the solver's tolerance."""
    ops = StructuredOperators(sw.model.mesh, sw.model.p, dtype=dt)
    b1 = torch.as_tensor(np.random.default_rng(0).standard_normal(grid), dtype=dt,
                         device=dev)
    pre = None
    if precond:
        (inv,) = tables_from_numpy((1.0 / ops.lumped_mass,), dev, dt)
        pre = lambda r: inv * r  # noqa: E731
    x1, k1, _ = cg(ops.spectral_mass, b1, kmax=kmax, rtol=rtol, precond=pre)
    x1n = to_numpy(x1)
    rel = float(np.abs(sw.to_global(x) - x1n).max() / np.abs(x1n).max())
    if abs(k1 - iters) > 1 or rel >= 10 * rtol:
        raise RuntimeError(f"sharded CG: {iters} iterations and a solution {rel:.3e} "
                           f"from one device's ({k1} iterations)")
    return dict(iters_single_device=k1, iteration_parity=k1 == iters,
                max_rel_solution_diff=rel)


def main(argv=None):
    ap = make_parser(size=32, degree=2, reps=8)
    ap.add_argument("--kmax", type=int, default=50)
    ap.add_argument("--rtol", type=float, default=1e-4)
    ap.add_argument("--ndev", type=int, default=1)
    ap.add_argument("--op", choices=["bp1", "spectral", "general"],
                    default="bp1")
    ap.add_argument("--q", type=int, default=None,
                    help="BP1 quadrature exactness degree (default 2p+3: "
                         "p+2 Gauss points, the CEED BP1 spec)")
    ap.add_argument("--precond", action="store_true",
                    help="Jacobi preconditioning")
    args = ap.parse_args(argv)
    report(**run(op=args.op, size=args.size, degree=args.degree, s=args.s,
                 reps=args.reps, dtype=args.dtype, device=args.device,
                 kmax=args.kmax, rtol=args.rtol, ndev=args.ndev, q=args.q,
                 precond=args.precond))


if __name__ == "__main__":
    main()
