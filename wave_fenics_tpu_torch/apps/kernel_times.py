"""Kernels B and F through their public wrappers on one CUDA card, for the
package of a given tree of the repository, so that two trees can be timed
in turns within one call (parent, new, new, parent).

Run it by path, not as a module, so that the package comes from ``--root``:

    python wave_fenics_tpu_torch/apps/kernel_times.py [--root DIR] [--reps 200] \
           [--dtype f32|bf16] [--library]

- kernel F: ``stiffness_grid_cuda(x, tables, p, out=)`` on the P7 grid
  (64^3 cells of a unit box, p = 4, 257^3 dofs; the tables of
  ``StructuredOperators.stiffness`` with c0 = 1500);
- kernel B: ``apply_flat_cuda(x, layout, stencil, out=)`` on the P1 layout
  (the planar3d case at 64x32x32 cells, p = 4, tile 48: (384, 144, 144);
  x random in the interior, 0 in the padding);

both in ``--dtype`` (f32, the default, or bf16: bf16 fields and tables).

Each is timed two ways: CUDA events over ``--reps`` back-to-back wrapper
calls (``utils.timing.timeit``; the host's per-call checks may pace them),
and the device time per call of the kernels the profiler records over the
same calls (``torch.profiler``), which the host cannot pace. Each result
is also held against the plain version (max |error| / max |ref|). It
prints the card's name and power limit (nvidia-smi) and, last, one JSON
line.

``--library`` (f32) adds the one PyTorch call that computes the function
of kernels B, E and F: ``torch.sparse.mm`` of the assembled operator as a
CSR matrix with int32 indices (:func:`csr_operator`, built on the host
from the 1D matrices by ``scipy.sparse.kron``; with the lumped GLL mass a
row holds 3p + 4 entries on average) on the dof grid: B's -c0^2 M^-1 K at
the P1 grid (257x129x129, p = 4), E's at the P12 grid (26x13x13 cells,
p = 10: 261x131x131) and F's -c0^2 K on the P7 grid (257^3). Each product
is held against the kernel's on the dof grid (limit 1e-5 of max|kernel|)
and timed as the kernels are, beside kernel E at P12 and the call's byte
bound (nnz x (4 + 4) bytes of values and column indices, the row
pointers, x read and y written once, at 3.35 TB/s).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path


def _device_us(torch, fn, reps: int) -> float:
    """Microseconds of device time per call of ``fn`` (all its kernels)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / reps


HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet


def csr_operator(cells, p: int, h, c0: float, inv_mass: bool):
    """The SciPy CSR matrix (float64, int32 indices) of -c0^2 K on the dof
    grid of ``cells`` (C order), or of -c0^2 M^-1 K with ``inv_mass`` (M
    the lumped GLL mass): K = sum_d A_d (x) L_d' (x) L_d'' by
    ``scipy.sparse.kron`` of the assembled 1D blocks ``A_d`` of
    ``separable_stiffness_tables`` and the diagonal weight lines of
    ``grid_lines`` (the separable stiffness of ``ops/separable.py``)."""
    import numpy as np
    import scipy.sparse as sp

    from wave_fenics_tpu_torch.core.basis import lumped_weight_line
    from wave_fenics_tpu_torch.ops.separable import grid_lines, separable_stiffness_tables

    A, _ = separable_stiffness_tables(p, h, np.float64)
    lines = grid_lines(tuple(cells), p, np.float64)

    def assembled(a, n):
        idx = np.arange(n)[:, None] * p + np.arange(p + 1)[None, :]
        rows = np.broadcast_to(idx[:, :, None], (n, p + 1, p + 1)).ravel()
        cols = np.broadcast_to(idx[:, None, :], (n, p + 1, p + 1)).ravel()
        vals = np.broadcast_to(a, (n, p + 1, p + 1)).ravel()
        return sp.csr_matrix((vals, (rows, cols)), shape=(n * p + 1,) * 2)

    K1 = [assembled(A[d], cells[d]) for d in range(3)]
    L = [sp.diags(line) for line in lines]
    K = (sp.kron(sp.kron(K1[0], L[1]), L[2], format="csr")
         + sp.kron(sp.kron(L[0], K1[1]), L[2], format="csr")
         + sp.kron(sp.kron(L[0], L[1]), K1[2], format="csr"))
    if inv_mass:
        m = [lumped_weight_line(cells[d], p, h[d]) for d in range(3)]
        K = sp.diags(1.0 / np.kron(np.kron(m[0], m[1]), m[2])) @ K
    K = (-float(c0) ** 2 * K).tocsr()
    K.sort_indices()
    K.indptr = K.indptr.astype(np.int32)
    K.indices = K.indices.astype(np.int32)
    return K


#: each kernel's full width: (cells, p); F on the unit box, B and E on the
#: planar3d case (the app's tile)
WIDTHS = {"F": ((64, 64, 64), 4), "B": ((64, 32, 32), 4), "E": ((26, 13, 13), 10)}


def kernel_case(torch, k: str, dtype, gen) -> dict:
    """Kernel ``k`` (F, B or E) at its :data:`WIDTHS` on the card, in
    ``dtype``: its input ``x`` (random; 0 in the padding), ``call`` (one
    launch through the wrapper into ``y``), ``plain`` (the plain version's
    result), ``grid`` (a field of the kernel's layout on the dof grid) and
    the mesh's ``h`` and ``c0`` that :func:`csr_operator` takes."""
    from wave_fenics_tpu_torch.apps import planar3d_app
    from wave_fenics_tpu_torch.convert import tables_from_numpy
    from wave_fenics_tpu_torch.core.mesh import box_mesh
    from wave_fenics_tpu_torch.ops import stiffness, wave
    from wave_fenics_tpu_torch.ops.operators import StructuredOperators

    dev = torch.device("cuda")
    cells, p = WIDTHS[k]
    if k == "F":
        ops = StructuredOperators(box_mesh(cells, (1.0, 1.0, 1.0)), p, dtype=dtype)
        tabs = stiffness.GridStiffnessTables(*tables_from_numpy(
            stiffness.stiffness_grid_tables(ops._sepA, ops._seplines, ops.grid_shape, p,
                                            -1500.0**2, dtype), dev, dtype))
        x = torch.randn(ops.grid_shape, dtype=dtype, device=dev, generator=gen)
        y = torch.empty_like(x)
        return dict(x=x, y=y, h=ops.mesh.h, c0=1500.0, grid=lambda t: t,
                    call=lambda: stiffness.stiffness_grid_cuda(x, tabs, p, out=y),
                    plain=lambda: stiffness.stiffness_grid_plain(x, tabs, p))
    _, pm = planar3d_app.build(cells, p, {torch.float32: "f32", torch.bfloat16: "bf16"}[dtype],
                               None, "cuda")
    x = pm.layout.pad(torch.randn(pm.layout.shape, dtype=dtype, device=dev, generator=gen))
    y = torch.empty_like(x)
    if k == "B":
        call = lambda: wave.apply_flat_cuda(x, pm.layout, pm.stencil, out=y)  # noqa: E731
        plain = lambda: wave.apply_flat_plain(x, pm.layout, pm.flat_tables)  # noqa: E731
    else:
        call = lambda: wave.apply_slab_cuda(x, pm.layout, pm.slab_tables, out=y)  # noqa: E731
        plain = lambda: wave.apply_slab_plain(x, pm.layout, pm.slab_tables)  # noqa: E731
    return dict(x=x, y=y, h=pm.base.mesh.h, c0=pm.base.c0, grid=pm.layout.unpad,
                call=call, plain=plain)


def library_times(torch, reps: int) -> dict:
    """Kernels B, E and F beside ``torch.sparse.mm`` of :func:`csr_operator`
    at their full widths, f32, on one card; raises where a product is not
    within 1e-5 of max|kernel|."""
    import numpy as np

    from wave_fenics_tpu_torch.utils.timing import timeit

    gen = torch.Generator(device="cuda").manual_seed(1)
    out = {}
    for k in ("B", "E", "F"):
        (cells, p), c = WIDTHS[k], kernel_case(torch, k, torch.float32, gen)
        c["call"]()
        y_kernel = c["grid"](c["y"]).reshape(-1)
        x_grid = c["grid"](c["x"]).reshape(-1, 1).contiguous()
        t0 = time.perf_counter()
        C = csr_operator(cells, p, c["h"], c["c0"], inv_mass=k != "F")
        build_s = time.perf_counter() - t0
        A = torch.sparse_csr_tensor(
            torch.from_numpy(C.indptr), torch.from_numpy(C.indices),
            torch.from_numpy(C.data.astype(np.float32)), size=C.shape,
            check_invariants=False).to("cuda")
        spmv = lambda: torch.sparse.mm(A, x_grid)  # noqa: E731
        y_lib = spmv()[:, 0]
        n = C.shape[0]
        nbytes = C.nnz * (4 + 4) + (n + 1) * 4 + 2 * n * 4
        out[k] = {
            "cells": list(cells), "p": p, "ndofs": n, "nnz": int(C.nnz),
            "index_dtype": str(A.col_indices().dtype),
            "rel_err": float((y_lib - y_kernel).abs().max() / y_kernel.abs().max()),
            "host_build_s": build_s,
            "library_ms": 1e3 * timeit(spmv, reps=reps),
            "library_device_ms": _device_us(torch, spmv, reps) / 1e3,
            "library_bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S,
            "kernel_ms": 1e3 * timeit(c["call"], reps=reps),
            "kernel_device_ms": _device_us(torch, c["call"], reps) / 1e3,
        }
        if not out[k]["rel_err"] <= 1e-5:
            raise RuntimeError(f"kernel {k} against the CSR SpMV: {out[k]['rel_err']:.3e}")
        del A, C, c, x_grid, y_lib, y_kernel
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="the tree whose wave_fenics_tpu_torch package is timed")
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--dtype", choices=("f32", "bf16"), default="f32")
    ap.add_argument("--library", action="store_true",
                    help="also B, E and F beside torch.sparse.mm of the assembled CSR (f32)")
    args = ap.parse_args(argv)
    if args.library and args.dtype != "f32":
        ap.error("--library times f32 only")
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("kernel_times needs a CUDA card")
    from wave_fenics_tpu_torch.utils.timing import timeit

    import wave_fenics_tpu_torch
    if not Path(wave_fenics_tpu_torch.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"wave_fenics_tpu_torch was imported from "
                           f"{wave_fenics_tpu_torch.__file__}, not from {root}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0].strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[args.dtype]
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"card": card, "root": str(root), "dtype": args.dtype}
    for k in ("F", "B"):
        c = kernel_case(torch, k, dtype, gen)
        c["call"]()
        y, ref = c["y"].float(), c["plain"]().float()
        out[k] = {"shape": list(c["x"].shape),
                  "rel_err": float((y - ref).abs().max() / ref.abs().max()),
                  "wrapper_ms": 1e3 * timeit(c["call"], reps=args.reps),
                  "device_ms": _device_us(torch, c["call"], args.reps) / 1e3}
        del c, y, ref
    if args.library:
        out["library"] = library_times(torch, args.reps)
    print(card)
    for k in ("F", "B"):
        r = out[k]
        print(f"kernel {k} {tuple(r['shape'])}: {r['device_ms']:.4f} ms/apply on the "
              f"device, {r['wrapper_ms']:.4f} through the wrapper; max|err|/max|ref| "
              f"{r['rel_err']:.3e} ({root})")
    for k, r in out.get("library", {}).items():
        print(f"kernel {k} {r['cells']} p={r['p']}: {r['kernel_device_ms']:.4f} ms on the "
              f"device; torch.sparse.mm of the CSR ({r['nnz']:,} nnz, "
              f"{r['index_dtype']}) {r['library_device_ms']:.4f} ms on the device, "
              f"{r['library_ms']:.4f} by events, bound {r['library_bound_ms']:.4f}; "
              f"against the kernel {r['rel_err']:.3e}")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
