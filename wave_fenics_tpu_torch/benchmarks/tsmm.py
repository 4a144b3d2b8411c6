"""Batched tensor-contraction benchmark (the reference's ``gpu_tsmm`` demo).

Port of ``wave_fenics_tpu.benchmarks.tsmm``. The reference times two
back-to-back cublasDgemm on [ndofs x ncells] matrices, interpolating to the
quadrature points and projecting back (demo/gpu_tsmm/main.cpp:12-68,
ncells = 100000, ndofs = 125, GFLOPs = 4 nc nd^2 / t). Here the pair is
sum-factorized (``ops.element_kernels.interp3``, then ``interp3_t``) on a
Gauss rule of 2p + 2 exactness: three batched [nq x nd] contractions a
direction instead of one [nd^3 x nq^3] gemm. The record keeps both flop
models: ``gflops_ref`` the reference's dense one, for comparison with it,
``gflops`` the sum-factorized work done.

The contractions are ``torch.einsum`` (cuBLAS on a card), as the JAX
package's are XLA einsums outside any Pallas kernel. On a card the run
turns TF32 off (``torch.backends.cuda.matmul.allow_tf32``,
``torch.backends.cudnn.allow_tf32``, the float32 matmul precision
"highest"), checks that it is off, and records the flags.

``--dtype bf16``: u and B in bf16, the six einsums bf16 (float32
accumulation in cuBLAS, each output rounded to bf16); ``--check`` raises
above ``common.BF16_CHECK_TOL``. The JAX package keeps B in float32 there,
so its bf16 contractions promote to float32.

Run: python -m wave_fenics_tpu_torch.benchmarks.tsmm [--ncells N] [--degree P]
         [--dtype f32|f64|bf16] [--device cuda|cpu] [--check]
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.basis import tabulate_1d
from ..ops.element_kernels import interp3, interp3_t
from ..utils.timing import sync
from .common import (bench_dtype, check_bf16, device_name, make_parser, report,
                     resolve_device, two_point_time)

__all__ = ["run", "main", "contract", "flops"]

#: cells the f64 check takes (the first ones)
CHECK_CELLS = 1000


def contract(u: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """One apply: interpolate to the quadrature points and project back."""
    return interp3_t(interp3(u, B), B)


def flops(ncells: int, nd: int, nq: int) -> tuple[float, float]:
    """(the reference's dense-gemm flops, demo/gpu_tsmm/main.cpp:58; the
    sum-factorized flops: nq nd^3 + nq^2 nd^2 + nq^3 nd multiply-adds a
    pass, two passes, two flops a multiply-add) of one apply, for 1D sizes
    ``nd`` and ``nq``."""
    nd3 = nd**3
    return (4.0 * ncells * nd3 * nd3,
            4.0 * ncells * (nq * nd**3 + nq**2 * nd**2 + nq**3 * nd))


def _tf32_off() -> dict:
    """Turn TF32 off for the card's f32 matmuls; the flags as they now are."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    flags = {"cuda_matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
             "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
             "float32_matmul_precision": torch.get_float32_matmul_precision()}
    if (flags["cuda_matmul_allow_tf32"] or flags["cudnn_allow_tf32"]
            or flags["float32_matmul_precision"] != "highest"):
        raise RuntimeError(f"TF32 is still on: {flags}")
    return flags


def run(ncells: int = 100000, degree: int = 4, reps: int = 100, dtype: str = "f32",
        device: str = "cuda", check: bool = False) -> dict:
    """One record: the JAX module's fields (``metric``, ``ncells``, ``ndofs``,
    ``nq``, ``degree``, ``dtype``, ``ms_per_apply``, ``timing``,
    ``gflops_ref``, ``gflops``, ``gdofs_per_s``), unrounded, with ``device``,
    ``applies`` (the applies run), the TF32 flags and, with ``check``, the
    largest error on the first ``CHECK_CELLS`` cells against the same
    contraction in float64, over the largest |value| of the latter."""
    dev = resolve_device(device)
    dt = bench_dtype(dtype)
    flags = _tf32_off() if dev.type == "cuda" else None
    p = degree
    tab = tabulate_1d(p, q=2 * p + 2, rule="gauss")  # not collocated: real contractions
    nd, nq = tab.nd, tab.nq
    B = torch.as_tensor(tab.B, dtype=dt, device=dev)
    u_host = np.random.default_rng(0).standard_normal((ncells, nd, nd, nd))
    u = torch.as_tensor(u_host, dtype=dt, device=dev)
    sync(dev)

    t, timing, calls = two_point_time(lambda: contract(u, B), reps, dev)
    flops_ref, flops_sf = flops(ncells, nd, nq)
    out = {"metric": "tsmm interp+project", "ncells": ncells, "ndofs": nd**3,
           "nq": nq**3, "degree": p, "dtype": dtype, "device": device_name(dev),
           "ms_per_apply": t * 1e3, "timing": timing,
           "gflops_ref": flops_ref / t / 1e9, "gflops": flops_sf / t / 1e9,
           "gdofs_per_s": ncells * nd**3 / t / 1e9, "applies": calls + int(check),
           "tf32": flags}
    if check:
        n = min(CHECK_CELLS, ncells)
        y = contract(u, B)[:n].double()
        ref = contract(torch.as_tensor(u_host[:n], device=dev),
                       torch.as_tensor(tab.B, device=dev))
        out["max_rel_err_vs_f64"] = float((y - ref).abs().max() / ref.abs().max())
        check_bf16(dtype, out["max_rel_err_vs_f64"], "tsmm --check")
    return out


def main(argv=None):
    ap = make_parser(degree=4, reps=100)
    ap.add_argument("--ncells", type=int, default=100000)
    args = ap.parse_args(argv)
    report(**run(ncells=args.ncells, degree=args.degree, reps=args.reps,
                 dtype=args.dtype, device=args.device, check=args.check))


if __name__ == "__main__":
    main()
