"""Kernels B and F through their public wrappers on one CUDA card, for the
package of a given tree of the repository, so that two trees can be timed
in turns within one call (parent, new, new, parent).

Run it by path, not as a module, so that the package comes from ``--root``:

    python wave_fenics_tpu_torch/apps/kernel_times.py [--root DIR] [--reps 200] \
           [--dtype f32|bf16]

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
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="the tree whose wave_fenics_tpu_torch package is timed")
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--dtype", choices=("f32", "bf16"), default="f32")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("kernel_times needs a CUDA card")
    from wave_fenics_tpu_torch.apps import planar3d_app
    from wave_fenics_tpu_torch.convert import tables_from_numpy
    from wave_fenics_tpu_torch.core.mesh import box_mesh
    from wave_fenics_tpu_torch.ops import stiffness, wave
    from wave_fenics_tpu_torch.ops.operators import StructuredOperators
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
    dev = torch.device("cuda")
    dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[args.dtype]
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {"card": card, "root": str(root), "dtype": args.dtype}

    ops = StructuredOperators(box_mesh((64, 64, 64), (1.0, 1.0, 1.0)), 4, dtype=dtype)
    tabs = stiffness.GridStiffnessTables(*tables_from_numpy(
        stiffness.stiffness_grid_tables(ops._sepA, ops._seplines, ops.grid_shape, 4,
                                        -1500.0**2, dtype), dev, dtype))
    x = torch.randn(ops.grid_shape, dtype=dtype, device=dev, generator=gen)
    y = torch.empty_like(x)
    call = lambda: stiffness.stiffness_grid_cuda(x, tabs, 4, out=y)  # noqa: E731
    call()
    ref = stiffness.stiffness_grid_plain(x, tabs, 4)
    out["F"] = {"shape": list(x.shape),
                "rel_err": float((y - ref).float().abs().max() / ref.float().abs().max()),
                "wrapper_ms": 1e3 * timeit(call, reps=args.reps),
                "device_ms": _device_us(torch, call, args.reps) / 1e3}
    del x, y, ref, tabs, ops

    _, pm = planar3d_app.build((64, 32, 32), 4, args.dtype, None, "cuda")
    x = pm.layout.pad(torch.randn(pm.layout.shape, dtype=dtype, device=dev, generator=gen))
    y = torch.empty_like(x)
    call = lambda: wave.apply_flat_cuda(x, pm.layout, pm.stencil, out=y)  # noqa: E731
    call()
    ref = wave.apply_flat_plain(x, pm.layout, pm.flat_tables)
    out["B"] = {"shape": list(x.shape),
                "rel_err": float((y - ref).float().abs().max() / ref.float().abs().max()),
                "wrapper_ms": 1e3 * timeit(call, reps=args.reps),
                "device_ms": _device_us(torch, call, args.reps) / 1e3}
    print(card)
    for k in ("F", "B"):
        r = out[k]
        print(f"kernel {k} {tuple(r['shape'])}: {r['device_ms']:.4f} ms/apply on the "
              f"device, {r['wrapper_ms']:.4f} through the wrapper; max|err|/max|ref| "
              f"{r['rel_err']:.3e} ({root})")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
