"""Operator matvec benchmarks (the reference's gpu_operator_monolithic and
gpu_spectral_mass demos, the BP1 mass and the stiffness).

Port of ``wave_fenics_tpu.benchmarks.operators_bench`` on one device:

- ``stiffness``: the separable stiffness, kernel F on a card
  (``StructuredOperators.stiffness``), ``--check`` against the f64
  per-cell path;
- ``bp1-mass``: the consistent Gauss mass of CEED BP1 on the padded layout,
  kernel G on a card, ``--check`` against the f64 separable mass;
- ``mass-fused``, ``spectral``: the collocated (diagonal) mass;
  ``spectral-roundtrip``: the same via gather -> detJw -> scatter
  (demo/gpu_spectral_mass/main.cpp:73-80); ``--check`` against f64;
- ``stiffness-padded``: the padded stiffness/m of the solver, kernel B,
  ``--check`` against the f64 per-cell stiffness over the lumped mass;
- the explicit-dofmap family on the box as a ``HexMesh``
  (``GeneralOperators``, kernel K on a card): ``mass`` (the decomposed B^T
  D B pipeline at Gauss points, demo/gpu_operator/main.cpp:139-172; K's
  ``mass_gauss``), ``mass-general`` (collocated GLL; K's ``mass``),
  ``stiffness-general`` (K's ``stiffness``, affine cells on the box),
  ``stiffness-gauss`` (K's ``stiffness_gauss``) and
  ``stiffness-general-xla`` (the plain indexed path, no kernel); ``--check``
  against the f64 indexed path of a second operator set on the same mesh
  and dofmap.

The f64 oracle runs on the same device as the op. ``--dtype bf16`` runs
each op on its kernel's bf16 form (F, G, B, K; the diagonal masses and the
roundtrip in bf16 torch), and its ``--check`` raises above
``common.BF16_CHECK_TOL`` of the oracle's largest |value|.

Run: python -m wave_fenics_tpu_torch.benchmarks.operators_bench --op stiffness --size 32
Metric: DOF/s (size_local / t of the reference).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..core.dofmap import build_dofmap
from ..core.mesh import box_mesh
from ..models.linear_wave import LinearWave
from ..models.linear_wave_padded import PaddedLinearWave
from ..ops.mass import bp1_setup, mass_apply
from ..ops.operators import GeneralOperators, StructuredOperators
from ..ops.separable import mass_separable, separable_mass_tables
from ..utils.timing import sync
from .common import (bench_dtype, cells_from_args, check_bf16, device_name, make_parser,
                     report, resolve_device, streaming_fields, two_point_time)

STRUCTURED_OPS = ("stiffness", "bp1-mass", "mass-fused", "spectral",
                  "spectral-roundtrip", "stiffness-padded")
GENERAL_OPS = ("mass", "mass-general", "stiffness-general",
               "stiffness-general-xla", "stiffness-gauss")
C0 = 1500.0

# nominal state-traffic passes per apply (x read + y write = 2; the spectral
# ops also read the diagonal): a lower bound on the real traffic
_TRAFFIC_PASSES = {"spectral": 3, "spectral-roundtrip": 3}


def _oracle(op: str, mesh, p: int, x: torch.Tensor, layout=None) -> torch.Tensor:
    """The op's f64 reference on the unpadded grid, on x's device."""
    ops64 = StructuredOperators(mesh, p, dtype=torch.float64)
    x64 = (layout.unpad(x) if layout is not None else x).to(torch.float64)
    if op == "bp1-mass":
        M1 = separable_mass_tables(p, mesh.h, np.float64)
        return mass_separable(x64, [torch.as_tensor(m, device=x.device) for m in M1], p)
    if op == "stiffness-padded":
        m = torch.as_tensor(ops64.lumped_mass, device=x.device)
        return ops64.stiffness_percell(x64, C0) / m
    return {
        "stiffness": lambda a: ops64.stiffness_percell(a, C0),
        "mass-fused": ops64.mass,
        "spectral": ops64.spectral_mass,
        "spectral-roundtrip": ops64.spectral_mass_roundtrip,
    }[op](x64)


def _general(op: str, mesh, p: int, dt: torch.dtype, dev: torch.device):
    """(x, the op's apply, a maker of its f64 oracle) of an explicit-dofmap
    op on the box as a HexMesh, set up on ``dev`` (the set-up kernels on a
    card); the oracle shares the mesh and the dofmap and is set up in the
    same route, in float64."""
    hexm = mesh.to_hex_mesh()
    dofs = build_dofmap(hexm, p, device=dev)
    rule = "gauss" if op in ("mass", "stiffness-gauss") else "gll"
    gops = GeneralOperators(hexm, dofs, dtype=dt, rule=rule, device=dev)
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(gops.ndofs),
                        dtype=dt, device=dev)
    f = {
        "mass": gops.mass,
        "mass-general": gops.mass,
        "stiffness-general": lambda a: gops.stiffness(a, C0),
        "stiffness-gauss": lambda a: gops.stiffness(a, C0),
        "stiffness-general-xla": lambda a: gops.stiffness_indexed(a, C0),
    }[op]

    def oracle():
        ops64 = GeneralOperators(hexm, dofs, dtype=torch.float64, rule=rule, device=dev)
        return (ops64.spectral_mass_roundtrip if op == "mass-general"
                else ops64.mass_indexed if op == "mass"
                else lambda a: ops64.stiffness_indexed(a, C0))

    return x, lambda: f(x), oracle


def run(op: str = "stiffness", size: int = 32, degree: int = 4,
        s: int | None = None, reps: int = 50, check: bool = False,
        dtype: str = "f32", device: str = "cuda") -> dict:
    """One matvec benchmark record (the JAX bench's keys, plus ``device``,
    ``timing``, ``applies``: the number of applies run, and ``setup_s``: the
    seconds that built the op, before its first apply, the device
    synchronised)."""
    if op not in STRUCTURED_OPS + GENERAL_OPS:
        raise ValueError(f"--op {op!r}: one of {STRUCTURED_OPS + GENERAL_OPS}")
    dev = resolve_device(device)
    dt = bench_dtype(dtype)
    t0 = time.perf_counter()
    mesh = box_mesh(cells_from_args(size, s), (1.0, 1.0, 1.0))
    p = degree
    grid = tuple(n * p + 1 for n in mesh.shape)
    ndofs = int(np.prod(grid))
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(grid),
                        dtype=dt, device=dev)
    layout = oracle = None
    if op in GENERAL_OPS:
        x, f, oracle = _general(op, mesh, p, dt, dev)
    elif op == "stiffness-padded":
        pm = PaddedLinearWave(LinearWave(mesh, p=p, c0=C0, dtype=dt, device=dev))
        layout = pm.layout
        x = pm.from_grid(x)
        f = lambda: pm._apply(x)  # noqa: E731
    elif op == "bp1-mass":
        layout, tables, _ = bp1_setup(mesh, p, dt, dev)
        x = layout.pad(x)
        f = lambda: mass_apply(x, layout, tables)  # noqa: E731
    else:
        ops = StructuredOperators(mesh, p, dtype=dt)
        g = {
            "stiffness": lambda a: ops.stiffness(a, C0),
            "mass-fused": ops.mass,
            "spectral": ops.spectral_mass,
            "spectral-roundtrip": ops.spectral_mass_roundtrip,
        }[op]
        f = lambda: g(x)  # noqa: E731
    sync(dev)
    setup_s = time.perf_counter() - t0

    t, timing, calls = two_point_time(f, reps, dev)
    out = {"metric": f"{op} matvec", "degree": p, "ndofs": ndofs,
           "dtype": dtype, "device": device_name(dev), "ms_per_apply": t * 1e3,
           "gdofs_per_s": ndofs / t / 1e9, "timing": timing,
           "applies": calls + int(check), "setup_s": setup_s}
    out.update(streaming_fields(
        _TRAFFIC_PASSES.get(op, 2) * ndofs * torch.finfo(dt).bits // 8, t, dev))
    if check:
        y = f()
        y = (layout.unpad(y) if layout is not None else y).to(torch.float64)
        ref = (oracle()(x.to(torch.float64)) if oracle is not None
               else _oracle(op, mesh, p, x, layout))
        out["max_rel_err_vs_f64_oracle"] = float(
            (y - ref).abs().max() / ref.abs().max().clamp_min(1e-300))
        check_bf16(dtype, out["max_rel_err_vs_f64_oracle"], f"{op} --check")
    return out


def main(argv=None):
    ap = make_parser(size=32, degree=4, reps=50)
    ap.add_argument("--op", choices=list(STRUCTURED_OPS + GENERAL_OPS),
                    default="stiffness")
    args = ap.parse_args(argv)
    report(**run(op=args.op, size=args.size, degree=args.degree, s=args.s,
                 reps=args.reps, check=args.check, dtype=args.dtype,
                 device=args.device))


if __name__ == "__main__":
    main()
