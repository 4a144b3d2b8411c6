"""Gather/scatter and exchange benchmarks (the reference's gpu_scatter_local
and gpu_scatter_mpi demos).

Port of ``wave_fenics_tpu.benchmarks.scatter_bench``:

- ``--mode local``: the structured overlap gather and scatter round trip
  (``ops.gather_scatter.gather_grid``/``scatter_grid``) on the unit box's
  dof grid; ``--check`` first gathers an iota grid and asks for the
  dofmap exactly (demo/gpu_scatter_local/main.cpp:84-90; an int64 iota,
  exact at any size, where the JAX bench's float32 one is exact only below
  2^24 dofs);
- ``--mode halo``: ``halo_add`` (the reverse and forward updates in one)
  and ``halo_sync`` (the forward update alone) on the blocks of
  ``parallel.sharded_wave.ShardedLinearWave`` over ``decompose3d(ndev)``
  (VectorUpdater update_rev/update_fwd, demo/gpu_scatter_mpi/main.cpp:
  105-160);
- ``--mode general-halo``: the imported-mesh interface assembly alone
  (``ShardedGeneralWave._assemble`` on the box as a ``HexMesh``, ``ndev``
  RCB parts, ``--exchange``), with ``interface_slots`` (allgather) or
  ``rounds`` and ``bucket_slots`` (ppermute).

With one card every block and part sits on it, so the exchange times are
the cost of the copies and of the launches, not of a link between cards.
Timing: ``common.two_point_time`` (CUDA events on a card); the record
holds ``us_per_exchange`` as the JAX bench's does.

Run: python -m wave_fenics_tpu_torch.benchmarks.scatter_bench --mode local --size 32
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.dofmap import StructuredDofGrid
from ..core.mesh import box_mesh
from ..models.general_wave import GeneralLinearWave
from ..models.linear_wave import LinearWave
from ..ops import gather_scatter as gs
from ..parallel.halo import halo_add, halo_sync
from ..parallel.partition import decompose3d
from ..parallel.sharded_general import EXCHANGES, ShardedGeneralWave
from ..parallel.sharded_wave import ShardedLinearWave
from .common import (bench_dtype, device_name, make_parser, report, resolve_device,
                     streaming_fields, two_point_time)

MODES = ("local", "halo", "general-halo")


def run(mode: str = "local", size: int = 32, degree: int = 4, reps: int = 50,
        dtype: str = "f32", device: str = "cuda", check: bool = False, ndev: int = 8,
        exchange: str = "auto") -> dict:
    """One record of ``mode`` on the unit box of ``size``^3 cells (the JAX
    bench's keys, plus ``device``, ``timing`` and ``calls``: the timed
    function's calls)."""
    if mode not in MODES:
        raise ValueError(f"--mode {mode!r}: one of {MODES}")
    dev = resolve_device(device)
    dt = bench_dtype(dtype)
    p = degree
    mesh = box_mesh((size,) * 3, (1.0, 1.0, 1.0))
    if mode == "local":
        dg = StructuredDofGrid(mesh, p)
        if check:
            x = torch.arange(dg.ndofs, dtype=torch.int64, device=dev).reshape(dg.grid_shape)
            xe = gs.gather_grid(x, p).reshape(dg.ncells, -1).cpu().numpy()
            if not np.array_equal(xe, dg.dofmap()):
                raise RuntimeError("gather(iota) != dofmap")
        x = torch.as_tensor(np.random.default_rng(0).standard_normal(dg.grid_shape),
                            dtype=dt, device=dev)
        t, timing, calls = two_point_time(
            lambda: gs.scatter_grid(gs.gather_grid(x, p), p, mesh.shape), reps, dev)
        ne = dg.ncells * (p + 1) ** 3  # element-tensor entries
        nbytes = 2 * (dg.ndofs + ne) * x.element_size()
        return dict(metric="structured gather+scatter roundtrip", ndofs=dg.ndofs,
                    degree=p, dtype=dtype, device=device_name(dev), ms=t * 1e3,
                    timing=timing, calls=calls, gdofs_per_s=dg.ndofs / t / 1e9,
                    **streaming_fields(nbytes, t, dev))
    if mode == "halo":
        sw = ShardedLinearWave(LinearWave(mesh, p, dtype=dt, device=dev),
                               decompose3d(ndev))
        u, _ = sw.zero_state()
        t, timing, calls = two_point_time(lambda: halo_add(u, sw.exchange), reps, dev)
        t_fwd, _, _ = two_point_time(lambda: halo_sync(u, sw.exchange), reps, dev)
        face = sw.block_shape[1] * sw.block_shape[2] * torch.finfo(dt).bits // 8
        return dict(metric="halo exchange (3-axis slab swaps)", ndev=ndev,
                    parts=list(sw.parts), degree=p, dtype=dtype, device=device_name(dev),
                    us_per_exchange=t * 1e6, us_per_fwd_sync=t_fwd * 1e6, timing=timing,
                    calls=calls, face_bytes=face)
    if exchange not in EXCHANGES:
        raise ValueError(f"--exchange {exchange!r}: one of {EXCHANGES}")
    gm = GeneralLinearWave(mesh.to_hex_mesh(), p, facet_tags={}, dtype=dt, device=dev)
    sw = ShardedGeneralWave(gm, ndev, exchange=exchange).prepare()
    u, _ = sw.zero_state()
    t, timing, calls = two_point_time(lambda: sw._assemble(u), reps, dev)
    ns = sw._nbr_setup
    extra = (dict(rounds=ns["NR"], bucket_slots=ns["Sb"])
             if sw.exchange_mode == "ppermute" and ns is not None
             else dict(interface_slots=sw._setup["S"]))
    return dict(metric=f"unstructured interface assembly ({sw.exchange_mode})",
                ndev=ndev, ndofs=gm.ndofs, degree=p, dtype=dtype, device=device_name(dev),
                us_per_exchange=t * 1e6, timing=timing, calls=calls, **extra)


def main(argv=None):
    ap = make_parser(size=32, degree=4, reps=50)
    ap.add_argument("--mode", choices=MODES, default="local")
    ap.add_argument("--ndev", type=int, default=8,
                    help="blocks (halo) or RCB parts (general-halo), all on the card "
                         "with one card")
    ap.add_argument("--exchange", default="auto", choices=EXCHANGES,
                    help="general-halo assembly collective")
    args = ap.parse_args(argv)
    report(**run(mode=args.mode, size=args.size, degree=args.degree, reps=args.reps,
                 dtype=args.dtype, device=args.device, check=args.check, ndev=args.ndev,
                 exchange=args.exchange))


if __name__ == "__main__":
    main()
