"""A distributed solve of the planar case on n blocks.

``ShardedPaddedWave(case.model, decompose3d(n), tile_x=8)``, 4 cells a
block on each axis (0.01 m, p = 4), 10 RK4 steps on the per-stage halo-add
path (kernel B on each block on a card). Every block lives on the one
device through ``halo.LocalExchange`` (the JAX package's example,
examples/multichip_solve.py:22-30, puts them on n virtual devices).

Float32 on a card, float64 on the CPU.

Run: python -m wave_fenics_tpu_torch.examples.multichip_solve [n]
         [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..models.planar3d import planar3d_case
from ..parallel.partition import decompose3d
from ..parallel.sharded_padded import ShardedPaddedWave


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("n", nargs="?", type=int, default=8, help="blocks (default 8)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    parts = decompose3d(args.n)
    dtype = torch.float32 if args.device == "cuda" else torch.float64
    case = planar3d_case(ncells=tuple(4 * m for m in parts), domain_length=0.01,
                         dtype=dtype, device=args.device)
    sw = ShardedPaddedWave(case.model, parts, tile_x=8)
    u, v, nsteps = sw.solve(case.t0, case.t0 + 10 * case.dt, case.dt)
    vg = sw.to_global(v)
    vmax = float(np.abs(vg).max())
    print(f"mesh={parts} steps={nsteps} |v|max={vmax:.3e}")
    return {"parts": parts, "steps": nsteps, "v_max": vmax, "v": vg}


if __name__ == "__main__":
    main()
