"""Worker process of ``tests/test_torch_multiprocess.py``: one of the
processes of a gloo process group that together run a ShardedPaddedWave
solve of the port, each driving the blocks it owns.

Usage: python _torch_mp_worker.py PORT RANK WORLD OUTDIR PARTS MODE

PARTS: a comma list like "4,1,1"; MODE: "stage" (the per-stage halo-add
``solve_n``) or "step" (the value-halo ``solve_step_n``). Rank 0 writes
the gathered global u and v to OUTDIR/u.npy and OUTDIR/v.npy.
"""

import os
import sys

import numpy as np
import torch

SHAPE, P, DT, NSTEPS = (4, 4, 2), 3, 1.0e-8, 5


def model():
    from wave_fenics_tpu_torch.core.mesh import FacetTags, box_mesh
    from wave_fenics_tpu_torch.models.linear_wave import LinearWave

    mesh = box_mesh(SHAPE, (1.0e-2, 1.0e-2, 0.5e-2),
                    facet_tags=FacetTags({1: (0,), 2: (1,)}))
    return LinearWave(mesh, p=P, c0=1500.0, freq0=0.5e6, dtype=torch.float64,
                      device="cpu")


def solve(sw, mode):
    if mode == "step":
        u, v, _ = sw.solve_step_n(0.0, DT, NSTEPS)
        return sw.to_global_step(u), sw.to_global_step(v)
    u, v, _ = sw.solve_n(0.0, DT, NSTEPS)
    return sw.to_global(u), sw.to_global(v)


def main():
    port, rank, world, outdir = (int(sys.argv[1]), int(sys.argv[2]),
                                 int(sys.argv[3]), sys.argv[4])
    parts = tuple(int(s) for s in sys.argv[5].split(","))
    mode = sys.argv[6]
    torch.set_num_threads(1)

    import torch.distributed as dist

    from wave_fenics_tpu_torch.parallel import distributed
    from wave_fenics_tpu_torch.parallel.sharded_padded import ShardedPaddedWave

    distributed.initialize(device="cpu", init_method=f"tcp://localhost:{port}",
                           world_size=world, rank=rank)
    print(distributed.process_summary(), flush=True)
    ex = distributed.ProcessGroupExchange(distributed.global_device_mesh(parts))
    assert len(ex.local_blocks) == int(np.prod(parts)) // world
    sw = ShardedPaddedWave(model(), parts, exchange=ex)
    ug, vg = solve(sw, mode)
    if rank == 0:
        np.save(os.path.join(outdir, "u.npy"), ug)
        np.save(os.path.join(outdir, "v.npy"), vg)
    dist.destroy_process_group()
    print(f"rank {rank} done", flush=True)


if __name__ == "__main__":
    main()
