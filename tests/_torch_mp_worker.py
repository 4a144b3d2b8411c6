"""Worker process of ``tests/test_torch_multiprocess.py``: one of the
processes of a gloo process group that together run a ShardedPaddedWave
or ShardedGeneralWave solve of the port, each driving the blocks or parts
it owns.

Usage: python _torch_mp_worker.py PORT RANK WORLD OUTDIR PARTS MODE [DTYPE]

PARTS: a comma list like "4,1,1" (for the general modes, the number of
parts, N,1,1); MODE: "stage" (the per-stage halo-add ``solve_n``), "step"
(the value-halo ``solve_step_n``), "general-allgather" or
"general-ppermute" (``ShardedGeneralWave.solve_n`` on the box as a
``HexMesh``, with that assembly); DTYPE: "f64" (default) or "bf16". Rank 0
writes the gathered global u and v (bf16 widened to float32) to
OUTDIR/u.npy and OUTDIR/v.npy.
"""

import os
import sys

import numpy as np
import torch

SHAPE, P, DT, NSTEPS = (4, 4, 2), 3, 1.0e-8, 5


DTYPES = {"f64": torch.float64, "bf16": torch.bfloat16}


def model(dtype=torch.float64):
    from wave_fenics_tpu_torch.core.mesh import FacetTags, box_mesh
    from wave_fenics_tpu_torch.models.linear_wave import LinearWave

    mesh = box_mesh(SHAPE, (1.0e-2, 1.0e-2, 0.5e-2),
                    facet_tags=FacetTags({1: (0,), 2: (1,)}))
    return LinearWave(mesh, p=P, c0=1500.0, freq0=0.5e6, dtype=dtype, device="cpu")


def general_model(dtype=torch.float64):
    """The box as a ``HexMesh``, p = 3, tag 1 on the x-low faces and 2 on
    the x-high ones (the JAX worker's ``general_facet_tags``)."""
    from wave_fenics_tpu_torch.models.general_wave import GeneralLinearWave

    hm = model(dtype).mesh.to_hex_mesh()
    length = float(hm.points[:, 0].max())

    def xquads(x0, vids):
        on = np.abs(hm.points[:, 0] - x0) < 1e-12
        quads = hm.cells[:, list(vids)]
        return quads[on[quads].all(axis=1)]

    tags = {1: xquads(0.0, (0, 2, 4, 6)), 2: xquads(length, (1, 3, 5, 7))}
    return GeneralLinearWave(hm, P, tags, c0=1500.0, freq0=0.5e6, dtype=dtype,
                             device="cpu")


def solve(sw, mode):
    if mode.startswith("general"):
        u, v, _ = sw.solve_n(0.0, DT, NSTEPS)
        return sw.to_global(u), sw.to_global(v)
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
    dtype = DTYPES[sys.argv[7] if len(sys.argv) > 7 else "f64"]
    torch.set_num_threads(1)

    import torch.distributed as dist

    from wave_fenics_tpu_torch.parallel import distributed
    from wave_fenics_tpu_torch.parallel.sharded_general import ShardedGeneralWave
    from wave_fenics_tpu_torch.parallel.sharded_padded import ShardedPaddedWave

    distributed.initialize(device="cpu", init_method=f"tcp://localhost:{port}",
                           world_size=world, rank=rank)
    print(distributed.process_summary(), flush=True)
    ex = distributed.ProcessGroupExchange(distributed.global_device_mesh(parts))
    assert len(ex.local_blocks) == int(np.prod(parts)) // world
    if mode.startswith("general"):
        sw = ShardedGeneralWave(general_model(dtype), parts[0],
                                exchange=mode.split("-")[1], comm=ex)
        assert sw.exchange_mode == mode.split("-")[1]
    else:
        sw = ShardedPaddedWave(model(dtype), parts, exchange=ex)
    ug, vg = solve(sw, mode)
    if rank == 0:
        np.save(os.path.join(outdir, "u.npy"), ug)
        np.save(os.path.join(outdir, "v.npy"), vg)
    dist.destroy_process_group()
    print(f"rank {rank} done", flush=True)


if __name__ == "__main__":
    main()
