"""Benchmark CLIs of the reference demo apps, on one device.

Each module is runnable as ``python -m wave_fenics_tpu_torch.benchmarks.<name>``,
has ``run(**kw) -> dict`` and prints one JSON result line:

- ``operators_bench``: matvec DOF/s of the structured and the
  explicit-dofmap operators (gpu_operator, gpu_operator_monolithic,
  gpu_spectral_mass; BP1 mass; stiffness);
- ``cg_bench``: CG Dofs*iteration/s (gpu_cg / CEED BP1; the general mass);
- ``general_solve``: the RK4 or leapfrog solve rate on a perturbed
  (unstructured) hex box, GDoF*steps/s;
- ``scatter_bench``: the structured gather/scatter round trip, the box's
  halo exchange and the imported-mesh interface assembly
  (gpu_scatter_local, gpu_scatter_mpi);
- ``tsmm``: the batched interpolate-and-project contraction pair
  (gpu_tsmm), GFLOP/s on the reference's dense model and on the
  sum-factorized work;
- ``suite``: every module above in one process (the JAX suite's entries),
  with, on a card, the headline planar3d RK4 records (``suite.headline``),
  written as one JSON document and a summary line.

``common.stream_ceiling_gbps`` measures the card's streaming ceiling (a
device-to-device copy of a buffer four times its L2 or more); the
streaming records carry their percentage of it on a card.
"""
