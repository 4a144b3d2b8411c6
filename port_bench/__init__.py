"""The benchmark of ``wave_fenics_tpu_torch`` on NVIDIA GPUs.

``python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` (``run.py``). What
belongs to one configuration, traffic mix or metric sits in a file of its
own, found by its name (``harness.py``). This package imports nothing
when imported: the references under ``reference/`` import neither the
port nor JAX.
"""
