"""PyTorch/CUDA port of wave_fenics_tpu: the matrix-free spectral-element
wave solver on an NVIDIA H100.

The JAX package ``wave_fenics_tpu`` is the reference; this package imports
``torch`` and ``numpy`` and never JAX. Each TPU (Pallas) kernel on the
ported path has a hand-written CUDA counterpart under ``csrc/``, built with
``nvcc`` at first use, and a plain torch version beside it in the same
module: CPU tensors run the plain version, CUDA tensors the kernel.
"""
