"""models layer of the PyTorch/CUDA port (see wave_fenics_tpu.models)."""
