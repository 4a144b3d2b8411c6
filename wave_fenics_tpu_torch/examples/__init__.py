"""Runnable examples of the port (``python -m wave_fenics_tpu_torch.examples.<name>``)."""
