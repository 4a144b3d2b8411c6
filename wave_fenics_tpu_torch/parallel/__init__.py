"""The distributed structured box (port of ``wave_fenics_tpu.parallel``
without ``sharded_general``): ``partition``, ``halo``, ``sharded_wave``,
``sharded_padded`` and ``distributed``."""
