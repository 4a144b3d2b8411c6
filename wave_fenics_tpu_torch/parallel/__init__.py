"""The distributed box and imported meshes (port of
``wave_fenics_tpu.parallel``): ``partition``, ``halo``, ``sharded_wave``,
``sharded_padded``, ``sharded_general`` and ``distributed``."""
