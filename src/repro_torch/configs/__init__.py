"""Architecture and shape configurations of the port: a copy of
``repro.configs`` (plain data, the same names, fields, ``SHAPES``,
``SMOKE_SHAPES``, ``shape_applicable`` and ``reduced()``), kept here so
the port imports nothing of the JAX package. ``registry.ARCHS`` maps an
architecture's name to its ``ArchConfig``."""
