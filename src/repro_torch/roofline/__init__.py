"""Roofline accounting of the port: ``analysis`` (the three terms of a
dry-run plan, the collectives' ring model, model FLOPs), ``plan`` (the
recorder of a step's bytes, FLOPs and custom calls) and ``aggregate``
(the dry-run and roofline tables)."""
