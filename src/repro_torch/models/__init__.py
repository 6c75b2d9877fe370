"""The model stack of the port: ``layers``, ``attention``, ``moe`` (the
three routers; ``pushrelabel`` runs the ``fused_ot_phases`` kernel on the
card), ``mamba``, ``transformer`` (stages of layers, remat), ``model``
(parameters, the training loss, prefill, decode, the abstract specs),
``sharding`` (logical axes, parameter specs, placement on a mesh; the
MoE layer's expert-parallel branch reads its mesh) and ``weights``
(parameters carried from and to the JAX reference as numpy arrays).

Parameters are nested dicts of tensors, as the reference's pytrees are,
except that a stage holds one dict per period instead of arrays stacked
along a leading period axis: the port runs a Python loop over layers
where the reference scans."""
