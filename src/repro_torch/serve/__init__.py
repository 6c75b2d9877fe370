"""Serving layers of the port: ``engine.Engine`` (prefill and lockstep
decode of a language model, ``models/``), ``engine.OTService``
(synchronous OT buckets), ``scheduler.AsyncOTScheduler`` (futures, a
collate and a dispatch thread), ``ft`` (failure classes, the degradation
ladder) and ``faults`` (the chaos harness). All run on the CUDA device
unless they are given ``device="cpu"``."""
