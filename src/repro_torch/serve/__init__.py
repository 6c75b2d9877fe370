"""Serving layers of the port: ``engine.OTService`` (synchronous buckets),
``scheduler.AsyncOTScheduler`` (futures, a collate and a dispatch thread),
``ft`` (failure classes, the degradation ladder) and ``faults`` (the
chaos harness). Both services run on the CUDA device unless they are
given ``device="cpu"``."""
