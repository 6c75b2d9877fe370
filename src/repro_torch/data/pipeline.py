"""Deterministic, stateless-resumable synthetic data pipeline.

Port of ``repro.data.pipeline``. Every batch is a pure function of
(seed, step) - a restarted trainer resumes at step k and sees
byte-identical data with zero pipeline state in the checkpoint. The
tokens are the reference's, byte for byte (the same numpy generator and
seed). The reference stores frames and patches as bf16 numpy arrays
(``ml_dtypes``); here they are float32 arrays holding the same bf16
values (round to nearest even, as ``.to(torch.bfloat16)`` rounds), which
the model casts to its compute dtype exactly. A background prefetch
thread keeps ``depth`` batches ahead so host-side generation overlaps
device compute."""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np
import torch


def _bf16_values(a: np.ndarray) -> np.ndarray:
    """float32 array of ``a``'s values rounded to bf16."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def synthetic_batch(cfg, seq_len: int, batch: int, *, seed: int, step: int,
                    kind: str = "train") -> Dict[str, np.ndarray]:
    """Markov-ish token streams (so loss decreases measurably), plus stub
    modality embeddings where the architecture needs them."""
    rng = np.random.default_rng(np.uint64(seed) * np.uint64(1_000_003)
                                + np.uint64(step))
    n_tok = seq_len + 1 if kind == "train" else seq_len
    v = cfg.vocab_size
    # low-order Markov structure: next = (prev * a + noise) % v
    base = rng.integers(0, v, size=(batch, 1))
    steps = rng.integers(0, 17, size=(batch, n_tok))
    toks = (base + np.cumsum(steps, axis=1)) % v
    out: Dict[str, np.ndarray] = {"tokens": toks.astype(np.int32)}
    if cfg.input_mode == "frames":
        out["frames"] = _bf16_values(rng.standard_normal(
            (batch, seq_len, cfg.d_model), dtype=np.float32))
    if cfg.input_mode == "tokens+patches":
        out["patches"] = _bf16_values(rng.standard_normal(
            (batch, cfg.num_patch_tokens, cfg.d_model), dtype=np.float32))
        n = max(seq_len - cfg.num_patch_tokens, 8)
        out["tokens"] = out["tokens"][:, : n + 1 if kind == "train" else n]
    return out


class Prefetcher:
    """Background thread that stays `depth` steps ahead of the consumer."""

    def __init__(self, cfg, seq_len, batch, *, seed, start_step=0, depth=2,
                 kind="train"):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def worker():
            step = start_step
            while not self._stop.is_set():
                b = synthetic_batch(cfg, seq_len, batch, seed=seed,
                                    step=step, kind=kind)
                while not self._stop.is_set():
                    try:
                        self._q.put((step, b), timeout=0.2)
                        break
                    except queue.Full:
                        continue
                step += 1

        self._t = threading.Thread(target=worker, daemon=True)
        self._t.start()

    def __iter__(self) -> Iterator:
        while True:
            yield self._q.get()

    def close(self):
        self._stop.set()
