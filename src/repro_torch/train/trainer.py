"""Fault-tolerant training loop.

Port of ``repro.train.trainer``:

- checkpoint/restart: atomic CRC-verified checkpoints every `ckpt_every`
  steps (async write); on start, resumes from the newest valid checkpoint -
  a SIGKILL mid-run loses at most `ckpt_every` steps and never corrupts
  state.
- deterministic data: batches are a pure function of (seed, step); resume
  replays the exact stream (see data/pipeline.py).
- straggler watchdog: per-step wall-time EWMA; steps slower than
  `straggler_factor` x EWMA are counted and logged (at fleet scale this is
  the signal used to evict/replace a slow host; here it feeds metrics).

- elastic restore: pass ``shardings`` (a tree of ``NamedSharding``, as
  ``models.sharding.param_shardings`` builds it on the *current* mesh) -
  the checkpoint stores full logical tensors, so a resume goes through
  ``checkpoint.restore(..., shardings=)`` onto any mesh whose blocks
  divide the shapes.

The parameters are drawn by ``init_params(cfg, seed=seed, device=...)``
and live on ``device`` (the card unless ``device="cpu"``). The port does
not execute FSDP or tensor parallelism of the dense layers (the
reference only compiles them for its dry-run): a leaf restored by its
sharding comes back as a ``ShardedTensor`` and is assembled on
``device`` (``ShardedTensor.full``), the step trains on full leaves, and
checkpoints keep full logical tensors. AdamW's moments are placed by
their parameters' shardings too; Adafactor's factored moments are
restored whole. Under ``sharding.set_mesh`` the MoE layers run expert
parallel with no change to this loop.
"""
from __future__ import annotations

import json
import os
import time
from contextlib import nullcontext
from typing import Any, Optional

import torch

from ..checkpoint import checkpointing as ckpt
from ..core.device import resolve_device
from ..data.pipeline import synthetic_batch
from ..models import model as M
from ..models import moe
from ..models.sharding import ShardedTensor
from ..obs import tracing
from .train_step import make_train_step


class Trainer:
    def __init__(self, cfg, workdir: str, *, seq_len: int = 128,
                 batch_size: int = 8, lr: float = 3e-4, seed: int = 0,
                 ckpt_every: int = 20, grad_accum: int = 1,
                 total_steps: int = 10_000, warmup: int = 100,
                 device=None, shardings: Any = None,
                 straggler_factor: float = 3.0):
        self.cfg = cfg
        self.workdir = workdir
        self.seq_len = seq_len
        self.batch_size = batch_size
        self.grad_accum = grad_accum
        self.seed = seed
        self.ckpt_every = ckpt_every
        self.device = resolve_device(device)
        self.shardings = shardings
        self.straggler_factor = straggler_factor
        self.metrics_log = os.path.join(workdir, "metrics.jsonl")
        os.makedirs(workdir, exist_ok=True)

        opt_init, self.step_fn = make_train_step(
            cfg, lr=lr, grad_accum=grad_accum, total_steps=total_steps,
            warmup=warmup,
        )
        params = M.init_params(cfg, seed=seed, device=self.device)
        opt_state = opt_init(params)
        start = ckpt.latest_step(os.path.join(workdir, "ckpt"))
        if start is None:
            self.step = 0
        else:
            like = {"params": params, "opt": opt_state}
            restored = ckpt.restore(os.path.join(workdir, "ckpt"), start,
                                    like, shardings=self._restore_shardings(
                                        opt_state))
            params = M.map_params(self._full, restored["params"])
            opt = restored["opt"]
            opt_state = opt._replace(m=M.map_params(self._full, opt.m),
                                     v=M.map_params(self._full, opt.v))
            self.step = start
        self.params = params
        self.opt_state = opt_state
        self._ewma: Optional[float] = None
        self.straggler_events = 0
        self._pending_save = None

    def _restore_shardings(self, opt_state):
        """``shardings`` along the checkpoint's tree: the parameters' and
        AdamW's moments'; None elsewhere."""
        if self.shardings is None:
            return None
        moments = self.shardings if self.cfg.optimizer == "adamw" else None
        return {"params": self.shardings,
                "opt": opt_state._replace(step=None, m=moments if
                                          opt_state.m is not None else None,
                                          v=moments, comp_err=None)}

    def _full(self, leaf):
        """A restored leaf as a full tensor on the trainer's device."""
        if isinstance(leaf, ShardedTensor):
            return leaf.full(self.device)
        return leaf

    def _checkpoint(self):
        if self._pending_save is not None:
            self._pending_save.join()
        self._pending_save = ckpt.save(
            os.path.join(self.workdir, "ckpt"), self.step,
            {"params": self.params, "opt": self.opt_state}, async_=True,
        )

    def train_step(self):
        """One iteration of ``run()``'s loop, without its checkpoint: the
        step's batch, the step, the loss read (the step's one wait for the
        card), the straggler EWMA and the metrics log line. Returns that
        line's record. While the tracer records (``obs.tracing``), the
        step is the root span ``train.step`` (children
        ``train.loss_grad`` and ``train.optim``, and within the forward
        ``attn.mla`` and ``moe.route``), and its counts are the MoE
        layers': ``moe.router.launches``, ``moe.router.units``,
        ``moe.router.unmatched`` and ``moe.dispatch.dropped``, summed on
        the card and read with the loss, so they add no wait."""
        with tracing.root("train.step") as sp:
            hook = moe.RouterTap() if sp is not None else None
            batch_np = synthetic_batch(
                self.cfg, self.seq_len, self.batch_size,
                seed=self.seed, step=self.step,
            )
            batch = {k: torch.as_tensor(v, device=self.device)
                     for k, v in batch_np.items()}
            t0 = time.perf_counter()
            with moe.tap(hook) if hook is not None else nullcontext():
                self.params, self.opt_state, metrics = self.step_fn(
                    self.params, self.opt_state, batch
                )
            counts = hook.device_counts() if hook is not None else None
            if counts is None:
                loss = float(metrics["loss"])  # sync point
            else:
                read = torch.cat([metrics["loss"].double()[None],
                                  counts]).tolist()  # sync point
                loss = read[0]
                for key, n in (("moe.router.launches", hook.launches),
                               ("moe.router.units", hook.units),
                               ("moe.router.unmatched", read[1]),
                               ("moe.dispatch.dropped", read[2])):
                    tracing.add(key, n)
            dt = time.perf_counter() - t0
            if self._ewma is None:
                self._ewma = dt
            else:
                if dt > self.straggler_factor * self._ewma:
                    self.straggler_events += 1
                self._ewma = 0.9 * self._ewma + 0.1 * dt
            self.step += 1
            rec = {"step": self.step, "loss": loss, "time_s": dt,
                   "grad_norm": float(metrics["grad_norm"]),
                   "stragglers": self.straggler_events}
            with open(self.metrics_log, "a") as f:
                f.write(json.dumps(rec) + "\n")
        return rec

    def run(self, num_steps: int):
        history = []
        for _ in range(num_steps):
            history.append(self.train_step())
            if self.step % self.ckpt_every == 0:
                self._checkpoint()
        self._checkpoint()
        if self._pending_save is not None:
            self._pending_save.join()
            self._pending_save = None
        return history
