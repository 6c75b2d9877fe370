"""Training step: loss and gradients -> clip -> optimizer, with optional
microbatch gradient accumulation.

Port of ``repro.train.train_step``. The reference jits the step and
donates the parameters and the optimizer state; here the step runs
eagerly and the optimizer updates them in place, which is the donation:
the tensors passed in are the tensors returned, holding the new values.
Gradients come from ``torch.autograd.grad`` over the float32 leaves (a
view of each leaf that requires grad, so the leaves themselves stay plain
tensors); with ``grad_accum > 1`` the batch's rows are cut into
``grad_accum`` contiguous micro-batches, as the reference's reshape
``(grad_accum, B // grad_accum, ...)`` cuts them, and the losses and
gradients are summed, then scaled by ``1 / grad_accum``. Inside a
traced ``Trainer.train_step`` the step's two halves are the spans
``train.loss_grad`` (forward, backward and the remat recompute, which
runs on autograd's thread and opens no span of its own) and
``train.optim`` (the clip and the optimizer). ``watch_grads`` hands
each step's gradients, before the clip, to a check."""
from __future__ import annotations

from contextlib import contextmanager

import torch

from ..models import model as M
from ..models.model import leaves
from ..obs import tracing
from ..optim.optimizer import (
    clip_by_global_norm, cosine_schedule, make_optimizer,
)


def make_loss(cfg):
    def loss_fn(params, batch):
        return M.loss_fn(params, cfg, batch)

    return loss_fn


def value_and_grad(loss_fn, params, batch, grad_accum: int = 1):
    """(loss, grads): the mean loss over ``grad_accum`` micro-batches and
    its gradient, a list in ``leaves(params)`` order."""
    if grad_accum == 1:
        micro = [batch]
    else:
        micro = [{k: x.reshape((grad_accum, x.shape[0] // grad_accum)
                               + tuple(x.shape[1:]))[i]
                  for k, x in batch.items()} for i in range(grad_accum)]
    loss, grads = None, None
    with torch.enable_grad():
        for mb in micro:
            views = M.map_params(
                lambda p: p.detach().requires_grad_(True), params)
            lv = leaves(views)
            l_ = loss_fn(views, mb)
            g = torch.autograd.grad(l_, lv)
            l_ = l_.detach()
            if loss is None:
                loss, grads = l_, list(g)
            else:
                loss = loss + l_
                for a, b in zip(grads, g):
                    a.add_(b)
    if grad_accum > 1:
        inv = 1.0 / grad_accum
        loss = loss * inv
        for g in grads:
            g.mul_(inv)
    return loss, grads


_WATCH = None


@contextmanager
def watch_grads(fn):
    """Call ``fn(grads)`` in every step of the body with the step's
    gradients: float32, in ``leaves(params)`` order, before the clip
    scales them in place (``fn`` copies what it keeps). Off, the default,
    a step pays one test."""
    global _WATCH
    prev, _WATCH = _WATCH, fn
    try:
        yield fn
    finally:
        _WATCH = prev


def make_train_step(cfg, *, lr: float = 3e-4, warmup: int = 100,
                    total_steps: int = 10_000, grad_accum: int = 1,
                    max_grad_norm: float = 1.0):
    """Returns (init_fn, step_fn). step_fn: (params, opt, batch) ->
    (params, opt, metrics), metrics {"loss", "grad_norm", "lr"} as ()
    float32 tensors on the parameters' device (reading one waits for the
    step). ``params`` and ``opt``'s moments are updated in place."""
    lr_fn = cosine_schedule(lr, warmup, total_steps)
    opt_init, opt_step = make_optimizer(cfg.optimizer, lr_fn)
    loss_fn = make_loss(cfg)

    def step_fn(params, opt_state, batch):
        with tracing.span("train.loss_grad"):
            loss, grads = value_and_grad(loss_fn, params, batch, grad_accum)
        if _WATCH is not None:
            _WATCH(grads)
        with tracing.span("train.optim"):
            grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
            params, opt_state = opt_step(params, grads, opt_state)
        return params, opt_state, {
            "loss": loss,
            "grad_norm": gnorm,
            "lr": lr_fn(opt_state.step - 1),
        }

    return opt_init, step_fn
