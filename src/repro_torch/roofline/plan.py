"""Recording a step's per-device plan: live bytes, op bytes, FLOPs and
custom calls.

The reference reads these from XLA's compiled module (``memory_analysis``,
``cost_analysis``). The port has no compiled module; :func:`record` runs
the step once under ``FakeTensorMode`` (the caller's), which allocates
nothing, and a :class:`PlanRecorder`, which counts

- the FLOPs of every aten op that ``FlopCounterMode`` counts (matmuls,
  convolutions, attention), by its registry, the backward included;
- every op's input and output bytes (views move none): an unfused upper
  bound of the HBM traffic;
- the peak of the live bytes of the storages the step creates, each
  added when an op returns a new storage and subtracted when that
  storage is freed (the arguments' storages are not counted);
- the producer of each storage, so a caller can tell which outputs were
  rebuilt by which op.

A kernel launch has no aten op (the port's CUDA wrappers call through
``ctypes``), so the code that would launch one calls
:func:`record_custom_call` when its input is fake: the plan keeps the
call, as XLA's cost analysis keeps a custom call it cannot cost.
"""
from __future__ import annotations

import weakref
from typing import Any, Dict, Iterable, List

import torch
from torch.utils._python_dispatch import (
    TorchDispatchMode, _get_current_dispatch_mode_stack,
)
from torch.utils.flop_counter import flop_registry


def nbytes(t: torch.Tensor) -> int:
    """The tensor's logical bytes (elements x item size)."""
    return t.numel() * t.element_size()


def _tensors(xs) -> List[torch.Tensor]:
    """The tensors of ``xs``, lists and tuples in it searched."""
    out: List[torch.Tensor] = []
    for x in xs:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out += _tensors(x)
    return out


def _key(t: torch.Tensor) -> int:
    """The identity of a tensor's storage while the storage lives."""
    return t.untyped_storage()._cdata


class PlanRecorder(TorchDispatchMode):
    """Bytes of a step's ops and the peak of its live storages.

    ``known``: tensors that exist before the step (its arguments); their
    storages are never counted as new. After the step: ``op_bytes``,
    ``peak`` (bytes), ``ops`` (aten ops that moved bytes), ``custom_calls``
    (dicts) and ``producer`` (storage key -> aten op name)."""

    def __init__(self, known: Iterable[torch.Tensor] = ()):
        super().__init__()
        self.flops = 0
        self.op_bytes = 0
        self.ops = 0
        self.live = 0
        self.peak = 0
        self.custom_calls: List[Dict[str, Any]] = []
        self.producer: Dict[int, str] = {}
        self._sizes: Dict[int, int] = {}
        self._known = {_key(t) for t in known}

    def _freed(self, key: int) -> None:
        self.live -= self._sizes.pop(key)
        self.producer.pop(key, None)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors(out if isinstance(out, (list, tuple)) else (out,))
        if not outs:                        # a metadata query
            return out
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        if func.is_view:
            return out
        ins = _tensors(args) + _tensors(kwargs.values())
        self.ops += 1
        self.op_bytes += sum(map(nbytes, ins)) + sum(map(nbytes, outs))
        in_keys = None
        for o in outs:
            k = _key(o)
            if k in self._sizes or k in self._known:
                continue
            if in_keys is None:
                in_keys = {_key(t) for t in ins}
            if k in in_keys:                # an output that is an input
                continue
            storage = o.untyped_storage()
            self._sizes[k] = storage.nbytes()
            self.producer[k] = func._schema.name.split("::")[-1]
            self.live += self._sizes[k]
            fin = weakref.finalize(storage, self._freed, k)
            fin.atexit = False
        self.peak = max(self.peak, self.live)
        return out


def record_custom_call(name: str, **info) -> None:
    """Keep a kernel launch that a fake input stood in for, in the
    innermost :class:`PlanRecorder` that is recording (none: nothing)."""
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, PlanRecorder):
            mode.custom_calls.append({"name": name, **info})
            return


def record(fn, known: Iterable[torch.Tensor]):
    """Run ``fn()`` (inside the caller's ``FakeTensorMode``) under a
    :class:`PlanRecorder`; returns ``(out, counts,
    recorder)`` with ``counts`` {"flops", "bytes", "temp_bytes", "ops"}."""
    with PlanRecorder(known) as rec:
        out = fn()
    counts = {"flops": int(rec.flops), "bytes": rec.op_bytes,
              "temp_bytes": rec.peak, "ops": rec.ops}
    return out, counts, rec
