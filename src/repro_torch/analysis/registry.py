"""Entry-point registry for the static audit.

Port of ``repro.analysis.registry``. Solver modules register every entry
point the drivers dispatch (stepped cores, the compacting driver's chunk
and converged-mask functions, the mesh chunk, the kernel wrappers, the
certificate and admission reductions) by calling :func:`register` when
they are imported, with a *lazy builder*: a function of no arguments that
records the entry on tiny CPU operands and returns a :class:`TracedEntry`.
Nothing is built until the CLI (or a test) asks, so registering costs
nothing at import.

The reference traces each entry to a jaxpr. Eager torch has no program to
trace: :func:`trace_entry` runs the entry once on the CPU under a
recording ``TorchDispatchMode`` and keeps the log of the aten operations
it ran (:class:`OpRec`), with, for every tensor in and out, its dtype,
shape, an id stable within the log and the address of its storage. Views
share a storage, so the storage address is what tells two tensors that
share memory apart from two that do not. The CUDA kernels launch through
``ctypes``, which no dispatch mode sees; on the CPU the ``kernels.ops``
wrappers run their plain versions, and those are what the log holds.

The registry records, per entry, the contracts the log alone cannot
express:

  * ``donated``    argument roots the dispatch may overwrite (the chunk
                   functions return a new state; the reference donates
                   the old one's buffers);
  * ``retained``   argument roots host code still reads AFTER the
                   dispatch (the donation-safety rule holds the two
                   apart);
  * ``must_trace`` operands that must reach the entry as tensors, never
                   as Python numbers (eps, thresholds, tolerances);
  * ``tags``       rule-selection labels ("state-init-chain",
                   "certificate", ...).

This module must not import ``repro_torch.core`` (core modules import it
to register themselves).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, FrozenSet, Iterable, List, Optional, Tuple

# Modules that register entry points when imported. ``load_all`` imports
# them, so the registry holds every entry whatever the caller imported
# first.
BUILTIN_MODULES: Tuple[str, ...] = (
    "repro_torch.core.pushrelabel",
    "repro_torch.core.transport",
    "repro_torch.core.problem",
    "repro_torch.core.compaction",
    "repro_torch.core.distributed",
    "repro_torch.core.solution",
    "repro_torch.core.validate",
    "repro_torch.kernels.ops",
    "repro_torch.core.sinkhorn",
    "repro_torch.portfolio.sinkhorn_spec",
    "repro_torch.portfolio.hybrid",
)


@dataclass(frozen=True)
class TensorRec:
    """One tensor seen by the recorder: ``id`` is stable within one log
    (the same tensor object always gets the same id), ``storage`` is
    ``untyped_storage().data_ptr()`` (0 for a tensor without elements)."""
    id: int
    dtype: str                      # "float32", "int32", "bool", ...
    shape: Tuple[int, ...]
    storage: int


@dataclass(frozen=True)
class OpRec:
    """One recorded aten operation. ``scalars`` holds the Python numbers
    among its arguments; ``writes`` the ids of the input tensors its
    schema marks as written (in-place ops and ``out=`` arguments)."""
    name: str                       # overload, e.g. "aten.mul.Tensor"
    base: str                       # schema name, e.g. "mul", "add_"
    inputs: Tuple[TensorRec, ...]
    outputs: Tuple[TensorRec, ...]
    scalars: Tuple[Any, ...] = ()
    writes: Tuple[int, ...] = ()


@dataclass(frozen=True)
class TracedEntry:
    """One audited entry point, recorded as an op log.

    ``in_names``/``in_leaves`` and ``out_names``/``out_leaves`` are the
    flat leaves of the arguments and of the result (``state.free_b``,
    ``ops['c']``, ...); a leaf that is not a tensor has ``None``. The
    contract sets hold argument ROOT names and match leaf names by
    prefix."""
    name: str
    ops: Tuple[OpRec, ...]
    in_names: Tuple[str, ...]
    in_leaves: Tuple[Optional[TensorRec], ...]
    out_names: Tuple[str, ...]
    out_leaves: Tuple[Optional[TensorRec], ...]
    arg_roots: Tuple[str, ...]
    donated: FrozenSet[str] = frozenset()
    retained: FrozenSet[str] = frozenset()
    must_trace: FrozenSet[str] = frozenset()
    tags: FrozenSet[str] = frozenset()
    source: str = ""

    def leaves_of(self, root: str, names: Iterable[str]) -> List[int]:
        """Indices in ``names`` of the leaves belonging to arg ``root``."""
        out = []
        for i, n in enumerate(names):
            if n == root or n.startswith(root + ".") or \
                    n.startswith(root + "["):
                out.append(i)
        return out


@dataclass(frozen=True)
class EntrySpec:
    name: str
    build: Callable[[], TracedEntry]
    source: str = ""


_REGISTRY: Dict[str, EntrySpec] = {}
_LOADED = False


def register(name: str, build: Callable[[], TracedEntry],
             source: str = "") -> None:
    """Register (or re-register) a lazy entry builder under ``name``."""
    _REGISTRY[name] = EntrySpec(name=name, build=build, source=source)


def load_all() -> None:
    """Import every builtin registering module exactly once."""
    global _LOADED
    if _LOADED:
        return
    import importlib

    for mod in BUILTIN_MODULES:
        importlib.import_module(mod)
    _LOADED = True


def entry_specs() -> List[EntrySpec]:
    load_all()
    return [spec for _, spec in sorted(_REGISTRY.items())]


def build_entries() -> List[TracedEntry]:
    """Record every registered entry (the expensive step; CLI/test only)."""
    return [spec.build() for spec in entry_specs()]


# --------------------------------------------------------------------------
# Recording
# --------------------------------------------------------------------------

def _leaf_names(root: str, val: Any) -> List[str]:
    """Flat leaf names for one argument (dict keys sorted; NamedTuple
    fields by position, named), as the reference names jax's leaves."""
    return [n for n, _ in _leaves(root, val)]


def _leaves(root: str, val: Any) -> List[Tuple[str, Any]]:
    if isinstance(val, tuple) and hasattr(val, "_fields"):
        out: List[Tuple[str, Any]] = []
        for f, v in zip(val._fields, val):
            out += _leaves(f"{root}.{f}", v)
        return out
    if isinstance(val, dict):
        out = []
        for k in sorted(val):
            out += _leaves(f"{root}[{k!r}]", val[k])
        return out
    if isinstance(val, (tuple, list)):
        out = []
        for i, v in enumerate(val):
            out += _leaves(f"{root}[{i}]", v)
        return out
    return [(root, val)]


def _recorder():
    """A fresh recording dispatch mode (torch imported here, not when the
    registry is imported)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    class Recorder(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops: List[OpRec] = []
            self._ids: Dict[int, int] = {}
            # every tensor seen stays alive for the recording, so neither
            # its Python id nor its storage address can be reused
            self._keep: List[Any] = []

        def rec(self, t) -> TensorRec:
            key = id(t)
            if key not in self._ids:
                self._ids[key] = len(self._ids)
                self._keep.append(t)
            storage = t.untyped_storage().data_ptr() if t.numel() else 0
            return TensorRec(id=self._ids[key],
                             dtype=str(t.dtype).replace("torch.", ""),
                             shape=tuple(t.shape), storage=storage)

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            flat_in, _ = tree_flatten((args, kwargs))
            written = []
            for i, a in enumerate(func._schema.arguments):
                if a.alias_info is None or not a.alias_info.is_write:
                    continue
                v = args[i] if i < len(args) else kwargs.get(a.name)
                vs = v if isinstance(v, (list, tuple)) else (v,)
                written += [x for x in vs if isinstance(x, torch.Tensor)]
            self.ops.append(OpRec(
                name=str(func),
                base=func._schema.name.split("::")[-1],
                inputs=tuple(self.rec(a) for a in flat_in
                             if isinstance(a, torch.Tensor)),
                outputs=tuple(self.rec(o) for o in tree_flatten(out)[0]
                              if isinstance(o, torch.Tensor)),
                scalars=tuple(a for a in flat_in
                              if isinstance(a, (int, float))
                              and not isinstance(a, bool)),
                writes=tuple(self.rec(t).id for t in written)))
            return out

    return Recorder()


def trace_entry(
    name: str,
    fn: Callable,
    args: Dict[str, Any],
    *,
    donated: Iterable[str] = (),
    retained: Iterable[str] = (),
    must_trace: Iterable[str] = (),
    tags: Iterable[str] = (),
    source: str = "",
) -> TracedEntry:
    """Run ``fn(*args.values())`` once on the CPU under the recorder and
    wrap its op log as a :class:`TracedEntry`. ``args`` is an ORDERED
    name -> value mapping (its order is the positional order); tensor
    leaves must lie on the CPU. Output leaf names come from the result's
    own structure: a dict result names leaves by its keys, so chain
    builders returning ``{"state": ..., "retained": ...}`` get
    ``state.*`` / ``retained[...]`` names the rules can group on."""
    import torch

    in_pairs: List[Tuple[str, Any]] = []
    for root, val in args.items():
        in_pairs += _leaves(root, val)
    for n, v in in_pairs:
        if isinstance(v, torch.Tensor) and v.device.type != "cpu":
            raise ValueError(f"{name}: argument leaf {n} is on {v.device}; "
                             "entries are recorded on the CPU")
    rec = _recorder()
    in_leaves = tuple(rec.rec(v) if isinstance(v, torch.Tensor) else None
                      for _, v in in_pairs)
    with torch.no_grad(), rec:
        out = fn(*args.values())
    if isinstance(out, dict):
        out_pairs = sum((_leaves(k, out[k]) for k in sorted(out)), [])
    else:
        out_pairs = _leaves("out", out)
    out_leaves = tuple(rec.rec(v) if isinstance(v, torch.Tensor) else None
                       for _, v in out_pairs)
    return TracedEntry(
        name=name,
        ops=tuple(rec.ops),
        in_names=tuple(n for n, _ in in_pairs),
        in_leaves=in_leaves,
        out_names=tuple(n for n, _ in out_pairs),
        out_leaves=out_leaves,
        arg_roots=tuple(args.keys()),
        donated=frozenset(donated),
        retained=frozenset(retained),
        must_trace=frozenset(must_trace),
        tags=frozenset(tags),
        source=source,
    )
