"""Rule-based audit passes over recorded entry points.

Port of ``repro.analysis.rules``: the same three rules, with the same
names and finding keys, over the op log ``registry.trace_entry`` records
instead of a jaxpr. Each guards against a bug class the reference
shipped:

``donation-safety``
    The reference's ``init_ot_state`` once built ``free_b =
    s_int.astype(int32)``; the same-dtype cast is elided, so the state
    SHARED its buffer with the caller's rounded masses, and the donating
    chunk dispatch overwrote them under the epilogue. torch elides the
    same cast too: ``s_int.to(torch.int32)`` returns ``s_int`` itself and
    records no operation, so the rule compares the storages of a
    ``state-init-chain`` entry's outputs and inputs, not its recorded
    ops. It flags (a) a ``state.*`` output sharing storage with a
    ``retained`` input leaf or a ``retained*`` output, (b) a contract
    that both donates and retains an argument, and (c) a recorded
    in-place write into the storage of a retained, non-donated input.

``dtype-drift``
    The OT termination threshold computed ON THE DEVICE as ``f32(eps) *
    f32(total)`` rounds the wrong way for some (eps, total) pairs, e.g.
    eps = 0.1, total = 10 gives 1 in f32 and 0 in the host-float64
    contract. The rule flags int -> small float -> arithmetic -> int round
    trips in any entry, following tensor ids through the log (an
    arithmetic op with an integer input and a float output is torch's
    implicit conversion); for ``certificate`` entries also Python float
    scalars mixed into the arithmetic (a literal whose dtype follows the
    operand's) and float32 sums (reported, so that the accepted ones are
    explicit baseline entries). torch has no weakly typed tensors, so
    the reference's weak-output check has no counterpart.

``recompile-hazard``
    The reference recompiles a jitted program for every value of an
    operand baked in as a Python scalar. Eager torch has no compile
    cache, but the contract carries over: every ``must_trace`` operand
    is an argument of the entry, is a tensor (not a Python number), and
    some recorded op reads it. The dynamic half (no kernel built anew
    across a bucket descent, the same buckets for any eps) is
    ``cli.audit_bucket_ladder``.

The hot-loop sync audit is AST-based and lives in ``syncaudit.py``; lock
discipline in ``locks.py``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Set, Tuple

from .registry import OpRec, TracedEntry


@dataclass(frozen=True)
class Finding:
    rule: str
    entry: str
    detail: str          # stable discriminator (no line numbers)
    message: str

    @property
    def key(self) -> str:
        return f"{self.rule}:{self.entry}:{self.detail}"

    def __str__(self) -> str:
        return f"[{self.rule}] {self.entry}: {self.message}"


_SMALL_FLOATS = ("float16", "bfloat16", "float32")
_INTS = ("int8", "int16", "int32", "int64", "uint8", "uint16", "uint32",
         "uint64")


def _base(op: OpRec) -> str:
    """Schema name without the in-place suffix ("add_" -> "add")."""
    return op.base.rstrip("_")


# --------------------------------------------------------------------------
# Rule 1: donation safety
# --------------------------------------------------------------------------

def rule_donation_safety(entry: TracedEntry) -> List[Finding]:
    findings: List[Finding] = []

    # (b) contract level: a donated argument that host code reads
    # afterwards is read after the dispatch overwrote it
    for root in sorted(entry.donated & entry.retained):
        findings.append(Finding(
            rule="donation-safety", entry=entry.name,
            detail=f"donated-retained:{root}",
            message=(f"argument '{root}' is DONATED by the dispatch but "
                     "declared retained (read by host code afterwards): "
                     "the dispatch overwrites the buffer under the "
                     "reader"),
        ))

    retained_in: Dict[int, str] = {}
    kept: Dict[int, str] = {}      # retained and not donated
    for root in entry.retained:
        for i in entry.leaves_of(root, entry.in_names):
            leaf = entry.in_leaves[i]
            if leaf is not None and leaf.storage:
                retained_in[leaf.storage] = entry.in_names[i]
                if root not in entry.donated:
                    kept[leaf.storage] = entry.in_names[i]

    # (a) storage level: in a state-init chain, a 'state.*' output that
    # shares storage with a retained input or a 'retained*' output is
    # overwritten with it by the chunk dispatches
    if "state-init-chain" in entry.tags:
        outs = [(n, leaf) for n, leaf in zip(entry.out_names,
                                             entry.out_leaves)
                if leaf is not None and leaf.storage]
        retained_out = {leaf.storage for n, leaf in outs
                        if n.startswith("retained")}
        for n, leaf in outs:
            if not n.startswith("state"):
                continue
            if leaf.storage in retained_in:
                findings.append(Finding(
                    rule="donation-safety", entry=entry.name,
                    detail=f"alias:{n}",
                    message=(f"state output '{n}' shares storage with "
                             f"retained input '{retained_in[leaf.storage]}'"
                             " (a view or an elided same-dtype cast, no "
                             "copy): the chunk dispatches overwrite the "
                             "retained buffer - copy it, as init_ot_state "
                             "does with .to(torch.int32, copy=True)"),
                ))
            elif leaf.storage in retained_out:
                findings.append(Finding(
                    rule="donation-safety", entry=entry.name,
                    detail=f"alias:{n}",
                    message=(f"state output '{n}' shares storage with a "
                             "retained output of the same entry (a view or "
                             "an elided same-dtype cast, no copy): the "
                             "chunk dispatches overwrite the retained "
                             "buffer - copy it, as init_ot_state does with "
                             ".to(torch.int32, copy=True)"),
                ))

    # (c) a recorded in-place write into a retained, non-donated input
    seen: Set[str] = set()
    for op in entry.ops:
        for t in op.inputs:
            if t.id in op.writes and t.storage in kept and \
                    kept[t.storage] not in seen:
                leaf = kept[t.storage]
                seen.add(leaf)
                findings.append(Finding(
                    rule="donation-safety", entry=entry.name,
                    detail=f"inplace:{leaf}",
                    message=(f"'{op.name}' writes in place into the "
                             f"storage of retained input '{leaf}', which "
                             "host code reads after the dispatch and the "
                             "contract does not donate"),
                ))
    return findings


# --------------------------------------------------------------------------
# Rule 2: dtype drift
# --------------------------------------------------------------------------

# float arithmetic followed upstream from a float -> int conversion
_ARITH = {"mul", "add", "sub", "rsub", "div", "neg", "maximum", "minimum",
          "sum", "amax", "amin", "max", "min", "floor", "ceil", "round",
          "trunc", "clamp", "clamp_min", "clamp_max"}
# shape-only ops the walk passes through
_VIEWS = {"view", "_unsafe_view", "reshape", "unsqueeze", "squeeze",
          "expand", "slice", "select", "alias", "clone", "contiguous",
          "permute", "t", "transpose"}
# ops whose Python float operands are literals in the arithmetic
_LITERAL_OPS = _ARITH | {"where", "pow", "lerp", "masked_fill", "fill",
                         "addcmul", "addcdiv", "remainder", "fmod"}


def _producers(ops: Iterable[OpRec]) -> Dict[int, OpRec]:
    prod: Dict[int, OpRec] = {}
    for op in ops:
        for o in op.outputs:
            prod.setdefault(o.id, op)
    return prod


def _is_cast(op: OpRec) -> bool:
    """``Tensor.to(dtype)`` as it reaches the dispatcher (a same-dtype
    ``.to()`` records nothing at all)."""
    return op.base == "_to_copy" and len(op.inputs) == 1 and \
        len(op.outputs) == 1


def _f32_roundtrips(ops: Tuple[OpRec, ...]) -> Iterable[str]:
    """Descriptions of int -> small float arithmetic -> int round trips
    (the device threshold's shape)."""
    prod = _producers(ops)
    for op in ops:
        if not _is_cast(op):
            continue
        src, dst = op.inputs[0], op.outputs[0]
        if src.dtype not in _SMALL_FLOATS or dst.dtype not in _INTS:
            continue
        seen: Set[int] = set()
        frontier = [src.id]
        passed_arith = False
        for _ in range(8):
            nxt = []
            for tid in frontier:
                e = prod.get(tid)
                if e is None or id(e) in seen:
                    continue
                seen.add(id(e))
                b = _base(e)
                if _is_cast(e):
                    if e.inputs[0].dtype in _INTS and passed_arith:
                        yield (f"int -> {src.dtype} arithmetic -> "
                               f"{dst.dtype} round trip")
                        return
                    nxt.append(e.inputs[0].id)
                elif b in _ARITH:
                    passed_arith = True
                    if any(t.dtype in _INTS for t in e.inputs):
                        # an integer operand promoted by the op itself
                        yield (f"int -> {src.dtype} arithmetic -> "
                               f"{dst.dtype} round trip")
                        return
                    nxt.extend(t.id for t in e.inputs)
                elif b in _VIEWS:
                    nxt.extend(t.id for t in e.inputs)
            frontier = nxt
            if not frontier:
                break


def rule_dtype_drift(entry: TracedEntry) -> List[Finding]:
    findings: List[Finding] = []
    for desc in _f32_roundtrips(entry.ops):
        findings.append(Finding(
            rule="dtype-drift", entry=entry.name,
            detail="f32-int-roundtrip",
            message=(f"{desc}: device small-float arithmetic feeding an "
                     "integer (the termination-threshold shape) rounds "
                     "differently from the host-float64 contract for some "
                     "operand values - compute the threshold on the host "
                     "in float64 (ot_termination_threshold) and pass it "
                     "in as a tensor"),
        ))
        break   # one per entry is enough signal

    if "certificate" in entry.tags:
        # Python float literals follow the operand's dtype: a certificate
        # fed lower-precision operands would silently compute in it
        literal_of = {o.id for op in entry.ops
                      if op.base == "scalar_tensor"
                      and any(isinstance(s, float) for s in op.scalars)
                      for o in op.outputs}
        found = set()
        for op in entry.ops:
            if _base(op) not in _LITERAL_OPS:
                continue
            if any(isinstance(s, float) for s in op.scalars) or any(
                    t.id in literal_of for t in op.inputs):
                found.add(_base(op))
        for b in sorted(found):
            findings.append(Finding(
                rule="dtype-drift", entry=entry.name,
                detail=f"weak-literal:{b}",
                message=(f"Python float literal feeds '{b}' in a "
                         "certificate reduction: anchor its dtype (a "
                         "tensor of the operand's dtype, e.g. "
                         "c.new_zeros(())) so the arithmetic cannot drift "
                         "with the operand"),
            ))
        # f32 accumulation: the certificate contract is host-f64; device
        # f32 sums are accepted but must be explicit baseline entries
        if any(_base(op) in ("sum", "cumsum") and op.outputs
               and op.outputs[0].dtype in _SMALL_FLOATS
               for op in entry.ops):
            findings.append(Finding(
                rule="dtype-drift", entry=entry.name,
                detail="f32-accum",
                message=("certificate reduction accumulates in float32 on "
                         "the device (the host contract is float64): "
                         "acceptable only as an explicit baseline entry"),
            ))
    return findings


# --------------------------------------------------------------------------
# Rule 3: recompile hazard
# --------------------------------------------------------------------------

def rule_recompile_hazard(entry: TracedEntry) -> List[Finding]:
    findings: List[Finding] = []
    roots = set(entry.arg_roots)
    for name in sorted(entry.must_trace - roots):
        findings.append(Finding(
            rule="recompile-hazard", entry=entry.name,
            detail=f"baked:{name}",
            message=(f"must-trace operand '{name}' is not an argument of "
                     "the entry: it was captured as a constant, so the "
                     "entry cannot be told another value"),
        ))

    read: Set[int] = {t.id for op in entry.ops for t in op.inputs}
    for root in sorted(entry.must_trace & roots):
        idxs = entry.leaves_of(root, entry.in_names)
        leaves = [entry.in_leaves[i] for i in idxs]
        if any(leaf is None for leaf in leaves):
            findings.append(Finding(
                rule="recompile-hazard", entry=entry.name,
                detail=f"scalar:{root}",
                message=(f"must-trace operand '{root}' is a Python "
                         "number, not a tensor: it enters the arithmetic "
                         "as a literal (the reference's jitted programs "
                         "recompile for every value) - pass it as a "
                         "tensor"),
            ))
        elif leaves and not any(leaf.id in read for leaf in leaves):
            findings.append(Finding(
                rule="recompile-hazard", entry=entry.name,
                detail=f"unused:{root}",
                message=(f"must-trace operand '{root}' reaches the entry "
                         "but no recorded operation reads it - the value "
                         "most likely comes from a constant elsewhere"),
            ))
    return findings


RULES = (rule_donation_safety, rule_dtype_drift, rule_recompile_hazard)


def audit_entry(entry: TracedEntry) -> List[Finding]:
    out: List[Finding] = []
    for rule in RULES:
        out.extend(rule(entry))
    return out


def audit_entries(entries: Iterable[TracedEntry]
                  ) -> Tuple[List[Finding], int]:
    findings: List[Finding] = []
    n = 0
    for e in entries:
        n += 1
        findings.extend(audit_entry(e))
    return findings, n
