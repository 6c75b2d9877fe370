"""The port's static-audit layer (``repro_torch.analysis``), the
counterpart of ``tests/test_analysis.py``.

The centerpiece fixtures RE-INTRODUCE the reference's two historical bug
classes in tiny throwaway torch functions and assert the analyzer flags
them, over the op log the recorder keeps in place of a jaxpr:

  * ``init_ot_state`` sharing ``s_int``'s buffer with the solver state
    (``s_int.to(torch.int32)`` returns ``s_int`` itself and records no
    op), so the chunks overwrite the retained masses (donation-safety);
  * the OT termination threshold computed in on-device f32 (int -> f32
    arithmetic -> int), rounding differently from the host-f64 contract
    (dtype-drift).
"""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.analysis import registry as jregistry
from repro_torch.analysis import registry
from repro_torch.analysis.baseline import (
    DEFAULT_BASELINE,
    apply_baseline,
    load_baseline,
)
from repro_torch.analysis.rules import Finding, audit_entry
from repro_torch.analysis.syncaudit import audit_function_source
from repro_torch.core.transport import OTState, init_ot_state, ot_prologue

ROOT = Path(__file__).resolve().parents[1]
# entries of the reference the port cannot have (none today)
NOT_PORTED: set = set()


def _keys(findings):
    return {f.key for f in findings}


# --------------------------------------------------------------------------
# The recorder
# --------------------------------------------------------------------------

def test_recorder_logs_ops_storage_and_the_elided_cast():
    def fn(x, i):
        v = x[:2]                 # a view: same storage, new tensor
        same = i.to(torch.int32)  # same dtype: returns i, records nothing
        return {"v": v, "same": same, "y": x * 2.0}

    e = registry.trace_entry(
        name="fixture.recorder", fn=fn,
        args={"x": torch.ones(4), "i": torch.ones(3, dtype=torch.int32)})
    assert [op.base for op in e.ops] == ["slice", "mul"]
    x, i = e.in_leaves
    out = dict(zip(e.out_names, e.out_leaves))
    assert out["v"].storage == x.storage and out["v"].id != x.id
    assert out["same"].id == i.id
    assert out["y"].storage != x.storage
    mul = e.ops[1]
    assert mul.inputs[0].id == x.id and mul.scalars == (2.0,)
    assert (mul.outputs[0].dtype, mul.outputs[0].shape) == ("float32", (4,))


def test_recorder_marks_in_place_writes():
    def fn(x):
        y = x.clone()
        y.add_(1)
        return y

    e = registry.trace_entry(name="fixture.inplace", fn=fn,
                             args={"x": torch.zeros(3)})
    add = next(op for op in e.ops if op.base == "add_")
    assert add.writes == (add.inputs[0].id,)
    assert all(not op.writes for op in e.ops if op is not add)


def test_entries_are_recorded_on_the_cpu_only():
    if not torch.cuda.is_available():
        x = torch.zeros(2, device="meta")
    else:
        x = torch.zeros(2, device="cuda")
    with pytest.raises(ValueError, match="recorded on the CPU"):
        registry.trace_entry(name="fixture.off_cpu", fn=lambda x: x * 2,
                             args={"x": x})


# --------------------------------------------------------------------------
# Seeded regression fixture 1: the shared-buffer state init
# --------------------------------------------------------------------------

def _ot_chain(init):
    """prologue -> ``init`` chain of one OT instance, its rounded masses
    retained for the epilogue."""

    def chain(c, nu, mu, theta, eps):
        c_int, s_int, d_int, _ = ot_prologue(c, nu, mu, theta, eps)
        return {"state": init(s_int, d_int),
                "retained": {"c_int": c_int, "s_int": s_int,
                             "d_int": d_int}}

    args = {"c": torch.zeros((1, 4, 4)),
            "nu": torch.full((1, 4), 0.25), "mu": torch.full((1, 4), 0.25),
            "theta": torch.tensor([64.0]), "eps": torch.tensor([0.25])}
    return chain, args


def _init_ot_state_without_copy(s_int, d_int):
    """init_ot_state as the reference once shipped it: the free masses ARE
    the retained rounded masses (no copy)."""
    b, nb = s_int.shape
    na = d_int.shape[1]

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.int32)
    return OTState(
        y_b=torch.ones((b, nb), dtype=torch.int32), ya_hi=zeros(b, na),
        free_b=s_int.to(torch.int32),      # BUG (seeded): no copy=True
        free_a=d_int.to(torch.int32),      # BUG (seeded): no copy=True
        f_hi=zeros(b, nb, na), f_lo=zeros(b, nb, na), phases=zeros(b),
        rounds=zeros(b))


def test_seeded_donation_alias_flagged():
    chain, args = _ot_chain(_init_ot_state_without_copy)
    e = registry.trace_entry(
        name="fixture.buggy_ot_chain", fn=chain, args=args,
        retained={"c", "nu", "mu"}, tags={"state-init-chain"})
    keys = _keys(audit_entry(e))
    assert "donation-safety:fixture.buggy_ot_chain:alias:state.free_b" \
        in keys, keys
    assert "donation-safety:fixture.buggy_ot_chain:alias:state.free_a" \
        in keys, keys


def test_fixed_donation_chain_clean():
    chain, args = _ot_chain(init_ot_state)
    e = registry.trace_entry(
        name="fixture.fixed_ot_chain", fn=chain, args=args,
        retained={"c", "nu", "mu"}, tags={"state-init-chain"})
    assert not any(f.rule == "donation-safety" for f in audit_entry(e))


def test_state_sharing_a_retained_input_flagged():
    e = registry.trace_entry(
        name="fixture.view_of_input",
        fn=lambda y0: {"state": {"y_b": y0[:, :]}, "retained": {}},
        args={"y0": torch.ones((1, 4), dtype=torch.int32)},
        retained={"y0"}, tags={"state-init-chain"})
    assert "donation-safety:fixture.view_of_input:alias:state['y_b']" in \
        _keys(audit_entry(e))


def test_donated_and_retained_root_flagged():
    entry = registry.trace_entry(
        name="fixture.donated_retained",
        fn=lambda x: x * 2,
        args={"x": torch.zeros(4)},
        donated={"x"}, retained={"x"})
    keys = _keys(audit_entry(entry))
    assert "donation-safety:fixture.donated_retained:donated-retained:x" \
        in keys


def test_in_place_write_into_retained_input_flagged():
    def fn(x):
        x.mul_(2)
        return x

    keys = _keys(audit_entry(registry.trace_entry(
        name="fixture.writes_retained", fn=fn, args={"x": torch.ones(4)},
        retained={"x"})))
    assert "donation-safety:fixture.writes_retained:inplace:x" in keys
    # a donated argument may be overwritten
    keys = _keys(audit_entry(registry.trace_entry(
        name="fixture.writes_donated", fn=fn, args={"x": torch.ones(4)},
        donated={"x"})))
    assert not any(k.startswith("donation-safety") for k in keys), keys


# --------------------------------------------------------------------------
# Seeded regression fixture 2: the on-device f32 threshold
# --------------------------------------------------------------------------

def _buggy_threshold(implicit: bool):
    """The OT termination threshold computed on the device from integer
    operands through f32 arithmetic, then floored back to int32."""

    def threshold(d_int):
        m = d_int.sum(dtype=torch.int32)
        eps = torch.tensor(0.12, dtype=torch.float32)
        # BUG (seeded): int -> f32 arithmetic -> int round trip, the cast
        # explicit or left to torch's type promotion
        t = eps * m if implicit else eps * m.to(torch.float32)
        return torch.floor(t).to(torch.int32)

    return registry.trace_entry(
        name="fixture.buggy_threshold", fn=threshold,
        args={"d_int": torch.ones((8,), dtype=torch.int32)})


@pytest.mark.parametrize("implicit", [False, True])
def test_seeded_f32_roundtrip_flagged(implicit):
    keys = _keys(audit_entry(_buggy_threshold(implicit)))
    assert "dtype-drift:fixture.buggy_threshold:f32-int-roundtrip" in keys


def test_fixed_threshold_clean():
    """Threshold passed in as a tensor (computed on the host in f64)."""
    e = registry.trace_entry(
        name="fixture.fixed_threshold",
        fn=lambda d_int, t: torch.minimum(t, d_int.sum(dtype=torch.int32)),
        args={"d_int": torch.ones((8,), dtype=torch.int32),
              "t": torch.tensor(3, dtype=torch.int32)},
        must_trace={"t"})
    assert not any(f.rule == "dtype-drift" for f in audit_entry(e))


def test_pure_float_rounding_not_flagged():
    """floor(c / eps).to(int32) is the rounding prologue's legitimate
    pattern: float arithmetic floored to int, with no int origin."""
    e = registry.trace_entry(
        name="fixture.rounding",
        fn=lambda c: torch.floor(c / 0.25).to(torch.int32),
        args={"c": torch.zeros((4, 4))})
    assert not any("f32-int-roundtrip" in f.key for f in audit_entry(e))


def test_certificate_literal_and_f32_sum_flagged():
    def weak(c):
        return torch.where(c > 0, c, 0.0).sum(dim=1)

    def anchored(c):
        return torch.where(c > 0, c, c.new_zeros(())).amax(dim=1)

    keys = _keys(audit_entry(registry.trace_entry(
        name="fixture.weak", fn=weak, args={"c": torch.ones((2, 4))},
        tags={"certificate"})))
    assert keys == {"dtype-drift:fixture.weak:weak-literal:where",
                    "dtype-drift:fixture.weak:f32-accum"}
    assert audit_entry(registry.trace_entry(
        name="fixture.anchored", fn=anchored, args={"c": torch.ones((2, 4))},
        tags={"certificate"})) == []


# --------------------------------------------------------------------------
# Recompile-hazard rule
# --------------------------------------------------------------------------

def test_baked_operand_flagged():
    """eps captured from the closure: the entry cannot be told another
    value."""
    eps = 0.25
    e = registry.trace_entry(
        name="fixture.baked_eps",
        fn=lambda c: torch.floor(c / eps).to(torch.int32),
        args={"c": torch.zeros((4, 4))}, must_trace={"eps"})
    assert "recompile-hazard:fixture.baked_eps:baked:eps" in \
        _keys(audit_entry(e))


def test_python_scalar_operand_flagged():
    e = registry.trace_entry(
        name="fixture.scalar_eps",
        fn=lambda c, eps: torch.floor(c / eps).to(torch.int32),
        args={"c": torch.zeros((4, 4)), "eps": 0.25}, must_trace={"eps"})
    assert "recompile-hazard:fixture.scalar_eps:scalar:eps" in \
        _keys(audit_entry(e))


def test_tensor_operand_clean():
    e = registry.trace_entry(
        name="fixture.tensor_eps",
        fn=lambda c, eps: torch.floor(c / eps).to(torch.int32),
        args={"c": torch.zeros((4, 4)), "eps": torch.tensor(0.25)},
        must_trace={"eps"})
    assert not any(f.rule == "recompile-hazard" for f in audit_entry(e))


def test_unused_must_trace_flagged():
    """A must-trace operand that no op reads is a dead knob (the value
    changes, the result does not)."""
    e = registry.trace_entry(
        name="fixture.dead_knob",
        fn=lambda c, eps: torch.floor(c * 4.0).to(torch.int32),
        args={"c": torch.zeros((4, 4)), "eps": torch.tensor(0.25)},
        must_trace={"eps"})
    assert "recompile-hazard:fixture.dead_knob:unused:eps" in \
        _keys(audit_entry(e))


# --------------------------------------------------------------------------
# Hot-loop sync audit (AST fixtures)
# --------------------------------------------------------------------------

_LOOP = '''
def drive(run_fn, conv_fn, data, state, n):
    for _ in range(n):
        state = run_fn(data, state)
        both = host_numpy("chunk", conv_fn(data, state))
{extra}        if both[0].all():
            break
    return state
'''


@pytest.mark.parametrize("extra,marker", [
    ('        ph = host_numpy("chunk", state.phases)\n', "host_numpy"),
    ("        ph = state.phases.cpu()\n", ".cpu()"),
    ("        ph = int(state.phases.max().item())\n", ".item()"),
    ("        ph = state.phases.tolist()\n", ".tolist()"),
    ("        ph = np.asarray(state.phases)\n", "np.asarray"),
    ('        stop, = host_flags("round", state.done)\n', "host_flags"),
    ("        torch.cuda.synchronize()\n", "torch.cuda.synchronize"),
])
def test_syncaudit_flags_second_read(extra, marker):
    fs = audit_function_source(_LOOP.format(extra=extra), "drive",
                               "fixture")
    assert [f.detail.split(":")[1] for f in fs] == [marker], fs


def test_syncaudit_whitelists_the_chunk_read():
    assert audit_function_source(_LOOP.format(extra=""), "drive",
                                 "fixture") == []


def test_syncaudit_whitelist_is_the_chunk_kind_only():
    src = _LOOP.format(extra="").replace('"chunk"', '"round"')
    fs = audit_function_source(src, "drive", "fixture")
    assert [f.detail.split(":")[1] for f in fs] == ["host_numpy"]


def test_syncaudit_default_targets_clean():
    from repro_torch.analysis.syncaudit import audit_targets, default_targets
    assert audit_targets(default_targets()) == []


def test_syncaudit_missing_function():
    fs = audit_function_source("x = 1", "drive", "fixture")
    assert any(f.detail.startswith("missing") for f in fs)


def test_synctarget_paths_exist():
    from repro_torch.analysis.syncaudit import default_targets
    targets = default_targets()
    assert {t.func for t in targets} == {"_drive"}
    for t in targets:
        assert os.path.exists(str(t.path)), t


# --------------------------------------------------------------------------
# Registry mechanics over the real entry set
# --------------------------------------------------------------------------

def test_entry_names_equal_reference():
    names = {s.name for s in registry.entry_specs()}
    ref = {s.name for s in jregistry.entry_specs()}
    assert names == ref - NOT_PORTED
    assert len(names) == 32


def test_builtin_entries_record():
    entries = registry.build_entries()
    assert len(entries) == len(registry.entry_specs())
    for e in entries:
        assert e.ops, f"{e.name} recorded no op"
        assert e.out_leaves, f"{e.name} returned nothing"
        assert all(t is None or t.storage for t in e.in_leaves), e.name


def test_builtin_findings_are_the_baseline():
    """The port's own entries give exactly the accepted findings: the
    reference's four (the device threshold fallback, three f32
    certificate sums)."""
    from repro_torch.analysis.rules import audit_entries

    findings, n = audit_entries(registry.build_entries())
    assert n == 32
    assert _keys(findings) == set(load_baseline(DEFAULT_BASELINE))


def test_repo_strict_audit_passes():
    """The gate as a user runs it: ``python -m repro_torch.analysis
    --strict``, the dynamic pass included (on the CPU, asked for with
    ``--device cpu``)."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    env.pop("REPRO_DEBUG_CHECKS", None)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--strict",
         "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "no unsuppressed findings" in out.stdout
    assert "bucket-ladder audit" in out.stdout


def test_cli_list_and_strict_without_dynamic(capsys):
    from repro_torch.analysis.cli import main
    assert main(["--list"]) == 0
    listed = capsys.readouterr().out.split()
    assert listed == sorted(s.name for s in jregistry.entry_specs())
    assert main(["--strict", "--no-dynamic"]) == 0


# --------------------------------------------------------------------------
# Baseline machinery
# --------------------------------------------------------------------------

def test_baseline_requires_justification(tmp_path):
    p = tmp_path / "base.txt"
    p.write_text("some-rule:entry:detail\n")
    with pytest.raises(ValueError, match="justification"):
        load_baseline(p)
    p.write_text("some-rule:entry:detail -- \n")
    with pytest.raises(ValueError, match="justification"):
        load_baseline(p)


def test_baseline_suppresses_and_reports_stale(tmp_path):
    p = tmp_path / "base.txt"
    p.write_text("r:e:d -- accepted for reasons\n"
                 "r:gone:d -- entry was removed\n")
    base = load_baseline(p)
    f = Finding(rule="r", entry="e", detail="d", message="m")
    g = Finding(rule="r", entry="e", detail="other", message="m")
    active, suppressed, stale = apply_baseline([f, g], base)
    assert active == [g]
    assert suppressed == [(f, "accepted for reasons")]
    assert stale == ["r:gone:d"]


def test_stale_baseline_entry_fails_strict(tmp_path):
    from repro_torch.analysis.cli import main
    p = tmp_path / "base.txt"
    p.write_text(Path(DEFAULT_BASELINE).read_text()
                 + "r:gone:d -- an entry that matches nothing\n")
    assert main(["--strict", "--no-dynamic", "--baseline", str(p)]) == 1
    assert main(["--no-dynamic", "--baseline", str(p)]) == 0


# --------------------------------------------------------------------------
# Bucket-ladder audit (dynamic; exercises the real driver)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("spec_name", ["assignment", "ot"])
def test_bucket_ladder_clean(spec_name):
    from repro_torch.analysis.cli import audit_bucket_ladder
    findings = audit_bucket_ladder(spec_name, device="cpu")
    assert findings == [], [f.key for f in findings]


def test_dynamic_audit_does_not_fall_back_to_the_cpu():
    """Without a card the dynamic audit raises unless the CPU is asked
    for; it never carries on on the CPU by itself."""
    import torch
    from repro_torch.analysis.cli import audit_bucket_ladder, main

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        audit_bucket_ladder()
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--strict"])


def test_bucket_ladder_restores_debug_flag():
    from repro_torch import analysis
    from repro_torch.analysis.cli import audit_bucket_ladder

    analysis.set_debug_checks(True)
    try:
        assert audit_bucket_ladder(device="cpu") == []
        assert analysis.debug_checks_enabled()
    finally:
        analysis.set_debug_checks(None)


def test_leaves_of_prefix_matching():
    lo = registry.TracedEntry.leaves_of
    assert lo(None, "state",
              ["state.y_b", "state.y_a", "stateful"]) == [0, 1]
    assert lo(None, "x", ["x"]) == [0]
    assert lo(None, "ops", ["ops['c']", "ops['nu']", "out"]) == [0, 1]


def test_leaf_names_match_the_reference():
    st = init_ot_state(torch.ones((1, 2), dtype=torch.int32),
                       torch.ones((1, 3), dtype=torch.int32))
    val = {"b": [st, 1.0], "a": np.zeros(2)}
    assert registry._leaf_names("x", val) == jregistry._leaf_names("x", val)
