"""A whole run of each cell on the CPU at a test's size, the look for a
chip skipped: ``correct`` is true as the program stands, and false with
the timed path broken underneath (a step that returns its state
unchanged; half of a batch answered with the other half's answers; an
answer altered where it is produced) and with the control (every cost
built in bfloat16). The exchange between chips is no fault these cells
can have: each runs on one chip."""
from pathlib import Path
import sys
import time

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench.control import bf16_costs  # noqa: E402
from portbench.lib import harness  # noqa: E402
from repro_torch.core import api  # noqa: E402
from repro_torch.core.problem import AssignmentSpec, OTSpec  # noqa: E402

# each cell's traffic at a size the CPU runs in a few seconds; the rest
# of its workload file as it is
SMALL = {
    "fig1_points.solo": {"sizes": {"law": "fixed", "m": 48, "n": 48},
                         "pool": 3},
    "ot_points.solo": {"sizes": {"law": "fixed", "m": 48, "n": 48},
                       "pool": 3},
    "fig1_points.batch": {"sizes": {"law": "fixed", "m": 32, "n": 32},
                          "batch": 4, "pool": 2},
}
SECONDS = 1.0
CELLS = sorted(SMALL)
BATCHED = ["fig1_points.batch"]


def _run(name, seed=2_000_000_003):
    cell = harness.load_cell(name)
    cell.params.update(SMALL[name])
    res, _ = harness.run_cell(cell, seed, SECONDS, False,
                              torch.device("cpu"), time.monotonic())
    return res


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    res = _run(name)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("name", CELLS)
def test_a_step_that_returns_its_state_unchanged(name, monkeypatch):
    for spec in (AssignmentSpec, OTSpec):
        monkeypatch.setattr(spec, "run_phases",
                            lambda self, data, state, k: state)
    assert not _run(name)["correct"]


def _swap_two_rows(result):
    """The answer of every lane altered where the epilogue makes it: rows
    0 and 1 trade their columns (assignment) or their plan rows (OT)."""
    if hasattr(result, "matching"):
        m = result.matching.clone()
        m[:, [0, 1]] = m[:, [1, 0]]
        return result._replace(matching=m)
    p = result.plan.clone()
    p[:, [0, 1]] = p[:, [1, 0]]
    return result._replace(plan=p)


@pytest.mark.parametrize("name", CELLS)
def test_an_answer_altered_where_it_is_produced(name, monkeypatch):
    for spec in (AssignmentSpec, OTSpec):
        orig = spec.epilogue
        monkeypatch.setattr(
            spec, "epilogue",
            lambda self, ctx, state, orig=orig: _swap_two_rows(
                orig(self, ctx, state)))
    assert not _run(name)["correct"]


@pytest.mark.parametrize("name", BATCHED)
def test_half_of_a_batch_left_out(name, monkeypatch):
    """Each dispatched bucket solves only its first half; the second half
    gets copies of those answers."""
    orig = api.solve

    def half(spec, instances, eps, policy=None, **kw):
        if isinstance(instances, dict):
            b = int(instances["c"].shape[0])
            if b > 1:
                idx = torch.arange(b) % ((b + 1) // 2)
                instances = {k: v[idx.to(v.device)]
                             for k, v in instances.items()}
        return orig(spec, instances, eps, policy, **kw)

    monkeypatch.setattr(api, "solve", half)
    assert not _run(name)["correct"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    """Every cost built in bfloat16: a sound run on other costs."""
    with bf16_costs():
        res = _run(name)
    assert not res["correct"], res["checks"]
