"""A cell whose inputs and answers are not point clouds runs through the
harness from new files alone; the point-cloud references judge answers
through ``check`` exactly as through ``certify``; the chunk metric reads
the solve path's recorded spans."""
import json
from pathlib import Path
import shutil
import sys
import time

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench.entries.solve import _host_answers  # noqa: E402
from portbench.lib import gen, harness  # noqa: E402
from portbench.reference import assignment, transport  # noqa: E402
from repro_torch.core import api  # noqa: E402
from repro_torch.core.costs import build_cost_matrix  # noqa: E402
from repro_torch.obs import tracing  # noqa: E402

SEED = 3_000_000_019

# a training-like cell: each step multiplies a batch drawn from the seed
# by weights drawn from the seed, on the device, and hands back the
# product; its reference recomputes it in float64 with plain torch
STUB_ENTRY = '''
import types

import torch

from portbench.lib import gen
from portbench.lib.harness import Window


def run(env):
    params, d = env.cell.params, env.cell.config["d"]
    w_rng = gen.rng_for(env.seed, "weights")
    w = torch.tensor(w_rng.standard_normal((d, d)), dtype=torch.float32,
                     device=env.device)
    rng = gen.rng_for(env.seed, "batch")
    win = Window(setup_s=env.clock() - env.t_start)
    t0 = env.clock()
    while env.clock() - t0 < env.seconds:
        x = torch.tensor(rng.standard_normal((params["batch"], d)),
                         dtype=torch.float32, device=env.device)
        win.attempted += 1
        y = torch.tanh(x @ w).cpu().numpy()
        if params.get("fault"):
            y[0, 0] += 1e-3
        inst = types.SimpleNamespace(x=x.cpu().numpy(), w=w.cpu().numpy(),
                                     shape=tuple(x.shape))
        win.answers.append((inst, {"y": y}))
        win.calls_done += 1
        win.instances_done += 1
    win.elapsed_s = env.clock() - t0
    win.peak_bytes = win.process_peak_bytes = env.peak()
    return win
'''

STUB_REFERENCE = '''
import torch


def check(instance, answer, config):
    x = torch.as_tensor(instance.x, dtype=torch.float64)
    w = torch.as_tensor(instance.w, dtype=torch.float64)
    want = torch.tanh(x @ w)
    got = torch.as_tensor(answer["y"], dtype=torch.float64)
    return {"max_err": float((got - want).abs().max())}
'''


def _stub_root(tmp_path: Path, fault: bool = False) -> Path:
    """A checkout holding only the stub cell's files (and the two
    metric readers it reports)."""
    bench = tmp_path / "portbench"
    for sub in ("configs", "workloads", "entries", "reference", "metrics"):
        (bench / sub).mkdir(parents=True)
    for name in ("setup_s", "instances_per_s"):
        shutil.copy(ROOT / "portbench" / "metrics" / f"{name}.py",
                    bench / "metrics")
    cell = {"name": "stub_train.steps", "config": "stub_train",
            "traffic": "steps", "chips": 1,
            "why": "a stub step: a batch times weights, both from the seed"}
    manifest = {
        "configs": [{"name": "stub_train", "source": "none",
                     "file": "portbench/configs/stub_train.json",
                     "reduced": [], "why": "a cell that is not a solve"}],
        "workloads": [cell],
        "end_to_end": [
            {"name": "instances_per_s", "unit": "instances/s",
             "better": "higher", "bound": 0.25, "source": "host_clock"},
            {"name": "setup_s", "unit": "s", "better": "lower",
             "bound": 0.25, "source": "host_clock"}],
        "per_layer": []}
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    (bench / "configs" / "stub_train.json").write_text(json.dumps(
        {"name": "stub_train", "reference": "stub_tanh", "d": 16,
         "guarantees": {"max_err": 1e-5}}))
    (bench / "workloads" / "stub_train.steps.json").write_text(json.dumps(
        dict(cell, entry="stub_steps", batch=8, check=5, fault=fault)))
    (bench / "entries" / "stub_steps.py").write_text(STUB_ENTRY)
    (bench / "reference" / "stub_tanh.py").write_text(STUB_REFERENCE)
    return tmp_path


def _run_stub(root: Path):
    cell = harness.load_cell("stub_train.steps", root)
    return harness.run_cell(cell, SEED, 0.2, False, torch.device("cpu"),
                            time.monotonic())


def test_a_cell_that_is_not_a_solve_runs_from_new_files(tmp_path):
    res, notes = _run_stub(_stub_root(tmp_path))
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"instances_per_s", "setup_s"}
    assert res["checks"]["max_err"]["value"] < 1e-5
    assert notes["answers_checked"] == min(5, notes["answers"])
    assert list(res)[-1] == "checks"


def test_a_broken_stub_answer_is_not_correct(tmp_path):
    res, _ = _run_stub(_stub_root(tmp_path, fault=True))
    assert not res["correct"]
    assert res["checks"]["max_err"]["value"] > 1e-4


def test_a_configuration_without_points_draws_no_pool(tmp_path,
                                                      monkeypatch):
    """The closed loop's pool is drawn only for a point law: the stub's
    entry gets none."""
    seen = []
    root = _stub_root(tmp_path)
    entry = harness.load_file("entries", "stub_steps", root)
    orig = entry.run
    monkeypatch.setattr(entry, "run",
                        lambda env: seen.append(env.calls) or orig(env))
    monkeypatch.setattr(gen, "make_calls", lambda *a: pytest.fail(
        "make_calls without a point law"))
    assert _run_stub(root)[0]["correct"]
    assert seen == [[]]


def _canned(name: str, count: int = 5, n: int = 40):
    """The cell's configuration with ``count`` small instances from its
    generator, and the port's answers to them on the CPU."""
    cell = harness.load_cell(name)
    cfg = cell.config
    params = dict(cell.params, sizes={"law": "fixed", "m": n, "n": n},
                  pool=count, batch=1)
    params.pop("set_seed", None)
    insts = [c.instances[0] for c in gen.make_calls(cfg, params, SEED)]
    spec = api.ASSIGNMENT if cfg["problem"] == "assignment" else api.OT
    answers = []
    for inst in insts:
        c = build_cost_matrix(inst.x, inst.y, cfg["metric"], device="cpu")
        if inst.nu is None:
            sols = list(api.solve(spec, {"c": c[None]}, cfg["eps"],
                                  want=tuple(params["want"]), device="cpu"))
        else:
            sols = api.solve(spec, [(c, inst.nu, inst.mu)], cfg["eps"],
                             want=tuple(params["want"]), device="cpu")
        answers.append((inst, _host_answers(sols, cfg["problem"])[0]))
    return cell, answers


@pytest.mark.parametrize("name", ["fig1_points.solo", "ot_points.solo"])
def test_check_answers_equals_direct_certify_calls(name):
    """Bit for bit: the worst of each number over the answers, through
    the references' ``check``, equals that of direct ``certify`` calls."""
    cell, answers = _canned(name)
    cfg = cell.config
    direct = []
    for inst, out in answers:
        if inst.nu is None:
            direct.append(assignment.certify(inst.x, inst.y, cfg["metric"],
                                             cfg["eps"], out))
        else:
            direct.append(transport.certify(inst.x, inst.y, inst.nu,
                                            inst.mu, cfg["metric"],
                                            cfg["eps"], out))
    got = harness.check_answers(cell, answers, SEED, len(answers))
    want = {k: max(float(d[k]) for d in direct) for k in direct[0]}
    assert got == dict(want, checked=float(len(answers)))
    assert harness.judge(got, harness.limits_of(cell))[0]


@pytest.fixture
def recorder():
    """An empty ring, recording on; the recorder as it was afterwards."""
    tracing.clear()
    tracing.record(True)
    yield tracing
    tracing.record(None)
    tracing.clear()


@pytest.mark.parametrize("problem", ["assignment", "ot"])
def test_the_chunk_metric_reads_the_recorded_spans(recorder, problem,
                                                   monkeypatch):
    """Host us a ``driver.chunk`` span under a ``solve`` span, over their
    count; None from an empty ring or a program without the recorder."""
    read = harness.load_file("metrics", "driver.chunk_host_us.solo").read
    recorder.record(False)
    assert read(None) is None
    recorder.record(True)
    rng = np.random.default_rng(5)
    for _ in range(2):
        x = rng.uniform(size=(1, 24, 2)).astype(np.float32)
        y = rng.uniform(size=(1, 24, 2)).astype(np.float32)
        c = build_cost_matrix(x, y, "euclidean", device="cpu")
        if problem == "assignment":
            list(api.solve(api.ASSIGNMENT, {"c": c}, 0.1, device="cpu"))
        else:
            nu = rng.dirichlet(np.ones(24)).astype(np.float32)
            api.solve(api.OT, [(c[0], nu, nu)], 0.1, device="cpu")
    spans = tracing.recorded()
    solves = {s["span_id"] for s in spans if s["name"] == "solve"}
    chunks = [s["dur_s"] for s in spans if s["name"] == "driver.chunk"]
    assert len(solves) == 2 and chunks
    assert all(s["parent_id"] in solves for s in spans
               if s["name"] == "driver.chunk")
    assert read(None) == pytest.approx(1e6 * sum(chunks) / len(chunks),
                                       rel=1e-12)
    monkeypatch.delattr(tracing, "recorded")
    assert read(None) is None
