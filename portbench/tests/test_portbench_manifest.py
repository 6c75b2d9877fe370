"""BENCHMARK.json against the benchmark's rules, and every name in it
against its file; no module of the benchmark imports JAX or the JAX
package, and a reference is plain NumPy or plain torch and imports
nothing of the program nor of the benchmark's entries and lib."""
import ast
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_size():
    assert set(MANIFEST) == TOP_KEYS
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert MANIFEST["command"] == ["python3", "portbench/run.py"]
    assert isinstance(MANIFEST["run_seconds"], int)
    assert 1 <= MANIFEST["run_seconds"] <= 51


def test_paths_hold_only_the_benchmark():
    paths = MANIFEST["paths"]
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    for word in MANIFEST["command"][1:]:
        assert _line(word)
        if "/" in word:
            assert any(word.startswith(p + "/") for p in paths)


@pytest.mark.parametrize("key", ["configs", "workloads", "end_to_end",
                                 "per_layer"])
def test_names_are_unique_and_well_formed(key):
    names = [e["name"] for e in MANIFEST[key]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n


def test_configs():
    used = {w["config"] for w in MANIFEST["workloads"]}
    files = set()
    assert 1 <= len(MANIFEST["configs"]) <= 24
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in MANIFEST["paths"])
        assert c["file"] not in files
        files.add(c["file"])
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["name"] == c["name"]
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k)


def test_workloads():
    cells = MANIFEST["workloads"]
    configs = {c["name"] for c in MANIFEST["configs"]}
    assert 1 <= len(cells) <= 24
    pairs = set()
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs
        assert NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
        assert _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    four = sum(w["chips"] == 4 for w in cells)
    assert four <= max(1, len(cells) // 4)


def _metrics_of(cell, key):
    return [m for m in MANIFEST[key]
            if "workloads" not in m or cell in m["workloads"]]


def test_metrics():
    cells = {w["name"] for w in MANIFEST["workloads"]}
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert 1 <= len(e2e) <= 16 and "setup_s" in e2e
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in MANIFEST["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    assert 1 <= len(MANIFEST["per_layer"]) <= 128
    layers = {}
    for m in MANIFEST["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES and _line(m["layer"])
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert m["moves"] in {x["name"] for x in
                                  _metrics_of(cell, "end_to_end")}
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"].split(" ")[0], set()).add(m["layer"])
    # one layer, one spelling
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_every_cell_reports_enough(cell):
    e2e = {m["name"] for m in _metrics_of(cell, "end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert _metrics_of(cell, "per_layer")


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_every_cell_resolves_to_its_files(cell):
    entry = next(w for w in MANIFEST["workloads"] if w["name"] == cell)
    params = json.loads((BENCH / "workloads" / f"{cell}.json").read_text())
    assert params["config"] == entry["config"]
    assert params["traffic"] == entry["traffic"]
    assert params["chips"] == entry["chips"] and params["why"] == entry["why"]
    assert (BENCH / "entries" / f"{params['entry']}.py").is_file()
    conf = next(c for c in MANIFEST["configs"]
                if c["name"] == entry["config"])
    config = json.loads((ROOT / conf["file"]).read_text())
    ref = BENCH / "reference" / f"{config['reference']}.py"
    assert "check" in {n.name for n in ast.parse(ref.read_text()).body
                       if isinstance(n, ast.FunctionDef)}, ref
    # each law where it is named; a point law draws the closed loop's
    # pool, which needs a size law too
    laws = [(role, config[role]) for role in ("points", "masses")
            if config.get(role)]
    if "points" in config or "sizes" in params:
        laws.append(("sizes", params["sizes"]["law"]))
    for role, law in laws:
        assert (BENCH / "traffic" / f"{role}_{law}.py").is_file(), law


@pytest.mark.parametrize("key", ["end_to_end", "per_layer"])
def test_every_metric_resolves_to_its_reader(key):
    for m in MANIFEST[key]:
        path = BENCH / "metrics" / f"{m['name']}.py"
        assert path.is_file(), path
        tree = ast.parse(path.read_text())
        assert any(isinstance(n, (ast.FunctionDef, ast.ImportFrom))
                   for n in tree.body)


def _imports(path: Path):
    """Top-level names of every module ``path`` imports."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


SOURCES_PY = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES_PY,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES_PY])
def test_no_jax_nor_the_jax_package(path):
    assert not _imports(path) & {"jax", "jaxlib", "flax", "repro"}


REFERENCES = sorted((BENCH / "reference").glob("*.py"))
# the references of the point-cloud cells, NumPy alone
NUMPY_ONLY = {"__init__.py", "assignment.py", "costs.py", "transport.py"}


@pytest.mark.parametrize("path", REFERENCES,
                         ids=[p.name for p in REFERENCES])
def test_the_reference_is_plain_numpy(path):
    """Plain NumPy or plain torch: no other package, no import that climbs
    out of ``reference/`` (the benchmark's ``entries`` and ``lib``); the
    references of the point-cloud cells NumPy alone."""
    climbs = [n for n in ast.walk(ast.parse(path.read_text()))
              if isinstance(n, ast.ImportFrom) and n.level > 1]
    assert not climbs, path
    allowed = {"__future__", "math", "numpy", "torch"}
    if path.name in NUMPY_ONLY:
        allowed = {"__future__", "numpy"}
    assert _imports(path) <= allowed, path


def test_top_level_names_are_compared_whole(monkeypatch):
    monkeypatch.syspath_prepend(str(BENCH))
    import run

    fake = {"repro_torch": 1, "repro_torch.core": 1, "numpy": 1}
    monkeypatch.setattr(run.sys, "modules", fake)
    assert run.forbidden_modules() == []
    fake["repro.core"] = 1
    fake["jaxlib"] = 1
    assert run.forbidden_modules() == ["jaxlib", "repro"]
