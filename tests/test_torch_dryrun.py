"""repro_torch's dry-run (``launch/dryrun.py``) against the reference's.

The reference's six small-mesh cells (``test_sharded_ot.py``'s
``test_dryrun_small_mesh_cells``: reduced configs, smoke shapes,
``unroll=False``, a (2, 4) ('data', 'model') mesh) run through both
packages: the reference compiles them under forced host devices, in one
module-scoped subprocess; the port plans them on a mesh of ``meta``
devices. Held equal: ``ok``, ``argument_bytes``, ``model_flops`` and
``alias_bytes`` (less, in three cells, the donated buffers the
reference's XLA cannot alias: ``XLA_UNALIASED``); printed side by side:
output and temp bytes, FLOPs and
the collective totals (XLA's own choices, which no torch program
reproduces). The collective records of each cell, rendered as HLO lines,
give the same totals through the reference's parser as through the
port's ``collective_bytes``. Also: the collectives of one dense layer on
a (2, 2) mesh listed by hand, the production mesh's shapes, the CLI and
the aggregate's tables.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.roofline.analysis import collective_bytes as ref_collective_bytes
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.roofline import aggregate
from repro_torch.roofline.analysis import collective_bytes, hlo_lines

ROOT = Path(__file__).resolve().parents[1]
CELLS = [
    ("qwen3-4b", "train_4k"),
    ("deepseek-moe-16b", "train_4k"),
    ("mamba2-2.7b", "decode_32k"),
    ("seamless-m4t-medium", "prefill_32k"),
    ("jamba-1.5-large-398b", "decode_32k"),
    ("llava-next-mistral-7b", "train_4k"),
]
# Bytes of donated buffers that the reference's XLA does not alias: it
# gives some updated outputs another sharding than their inputs, so their
# per-device shapes differ (read from the compiled module's
# input_output_alias): qwen3-4b's updated q_norm / k_norm come out split
# over 'data' (3 x 512 B: v of final_norm, q_norm and k_norm stay
# donors); the Mamba conv tail of x (4 and 7 layers x 1536 B) comes out
# split like its projection. The port writes parameters, moments and
# attention caches in place and counts every piece of state it hands
# back as aliased, so its alias bytes are the donated bytes.
XLA_UNALIASED = {("qwen3-4b", "train_4k"): 1536,
                 ("mamba2-2.7b", "decode_32k"): 4 * 1536,
                 ("jamba-1.5-large-398b", "decode_32k"): 7 * 1536}


@pytest.fixture(scope="module")
def reference_cells():
    """The reference's ``run_cell`` on the six cells, in a subprocess
    (it forces its host device count when imported)."""
    script = (
        "import json\n"
        "from repro.launch.dryrun import run_cell\n"
        f"cells = {CELLS!r}\n"
        "outs = []\n"
        "for a, s in cells:\n"
        "    o = run_cell(a, s, small=True, smoke=True, unroll=False)\n"
        "    r = o.get('roofline', {})\n"
        "    outs.append({'ok': o['ok'], 'err': o.get('error'),\n"
        "                 'memory': o.get('memory'),\n"
        "                 'model_flops': o.get('model_flops'),\n"
        "                 'flops': r.get('flops_per_device'),\n"
        "                 'collective': r.get('collective')})\n"
        "print('RESULT:' + json.dumps(outs))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True,
        timeout=600, cwd=str(ROOT),
        env={"PYTHONPATH": "src", "PATH": os.environ.get("PATH", ""),
             "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [x for x in proc.stdout.splitlines() if x.startswith("RESULT:")]
    return dict(zip(CELLS, json.loads(line[0][len("RESULT:"):])))


@pytest.fixture(scope="module")
def port_cells():
    return {c: dryrun.run_cell(*c, small=True, smoke=True, unroll=False)
            for c in CELLS}


@pytest.mark.parametrize("cell", CELLS, ids=["__".join(c) for c in CELLS])
def test_small_mesh_cell_equals_reference(cell, reference_cells,
                                          port_cells):
    ref, got = reference_cells[cell], port_cells[cell]
    assert ref["ok"], ref["err"]
    assert got["ok"], got.get("traceback")
    assert got["n_chips"] == 8 and got["mesh"] == {"data": 2, "model": 4}
    rm, gm = ref["memory"], got["memory"]
    assert gm["argument_bytes"] == rm["argument_bytes"]
    assert gm["alias_bytes"] == rm["alias_bytes"] + XLA_UNALIASED.get(
        cell, 0)
    assert got["model_flops"] == ref["model_flops"]
    rc, gc = ref["collective"], got["roofline"]["collective"]
    print(f"\n{cell}: output bytes {gm['output_bytes']} (reference "
          f"{rm['output_bytes']}), temp {gm['temp_bytes']} "
          f"({rm['temp_bytes']}), flops/device "
          f"{got['roofline']['flops_per_device']} ({ref['flops']}), "
          f"collectives {gc['counts']} moving {gc['moved_bytes']} B "
          f"({rc['counts']}, {rc['moved_bytes']} B)")


@pytest.mark.parametrize("cell", CELLS, ids=["__".join(c) for c in CELLS])
def test_collective_records_through_both_parsers(cell, port_cells):
    """The records of each cell, rendered as HLO lines, give the same
    totals through the reference's parser."""
    recs = port_cells[cell]["collective_records"]
    got = collective_bytes(recs)
    want = ref_collective_bytes(hlo_lines(recs))
    assert got["counts"] == want["counts"]
    assert got["while_ops"] == want["while_ops"]
    for op, v in want["by_op"].items():
        assert got["by_op"][op] == pytest.approx(v, rel=1e-12), op
    assert got["moved_bytes"] == pytest.approx(want["moved_bytes"],
                                               rel=1e-12)
    assert port_cells[cell]["roofline"]["collective"] == got


def _by_hand(b, s):
    """One dense layer of reduced llama3.2-3b (d 128, 4 heads and 2 KV
    heads of 32, d_ff 256, vocab 512) training on a (2, 2) mesh, remat on,
    a 'data' shard of ``b`` sequences of ``s`` tokens: every collective
    as (op, dtype, result shape, group)."""
    rows = b * s
    ar_act = ("all-reduce", "bf16", (rows, 128), 2)
    out = [
        # embed (512, 128) on ('tp', 'dp'): gathered to its 'model' block
        ("all-gather", "bf16", (256, 128), 2),
        ("reduce-scatter", "f32", (256, 64), 2),
        ar_act, ar_act,                          # forward, backward
        ("all-reduce", "f32", (128,), 2),        # final_norm's gradient
        # lm_head (128, 512) on ('dp', 'tp')
        ("all-gather", "bf16", (128, 256), 2),
        ("reduce-scatter", "f32", (64, 256), 2),
        ("all-reduce", "f32", (128,), 2),        # ln1
        ("all-reduce", "f32", (128,), 2),        # ln2
    ]
    # the layer's matrices: gathered in the forward pass and again in the
    # remat recompute; (shape, spec on dims 0 and 1)
    for shape, row_parallel in [((128, 128), False), ((128, 64), False),
                                ((128, 64), False), ((128, 128), True),
                                ((128, 256), False), ((128, 256), False),
                                ((256, 128), True)]:
        r, c = shape
        if row_parallel:      # ('tp', 'dp')
            gathered, block = (r // 2, c), (r // 2, c // 2)
        else:                 # ('dp', 'tp')
            gathered, block = (r, c // 2), (r // 2, c // 2)
        out += [("all-gather", "bf16", gathered, 2)] * 2
        out.append(("reduce-scatter", "f32", block, 2))
        if row_parallel:      # wo, w_down: forward, recompute, backward
            out += [ar_act] * 3
    return out


def test_collective_rules_by_hand():
    from repro_torch.configs.registry import ARCHS, SMOKE_SHAPES, reduced
    from repro_torch.launch.mesh import make_small_mesh
    from repro_torch.models import model as M
    from repro_torch.models import sharding

    cfg = reduced(ARCHS["llama3.2-3b"]).with_(num_layers=1)
    assert not cfg.qkv_bias and not cfg.qk_norm and cfg.remat
    shape = SMOKE_SHAPES["train_4k"]             # B = 2, S = 64
    mesh = make_small_mesh((2, 2), devices="meta")
    saved = dict(sharding._STATE)
    try:
        sharding.set_mesh(mesh)
        recs = dryrun.collective_records(cfg, shape, "train", mesh,
                                         M.abstract_params(cfg))
    finally:
        sharding._STATE.clear()
        sharding._STATE.update(saved)
    got = sorted((r["op"], r["dtype"], tuple(r["shape"]), r["group"])
                 for r in recs)
    want = sorted(_by_hand(1, 64))
    assert got == want
    # the ring model on these: 2 (N-1)/N = 1 for N = 2, and so on
    moved = 0.0
    for op, dt, shp, n in want:
        nbytes = (2 if dt == "bf16" else 4) * int(torch.tensor(shp).prod())
        moved += {"all-reduce": 1.0, "all-gather": 0.5,
                  "reduce-scatter": 1.0}[op] * nbytes
    assert collective_bytes(recs)["moved_bytes"] == moved


def test_production_mesh_shapes_and_names():
    sp = make_production_mesh()
    assert sp.shape == {"data": 16, "model": 16} and sp.size == 256
    assert {d.type for d in sp.flat_devices} == {"meta"}
    mp = make_production_mesh(multi_pod=True)
    assert mp.shape == {"pod": 2, "data": 16, "model": 16}
    assert mp.axis_names == ("pod", "data", "model") and mp.size == 512
    cpu = make_production_mesh(devices="cpu")
    assert {d.type for d in cpu.flat_devices} == {"cpu"}


def test_shard_bytes_round_up_where_a_dimension_does_not_divide():
    from repro_torch.models.sharding import NamedSharding, P

    mesh = make_production_mesh()
    sh = NamedSharding(mesh, P("data", "model"))
    assert dryrun.block_shape(sh, (100, 33)) == (7, 3)
    x = torch.empty((100, 33), dtype=torch.bfloat16, device="meta")
    assert dryrun.shard_bytes(dryrun.Placed(x, sh)) == 7 * 3 * 2
    with pytest.raises(ValueError):
        sh.shard_shape((100, 33))


def test_skipped_and_failed_cells():
    skip = dryrun.run_cell("qwen3-4b", "long_500k", small=True, smoke=True)
    assert skip["ok"] and skip["skipped"].startswith("long_500k skipped")
    bad = dryrun.run_cell("no-such-arch", "train_4k", small=True,
                          smoke=True)
    assert not bad["ok"] and bad["error"].startswith("KeyError")


def test_cli_writes_the_record_and_collective_lines(tmp_path, monkeypatch,
                                                    capsys):
    out, hlo = tmp_path / "out", tmp_path / "hlo"
    monkeypatch.setattr(sys, "argv", [
        "dryrun", "--arch", "deepseek-moe-16b", "--shape", "decode_32k",
        "--small", "--smoke", "--router", "pushrelabel", "--out", str(out),
        "--save-hlo", str(hlo)])
    dryrun.main()
    rec = json.loads((out / "deepseek-moe-16b__decode_32k__sp__pushrelabel"
                             "__smoke.json").read_text())
    assert rec["ok"] and rec["router"] == "pushrelabel"
    # one router launch a MoE layer of the decode step, costed once each
    assert rec["roofline"]["collective"]["while_ops"] == 3
    assert [c["shape"] for c in rec["plan"]["custom_calls"]] == [[1, 8]] * 3
    lines = (hlo / "deepseek-moe-16b__decode_32k__sp.collectives.txt"
             ).read_text()
    assert ref_collective_bytes(lines)["counts"] == \
        rec["roofline"]["collective"]["counts"]
    assert "mem/device" in capsys.readouterr().out


def test_import_sets_no_flag_and_no_jax():
    code = ("import os, sys\n"
            "import repro_torch.launch.dryrun, repro_torch.roofline."
            "aggregate\n"
            "print(os.environ.get('XLA_FLAGS'), 'jax' in sys.modules, "
            "any(m == 'repro' or m.startswith('repro.') "
            "for m in sys.modules))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=str(ROOT),
                          env={"PYTHONPATH": "src",
                               "PATH": os.environ.get("PATH", "")})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.split() == ["None", "False", "False"]


def test_aggregate_renders_ok_skip_and_fail_rows(tmp_path, port_cells,
                                                 capsys, monkeypatch):
    for (arch, shape), rec in list(port_cells.items())[:2]:
        (tmp_path / f"{arch}__{shape}__sp.json").write_text(json.dumps(rec))
    skip = dryrun.run_cell("qwen3-4b", "long_500k", small=True, smoke=True)
    (tmp_path / "qwen3-4b__long_500k__sp.json").write_text(json.dumps(skip))
    bad = {"arch": "x", "shape": "train_4k", "multi_pod": True, "ok": False,
           "error": "RuntimeError: boom", "compile_s": 0.1}
    (tmp_path / "x__train_4k__mp.json").write_text(json.dumps(bad))
    cells = aggregate.load(str(tmp_path))
    assert len(cells) == 4
    table = aggregate.dryrun_table(cells)
    assert table.count("| ok |") == 2
    assert "| SKIP (long_500k skipped) |" in table
    assert "**FAIL** RuntimeError: boom" in table
    roof = aggregate.roofline_table(cells)
    assert len(roof.splitlines()) == 2 + 2
    assert "(scaled)" in roof and "MXU" not in roof
    monkeypatch.setattr(sys, "argv", ["aggregate", str(tmp_path)])
    aggregate.main()
    out = capsys.readouterr().out
    assert "4 cells, 3 ok (1 skipped-by-design), 1 failed" in out
    assert "H100 SXM" in out
