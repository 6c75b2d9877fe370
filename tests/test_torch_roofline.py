"""repro_torch's ``roofline.analysis.model_flops`` against the
reference's: every count equal, on three configurations (MoE, dense,
hybrid) and both kinds of shape; and the reference's own accounting
case on the port."""
import pytest

pytest.importorskip("torch")

from repro.configs import base as jbase
from repro.configs import registry as jreg
from repro.roofline.analysis import model_flops as ref_model_flops
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg
from repro_torch.roofline.analysis import model_flops


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "llama3.2-3b",
                                  "jamba-1.5-large-398b"])
@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_model_flops_equals_reference(arch, shape):
    got = model_flops(treg.ARCHS[arch], tbase.SHAPES[shape], 256)
    want = ref_model_flops(jreg.ARCHS[arch], jbase.SHAPES[shape], 256)
    assert got == want


def test_model_flops_accounting():
    cfg = treg.ARCHS["deepseek-moe-16b"]
    mf = model_flops(cfg, tbase.SHAPES["train_4k"], 256)
    assert 1.4e10 < mf["n_params_total"] < 2.2e10
    assert mf["n_params_active"] < 0.35 * mf["n_params_total"]
    assert mf["model_flops_total"] == 6 * mf["n_params_active"] * mf["tokens"]


def test_model_flops_of_the_training_slice():
    """deepseek-moe-16b at full width and 4 layers (the dense layer and 3
    MoE layers), as ``chip_smoke.py`` phase 12 trains it: 2048 tokens a
    step."""
    cfg = treg.ARCHS["deepseek-moe-16b"].with_(num_layers=4)
    mf = model_flops(cfg, tbase.ShapeConfig("step", 512, 4, "train"), 1)
    assert mf["n_params_total"] == 2_267_039_744
    assert mf["n_params_active"] == 505_055_232
    assert mf["model_flops_total"] == 6 * 505_055_232 * 2048


# -- the three terms and the collective ring model ---------------------------

# the reference's test_system.py four collectives and one while loop, as
# records
SYSTEM_RECORDS = [
    {"op": "all-reduce", "dtype": "f32", "shape": [1024, 256], "group": 16,
     "where": "ar", "rule": "test"},
    {"op": "all-gather", "dtype": "bf16", "shape": [4096, 128], "group": 16,
     "where": "ag", "rule": "test"},
    {"op": "reduce-scatter", "dtype": "f32", "shape": [64, 64], "group": 4,
     "where": "rs", "rule": "test"},
    {"op": "collective-permute", "dtype": "f32", "shape": [32], "group": 2,
     "where": "cp", "rule": "test"},
    {"op": "while", "dtype": "s32", "shape": [], "group": 1,
     "where": "loop", "rule": "test"},
]


def test_collective_bytes_of_the_reference_system_collectives():
    from repro.roofline.analysis import collective_bytes as ref_cb
    from repro_torch.roofline.analysis import collective_bytes, hlo_lines

    out = collective_bytes(SYSTEM_RECORDS)
    c = out["counts"]
    assert c["all-reduce"] == 1 and c["all-gather"] == 1
    assert c["reduce-scatter"] == 1 and c["collective-permute"] == 1
    assert out["by_op"]["all-reduce"] == 2 * 15 / 16 * 1024 * 256 * 4
    assert out["by_op"]["all-gather"] == 15 / 16 * 4096 * 128 * 2
    assert out["by_op"]["reduce-scatter"] == 3 * 64 * 64 * 4
    assert out["by_op"]["collective-permute"] == 32 * 4
    assert out["while_ops"] == 1
    # the same records through the reference's HLO parser
    assert ref_cb(hlo_lines(SYSTEM_RECORDS)) == out


@pytest.mark.parametrize("group", [1, 2, 8, 32])
@pytest.mark.parametrize("op", ["all-reduce", "all-gather", "reduce-scatter",
                                "all-to-all", "collective-permute"])
def test_ring_model_equals_reference_parser(op, group):
    from repro.roofline.analysis import collective_bytes as ref_cb
    from repro_torch.roofline.analysis import collective_bytes, hlo_lines

    recs = [{"op": op, "dtype": dt, "shape": shape, "group": group,
             "where": "x", "rule": "y"}
            for dt, shape in [("bf16", [3, 5, 7]), ("f32", []),
                              ("s32", [1000])]]
    got, want = collective_bytes(recs), ref_cb(hlo_lines(recs))
    assert got["counts"] == want["counts"]
    assert got["moved_bytes"] == pytest.approx(want["moved_bytes"],
                                               rel=1e-12)


def test_roofline_terms_use_the_h100_constants():
    import inspect
    import re

    from repro_torch.roofline import analysis

    coll = analysis.collective_bytes(SYSTEM_RECORDS)
    cost = {"flops": 989e12, "bytes accessed": 3.35e12 * 2,
            "dus_alias_bytes": 3.35e12}
    t = analysis.roofline_terms(cost, coll)
    assert t["t_compute_s"] == 1.0
    assert t["t_memory_s"] == 2.0 and t["t_memory_adjusted_s"] == 1.0
    assert t["t_collective_s"] == coll["moved_bytes"] / 450e9
    assert t["dominant"] == "compute" and t["bound_time_s"] == 1.0
    assert t["roofline_fraction"] == 1.0
    assert t["constants"]["card"].startswith("H100 SXM")
    assert (analysis.PEAK_FLOPS, analysis.HBM_BW, analysis.LINK_BW) == (
        989e12, 3.35e12, 450e9)
    # no TPU v5e constant (197e12, 819e9, 50e9) is left in the module
    src = inspect.getsource(analysis)
    for tpu in (r"\b197e12", r"\b819e9", r"(?<!4)50e9", "v5e", "ICI"):
        assert not re.search(tpu, src), tpu


def test_dus_alias_bytes_reads_rebuild_records():
    from repro_torch.roofline.analysis import dus_alias_bytes

    recs = [{"where": "a", "op": "cat", "dtype": "bf16", "shape": [2, 3, 8]},
            {"where": "b", "op": "cat", "dtype": "f32", "shape": [4]}]
    assert dus_alias_bytes(recs) == 2 * (2 * 3 * 8 * 2 + 4 * 4)
    assert dus_alias_bytes([]) == 0
