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
