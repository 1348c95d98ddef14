"""The port's int8 promotion gate (scripts/quant_fidelity_torch.py --gate)
against the JAX package's (scripts/quant_fidelity.py).

- `gate_verdict` is a pure function of the measurements: the port's equals
  the JAX script's on every measurement dict of tests/test_quant_gate.py,
  and both scripts carry the same GATE thresholds.
- `run_gate` end to end on the TINY flagship (CPU, fp32, every conv a call
  site): one JSON line on stdout, every criterion BLOCKED on random weights
  and carrying its measured value.
"""

import argparse
import copy
import importlib.util
import json
import os

import numpy as np
import pytest

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts",
                                                                     f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


qf = _load("quant_fidelity")
qft = _load("quant_fidelity_torch")


def _passing_meas():
    """tests/test_quant_gate.py's measurements that pass every criterion."""
    return {
        "fidelity": {
            "objectives": [{"spearman_per_pop": [0.95, 0.92, 0.93, 0.96],
                            "topk_per_pop": [0.875, 1.0, 0.875, 0.875]}],
            "survival_overlap_per_pop": [0.9, 0.875, 0.9, 0.875],
            "k": 8,
        },
        "ab": {"bf16": [-0.30, -0.32, -0.34, -0.31, -0.33],
               "int8": [-0.31, -0.31, -0.33, -0.32, -0.33]},
        "saturation": {"eligible_sites": 40, "max_ratio": 0.93, "mean_ratio": 0.7},
    }


def _case(name):
    """tests/test_quant_gate.py's variations of the passing measurements."""
    m = _passing_meas()
    if name == "single_fail":
        m["fidelity"]["objectives"][0]["spearman_per_pop"][1] = 0.88
    elif name == "ab_worst_seed":
        m["ab"]["int8"][2] = m["ab"]["bf16"][2] + 0.08
    elif name == "insufficient_samples":
        m["fidelity"]["objectives"][0]["spearman_per_pop"] = [0.99, 0.99]
        m["ab"] = {"bf16": [-0.30, -0.32], "int8": [-0.31, -0.31]}
    elif name == "no_op_config":
        m["saturation"] = {"eligible_sites": 0, "max_ratio": 0.0, "mean_ratio": 0.0}
    elif name == "saturates":
        m["saturation"]["max_ratio"] = 1.2
    elif name == "no_survival":
        m["fidelity"]["survival_overlap_per_pop"] = None
    return m


def test_gate_thresholds_match_jax():
    assert qft.GATE == qf.GATE


@pytest.mark.parametrize("pretrained", [True, False])
@pytest.mark.parametrize("case", ["pass", "single_fail", "ab_worst_seed",
                                  "insufficient_samples", "no_op_config", "saturates",
                                  "no_survival"])
def test_gate_verdict_equals_jax(case, pretrained):
    m = _case(case)
    want = qf.gate_verdict(copy.deepcopy(m), pretrained=pretrained)
    got = qft.gate_verdict(copy.deepcopy(m), pretrained=pretrained)
    assert got == want
    if not pretrained:
        assert got["overall"] == "BLOCKED"
        assert all(c["status"] == "BLOCKED" for c in got["criteria"])


def test_spearman_matches_jax():
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=16), rng.normal(size=16)
    assert qft.spearman(a, b) == qf.spearman(a, b)
    assert qft.spearman(a, a) == 1.0


def test_gate_end_to_end_tiny(capsys):
    from clip_glass_torch.config import get_config
    from clip_glass_torch.models.clip import model as tclip
    from clip_glass_torch.models.stylegan2 import model as tsg2

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = get_config("StyleGAN2_ffhq_d").replace(
            weights="random:0", target="a face", pop_size=8, dim_z=32, n_var=32,
            compute_dtype="float32", quantize_min_ch=1)
        args = argparse.Namespace(pops=2, gate_seeds=2, generations=2)
        v = qft.run_gate(cfg, args, pb_kwargs=dict(device="cpu", clip_cfg=tclip.TINY,
                                                   model_cfg=tsg2.TINY),
                         log=lambda *a, **k: None)
    finally:
        torch.set_num_threads(n)
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and json.loads(out[0]) == v
    assert v["overall"] == "BLOCKED" and v["pretrained"] is False
    assert v["config"] == "StyleGAN2_ffhq_d"
    c = {x["criterion"]: x for x in v["criteria"]}
    assert set(c) == {"rank_fidelity", "selection_fidelity", "outcome_ab",
                      "calibration_saturation"}
    for x in c.values():
        assert x["status"] == "BLOCKED" and x["would"] in ("PASS", "FAIL")
    assert "16 call sites" in c["calibration_saturation"]["detail"]
    assert np.isfinite(c["calibration_saturation"]["measured"])
    assert -1.0 <= c["rank_fidelity"]["measured"] <= 1.0
