"""The result line: its keys and their shapes, untraced and traced, and a
run without a card that prints nothing and exits non-zero."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from benchmark.harness.cell import ROOT, result_line
from benchmark.tests.helpers import run_tiny, tiny_bench


def test_untraced_line_has_the_contract_keys_with_checks_last(tmp_path):
    root, bench = tiny_bench(tmp_path)
    line = result_line(run_tiny(root, bench, "tiny_sg2.search8"))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {"cand_per_s", "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in line["metrics"].values())
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())
    json.dumps(line)


def test_traced_line_carries_the_window_and_a_breakdown(tmp_path):
    root, bench = tiny_bench(tmp_path)
    line = result_line(run_tiny(root, bench, "tiny_sg2.serve2", trace=True))
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(len(v) <= 10 for v in line["breakdown"].values())
    assert "cand_per_s" not in line["metrics"]
    assert line["metrics"]["serve.occupancy"]["value"] == 1.0
    assert line["metrics"]["search.host_ms_per_gen"]["value"] > 0


def test_without_a_card_run_prints_no_result_and_exits_non_zero():
    if torch.cuda.is_available():
        pytest.skip("this process sees a CUDA card")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "sg2_ffhq_d.search16", "--seed", "5", "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
