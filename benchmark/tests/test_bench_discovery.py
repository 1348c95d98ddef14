"""The harness finds every configuration, model family, traffic mix, limit
and per-layer reader by name: a throwaway configuration of a throwaway
family, a mix and a metric added as files run without an edit to an
existing file."""

from __future__ import annotations

import json

import benchmark.families
from benchmark.tests import tiny
from benchmark.tests.helpers import run_tiny, tiny_bench

READER = '''"""tiny.units: the window's generations or ticks a second."""


def read(ctx):
    return ctx["rate"] if ctx["rate"] > 0 else None
'''


FAMILY = '''"""A throwaway family: StyleGAN2's, under another name."""

from benchmark.families.stylegan2 import (block_rows, flops_per_candidate,  # noqa: F401
                                          make_weights, model_config, score, targets)
'''


def test_added_config_family_mix_and_metric_run_without_edits(tmp_path, monkeypatch):
    root, bench = tiny_bench(tmp_path)
    families = tmp_path / "families"
    families.mkdir()
    (families / "tiny_added.py").write_text(FAMILY)
    monkeypatch.setattr(benchmark.families, "__path__",
                        list(benchmark.families.__path__) + [str(families)])
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    cfg = {**tiny.SG2, "name": "tiny_sg2_added", "family": "tiny_added"}
    (root / "configs" / "tiny_sg2_added.json").write_text(json.dumps(cfg))
    (root / "traffic" / "search4.json").write_text(json.dumps(
        {**tiny.TRAFFIC["search8"], "pop": 4}))
    (root / "limits" / "tiny_sg2_added.search4.json").write_text(json.dumps(tiny.LIMITS))
    (root / "metrics" / "tiny.units.py").write_text(READER)
    workload = {"name": "tiny_sg2_added.search4", "config": "tiny_sg2_added",
                "traffic": "search4", "chips": 1}
    bench = {**bench, "workloads": bench["workloads"] + [workload],
             "per_layer": bench["per_layer"] + [
                 {"name": "tiny.units", "unit": "cand/s", "better": "higher",
                  "source": "host_clock", "layer": "search driver", "moves": "cand_per_s",
                  "workloads": [workload["name"]]}]}
    run = run_tiny(root, bench, workload["name"], trace=True)
    assert run.correct
    assert run.metrics["tiny.units"]["value"] > 0
    # a per-layer metric that lists cells is read in those cells alone
    other = run_tiny(root, bench, "tiny_sg2.search8", trace=True)
    assert "tiny.units" not in other.metrics
    assert all(p.read_bytes() == b for p, b in before.items())


def test_every_committed_cell_names_files_that_exist():
    from benchmark.harness.cell import BENCH, ROOT

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for cfg in bench["configs"]:
        assert (ROOT / cfg["file"]).is_file()
        data = json.loads((ROOT / cfg["file"]).read_text())
        assert data["name"] == cfg["name"]
        assert (BENCH / "families" / f"{data['family']}.py").is_file()
    for w in bench["workloads"]:
        assert (BENCH / "configs" / f"{w['config']}.json").is_file()
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (BENCH / "limits" / f"{w['name']}.json").is_file()
    for m in bench["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
