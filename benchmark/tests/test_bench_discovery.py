"""The harness finds every configuration, model family, traffic mix, limit
and per-layer reader by name: a throwaway configuration of a throwaway
family, a mix and a metric added as files run without an edit to an
existing file; the tiny benchmark finds each committed cell's stand-in by
its family and traffic kind, so a cell added by files alone needs no edit
of it either."""

from __future__ import annotations

import json
import shutil

import benchmark.families
from benchmark.harness.cell import BENCH, ROOT
from benchmark.tests import tiny
from benchmark.tests.helpers import run_tiny, tiny_bench

# the stand-ins of the committed cells, as the tiny benchmark named them
# before it found them
STOOD_FOR = {"sg2_ffhq_d.serve4": "tiny_sg2.serve2", "sg2_ffhq_d.search16": "tiny_sg2.search8",
             "biggan512.search32": "tiny_biggan.search8"}

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


def _with_added_cells(tmp_path):
    """A copy of the committed benchmark's BENCHMARK.json, configurations,
    mixes and readers, with three cells added as files and entries, each
    listed in every per-layer metric: a GPT-2 search, a second StyleGAN2
    search, and a cell of a family the tiny benchmark lacks."""
    src = tmp_path / "src" / "benchmark"
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(BENCH / sub, src / sub, ignore=shutil.ignore_patterns("__pycache__"))
    for cfg in ({**tiny.GPT2, "name": "gpt2_added"}, {**tiny.SG2, "name": "sg2_added"},
                {**tiny.SG2, "name": "other_added", "family": "no_tiny_family"}):
        (src / "configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
    (src / "traffic" / "added.json").write_text(json.dumps(tiny.TRAFFIC["search8"]))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    added = [{"name": f"{c}.added", "config": c, "traffic": "added", "chips": 1}
             for c in ("gpt2_added", "sg2_added", "other_added")]
    bench["workloads"] += added
    for m in bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] += [w["name"] for w in added]
    (src.parent / "BENCHMARK.json").write_text(json.dumps(bench))
    return src, bench


def test_committed_cells_map_to_the_stand_ins_they_had(tmp_path):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    stands = tiny.stand_ins(bench)
    assert {k: stands[k] for k in STOOD_FOR} == STOOD_FOR
    _, written = tiny_bench(tmp_path)
    for m, w in zip(bench["per_layer"], written["per_layer"]):
        old = [STOOD_FOR[c] for c in m["workloads"] if c in STOOD_FOR]
        assert w["name"] == m["name"] and w["workloads"][:len(old)] == old


def test_tiny_benchmark_finds_stand_ins_of_cells_added_as_files(tmp_path):
    src, bench = _with_added_cells(tmp_path)
    committed = json.loads((ROOT / "BENCHMARK.json").read_text())
    base = tiny.stand_ins(committed)
    assert tiny.stand_ins(bench, src) == {**base, "gpt2_added.added": "tiny_gpt2.search8",
                                          "sg2_added.added": "tiny_sg2.search8"}
    root = tmp_path / "tiny" / "benchmark"
    written = tiny.write(root, src)
    assert json.loads((root.parent / "BENCHMARK.json").read_text()) == written
    assert [w["name"] for w in written["workloads"]] == [w["name"] for w in tiny.WORKLOADS]
    lists = {m["name"]: m["workloads"] for m in committed["per_layer"]}
    for m in written["per_layer"]:
        # the committed cells' stand-ins in their order, then the added
        # cells' that are new to the list: none for the family without one
        mapped = [base[w] for w in lists[m["name"]] if w in base]
        want = list(dict.fromkeys(mapped + ["tiny_gpt2.search8", "tiny_sg2.search8"]))
        assert m["workloads"] == want, m["name"]
        assert (root / "metrics" / f"{m['name']}.py").is_file()
