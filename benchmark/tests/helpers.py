"""Shared pieces of the benchmark's CPU tests: the committed cells, the tiny
benchmark written into a temporary directory, and one run of one of its
cells on the CPU."""

from __future__ import annotations

import json
import time

import torch

from benchmark.harness.cell import BENCH, ROOT, load_json, run_cell
from benchmark.tests import tiny

SEED = 2 ** 31 + 12345   # above 32 signed bits, as the driver's seeds are


def tiny_bench(tmp_path):
    root = tmp_path / "benchmark"
    return root, tiny.write(root)


def run_tiny(root, bench, name: str, seed: int = SEED, trace: bool = False, **kw):
    workload = next(w for w in bench["workloads"] if w["name"] == name)
    return run_cell(bench, workload, seed, 0.3, trace, time.perf_counter(),
                    torch.device("cpu"), bench_dir=root, log=lambda s: None, **kw)


def committed() -> list:
    """(workload, configuration, traffic) of each cell of BENCHMARK.json."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    return [(w, load_json(BENCH / "configs" / f"{w['config']}.json"),
             load_json(BENCH / "traffic" / f"{w['traffic']}.json")) for w in bench["workloads"]]
