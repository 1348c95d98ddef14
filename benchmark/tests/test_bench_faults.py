"""The output check catches a broken timed path: each fault a cell can have
is planted underneath a whole run on the CPU (the card's look skipped), and
`correct` comes out false. The control, the reference with fp8 operands in
the port's place (for image to text, decoding its own ids in e4m3), fails
the limits too."""

from __future__ import annotations

import pytest
import torch

from benchmark.harness.check import judge
from benchmark.tests.helpers import committed, run_tiny, tiny_bench

CELLS = ["tiny_sg2.search8", "tiny_sg2.serve2", "tiny_biggan.search8", "tiny_gpt2.search8",
         "tiny_gpt2.serve2"]


def _on_fitness(monkeypatch, change):
    """`change(F)` on the fitness [rows, n_obj] of every batch, where it is
    made: the image families' `_eval_batch` and image to text's
    `_eval_img2txt` (F [K, pop, 1])."""
    from clip_glass_torch.fitness import generator

    for name in ("_eval_batch", "_eval_img2txt"):
        original = getattr(generator.Generator, name)

        def planted(self, X, *a, original=original, **k):
            F = original(self, X, *a, **k).clone()
            change(F.view(-1, F.shape[-1]))
            return F

        monkeypatch.setattr(generator.Generator, name, planted)


def _altered_answer(monkeypatch):
    """One row of every evaluation's fitness altered where it is made."""
    def altered(F):
        F[0, 0] += 0.05

    _on_fitness(monkeypatch, altered)


def _half_batch(monkeypatch):
    """Half of every evaluation's rows scored, the other half given their
    fitness."""
    def half(F):
        n = F.shape[0] // 2
        F[n:] = F[:F.shape[0] - n].clone()

    _on_fitness(monkeypatch, half)


def _unchanged_state(monkeypatch):
    """A step that returns its state unchanged."""
    from clip_glass_torch.evolve import algorithm, batched

    monkeypatch.setattr(algorithm, "make_step",
                        lambda *a, **k: (lambda state, gen: state))
    monkeypatch.setattr(batched.BatchedAlgorithm, "step", lambda self, state, gens: state)


FAULTS = {"altered_answer": (_altered_answer, "sim_gap"),
          "half_batch": (_half_batch, "sim_gap"),
          "unchanged_state": (_unchanged_state, "moved_rows")}


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_fault_makes_the_run_incorrect(tmp_path, monkeypatch, cell, fault):
    root, bench = tiny_bench(tmp_path)
    plant, number = FAULTS[fault]
    plant(monkeypatch)
    run = run_tiny(root, bench, cell)
    assert not run.correct
    assert not run.checks[number]["ok"]


@pytest.mark.parametrize("cell", ["tiny_gpt2.search8", "tiny_gpt2.serve2"])
def test_a_swapped_decoded_token_fails_the_decode_margin(tmp_path, monkeypatch, cell):
    """At the fifth step of every decode, the first row takes its
    lowest-logit token: the reference, teacher-forced on the port's ids,
    finds that step's token far below its best."""
    from clip_glass_torch.models.gpt2 import model as g2

    original, calls = g2._select_next, []

    def swapped(logits, *a, **k):
        tok = original(logits, *a, **k)
        calls.append(None)
        if len(calls) % 30 == 5:
            tok = tok.clone()
            tok[0] = logits[0].float().argmin()
        return tok

    monkeypatch.setattr(g2, "_select_next", swapped)
    root, bench = tiny_bench(tmp_path)
    run = run_tiny(root, bench, cell)
    assert calls and not run.correct
    assert not run.checks["decode_margin"]["ok"]
    assert run.values["decode_margin"] > 1.0


@pytest.mark.parametrize("cell", CELLS)
def test_the_sound_run_is_correct(tmp_path, cell):
    root, bench = tiny_bench(tmp_path)
    assert run_tiny(root, bench, cell).correct


@pytest.mark.parametrize("cell", CELLS)
def test_the_fp8_control_fails_the_limits(tmp_path, cell):
    root, bench = tiny_bench(tmp_path)
    run = run_tiny(root, bench, cell, controls=("fp8",))
    assert run.correct
    limits = {k: {"max": c["limit"]} for k, c in run.checks.items() if k != "moved_rows"}
    assert not all(c["ok"] for c in judge(run.controls["fp8"], limits).values())


@pytest.mark.parametrize("name", [w["name"] for w, _, _ in committed()])
def test_one_altered_row_in_a_committed_cells_sample_fails_its_limits(name):
    """An answer altered by 0.05 in one row of all that a committed cell
    checks a run fails its limits, all the other rows exact: no number
    compared dilutes one row below its limit."""
    from benchmark.harness.cell import BENCH, load_json
    from benchmark.harness.check import summarize

    traffic = next(t for w, _, t in committed() if w["name"] == name)
    limits = load_json(BENCH / "limits" / f"{name}.json")
    rows = traffic["check_evaluations"] * traffic["pop"] * traffic.get("slots", 1)
    gaps = {"sim": torch.zeros(rows, dtype=torch.float64)}
    gaps["sim"][rows // 2] = 0.05
    checks = judge({**summarize(gaps), "moved_rows": 1}, limits)
    assert not all(c["ok"] for k, c in checks.items() if k.startswith("sim"))


def test_the_control_at_the_cells_size_fails_the_committed_limits(card):
    """On the card: each committed cell's control, at the cell's size and
    load with a short window, fails one of the committed limits while the
    port passes them (benchmark/tools/readings.py reads a dozen seeds)."""
    import json
    import time

    from benchmark.harness.cell import ROOT, run_cell

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for workload in bench["workloads"]:
        run = run_cell(bench, workload, 2 ** 31 + 777, 3.0, False, time.perf_counter(), card,
                       log=lambda s: None, controls=("fp8",))
        assert run.correct, (workload["name"], run.checks)
        limits = json.loads((ROOT / "benchmark" / "limits" / f"{workload['name']}.json")
                            .read_text())
        assert not all(c["ok"] for c in judge(run.controls["fp8"], limits).values())


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card: pytest -m gpu benchmark/tests)")
    return torch.device("cuda", 0)


test_the_control_at_the_cells_size_fails_the_committed_limits = pytest.mark.gpu(
    test_the_control_at_the_cells_size_fails_the_committed_limits)
