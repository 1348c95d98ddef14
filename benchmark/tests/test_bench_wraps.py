"""A traced run wraps the harness's own layer functions in every cell and,
beside them, those the cell's model family declares (GPT-2's decode and
CLIP's text tower); the image families declare none, so their cells wrap
the four functions they always did; every wrapped attribute is the port's
own again once a phase ends."""

from __future__ import annotations

import importlib

import pytest
import torch

from benchmark.families import family
from benchmark.harness import cell
from benchmark.harness.trace import LAYER_FUNCTIONS, Tap
from benchmark.tests import tiny
from benchmark.tests.helpers import committed, run_tiny, tiny_bench

CPU = torch.device("cpu")
# what every cell's traced phases wrapped before a family could add to it
HARNESS = {("clip_glass_torch.models.stylegan2.model", "generator_apply"),
           ("clip_glass_torch.models.biggan.model", "apply"),
           ("clip_glass_torch.models.clip.model", "encode_image"),
           ("clip_glass_torch.models.stylegan2.model", "discriminator_apply")}
GPT2 = {("clip_glass_torch.models.gpt2.model", "sample_sequence", "models.G"),
        ("clip_glass_torch.models.clip.model", "encode_text", "models.CLIP")}
WRAPPABLE = {(m, a) for m, a, _ in LAYER_FUNCTIONS} | {(m, a) for m, a, _ in GPT2}


def _originals() -> dict:
    return {(m, a): getattr(importlib.import_module(m), a) for m, a in WRAPPABLE}


def _replaced_in(tap: Tap, mode: str) -> set:
    """The (module, function) pairs that `tap.phase(mode)` replaces; each
    is checked to be the original again after the phase."""
    originals = _originals()
    with tap.phase(mode):
        inside = {k for k, f in originals.items()
                  if getattr(importlib.import_module(k[0]), k[1]) is not f}
    assert _originals() == originals
    return inside


def test_the_harness_wraps_are_the_four_it_always_had():
    assert {(m, a) for m, a, _ in LAYER_FUNCTIONS} == HARNESS


@pytest.mark.parametrize("cfg", [tiny.SG2, tiny.BIGGAN], ids=["stylegan2", "biggan"])
def test_an_image_family_declares_no_wraps(cfg):
    assert not hasattr(family(cfg), "LAYER_FUNCTIONS")


def test_gpt2_declares_its_decode_and_text_tower():
    assert set(family(tiny.GPT2).LAYER_FUNCTIONS) == GPT2


@pytest.mark.parametrize("name", [w["name"] for w, _, _ in committed()])
@pytest.mark.parametrize("mode", ["timed", "profiled"])
def test_a_committed_cells_phases_wrap_the_harness_four_and_its_familys(name, mode):
    config = next(c for w, c, _ in committed() if w["name"] == name)
    declared = getattr(family(config), "LAYER_FUNCTIONS", ())
    tap = Tap(CPU, declared)
    assert _replaced_in(tap, mode) == HARNESS | {(m, a) for m, a, _ in declared}


def test_a_traced_gpt2_run_spans_its_decode_and_text_tower(tmp_path, monkeypatch):
    taps = []

    class Kept(Tap):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            taps.append(self)

    monkeypatch.setattr(cell, "Tap", Kept)
    originals = _originals()
    root, bench = tiny_bench(tmp_path)
    run = run_tiny(root, bench, "tiny_gpt2.search8", trace=True)
    assert run.correct
    assert len(taps) == 1 and set(taps[0].layers) == set(LAYER_FUNCTIONS) | GPT2
    spans = [n for *_, n in taps[0].host]
    # one decode and one text tower an evaluation, the profiled phase's one
    assert spans.count("models.G") == spans.count("models.CLIP") == spans.count("fitness.eval")
    assert spans.count("fitness.eval") == tiny.TRAFFIC["search8"]["profile_units"]
    assert _originals() == originals
