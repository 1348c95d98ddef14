"""The window keeps an image-to-text family's generator outputs, the port's
decoded ids, by reference: the very tensors the port returned, one a
search row, with tracing off and on, and the port's attribute restored
after. An image family's evaluations keep nothing besides X, F and the
targets."""

from __future__ import annotations

from contextlib import nullcontext

import pytest
import torch

from benchmark.families import family
from benchmark.harness.cell import build_problem, draw_targets, make_weights, sub_seed
from benchmark.harness.drivers import SearchDriver
from benchmark.harness.trace import Tap
from benchmark.tests import tiny
from benchmark.tests.helpers import SEED

CPU = torch.device("cpu")


def _recorded(cfg, tmp_path, trace: bool, returned: list):
    """One recorded generation of a tiny search of `cfg`: the Tap's evals,
    with `returned` collecting what the port's decode returned."""
    from clip_glass_torch.fitness import generator

    traffic = tiny.TRAFFIC["search8"]
    targets = draw_targets(cfg, SEED, 1, tmp_path)
    problem = build_problem(cfg, traffic, make_weights(cfg, SEED, CPU), targets[0],
                            sub_seed(SEED, "search"), CPU)
    tap = Tap(CPU)
    driver = SearchDriver(problem, traffic, targets, sub_seed(SEED, "search"), tap)
    driver.setup()
    original = generator.Generator._decode_rows

    def seen(self, *a, **k):
        out = original(self, *a, **k)
        returned.append(out)
        return out

    generator.Generator._decode_rows = seen
    try:
        tap.recording = True
        with tap.phase("timed") if trace else nullcontext(), \
                tap.capture(getattr(family(cfg), "GENERATOR_OUTPUT", None)):
            driver.advance()
        tap.recording = False
        assert generator.Generator._decode_rows is seen
    finally:
        generator.Generator._decode_rows = original
    return tap.evals


@pytest.mark.parametrize("trace", [False, True])
def test_the_port_decoded_ids_are_kept_by_reference(tmp_path, trace):
    returned = []
    evals = _recorded(tiny.GPT2, tmp_path, trace, returned)
    assert len(evals) == 1 and len(returned) == 1
    X, F, targets, outputs = evals[0]
    assert len(outputs) == 1 and outputs[0] is returned[0]
    s = tiny.GPT2["search"]
    assert outputs[0].shape == (X.shape[0], s["n_var"] + 3 + s["max_tokens_len"])
    assert targets[0].endswith(".png")


@pytest.mark.parametrize("cfg", [tiny.SG2, tiny.BIGGAN], ids=["stylegan2", "biggan"])
def test_an_image_family_records_nothing_extra(tmp_path, cfg):
    assert not hasattr(family(cfg), "GENERATOR_OUTPUT")
    returned = []
    evals = _recorded(cfg, tmp_path, False, returned)
    assert evals and all(len(e) == 4 and e[3] is None for e in evals)
    assert returned == []
    assert evals[0][2] == draw_targets(cfg, SEED, 1, tmp_path)


def test_capture_outside_an_evaluation_keeps_nothing():
    from clip_glass_torch.fitness import generator

    tap = Tap(CPU)
    original = generator.Generator._decode_rows
    with tap.capture(family(tiny.GPT2).GENERATOR_OUTPUT):
        assert generator.Generator._decode_rows is not original
        assert tap._outputs is None
    assert generator.Generator._decode_rows is original
