"""The inputs a run makes come from its seed alone: the same seed gives the
same targets (prompts or image files), weights and search, another seed
other ones; the committed cells' prompts are those they had before the
target hook."""

from __future__ import annotations

import random

import numpy as np
import pytest
import torch

from benchmark.families import family
from benchmark.harness import prompts
from benchmark.harness.cell import build_problem, draw_targets, make_weights, sub_seed
from benchmark.harness.drivers import SearchDriver, ServeDriver
from benchmark.harness.trace import Tap
from benchmark.tests import tiny
from benchmark.tests.helpers import SEED, committed

CPU = torch.device("cpu")


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    values = tree.values() if isinstance(tree, dict) else tree
    return [t for v in values for t in _leaves(v)]


def test_sub_seeds_are_fixed_and_distinct():
    assert sub_seed(SEED, "weights") == sub_seed(SEED, "weights")
    assert sub_seed(SEED, "weights") != sub_seed(SEED, "search")
    assert sub_seed(SEED, "weights") != sub_seed(SEED + 1, "weights")
    assert 0 <= sub_seed(2 ** 40, "x") < 2 ** 63


def test_prompts_repeat_per_seed_and_are_distinct_ascii():
    a = prompts.draw(random.Random(sub_seed(SEED, "prompts")), 4)
    assert a == prompts.draw(random.Random(sub_seed(SEED, "prompts")), 4)
    assert a != prompts.draw(random.Random(sub_seed(SEED + 1, "prompts")), 4)
    assert len(set(a)) == 4 and all(p.isascii() for p in a)


@pytest.mark.parametrize("name", [w["name"] for w, cfg, _ in committed()
                                  if not hasattr(family(cfg), "draw_targets")])
def test_a_committed_cells_targets_are_the_prompts_it_drew_before(tmp_path, name):
    """A family without `draw_targets` gets prompts.draw on the seed's
    "prompts" stream: byte for byte the prompts of the harness before the
    hook, for several seeds, and no file is written."""
    config, traffic = next((c, t) for w, c, t in committed() if w["name"] == name)
    n = traffic.get("requests", 1)
    for seed in (SEED, 0, 7, 2 ** 40 + 3):
        got = draw_targets(config, seed, n, tmp_path)
        want = prompts.draw(random.Random(sub_seed(seed, "prompts")), n)
        assert [t.encode() for t in got] == [t.encode() for t in want]
    assert not any(tmp_path.iterdir())


def test_image_targets_repeat_per_seed(tmp_path):
    """An image-to-text family's targets: PNG files of uint8 pixels at
    CLIP's input size, distinct, byte for byte the same for the same seed
    and other for another."""
    from PIL import Image

    dirs = [tmp_path / d for d in ("a", "b", "c")]
    paths = []
    for d, seed in zip(dirs, (SEED, SEED, SEED + 1)):
        d.mkdir()
        paths.append(draw_targets(tiny.GPT2, seed, 3, d))
    read = [[open(p, "rb").read() for p in ps] for ps in paths]
    assert read[0] == read[1] and read[0] != read[2] and len(set(read[0])) == 3
    size = tiny.GPT2["clip"]["image_resolution"]
    for p in paths[0]:
        with Image.open(p) as im:
            assert im.format == "PNG" and im.size == (size, size) and im.mode == "RGB"
            pixels = np.asarray(im)
        assert pixels.dtype == np.uint8 and pixels.std() > 0


def test_weights_repeat_per_seed():
    for cfg in (tiny.SG2, tiny.BIGGAN, tiny.GPT2):
        a, b = make_weights(cfg, SEED, CPU), make_weights(cfg, SEED, CPU)
        c = make_weights(cfg, SEED + 1, CPU)
        la, lb, lc = _leaves(a), _leaves(b), _leaves(c)
        assert all(torch.equal(x, y) for x, y in zip(la, lb))
        assert not all(torch.equal(x, y) for x, y in zip(la, lc))


def test_searches_repeat_per_seed():
    for driver_cls, traffic in ((SearchDriver, tiny.TRAFFIC["search8"]),
                                (ServeDriver, tiny.TRAFFIC["serve2"])):
        pops = []
        for seed in (SEED, SEED, SEED + 1):
            texts = prompts.draw(random.Random(sub_seed(seed, "prompts")),
                                 traffic.get("requests", 1))
            problem = build_problem(tiny.SG2, traffic, make_weights(tiny.SG2, seed, CPU),
                                    texts[0], sub_seed(seed, "search"), CPU)
            driver = driver_cls(problem, traffic, texts, sub_seed(seed, "search"), Tap(CPU))
            driver.setup()
            driver.advance()
            pops.append(driver.population().clone())
        assert torch.equal(pops[0], pops[1])
        assert not torch.equal(pops[0], pops[2])
