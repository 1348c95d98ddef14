"""The inputs a run makes come from its seed alone: the same seed gives the
same prompts, weights and search, another seed other ones."""

from __future__ import annotations

import random

import torch

from benchmark.harness import prompts
from benchmark.harness.cell import build_problem, make_weights, sub_seed
from benchmark.harness.drivers import SearchDriver, ServeDriver
from benchmark.harness.trace import Tap
from benchmark.tests import tiny
from benchmark.tests.helpers import SEED

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


def test_weights_repeat_per_seed():
    for cfg in (tiny.SG2, tiny.BIGGAN):
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
