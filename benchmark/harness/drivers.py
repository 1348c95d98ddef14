"""The one general driver of the timed entries, read by a traffic file's
parameters (`benchmark/traffic/<mix>.json`):

- "search": one search of the port, as `run_torch.py` runs it without its
  dumps: `GenerationProblem.make_algorithm()`, its `init`, then its
  `step_fn()` eagerly, one generation a call. Keys: `pop`,
  `warmup_generations`.
- "serve": the port's `SearchServer` with `slots` slots and `chunk`
  generations a tick. `requests` requests of `generations` generations
  each, with distinct targets, are submitted in set-up; the first `slots`
  are admitted there, the rest queue behind them and are admitted as slots
  free; the window ticks the server. Keys: `pop`, `slots`, `chunk`,
  `requests`, `generations`, `warmup_ticks`.

Every driver advances in whole units (a generation, a tick) and says how
many useful candidates each unit scored, where the window's populations
stand and which target each search of an evaluation is scored against, for
the output check. A target is what the run drew (harness/cell.py's
`draw_targets`): a text prompt, or an image file's path for an
image-to-text family; the driver hands it to the port as it is.
"""

from __future__ import annotations

from typing import List

import torch


class SearchDriver:
    """One search: a unit is one generation of `pop` candidates."""

    def __init__(self, problem, traffic: dict, targets: List[str], seed: int, tap):
        self.problem = problem
        self.pop = traffic["pop"]
        self.warmup = traffic["warmup_generations"]
        self.targets = targets[:1]
        algorithm = problem.make_algorithm()
        algorithm.eval_fn = tap.wrap_eval(algorithm.eval_fn, self.search_targets)
        self.generator = algorithm.generator(seed)
        self.state = algorithm.init(self.generator)
        self._step = tap.wrap_step(algorithm.step_fn())

    def setup(self) -> None:
        for _ in range(self.warmup):
            self.advance()

    def advance(self) -> int:
        self.state = self._step(self.state, self.generator)
        return self.pop

    def population(self) -> torch.Tensor:
        """X of every search [K, pop, n_var]."""
        return self.state.X[None]

    def search_targets(self) -> List[str]:
        """The target of each search, in the order of the evaluations' rows."""
        return self.targets

    def counters(self) -> dict:
        return {}

    def close(self) -> None:
        self.state = self._step = self.generator = None


class ServeDriver:
    """The search server, fully occupied: a unit is one tick of `chunk`
    generations of every slot; useful candidates are the occupied slots'."""

    def __init__(self, problem, traffic: dict, targets: List[str], seed: int, tap):
        from clip_glass_torch.serving import SearchServer

        self.traffic = traffic
        self.server = SearchServer(problem, n_slots=traffic["slots"], chunk=traffic["chunk"],
                                   seed=seed)
        balgo = self.server.balgo
        # the server's generation steps evaluate with targets=None; an
        # admission hands its new requests' targets and is not checked
        balgo.evaluate = tap.wrap_eval(balgo.evaluate, self.search_targets,
                                       checked=lambda X, targets=None, seeds=None: targets is None)
        balgo.step = tap.wrap_step(balgo.step)
        self.targets = targets[:traffic["requests"]]
        self._held = [None] * traffic["slots"]

    def setup(self) -> None:
        for t in self.targets:
            self.server.submit(t, self.traffic["generations"])
        for _ in range(self.traffic["warmup_ticks"]):
            self.server.tick()

    def advance(self) -> int:
        before = self.server.stats.useful_evals
        self.server.tick()
        return self.server.stats.useful_evals - before

    def population(self) -> torch.Tensor:
        return self.server.state.X

    def search_targets(self) -> List[str]:
        """Each slot's target as the evaluation being made sees it: the
        request it holds, or the last it held (an idle slot keeps evolving
        its last target)."""
        for i, slot in enumerate(self.server._slots):
            if slot.ticket is not None:
                self._held[i] = slot.ticket
        if None in self._held:
            raise RuntimeError("a slot never held a request: the traffic must fill every "
                               "slot in set-up")
        return [self.server.meta[t] for t in self._held]

    def counters(self) -> dict:
        """The server's counters (ServerStats) as they stand."""
        return dict(vars(self.server.stats))

    def close(self) -> None:
        self.server = None


DRIVERS = {"search": SearchDriver, "serve": ServeDriver}
