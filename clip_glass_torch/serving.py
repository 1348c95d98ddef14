"""Continuous-batching search serving: a fixed-slot server over the
multi-search batched engine (evolve/batched.py).

The reference serves one target per process (reference run.py:22): a new
prompt pays a fresh process and model load. Here K slots stay resident and
advance together, each generation one batched evaluation of all K
populations; requests queue, and a finished slot is refilled with the next
request by overwriting its row of the target features, the population, the
fitness and its generator. This is the JAX package's `serving.py` in plain
eager PyTorch: its donated and fused programs exist for the TPU's per-program
round trip and have no counterpart here.

Semantics: the request admitted with ticket t equals an independent
`evolve.minimize` of the same config with its target and the generator
`search_generator(seed, t)` (tests/test_torch_serving.py), up to the
evaluation batch's summation order. Slots advance `chunk` generations a
tick; a request's `n_gen` rounds up to a multiple of `chunk`. An idle slot
(queue drained) keeps evolving its previous target and that work is counted
in `total_evals`, as in the JAX package; `stats.occupancy` is the useful
share. Skipping idle slots is open work (ROADMAP.md, under item 7).

Scale-out: `mesh` (parallel.mesh) splits the slots over its row blocks,
whole searches a block (n_slots must divide over them), so that a tick's
evaluation moves only its fitness rows between cards; the weights go to
each card once. The GA state stays whole on the mesh's first card.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Dict, List, Optional, Sequence

import torch

from clip_glass_torch.evolve.algorithm import GAState, Result, extract_result
from clip_glass_torch.evolve.batched import make_batched, search_generator, slice_state


@dataclasses.dataclass
class _Slot:
    ticket: Optional[int] = None   # None: idle (evolving a stale target)
    remaining: int = 0             # generations left before harvest


@dataclasses.dataclass
class ServerStats:
    ticks: int = 0                 # chunks advanced
    completed: int = 0             # requests harvested
    useful_evals: int = 0          # candidate evaluations on occupied slots
    total_evals: int = 0           # including the idle slots' work
    # the admitted requests' initial populations (scored, but kept out of
    # useful_evals so that rates compare with the steady state)
    admission_evals: int = 0

    @property
    def occupancy(self) -> float:
        return self.useful_evals / self.total_evals if self.total_evals else 0.0


class SearchServer:
    """Fixed-slot continuous-batching server for one config and weight set.

    >>> server = SearchServer(problem, n_slots=4, chunk=25)
    >>> t0 = server.submit("a red flower", n_gen=200)
    >>> server.run()                     # pump until queue and slots drain
    >>> server.results[t0].pop_X         # == an independent search's

    `submit` is thread-safe (a driving thread may pump `run(forever=True)`
    while request threads submit); everything else belongs to the pumping
    thread.
    """

    def __init__(self, problem, n_slots: int, chunk: int = 25, seed: int = 0,
                 search_microbatch: Optional[int] = None, mesh=None):
        if n_slots < 1 or chunk < 1:
            raise ValueError("n_slots and chunk must be >= 1")
        if mesh is not None and n_slots % mesh.dp:
            raise ValueError(f"n_slots {n_slots} must divide over the mesh's "
                             f"{mesh.dp} row blocks")
        self.mesh = mesh
        self.problem = problem
        self.chunk = int(chunk)
        self.seed = int(seed)
        # every slot starts on the problem's own target, a placeholder that
        # an admission overwrites
        self.balgo = make_batched(problem, [problem.config.target] * n_slots,
                                  search_microbatch=search_microbatch, mesh=mesh)
        self._gens = self.balgo.generators(self.seed)
        self.state: GAState = self.balgo.init(self._gens)
        self._slots = [_Slot() for _ in range(n_slots)]
        self._queue: collections.deque = collections.deque()
        self._lock = threading.Lock()
        self._next_ticket = 0
        self._stop = False
        self.results: Dict[int, Result] = {}
        self.meta: Dict[int, str] = {}   # ticket -> target, set in submit()
        self.stats = ServerStats()

    # ---------------------------------------------------------------- API

    @property
    def n_slots(self) -> int:
        return len(self._slots)

    def submit(self, target: str, n_gen: int) -> int:
        """Queue a search request and return its ticket. `n_gen` rounds up
        to a multiple of `chunk`. Thread-safe; the target is in
        `meta[ticket]` before the request can be admitted."""
        if n_gen < 1:
            raise ValueError("n_gen must be >= 1")
        n_eff = -(-n_gen // self.chunk) * self.chunk
        with self._lock:
            ticket = self._next_ticket
            self._next_ticket += 1
            self.meta[ticket] = target
            self._queue.append((ticket, target, n_eff))
        return ticket

    def pending(self) -> int:
        with self._lock:
            return len(self._queue)

    def active(self) -> int:
        return sum(s.ticket is not None for s in self._slots)

    def tick(self) -> bool:
        """Free the slots that finished on the previous tick, admit queued
        requests into free slots, advance every slot `chunk` generations,
        and only then copy the finished slots' populations to the host.
        Returns False when there was nothing to do."""
        harvest = []
        for i, slot in enumerate(self._slots):
            if slot.ticket is not None and slot.remaining <= 0:
                # the rows of the state before this tick: the step makes new
                # tensors, so these views keep the finished populations
                harvest.append((slot.ticket, slice_state(self.state, i)))
                slot.ticket, slot.remaining = None, 0
        self._admit()
        occupied = self.active()
        if occupied:
            for _ in range(self.chunk):
                self.state = self.balgo.step(self.state, self._gens)
            self.stats.ticks += 1
            per_slot = self.balgo.pop_size * self.chunk
            self.stats.useful_evals += occupied * per_slot
            self.stats.total_evals += self.n_slots * per_slot
            for slot in self._slots:
                if slot.ticket is not None:
                    slot.remaining -= self.chunk
        for ticket, s in harvest:
            self.results[ticket] = extract_result(s.X.cpu(), s.F.cpu(), self.balgo.algorithm, s)
            self.stats.completed += 1
        return bool(occupied or harvest)

    def run(self, forever: bool = False) -> None:
        """Tick until the queue and all slots drain, or with forever=True
        until `stop()` (waiting on an empty queue for other threads'
        submits). With forever=False a submit racing the final empty-queue
        check may stay queued for a later run(); mix concurrent submits with
        forever=True and stop()."""
        self._stop = False
        while not self._stop:
            if self.tick():
                continue
            if not forever:
                with self._lock:
                    if not self._queue:
                        return
            else:
                time.sleep(0.005)

    def stop(self) -> None:
        self._stop = True

    def map(self, targets: Sequence[str], n_gen: int) -> List[Result]:
        """Submit all `targets`, run to completion, return the results in
        submission order."""
        tickets = [self.submit(t, n_gen) for t in targets]
        self.run()
        return [self.results[t] for t in tickets]

    # ----------------------------------------------------------- internals

    @torch.inference_mode()
    def _admit(self) -> None:
        """Pop queued requests into free slots: their targets encoded in one
        CLIP call, each population sampled from its ticket's generator
        (`Algorithm.init`'s draws), all of them evaluated in one batched
        call, and the rows written into the slots."""
        free = [i for i, s in enumerate(self._slots) if s.ticket is None]
        picked = []
        with self._lock:
            while self._queue and len(picked) < len(free):
                picked.append(self._queue.popleft())
        if not picked:
            return
        balgo = self.balgo
        feats = self.problem.generator.encode_targets([tgt for _, tgt, _ in picked])
        gens = [search_generator(self.seed, t, balgo.device) for t, _, _ in picked]
        X0 = torch.stack([balgo.sample(g) for g in gens])
        F0 = balgo.evaluate(X0, feats, balgo.draw_seeds(gens))
        self.stats.admission_evals += len(picked) * balgo.pop_size
        idx = free[:len(picked)]
        # new tensors: views taken for harvest keep the old rows
        X, F, targets = self.state.X.clone(), self.state.F.clone(), balgo.targets.clone()
        gen = list(self.state.gen)
        for j, (i, (ticket, _, n_gen)) in enumerate(zip(idx, picked)):
            X[i], F[i], targets[i], gen[i] = X0[j], F0[j], feats[j], 0
            self._gens[i] = gens[j]
            self._slots[i].ticket, self._slots[i].remaining = ticket, n_gen
        self.state = GAState(X, F, tuple(gen))
        balgo.targets = targets
