"""Multi-search batching: K searches of one config and weight set, each with
its own target, evaluated as one batch.

The reference serves one target per process (reference run.py:22). Here K
searches share the problem's weights and run each generation as: every
search's `vary` half (selection, crossover, mutation, duplicate resampling)
with its own generator, one evaluation of all K·pop offspring
(`Generator.eval_population_batched`: G and CLIP at K·pop, the cosine per
search, D's minibatch-std groups per search), then every search's
`survive` half. A stochastic fitness (GPT-2's sampled decode) gets one seed a
search, drawn from that search's generator after its `vary` (its `init`
after the sampling), as `Algorithm`'s step draws it. Search i of a batch is
an independent search with target i
and generator `search_generator(seed, i)`, as the JAX package's
`evolve/batched.py` holds its batch to independent runs; the evaluation
batch differs, so the fitness agrees to the convolutions' summation order,
not bitwise.

`search_microbatch` evaluates the searches in chunks of that many (it must
divide K): the activations are those of one chunk; the results are the
same. For GPT-2 it groups the decodes instead, and when not given takes
`_auto_search_microbatch(K)`, the JAX package's rule.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, List, Optional, Sequence, Union

import torch

from clip_glass_torch.evolve.algorithm import (Algorithm, GAState, Result, draw_seed,
                                               extract_result, make_step_halves)
from clip_glass_torch.parallel import distributed as dist

# the 64-bit golden-ratio constant: odd, so in its low 32 bits too, and
# index -> seed + index * stride is a bijection modulo 2**32 and 2**64
SEED_STRIDE = 0x9E3779B97F4A7C15


def search_seed(seed: int, index: int) -> int:
    """The seed of search (or serving ticket) `index` of a run seeded `seed`:
    (seed + index * SEED_STRIDE) mod 2**64. Search 0 gets `seed` itself, so
    a batch of one searches as the single-search `Algorithm.generator(seed)`.
    CUDA's Philox generator reads all 64 bits of a seed, the CPU's
    Mersenne Twister the low 32, where the stride is odd too: the indexes
    0 .. 2**32 - 1 of one seed give distinct seeds on both. The JAX
    package's `split` / `fold_in` streams are not reproduced."""
    return (seed + index * SEED_STRIDE) % 2 ** 64


def search_generator(seed: int, index: int, device) -> torch.Generator:
    """Search `index`'s own generator on `device`, seeded `search_seed`."""
    return torch.Generator(device=torch.device(device)).manual_seed(search_seed(seed, index))


def slice_state(state: GAState, i: int) -> GAState:
    """Search i of a batched state."""
    return GAState(state.X[i], state.F[i], state.gen[i])


def stack_states(states: Sequence[GAState]) -> GAState:
    """K single-search states -> one batched state: X [K, pop, n_var],
    F [K, pop, n_obj], gen a tuple of K ints."""
    return GAState(torch.stack([s.X for s in states]), torch.stack([s.F for s in states]),
                   tuple(int(s.gen) for s in states))


def _auto_search_microbatch(K: int) -> Optional[int]:
    """The JAX package's default decode grouping for batched GPT-2
    (batched.py:222-238): the largest proper divisor of K, None when K < 4
    or K is prime. Its reason there is that group g+1's decode overlaps
    group g's host round trip; the port's eager decode overlaps nothing
    (Generator._eval_img2txt), so here it bounds the KV cache only."""
    if K < 4:
        return None
    for p in range(2, int(K ** 0.5) + 1):
        if K % p == 0:
            return K // p
    return None


@dataclasses.dataclass
class BatchedAlgorithm:
    """K searches of `base`'s operators, population and algorithm, scored by
    `generator` (the problem's fitness.generator.Generator) against one
    row of `targets` [K, D] each. States carry a leading search axis.
    `mesh` (parallel.mesh): the evaluations split their rows over it, and
    every rank steps the whole state, as `minimize` does."""
    base: Algorithm
    generator: object
    targets: torch.Tensor
    search_microbatch: Optional[int] = None
    mesh: object = None

    def __post_init__(self):
        smb = self.search_microbatch
        if smb is not None and (smb < 1 or self.n_search % min(smb, self.n_search)):
            raise ValueError(f"search_microbatch {smb} must divide n_search {self.n_search}")

    @property
    def n_search(self) -> int:
        return self.targets.shape[0]

    @property
    def pop_size(self) -> int:
        return self.base.pop_size

    @property
    def algorithm(self) -> str:
        return self.base.algorithm

    @property
    def device(self) -> torch.device:
        return self.base.device

    @functools.cached_property
    def _halves(self):
        return make_step_halves(self.base.ops, self.pop_size, self.algorithm)

    def generators(self, seed: int) -> List[torch.Generator]:
        return [search_generator(seed, i, self.device) for i in range(self.n_search)]

    def evaluate(self, Xb: torch.Tensor, targets: Optional[torch.Tensor] = None,
                 seeds: Optional[Sequence[int]] = None) -> torch.Tensor:
        """F [k, pop, n_obj] of Xb [k, pop, n_var] against `targets` [k, D]
        (default: all K of this batch), in chunks of `search_microbatch`
        searches or, where that does not divide k, of its largest divisor
        below it. `seeds`: each search's (`draw_seeds`), read by a
        stochastic fitness alone."""
        targets = self.targets if targets is None else targets
        smb = self.search_microbatch
        if smb is not None:
            k = Xb.shape[0]
            smb = max(d for d in range(1, min(smb, k) + 1) if k % d == 0)
        return self.generator.eval_population_batched(Xb, targets, smb, self.mesh, seeds)

    def draw_seeds(self, generators: Sequence[torch.Generator]) -> Optional[List[int]]:
        """One evaluation seed from each search's generator when the fitness
        is stochastic; None, and no draw, otherwise."""
        return [draw_seed(g) for g in generators] if self.base.stochastic else None

    def sample(self, gen: torch.Generator) -> torch.Tensor:
        return self.base.ops.sample(gen, self.pop_size)

    @torch.inference_mode()
    def init(self, generators: Sequence[torch.Generator]) -> GAState:
        """Each search samples with its generator (`Algorithm.init`'s draws),
        then one evaluation of all K populations."""
        X0 = torch.stack([self.sample(g) for g in generators])
        return GAState(X0, self.evaluate(X0, seeds=self.draw_seeds(generators)),
                       (0,) * self.n_search)

    @torch.inference_mode()
    def step(self, state: GAState, generators: Sequence[torch.Generator]) -> GAState:
        """One generation of every search: K `vary` halves, one evaluation,
        K `survive` halves."""
        vary, survive = self._halves
        states = [slice_state(state, i) for i in range(self.n_search)]
        off = torch.stack([vary(s, g) for s, g in zip(states, generators)])
        F_off = self.evaluate(off, seeds=self.draw_seeds(generators))
        return stack_states([survive(s, off[i], F_off[i]) for i, s in enumerate(states)])


def make_batched(problem, targets: Sequence[str],
                 search_microbatch: Optional[int] = None, mesh=None) -> BatchedAlgorithm:
    """K searches of `problem`'s config and weights, one per target (text
    prompts, or image paths for GPT2), their features from one CLIP call.
    GPT-2's argmax decode groups by `_auto_search_microbatch(K)` unless
    `search_microbatch` is given (stochastic decodes go one search at a
    time regardless). `mesh`: the problem's unless given."""
    targets = list(targets)
    smb = search_microbatch
    if smb is None and problem.config.task == "img2txt" and not problem.config.stochastic:
        smb = _auto_search_microbatch(len(targets))
    return BatchedAlgorithm(base=problem.make_algorithm(), generator=problem.generator,
                            targets=problem.generator.encode_targets(targets),
                            search_microbatch=smb,
                            mesh=mesh if mesh is not None else problem.generator.mesh)


@torch.inference_mode()
def minimize_batched(balgo: BatchedAlgorithm, n_gen: int,
                     generators: Union[int, Sequence[torch.Generator]] = 0,
                     callback: Optional[Callable] = None, save_each: int = 50,
                     verbose: bool = False, state: Optional[GAState] = None) -> List[Result]:
    """Run K searches `n_gen` generations; one `Result` per search (as
    `minimize`'s). `generators`: the K searches' generators, or an int seed
    for `balgo.generators(seed)`. `callback(state)` gets the batched state
    after every `save_each` generations and after the last."""
    gens = balgo.generators(generators) if isinstance(generators, int) else list(generators)
    if state is None:
        state = balgo.init(gens)
    for done in range(1, n_gen + 1):
        state = balgo.step(state, gens)
        if done % save_each and done != n_gen:
            continue
        if verbose and dist.is_primary():
            best = state.F.min(dim=1).values.cpu().numpy()
            print(f"gen {state.gen[0]:5d}  best/search={best.tolist()}")
        if callback is not None:
            callback(state)
    X, F = state.X.cpu(), state.F.cpu()
    return [extract_result(X[i], F[i], balgo.algorithm, slice_state(state, i))
            for i in range(balgo.n_search)]
