"""GA / NSGA-II generation step + search loop, on the population's device.

One generation: tournament selection, SBX, polynomial mutation, duplicate
resampling, fitness evaluation, survival (reference run.py:53-76 with pymoo):
by fitness for the GA, by rank and crowding for NSGA-II. The genomes and
fitness stay on the device; all randomness comes from one explicit
torch.Generator, drawn in a fixed order, so a seed and the generator's state
fix the whole search. A stochastic fitness (config.stochastic: GPT-2's
sampled decode) gets a seed of its own for each evaluation, drawn from that
generator after the variation (the JAX package's `k_eval`); no other config
draws it.

Over a mesh (parallel.mesh) of several processes every rank runs this loop
on the whole state: its generator is seeded alike, so every rank draws the
same variation and X stays replicated, and the evaluation hands every rank
the whole F (`parallel.distributed.fetch` of the shards' rows). Only rank 0
prints.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Union

import numpy as np
import torch

from clip_glass_torch.core.device import constant, resolve_device
from clip_glass_torch.evolve import crossover as xo
from clip_glass_torch.evolve import mutation as mut
from clip_glass_torch.evolve import sampling as smp
from clip_glass_torch.evolve.nds import crowding_distance, non_dominated_rank
from clip_glass_torch.evolve.selection import tournament_ga, tournament_nsga2
from clip_glass_torch.evolve.survival import fitness_survival, nsga2_survival
from clip_glass_torch.parallel import distributed as dist


class GAState(NamedTuple):
    X: torch.Tensor     # [pop, n_var] genomes (float32)
    F: torch.Tensor     # [pop, n_obj] fitness
    gen: int            # generation counter


class Operators(NamedTuple):
    """Per-config operators (reference get_operators, operators.py:37-81);
    each draws from the torch.Generator it is given."""
    sample: Callable    # (gen, n) -> X
    cross: Callable     # (gen, x1, x2) -> (o1, o2)
    mutate: Callable    # (gen, X) -> X


def operators_for_config(config) -> Operators:
    """The reference's operator set for each config family (reference
    operators.py:37-81): BigGAN's mixed genome, StyleGAN2's reals, GPT-2's
    integer token ids."""
    if config.name == "GPT2":
        return Operators(
            sample=lambda g, n: smp.int_random_sampling(g, n, config.n_var, config.xl,
                                                        config.xu),
            cross=lambda g, x1, x2: xo.sbx(g, x1, x2, config.xl, config.xu, eta=3.0,
                                           prob=1.0, round_int=True),
            mutate=lambda g, x: mut.polynomial_mutation(g, x, config.xl, config.xu,
                                                        eta=3.0, prob=0.5, round_int=True),
        )
    if config.name.startswith("DeepMindBigGAN"):
        def mask(x):
            return constant(_real_mask, config.dim_z, config.num_classes,
                            device=x.device, dtype=torch.bool)

        return Operators(
            sample=lambda g, n: smp.mixed_biggan_sampling(
                g, n, config.dim_z, config.num_classes, bool_prob=5 / 1000),
            cross=lambda g, x1, x2: xo.mixed_crossover(
                g, x1, x2, mask(x1), config.xl, config.xu, eta=3.0, real_prob=1.0,
                bool_prob=0.2),
            mutate=lambda g, x: mut.mixed_mutation(
                g, x, mask(x), config.xl, config.xu, eta=3.0, real_prob=0.5,
                bool_prob=10 / 1000),
        )
    return Operators(
        sample=lambda g, n: smp.normal_sampling(g, n, config.n_var),
        cross=lambda g, x1, x2: xo.sbx(g, x1, x2, config.xl, config.xu,
                                       eta=3.0, prob=1.0),
        mutate=lambda g, x: mut.polynomial_mutation(g, x, config.xl, config.xu,
                                                    eta=3.0, prob=0.5),
    )


def _real_mask(dim_z: int, num_classes: int) -> np.ndarray:
    """The BigGAN genome's real genes: z first, then the class bits."""
    return np.arange(dim_z + num_classes) < dim_z


def resample_duplicates_core(off: torch.Tensor, pop_X: torch.Tensor,
                             fresh: torch.Tensor, eps: float = 1e-16) -> torch.Tensor:
    """Replace every offspring identical to a current member or to an earlier
    sibling by the matching row of `fresh` (the reference's
    eliminate_duplicates=True, run.py:65, at a fixed cost)."""
    n = off.shape[0]
    dup_vs_pop = ((off[:, None, :] - pop_X[None, :, :]).abs() <= eps).all(-1).any(1)
    eq_sib = ((off[:, None, :] - off[None, :, :]).abs() <= eps).all(-1)
    earlier = torch.ones((n, n), dtype=torch.bool, device=off.device).tril(-1)
    dup = dup_vs_pop | (eq_sib & earlier).any(1)
    return torch.where(dup[:, None], fresh, off)


def resample_duplicates(gen: torch.Generator, off: torch.Tensor,
                        pop_X: torch.Tensor, sample: Callable,
                        eps: float = 1e-16) -> torch.Tensor:
    fresh = sample(gen, off.shape[0]).to(off.device)
    return resample_duplicates_core(off, pop_X, fresh, eps)


def draw_seed(gen: torch.Generator) -> int:
    """One evaluation's seed for a stochastic fitness, drawn from the search's
    generator (the JAX package's `k_eval`, split off in `vary`)."""
    return int(torch.randint(2 ** 62, (), generator=gen, device=gen.device))


def make_step_halves(ops: Operators, pop_size: int, algorithm: str = "nsga2"):
    """The two halves of a generation around its evaluation (the JAX
    package's `make_step_halves`, algorithm.py:109), so that K searches can
    each vary with their own generator, be evaluated in one batch and each
    survive (evolve/batched.py):

      vary(state, gen) -> offspring: selection, crossover, mutation and
        duplicate resampling, drawing from `gen` in that order;
      survive(state, offspring, F_offspring) -> the next state (no draws).
    """
    if algorithm not in ("ga", "nsga2"):
        raise ValueError(f"unknown algorithm {algorithm!r}")
    if pop_size % 2:
        raise ValueError("pop_size must be even")
    n_matings = pop_size // 2
    is_nsga2 = algorithm == "nsga2"

    def vary(state: GAState, gen: torch.Generator) -> torch.Tensor:
        if is_nsga2:
            rank = non_dominated_rank(state.F)
            crowd = crowding_distance(state.F, rank)
            pairs = tournament_nsga2(gen, state.F, crowd, n_matings)
        else:
            pairs = tournament_ga(gen, state.F, n_matings)
        o1, o2 = ops.cross(gen, state.X[pairs[:, 0]], state.X[pairs[:, 1]])
        off = ops.mutate(gen, torch.cat([o1, o2], dim=0))
        return resample_duplicates(gen, off, state.X, ops.sample)

    def survive(state: GAState, off: torch.Tensor, F_off: torch.Tensor) -> GAState:
        X_all, F_all = torch.cat([state.X, off]), torch.cat([state.F, F_off])
        if is_nsga2:
            X_new, F_new, _, _ = nsga2_survival(X_all, F_all, pop_size)
        else:
            X_new, F_new = fitness_survival(X_all, F_all, pop_size)
        return GAState(X_new, F_new, state.gen + 1)

    return vary, survive


def make_step(ops: Operators, eval_fn: Callable, pop_size: int,
              algorithm: str = "nsga2", stochastic: bool = False) -> Callable:
    """`step(state, gen) -> state`: mating -> variation -> dedup -> eval ->
    survival. `algorithm`: "ga" (one objective) or "nsga2". `stochastic`:
    eval_fn takes (X, seed), the seed drawn from `gen` after the variation;
    otherwise eval_fn(X) and `gen` serves the variation alone."""
    vary, survive = make_step_halves(ops, pop_size, algorithm)

    def step(state: GAState, gen: torch.Generator) -> GAState:
        off = vary(state, gen)
        F_off = eval_fn(off, draw_seed(gen)) if stochastic else eval_fn(off)
        return survive(state, off, F_off)

    return step


def make_algorithm(config, eval_fn: Callable, device=None) -> "Algorithm":
    """eval_fn: (X [pop, n_var]) -> F [pop, n_obj]; with config.stochastic
    (X, seed) -> F."""
    return Algorithm(ops=operators_for_config(config), eval_fn=eval_fn,
                     pop_size=config.pop_size, algorithm=config.algorithm,
                     device=resolve_device(device), stochastic=config.stochastic)


@dataclasses.dataclass
class Result:
    """pymoo-shaped result (reference run.py:79-96): optimum X/F plus the
    final population; G/CV are identically zero (reference problem.py:29).
    Tensors are on the CPU. For the GA, X and F are the single best row."""
    X: torch.Tensor
    F: torch.Tensor
    G: torch.Tensor
    CV: torch.Tensor
    pop_X: torch.Tensor
    pop_F: torch.Tensor
    state: GAState


@dataclasses.dataclass
class Algorithm:
    ops: Operators
    eval_fn: Callable          # (X) -> F; stochastic: (X, seed) -> F
    pop_size: int
    algorithm: str = "nsga2"
    device: torch.device = torch.device("cuda")
    stochastic: bool = False   # each evaluation draws its seed (make_step)

    def generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    @torch.inference_mode()
    def init(self, gen: torch.Generator) -> GAState:
        """The initial population: sampled, then its seed drawn when the
        fitness is stochastic (the JAX package's init splits k_init, k_eval)."""
        X0 = self.ops.sample(gen, self.pop_size)
        return GAState(X0, self.eval_fn(X0, draw_seed(gen)) if self.stochastic
                       else self.eval_fn(X0), 0)

    def step_fn(self) -> Callable:
        return make_step(self.ops, self.eval_fn, self.pop_size, self.algorithm,
                         self.stochastic)


def extract_result(pop_X: torch.Tensor, pop_F: torch.Tensor,
                   algorithm_name: str, state: GAState) -> Result:
    """The optimum is NSGA-II's rank-0 front, or the GA's single best row
    (the first argmin); G/CV identically zero, float64 as the JAX package's
    (reference run.py:79-96)."""
    if algorithm_name == "nsga2":
        opt = non_dominated_rank(pop_F) == 0
        X_opt, F_opt = pop_X[opt], pop_F[opt]
        n_opt = X_opt.shape[0]
    else:
        best = pop_F[:, 0].argmin()
        X_opt, F_opt = pop_X[best], pop_F[best]
        n_opt = 1
    return Result(X=X_opt, F=F_opt, G=torch.zeros(n_opt, dtype=torch.float64),
                  CV=torch.zeros(n_opt, 1, dtype=torch.float64), pop_X=pop_X,
                  pop_F=pop_F, state=state)


@torch.inference_mode()
def minimize(algorithm: Algorithm, n_gen: int,
             generator: Union[int, torch.Generator] = 0,
             callback: Optional[Callable] = None, save_each: int = 50,
             verbose: bool = False, state: Optional[GAState] = None) -> Result:
    """Run the search (reference run.py:70-76 `minimize`).

    `generator`: a torch.Generator on the algorithm's device, or an int seed
    for one. Without `state`, the search starts with `algorithm.init`.
    `callback(state)` fires after every `save_each` generations and after
    the last (the reference's save cadence, run.py:29-51); `verbose` prints
    the best and mean fitness there."""
    gen = (algorithm.generator(generator) if isinstance(generator, int)
           else generator)
    if state is None:
        state = algorithm.init(gen)
    step = algorithm.step_fn()
    for done in range(1, n_gen + 1):
        state = step(state, gen)
        if done % save_each and done != n_gen:
            continue
        if verbose and dist.is_primary():
            F = state.F.cpu().numpy()
            print(f"gen {state.gen:5d}  best={F.min(0)}  mean={F.mean(0)}")
        if callback is not None:
            callback(state)
    return extract_result(state.X.cpu(), state.F.cpu(), algorithm.algorithm, state)
