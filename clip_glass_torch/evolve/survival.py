"""Survival of the merged parents and offspring. GA: the best `pop_size` by
scalar fitness (pymoo FitnessSurvival). NSGA-II: rank and crowding (pymoo
RankAndCrowdingSurvival), whole fronts until overflow, the splitting front
by descending crowding. Each is one sort."""

from __future__ import annotations

import torch

from clip_glass_torch.evolve.nds import crowding_distance, lexsort, non_dominated_rank


def fitness_survival(X: torch.Tensor, F: torch.Tensor, pop_size: int):
    """Keep the `pop_size` individuals with the smallest scalar fitness; the
    sort is stable, so ties keep their order (as the JAX package's)."""
    keep = torch.argsort(F[:, 0], stable=True)[:pop_size]
    return X[keep], F[keep]


def nsga2_survival(X: torch.Tensor, F: torch.Tensor, pop_size: int):
    """Returns the survivors' X, F, rank and crowding."""
    rank = non_dominated_rank(F)
    crowd = crowding_distance(F, rank)
    # (rank asc, crowding desc); -crowd with inf -> -inf sorts first
    keep = lexsort(rank, -crowd)[:pop_size]
    return X[keep], F[keep], rank[keep], crowd[keep]
