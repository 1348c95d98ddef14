"""NSGA-II rank-and-crowding survival (pymoo RankAndCrowdingSurvival): whole
fronts until overflow, the splitting front by descending crowding, as one
lexicographic sort."""

from __future__ import annotations

import torch

from clip_glass_torch.evolve.nds import crowding_distance, lexsort, non_dominated_rank


def nsga2_survival(X: torch.Tensor, F: torch.Tensor, pop_size: int):
    """Returns the survivors' X, F, rank and crowding."""
    rank = non_dominated_rank(F)
    crowd = crowding_distance(F, rank)
    # (rank asc, crowding desc); -crowd with inf -> -inf sorts first
    keep = lexsort(rank, -crowd)[:pop_size]
    return X[keep], F[keep], rank[keep], crowd[keep]
