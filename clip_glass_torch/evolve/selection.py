"""NSGA-II binary tournament parent selection (pymoo TournamentSelection).

pymoo draws candidate indices as concatenated random permutations of the
population (so each individual enters ~equally many tournaments). Each
operator has a core function that takes its random draws as tensors and a
thin wrapper that draws them from a torch.Generator, so the core can be fed
the JAX package's draws in tests.
"""

from __future__ import annotations

import torch

from clip_glass_torch.evolve.nds import domination_matrix


def pairs_from_perms(perms: torch.Tensor, n_pick: int) -> torch.Tensor:
    """Concatenated permutations -> [n_pick, 2] candidate index pairs."""
    return perms[:n_pick * 2].reshape(n_pick, 2)


def _permutation_pairs(gen: torch.Generator, n_pop: int, n_pick: int) -> torch.Tensor:
    """[n_pick, 2] candidate index pairs from tiled random permutations."""
    n_perms = -(-(n_pick * 2) // n_pop)
    perms = torch.cat([torch.randperm(n_pop, generator=gen, device=gen.device)
                       for _ in range(n_perms)])
    return pairs_from_perms(perms, n_pick)


def tournament_nsga2_core(F: torch.Tensor, crowding: torch.Tensor,
                          cand: torch.Tensor, tie_coin: torch.Tensor) -> torch.Tensor:
    """Dominance, then larger crowding, then the coin (pymoo
    binary_tournament). cand: [n_select*2, 2]; tie_coin: [n_select*2] bool.
    Returns [n_select, 2] parent index pairs."""
    D = domination_matrix(F)
    a, b = cand[:, 0], cand[:, 1]
    cd_a, cd_b = crowding[a], crowding[b]
    by_crowd = torch.where(cd_a > cd_b, a,
                           torch.where(cd_b > cd_a, b, torch.where(tie_coin, a, b)))
    winner = torch.where(D[a, b], a, torch.where(D[b, a], b, by_crowd))
    return winner.reshape(-1, 2)


def tournament_nsga2(gen: torch.Generator, F: torch.Tensor,
                     crowding: torch.Tensor, n_select: int) -> torch.Tensor:
    """NSGA-II binary tournament. Returns [n_select, 2] parent index pairs."""
    cand = _permutation_pairs(gen, F.shape[0], n_select * 2).to(F.device)
    tie_coin = torch.rand((n_select * 2,), generator=gen, device=gen.device) < 0.5
    return tournament_nsga2_core(F, crowding, cand, tie_coin.to(F.device))
