"""Non-dominated sorting + crowding distance, on the population's device.

Front ranks are the lengths of the longest domination chains ending at each
individual, computed by (max, +) matrix squaring: a fixed op count,
independent of the number of fronts (n = 2*pop is small for every config).
Crowding is pymoo-0.4.2's formula per front, via lexicographic sorts and
segment reductions keyed by front id, including pymoo's fill of zero gaps.
"""

from __future__ import annotations

import math

import torch


def domination_matrix(F: torch.Tensor) -> torch.Tensor:
    """D[i, j] = individual i dominates j (all objectives <=, one <)."""
    le = (F[:, None, :] <= F[None, :, :]).all(dim=-1)
    lt = (F[:, None, :] < F[None, :, :]).any(dim=-1)
    return le & lt


def lexsort(primary: torch.Tensor, secondary: torch.Tensor) -> torch.Tensor:
    """Stable lexicographic order by (primary, secondary), ties by index:
    two stable sorts, secondary key first."""
    o1 = torch.sort(secondary, stable=True).indices
    o2 = torch.sort(primary[o1], stable=True).indices
    return o1[o2]


def non_dominated_rank(F: torch.Tensor) -> torch.Tensor:
    """Front index per individual (0 = Pareto front) = the length in edges of
    the longest domination chain ending at it. int64."""
    n = F.shape[0]
    D = domination_matrix(F)
    if n <= 2:
        return D.any(dim=0).long()
    neg = -(n + 1)  # "-inf": any sum stays < 0 (paths <= n-1)
    P = torch.where(D, 1, neg).long()
    P.fill_diagonal_(0)
    # diagonal zeros make squaring monotone, so P after m squarings holds
    # the longest paths among those of <= 2^m edges
    for _ in range(max(1, math.ceil(math.log2(n - 1)))):
        P = (P[:, :, None] + P[None, :, :]).amax(dim=1).clamp_max(n)
    return P.amax(dim=0)


def crowding_distance(F: torch.Tensor, rank: torch.Tensor) -> torch.Tensor:
    """pymoo-0.4.2 crowding distance computed within each front.

    Per objective: sort front members, gap to sorted neighbours normalized by
    the front's objective range (0 when the range collapses), boundaries
    inf; total = mean over objectives. A zero gap inherits the nearest
    nonzero gap in sort order (pymoo's duplicate handling). Fronts with at
    most 2 members are all inf."""
    n, n_obj = F.shape
    rank = rank.long()
    idx = torch.arange(n, device=F.device)
    inf = torch.tensor(float("inf"), dtype=F.dtype, device=F.device)
    false = torch.zeros(1, dtype=torch.bool, device=F.device)
    dists = []
    for m in range(n_obj):
        f = F[:, m]
        order = lexsort(rank, f)
        f_sorted, r_sorted = f[order], rank[order]
        same = r_sorted[1:] == r_sorted[:-1]
        same_prev = torch.cat([false, same])
        same_next = torch.cat([same, false])
        prev_val = torch.cat([f_sorted[:1], f_sorted[:-1]])
        next_val = torch.cat([f_sorted[1:], f_sorted[-1:]])

        # per-front objective range via segment reductions keyed by front id
        fmax = torch.full((n,), -float("inf"), dtype=F.dtype, device=F.device
                          ).scatter_reduce(0, rank, f, "amax", include_self=False)
        fmin = torch.full((n,), float("inf"), dtype=F.dtype, device=F.device
                          ).scatter_reduce(0, rank, f, "amin", include_self=False)
        norm = (fmax - fmin)[rank][order]

        gap_prev = torch.where(same_prev, f_sorted - prev_val, inf)
        gap_next = torch.where(same_next, next_val - f_sorted, inf)
        # zero gaps inherit the nearest nonzero gap (forward fill for
        # gap_prev, backward fill for gap_next); front boundaries are inf,
        # so fills never cross fronts
        last_nz = torch.cummax(torch.where(gap_prev != 0, idx, -1), dim=0).values
        gap_prev = gap_prev[last_nz.clamp_min(0)]
        rev_nz = torch.cummax(torch.where(gap_next.flip(0) != 0, idx, -1), dim=0).values
        gap_next = gap_next[(n - 1 - rev_nz.flip(0)).clamp_max(n - 1)]

        # norm == 0: constant objective inside the front -> contribution 0
        d = torch.where(norm > 0, gap_prev / norm + gap_next / norm,
                        torch.zeros_like(norm))
        inv = torch.empty_like(order)
        inv[order] = idx
        dists.append(d[inv])
    crowd = torch.stack(dists, dim=1).sum(dim=1) / n_obj
    front_sizes = torch.zeros(n, dtype=torch.long, device=F.device).scatter_add(
        0, rank, torch.ones_like(rank))
    return torch.where(front_sizes[rank] <= 2, inf, crowd)
