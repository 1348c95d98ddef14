"""Multi-criteria decision making for the final Pareto pick (reference
run.py:103-113: pymoo "pseudo-weights" with weights [0, 1], falling back to
ASF decomposition argmin). numpy only."""

from __future__ import annotations

import numpy as np


def pseudo_weights(F: np.ndarray, weights) -> int:
    """Index of the Pareto point whose normalized pseudo-weight vector is
    L1-closest to `weights` (pymoo PseudoWeights)."""
    F = np.asarray(F, np.float64)
    w = np.asarray(weights, np.float64)
    f_min = F.min(axis=0)
    f_max = F.max(axis=0)
    span = f_max - f_min
    if np.any(span == 0):
        raise ValueError("degenerate objective range; pseudo-weights undefined")
    N = (f_max - F) / span
    N = N / N.sum(axis=1, keepdims=True)
    return int(np.argmin(np.abs(N - w).sum(axis=1)))


def asf(F: np.ndarray, weights) -> int:
    """Achievement scalarizing function argmin (pymoo ASF decomposition):
    min over points of max_j (F_ij - z*_j) / w_j, zero weights guarded."""
    F = np.asarray(F, np.float64)
    w = np.asarray(weights, np.float64)
    w = np.where(w <= 0, 1e-10, w)
    ideal = F.min(axis=0)
    vals = ((F - ideal) / w).max(axis=1)
    return int(np.argmin(vals))


def pick(F: np.ndarray, weights=(0, 1)) -> int:
    """The reference's decision flow (run.py:107-113)."""
    F = np.atleast_2d(np.asarray(F))
    if F.shape[0] == 1:
        return 0
    try:
        return pseudo_weights(F, weights)
    except ValueError:
        return asf(F, weights)
