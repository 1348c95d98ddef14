"""Adam as optax's `adam(lr, b1, b2, eps)`, written out over flat lists of
tensors: the projector's and the trainer's optimizer.

optax computes the moments `(1 - b) * g + b * m` and `(1 - b) * g**2 + b *
v`, corrects their bias by `1 - b**count` in fp32 (count from 1), divides
`m_hat / (sqrt(v_hat) + eps)` (eps outside the root) and scales by `-lr`.
`torch.optim.Adam` folds the rate in elsewhere and puts eps under another
bias correction, so its numbers differ. A parameter that took no gradient
(`None` in torch) counts as a zero gradient, as optax's is: its moments
decay.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch


@dataclasses.dataclass
class AdamState:
    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


def adam_init(params: Sequence[torch.Tensor]) -> AdamState:
    return AdamState(0, [torch.zeros_like(p) for p in params],
                     [torch.zeros_like(p) for p in params])


def bias_correction(b: float, count: int) -> float:
    """1 - b**count in fp32, as optax computes it."""
    return float(np.float32(1) - np.power(np.float32(b), np.float32(count)))


def adam_update(grads: Sequence[Optional[torch.Tensor]], state: AdamState,
                lr: float = 1.0, b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-8):
    """optax.adam(lr, b1, b2, eps) (its defaults): the moments, their bias
    correction and -lr * m_hat / (sqrt(v_hat) + eps). Returns (updates, new
    state); the caller adds the updates to the parameters."""
    grads = [torch.zeros_like(m) if g is None else g for g, m in zip(grads, state.mu)]
    mu = [(1 - b1) * g + b1 * m for g, m in zip(grads, state.mu)]
    nu = [(1 - b2) * g ** 2 + b2 * v for g, v in zip(grads, state.nu)]
    count = state.count + 1
    c1, c2 = bias_correction(b1, count), bias_correction(b2, count)
    # -(u * lr) is (-lr) * u bitwise; with lr = 1 it is -u
    updates = [-(((m / c1) / (torch.sqrt(v / c2) + eps)) * lr) for m, v in zip(mu, nu)]
    return updates, AdamState(count, mu, nu)


def global_norm(grads: Sequence[Optional[torch.Tensor]]) -> torch.Tensor:
    """optax.global_norm: the root of the sum of every gradient's squares
    (a missing gradient adds nothing)."""
    return torch.sqrt(sum(g.square().sum() for g in grads if g is not None))
