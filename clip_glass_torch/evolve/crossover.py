"""Simulated binary crossover (SBX) with pymoo-0.4.2 semantics: per-mating
prob, per-variable prob 0.5, 1e-14 equal-parent skip, per-variable child
swap, bound clipping.

`sbx_core` takes its four uniform draws as tensors (the JAX package splits
its key 4 ways for them); `sbx` draws them from a torch.Generator.
"""

from __future__ import annotations

import torch

_EPS = 1.0e-14


def sbx_core(x1: torch.Tensor, x2: torch.Tensor, xl, xu, u_mate, u_var,
             u_beta, u_swap, eta: float = 3.0, prob: float = 1.0,
             prob_per_variable: float = 0.5):
    """x1, x2: [m, n_var] parents; u_mate: [m, 1]; u_var, u_beta, u_swap:
    [m, n_var] uniforms in [0, 1). Returns two children."""
    n_var = x1.shape[1]
    xl = torch.as_tensor(xl, dtype=x1.dtype, device=x1.device).expand(n_var)
    xu = torch.as_tensor(xu, dtype=x1.dtype, device=x1.device).expand(n_var)
    cross = (u_mate < prob) & (u_var < prob_per_variable) & ((x1 - x2).abs() > _EPS)

    y1 = torch.minimum(x1, x2)
    y2 = torch.maximum(x1, x2)
    # pymoo floors the spread at 1e-10 and uses the floored value both as the
    # beta denominator and in the betaq*delta products
    delta = (y2 - y1).clamp_min(1.0e-10)

    def betaq(beta):
        alpha = 2.0 - beta.pow(-(eta + 1.0))
        lo = (u_beta * alpha).pow(1.0 / (eta + 1.0))
        hi = (1.0 / (2.0 - u_beta * alpha)).pow(1.0 / (eta + 1.0))
        return torch.where(u_beta <= 1.0 / alpha, lo, hi)

    c1 = 0.5 * ((y1 + y2) - betaq(1.0 + 2.0 * (y1 - xl) / delta) * delta)
    c2 = 0.5 * ((y1 + y2) + betaq(1.0 + 2.0 * (xu - y2) / delta) * delta)

    swap = u_swap <= 0.5
    c1s = torch.minimum(torch.maximum(torch.where(swap, c2, c1), xl), xu)
    c2s = torch.minimum(torch.maximum(torch.where(swap, c1, c2), xl), xu)
    o1 = torch.where(cross, c1s, x1)
    o2 = torch.where(cross, c2s, x2)
    return o1, o2


def sbx(gen: torch.Generator, x1: torch.Tensor, x2: torch.Tensor, xl, xu,
        eta: float = 3.0, prob: float = 1.0, prob_per_variable: float = 0.5):
    """SBX on parent matrices [m, n_var] -> two children."""
    m, n_var = x1.shape

    def u(*shape):
        return torch.rand(shape, generator=gen, device=gen.device).to(x1.device)

    return sbx_core(x1, x2, xl, xu, u(m, 1), u(m, n_var), u(m, n_var),
                    u(m, n_var), eta=eta, prob=prob,
                    prob_per_variable=prob_per_variable)
