"""Polynomial mutation in Deb's bounded formulation, as in pymoo 0.4.2
(delta1/delta2 split at rand 0.5, eta+1 powers, bound clamp).

`polynomial_mutation_core` takes its two uniform draws as tensors;
`polynomial_mutation` draws them from a torch.Generator.
"""

from __future__ import annotations

import torch


def polynomial_mutation_core(x: torch.Tensor, xl, xu, u_do, u_rand,
                             eta: float = 3.0, prob: float = 0.5) -> torch.Tensor:
    """x: [n, n_var]; u_do, u_rand: [n, n_var] uniforms in [0, 1)."""
    n_var = x.shape[1]
    xl = torch.as_tensor(xl, dtype=x.dtype, device=x.device).expand(n_var)
    xu = torch.as_tensor(xu, dtype=x.dtype, device=x.device).expand(n_var)
    span = xu - xl
    mut_pow = 1.0 / (eta + 1.0)
    # rand <= 0.5 branch
    xy1 = 1.0 - (x - xl) / span
    val1 = 2.0 * u_rand + (1.0 - 2.0 * u_rand) * xy1.pow(eta + 1.0)
    d1 = val1.pow(mut_pow) - 1.0
    # rand > 0.5 branch
    xy2 = 1.0 - (xu - x) / span
    val2 = 2.0 * (1.0 - u_rand) + 2.0 * (u_rand - 0.5) * xy2.pow(eta + 1.0)
    d2 = 1.0 - val2.pow(mut_pow)

    deltaq = torch.where(u_rand <= 0.5, d1, d2)
    y = torch.minimum(torch.maximum(x + deltaq * span, xl), xu)
    return torch.where(u_do < prob, y, x)


def polynomial_mutation(gen: torch.Generator, x: torch.Tensor, xl, xu,
                        eta: float = 3.0, prob: float = 0.5) -> torch.Tensor:
    def u():
        return torch.rand(x.shape, generator=gen, device=gen.device).to(x.device)

    return polynomial_mutation_core(x, xl, xu, u(), u(), eta=eta, prob=prob)
