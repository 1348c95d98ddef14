"""Mutation with pymoo-0.4.2 semantics (reference operators.py:60-77).

Polynomial mutation in Deb's bounded formulation (delta1/delta2 split at
rand 0.5, eta+1 powers, bound clamp, for integer genes rounding half to
even); bitflip on 0/1 genes; the BigGAN genome mixes the two by a per-gene
mask.

Each `_core` function takes its uniform draws as tensors (the JAX package
splits its key for them, in the order of the arguments); the functions
without the suffix draw them from a torch.Generator.
"""

from __future__ import annotations

import torch


def polynomial_mutation_core(x: torch.Tensor, xl, xu, u_do, u_rand,
                             eta: float = 3.0, prob: float = 0.5,
                             round_int: bool = False) -> torch.Tensor:
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
    out = torch.where(u_do < prob, y, x)
    return torch.round(out) if round_int else out


def polynomial_mutation(gen: torch.Generator, x: torch.Tensor, xl, xu,
                        eta: float = 3.0, prob: float = 0.5,
                        round_int: bool = False) -> torch.Tensor:
    return polynomial_mutation_core(x, xl, xu, _rand(gen, x), _rand(gen, x), eta=eta,
                                    prob=prob, round_int=round_int)


def _rand(gen, x):
    return torch.rand(x.shape, generator=gen, device=gen.device).to(x.device)


def bitflip_core(x: torch.Tensor, u_flip, prob: float) -> torch.Tensor:
    """Flip the 0/1 genes whose uniform is below `prob` (pymoo
    BinaryBitflipMutation; the reference's prob is 10/1000,
    operators.py:63)."""
    return torch.where(u_flip < prob, 1.0 - x, x)


def bitflip_mutation(gen: torch.Generator, x: torch.Tensor, prob: float) -> torch.Tensor:
    return bitflip_core(x, _rand(gen, x), prob)


def mixed_mutation_core(x, real_mask, xl, xu, u_pm, u_flip, eta: float = 3.0,
                        real_prob: float = 0.5, bool_prob: float = 10 / 1000):
    """Polynomial mutation where real_mask [n_var] holds, bitflip elsewhere
    (reference operators.py:60-64); u_pm: polynomial_mutation_core's two
    uniforms."""
    r = polynomial_mutation_core(x, xl, xu, *u_pm, eta=eta, prob=real_prob)
    return torch.where(real_mask, r, bitflip_core(x, u_flip, bool_prob))


def mixed_mutation(gen: torch.Generator, x, real_mask, xl, xu, eta: float = 3.0,
                   real_prob: float = 0.5, bool_prob: float = 10 / 1000):
    """The BigGAN mixed-genome mutation."""
    u_pm = (_rand(gen, x), _rand(gen, x))
    return mixed_mutation_core(x, real_mask, xl, xu, u_pm, _rand(gen, x), eta=eta,
                               real_prob=real_prob, bool_prob=bool_prob)
