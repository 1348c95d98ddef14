"""Crossover with pymoo-0.4.2 semantics (reference operators.py:54-77).

Simulated binary crossover (SBX): per-mating prob, per-variable prob 0.5,
1e-14 equal-parent skip, per-variable child swap, bound clipping, and for
integer genes rounding half to even (jnp.rint's rule). Half-
uniform crossover (HUX) on 0/1 genes: exactly ceil(n_diff/2) of the
differing bits swap. The BigGAN genome mixes the two by a per-gene mask.

Each `_core` function takes its uniform draws as tensors (the JAX package
splits its key for them, in the order of the arguments); the functions
without the suffix draw them from a torch.Generator.
"""

from __future__ import annotations

import torch

_EPS = 1.0e-14


def sbx_core(x1: torch.Tensor, x2: torch.Tensor, xl, xu, u_mate, u_var,
             u_beta, u_swap, eta: float = 3.0, prob: float = 1.0,
             prob_per_variable: float = 0.5, round_int: bool = False):
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
    if round_int:
        o1, o2 = torch.round(o1), torch.round(o2)
    return o1, o2


def sbx(gen: torch.Generator, x1: torch.Tensor, x2: torch.Tensor, xl, xu,
        eta: float = 3.0, prob: float = 1.0, prob_per_variable: float = 0.5,
        round_int: bool = False):
    """SBX on parent matrices [m, n_var] -> two children."""
    return sbx_core(x1, x2, xl, xu, *_sbx_uniforms(gen, x1), eta=eta, prob=prob,
                    prob_per_variable=prob_per_variable, round_int=round_int)


def hux_core(x1: torch.Tensor, x2: torch.Tensor, u_mate, u_score, prob: float = 0.2):
    """HUX on 0/1 genomes [m, n_var]: each differing position gets the
    score u_score, and in a mating (u_mate [m, 1] < prob) those ranked below
    ceil(n_diff/2) among the row's differing positions swap (the rank is the
    JAX package's argsort of the argsort, both stable)."""
    diff = x1 != x2
    n_swap = torch.ceil(diff.sum(dim=1, keepdim=True) / 2.0)
    score = torch.where(diff, u_score, torch.full_like(u_score, float("inf")))
    rank = torch.argsort(torch.argsort(score, dim=1, stable=True), dim=1, stable=True)
    swap = diff & (rank < n_swap) & (u_mate < prob)
    return torch.where(swap, x2, x1), torch.where(swap, x1, x2)


def _sbx_uniforms(gen, x):
    m, n_var = x.shape
    return tuple(_rand(gen, x, *s) for s in ((m, 1), (m, n_var), (m, n_var), (m, n_var)))


def _hux_uniforms(gen, x):
    m, n_var = x.shape
    return _rand(gen, x, m, 1), _rand(gen, x, m, n_var)


def _rand(gen, like, *shape):
    return torch.rand(shape, generator=gen, device=gen.device).to(like.device)


def hux(gen: torch.Generator, x1: torch.Tensor, x2: torch.Tensor, prob: float = 0.2):
    """HUX on parent matrices [m, n_var] -> two children."""
    return hux_core(x1, x2, *_hux_uniforms(gen, x1), prob=prob)


def mixed_crossover_core(x1, x2, real_mask, xl, xu, u_sbx, u_hux, eta: float = 3.0,
                         real_prob: float = 1.0, bool_prob: float = 0.2):
    """SBX on the genes where real_mask [n_var] holds, HUX on the others
    (reference operators.py:54-58); u_sbx: sbx_core's four uniforms, u_hux:
    hux_core's two."""
    r1, r2 = sbx_core(x1, x2, xl, xu, *u_sbx, eta=eta, prob=real_prob)
    b1, b2 = hux_core(x1, x2, *u_hux, prob=bool_prob)
    return torch.where(real_mask, r1, b1), torch.where(real_mask, r2, b2)


def mixed_crossover(gen: torch.Generator, x1, x2, real_mask, xl, xu, eta: float = 3.0,
                    real_prob: float = 1.0, bool_prob: float = 0.2):
    """The BigGAN mixed-genome crossover on parent matrices [m, n_var]."""
    u_sbx = _sbx_uniforms(gen, x1)
    return mixed_crossover_core(x1, x2, real_mask, xl, xu, u_sbx, _hux_uniforms(gen, x1),
                                eta=eta, real_prob=real_prob, bool_prob=bool_prob)
