"""Population initialization (reference operators.py:9-52).

Samplers draw from an explicit torch.Generator on its own device and return
[n, n_var] float32 genome matrices; boolean genes are 0/1 floats, integer
genes integral floats (fitness/latent.py decodes them). Where the
JAX package turns uniforms into its samples, a `_core` function takes the
uniforms as a tensor, so the tests can feed both packages the same ones.
"""

from __future__ import annotations

import math

import torch


def normal_sampling(gen: torch.Generator, n: int, n_var: int, mu: float = 0.0,
                    std: float = 1.0) -> torch.Tensor:
    """N(mu, std) (reference operators.py:17-25)."""
    return mu + std * torch.randn((n, n_var), generator=gen, device=gen.device)


def _rand(gen: torch.Generator, *shape) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=gen.device)


def truncnorm_core(u: torch.Tensor, lower: float = -2.0, upper: float = 2.0) -> torch.Tensor:
    """truncnorm(lower, upper) from uniforms u in [0, 1), as
    jax.random.truncated_normal maps its uniforms: sqrt2 * erfinv of the
    uniform rescaled to [erf(lower/sqrt2), erf(upper/sqrt2)), clipped to the
    open interval (lower, upper)."""
    def scalar(v):
        return torch.tensor(v, dtype=u.dtype, device=u.device)

    lo, hi, sqrt2 = scalar(lower), scalar(upper), scalar(math.sqrt(2.0))
    a, b = torch.erf(lo / sqrt2), torch.erf(hi / sqrt2)
    out = sqrt2 * torch.erfinv(torch.maximum(a, u * (b - a) + a))
    return torch.minimum(torch.maximum(out, torch.nextafter(lo, hi)), torch.nextafter(hi, lo))


def truncnorm_sampling(gen: torch.Generator, n: int, n_var: int) -> torch.Tensor:
    """truncnorm.rvs(-2, 2) (reference operators.py:14-15, latent.py:9)."""
    return truncnorm_core(_rand(gen, n, n_var))


def binary_sampling(gen: torch.Generator, n: int, n_var: int,
                    prob: float = 0.5) -> torch.Tensor:
    """Bernoulli(prob) as 0/1 floats (reference operators.py:27-34): a
    uniform below `prob`, as jax.random.bernoulli decides."""
    return (_rand(gen, n, n_var) < prob).float()


def int_random_core(u: torch.Tensor, xl, xu) -> torch.Tensor:
    """Integers uniform on [xl, xu] from uniforms u in [0, 1), as floats:
    floor(xl + u * (xu - xl + 1)), capped at xu."""
    lo = torch.as_tensor(xl, dtype=u.dtype, device=u.device)
    hi = torch.as_tensor(xu, dtype=u.dtype, device=u.device)
    return torch.minimum(torch.floor(lo + u * (hi - lo + 1.0)), hi)


def int_random_sampling(gen: torch.Generator, n: int, n_var: int, xl, xu) -> torch.Tensor:
    """Uniform integers in [xl, xu] (pymoo "int_random", reference
    operators.py:75). JAX's randint draws its integers from raw bits, not
    from uniforms, so the two packages' streams differ."""
    return int_random_core(_rand(gen, n, n_var), xl, xu)


def mixed_biggan_sampling(gen: torch.Generator, n: int, dim_z: int = 128,
                          num_classes: int = 1000,
                          bool_prob: float = 5 / 1000) -> torch.Tensor:
    """The BigGAN mixed genome: truncnorm reals ++ sparse Bernoulli class
    bits (reference operators.py:44-52)."""
    z = truncnorm_sampling(gen, n, dim_z)
    c = binary_sampling(gen, n, num_classes, bool_prob)
    return torch.cat([z, c], dim=1)
