"""Population initialization (reference operators.py:17-25).

Samplers draw from an explicit torch.Generator on its own device and return
[n, n_var] float32 genome matrices.
"""

from __future__ import annotations

import torch


def normal_sampling(gen: torch.Generator, n: int, n_var: int, mu: float = 0.0,
                    std: float = 1.0) -> torch.Tensor:
    """N(mu, std) (reference operators.py:17-25)."""
    return mu + std * torch.randn((n, n_var), generator=gen, device=gen.device)
