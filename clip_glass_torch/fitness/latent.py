"""Genome decoding per model family (reference latent.py:4-59)."""

from __future__ import annotations

import torch


def decode_biggan(x: torch.Tensor, dim_z: int = 128):
    """[pop, dim_z + classes] -> (z clipped to [-2, 2], the softmax class
    vector) (reference latent.py:20-24)."""
    return x[:, :dim_z].clamp(-2.0, 2.0), torch.softmax(x[:, dim_z:], dim=1)


def decode_stylegan2(x: torch.Tensor):
    """Identity (reference latent.py:40-41)."""
    return (x,)


def decode_gpt2(x: torch.Tensor):
    """Float genome -> int32 token ids (reference latent.py:55-56); the
    integer operators keep the genes integral, and torch.round, like
    jnp.rint, rounds half to even."""
    return (torch.round(x).to(torch.int32),)
