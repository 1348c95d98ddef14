"""Genome decoding per model family (reference latent.py:4-59)."""

from __future__ import annotations

import torch


def decode_stylegan2(x: torch.Tensor):
    """Identity (reference latent.py:40-41)."""
    return (x,)
