"""Perceptual Path Length.

Behavioral reference: stylegan2/metrics/ppl.py — epsilon-perturbed latent
pairs (lerp in W / slerp in Z, full- or end-sampling, 148-163), perceptual
distance of the two synthesized images divided by epsilon^2, with 1st/99th
percentile filtering (225-229). The port of the JAX package's
`metrics/ppl.py`.

Distance is pluggable like FID (the reference uses LPIPS-VGG16,
`metrics.lpips`). The synthesis runs in the config's default domain under
`torch.inference_mode()`: on the card the hand-written kernels 1-4 run
(kernel 4 at the s2d levels, 512 and 1024 px for config-f).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from clip_glass_torch.core.device import resolve_device
from clip_glass_torch.core.dtypes import tree_to
from clip_glass_torch.models.stylegan2 import model as sg2


def lerp(a, b, t):
    return a + (b - a) * t


def slerp(a, b, t):
    """Spherical interpolation (reference stylegan2/utils.py:117-145)."""
    norm = torch.linalg.vector_norm
    a_n = a / norm(a, dim=-1, keepdim=True)
    b_n = b / norm(b, dim=-1, keepdim=True)
    d = (a_n * b_n).sum(dim=-1, keepdim=True)
    p = t * torch.arccos(d.clamp(-1.0, 1.0))
    c = b_n - d * a_n
    c = c / norm(c, dim=-1, keepdim=True).clamp_min(1e-10)
    return (a_n * torch.cos(p) + c * torch.sin(p)) * norm(a, dim=-1, keepdim=True)


class PPL:
    """PPL of a StyleGAN2 G. Entry point: runs on the card unless
    `device="cpu"`; `g_params` are moved there."""

    def __init__(self, g_params, model_cfg: sg2.SG2Config,
                 distance_fn: Callable, num_samples: int = 2048,
                 batch_size: int = 16, epsilon: float = 1e-4,
                 use_dlatent: bool = True, full_sampling: bool = True,
                 seed: int = 0, device: Optional[str] = None):
        self.device = resolve_device(device)
        self.g_params = tree_to(g_params, self.device)
        self.cfg = model_cfg
        self.distance_fn = distance_fn
        self.num_samples = num_samples
        self.batch_size = batch_size
        self.epsilon = epsilon
        self.use_dlatent = use_dlatent
        self.full_sampling = full_sampling
        self.seed = seed

    def draw(self, gen: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor,
                                                   torch.Tensor, List[torch.Tensor]]:
        """One batch's draws from `gen`: z0, z1 [B, latent], t [B, 1] and
        the per-layer noise planes."""
        B, L, dev = self.batch_size, self.cfg.latent_size, self.device
        z0 = torch.randn((B, L), generator=gen, device=dev)
        z1 = torch.randn((B, L), generator=gen, device=dev)
        t = (torch.rand((B, 1), generator=gen, device=dev) if self.full_sampling
             else torch.zeros((B, 1), device=dev))
        noise = [torch.randn(s, generator=gen, device=dev) for s in self.cfg.noise_shapes()]
        return z0, z1, t, noise

    @torch.inference_mode()
    def batch_distances(self, z0, z1, t, noise) -> torch.Tensor:
        """[B] distances / epsilon^2 of one batch, from its draws."""
        cfg = self.cfg
        mapping = self.g_params["mapping"]
        if self.use_dlatent:
            w0 = sg2.mapping_apply(mapping, z0, cfg)
            w1 = sg2.mapping_apply(mapping, z1, cfg)
            a = lerp(w0, w1, t)
            b = lerp(w0, w1, t + self.epsilon)
        else:
            a = sg2.mapping_apply(mapping, slerp(z0, z1, t), cfg)
            b = sg2.mapping_apply(mapping, slerp(z0, z1, t + self.epsilon), cfg)
        n = cfg.num_latents
        dl = torch.cat([a[:, None, :].expand(-1, n, -1), b[:, None, :].expand(-1, n, -1)])
        imgs = sg2.synthesis_apply(self.g_params["synthesis"], dl, cfg, noise=noise)
        imgs01 = ((imgs + 1.0) / 2.0).clamp(0.0, 1.0)
        B = z0.shape[0]
        d = self.distance_fn(imgs01[:B], imgs01[B:])
        return d / (self.epsilon ** 2)

    def evaluate(self) -> float:
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        dists = [self.batch_distances(*self.draw(gen)).float().cpu().numpy()
                 for _ in range(max(1, self.num_samples // self.batch_size))]
        d = np.concatenate(dists)
        # percentile filter (reference stylegan2/metrics/ppl.py:225-229)
        lo, hi = np.percentile(d, 1), np.percentile(d, 99)
        return float(d[(d >= lo) & (d <= hi)].mean())
