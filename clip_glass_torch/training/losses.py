"""GAN losses and regularizers for StyleGAN2 training.

Behavioral reference: stylegan2/loss_fns.py: non-saturating / saturating
logistic and WGAN generator losses (57-78, 251-260), logistic / WGAN(+GP)
discriminator losses (81-98, 263-347), R1 / R2 gradient penalties (106-190),
and path-length regularization with its pl_avg EMA (42-49, 198-243). The
port of the JAX package's `training/losses.py`.

The penalties differentiate a gradient: `torch.autograd.grad(...,
create_graph=True)` where JAX takes `jax.grad` / `jax.vjp`, so a gradient
of the penalty with respect to the parameters goes through the gradient's
own graph (on the card through the kernels' `cuda._KernelGrad`, twice
differentiable). Penalties come unscaled: lazy regularization multiplies
them by the interval outside.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F


# ------------------------------------------------------------ G losses

def g_logistic_ns(fake_scores: torch.Tensor) -> torch.Tensor:
    """Non-saturating logistic: softplus(-D(G(z))) (loss_fns.py:57-66)."""
    return F.softplus(-fake_scores).mean()


def g_logistic(fake_scores: torch.Tensor) -> torch.Tensor:
    """Saturating logistic: -softplus(D(G(z)))."""
    return (-F.softplus(fake_scores)).mean()


def g_wgan(fake_scores: torch.Tensor) -> torch.Tensor:
    """WGAN G loss: -D(G(z)) (loss_fns.py:251-260)."""
    return -fake_scores.mean()


# ------------------------------------------------------------ D losses

def d_logistic(real_scores: torch.Tensor, fake_scores: torch.Tensor) -> torch.Tensor:
    """softplus(D(fake)) + softplus(-D(real)) (loss_fns.py:81-90)."""
    return F.softplus(fake_scores).mean() + F.softplus(-real_scores).mean()


def d_wgan(real_scores: torch.Tensor, fake_scores: torch.Tensor) -> torch.Tensor:
    return fake_scores.mean() - real_scores.mean()


def _input_grad(d_apply: Callable, params, x: torch.Tensor) -> torch.Tensor:
    """d sum(D(x)) / dx with its graph kept (x made a leaf that requires
    grad if it is not part of a graph already)."""
    if not x.requires_grad:
        x = x.detach().requires_grad_(True)
    with torch.enable_grad():
        (grad,) = torch.autograd.grad(d_apply(params, x).sum(), [x], create_graph=True)
    return grad


def d_wgan_gp(d_apply: Callable, params, reals, fakes,
              generator: Optional[torch.Generator] = None, gamma: float = 10.0,
              eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """WGAN gradient penalty on interpolates (loss_fns.py:263-347). `eps`
    [B, 1, 1, 1] uniform in [0, 1), drawn from `generator` unless given."""
    if eps is None:
        eps = torch.rand((reals.shape[0], 1, 1, 1), generator=generator,
                         device=reals.device)
    interp = eps * reals + (1 - eps) * fakes
    grads = _input_grad(d_apply, params, interp)
    norms = torch.sqrt(grads.reshape(grads.shape[0], -1).square().sum(dim=1) + 1e-8)
    return gamma * (norms - 1.0).square().mean()


# ------------------------------------------------------------ penalties

def r1_penalty(d_apply: Callable, params, reals, gamma: float = 10.0) -> torch.Tensor:
    """R1: gamma/2 * E||grad_x D(x)||^2 on reals (loss_fns.py:106-148)."""
    grads = _input_grad(d_apply, params, reals)
    return (gamma * 0.5) * grads.reshape(grads.shape[0], -1).square().sum(dim=1).mean()


def r2_penalty(d_apply: Callable, params, fakes, gamma: float = 10.0) -> torch.Tensor:
    """R2: the same on fakes (loss_fns.py:151-190)."""
    return r1_penalty(d_apply, params, fakes, gamma)


def path_length_reg(synthesis_apply: Callable, params, dlatents: torch.Tensor,
                    pl_avg: torch.Tensor, pl_decay: float = 0.01, pl_weight: float = 2.0,
                    y: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Path-length regularization (loss_fns.py:198-243): penalize the
    deviation of |J^T y| from its running mean; returns (penalty,
    new_pl_avg).

    dlatents: [B, n_latents, D], part of the caller's graph or not. `y` is
    the random projection's standard normal draw, the image's shape, drawn
    from `generator` unless given; it is divided by sqrt(H * W) here."""
    with torch.enable_grad():
        if not dlatents.requires_grad:
            dlatents = dlatents.detach().requires_grad_(True)
        imgs = synthesis_apply(params, dlatents)
        H, W = imgs.shape[-2:]
        if y is None:
            y = torch.randn(imgs.shape, generator=generator, device=imgs.device)
        y = y / math.sqrt(H * W)
        (grads,) = torch.autograd.grad(imgs, [dlatents], y, create_graph=True)
    lengths = torch.sqrt(grads.square().sum(dim=-1).mean(dim=-1) + 1e-8)  # [B]
    new_pl_avg = pl_avg + pl_decay * (lengths.mean() - pl_avg)
    penalty = pl_weight * (lengths - new_pl_avg).square().mean()
    return penalty, new_pl_avg
