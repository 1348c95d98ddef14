"""Latent-space projector: gradient-based inversion of a target image.

Behavioral reference: stylegan2/project.py — dlatent statistics from N
mapping samples (60-97), Adam on (dlatent, per-layer noise) with LPIPS
distance + multiscale noise regularization + per-step noise renormalization
(239-295), cosine-ramped learning rate with initial noise amplitude ramp
(245-251). The port of the JAX package's `projector.py`.

The step differentiates through synthesis in the plain domain (the JAX
package passes `s2d=False`; here `s2d_min_res=2**30`), in fp32: on the card
the hand-written kernels 1-3 (noise + bias + leaky ReLU, the RGB skip's
upsample, ToRGB) run under grad through `ops.cuda.with_grad`. The final
render runs the config's default domain under `inference_mode` (kernel 4 too
at the s2d levels).

Adam is optax's `adam(1.0, b1=0.9, b2=0.999)` (`core.optim.adam_update`,
re-exported here) followed by a scale by the learning rate, as the JAX
projector scales its updates.
The perceptual distance is pluggable: LPIPS-VGG16 (`lpips_params`, the
reference's), any callable, or the `downsampled_l2` stand-in.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from clip_glass_torch.core.device import resolve_device
from clip_glass_torch.core.dtypes import FP32, tree_to
from clip_glass_torch.core.optim import AdamState, adam_init, adam_update  # noqa: F401
from clip_glass_torch.models.stylegan2 import model as sg2


def downsampled_l2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Default stand-in distance: L2 on 4x-downsampled images, per sample."""
    def down(x):
        B, C, H, W = x.shape
        return x.reshape(B, C, H // 4, 4, W // 4, 4).mean(dim=(3, 5))
    return (down(a) - down(b)).square().mean(dim=(1, 2, 3))


@dataclasses.dataclass
class ProjectorConfig:
    num_steps: int = 1000
    dlatent_samples: int = 10000   # stats draw (reference project.py:60-97)
    initial_lr: float = 0.1
    lr_rampdown: float = 0.25
    lr_rampup: float = 0.05
    initial_noise_factor: float = 0.05
    noise_ramp: float = 0.75
    regularize_noise_weight: float = 1e5
    seed: int = 0


def lpips_distance(lpips_params, policy=None):
    """Projector-compatible perceptual distance from LPIPS-VGG16 params
    (reference project.py:166-168: LPIPS on [0, 1]-range images)."""
    from clip_glass_torch.metrics.lpips import lpips

    pol = policy or FP32

    def distance(a, b):
        return lpips(lpips_params, a, b, pixel_min=0.0, pixel_max=1.0, policy=pol)

    return distance


def dlatent_statistics(mapping_params, z: torch.Tensor, model_cfg: sg2.SG2Config):
    """Mean dlatent [D] and the scalar spread of N mapping samples: the
    square root of the sum of squared deviations over all elements divided
    by N alone (reference project.py:60-97; not torch.std)."""
    with torch.no_grad():
        w = sg2.mapping_apply(mapping_params, z, model_cfg)
        avg = w.mean(dim=0)
        return avg, torch.sqrt((w - avg).square().sum() / z.shape[0])


def noise_regularization(noises: Sequence[torch.Tensor]) -> torch.Tensor:
    """Multiscale shift-correlation penalty (reference project.py:274-286)."""
    reg = 0.0
    for n in noises:
        n = n[None, None]  # [1, 1, H, W]
        while True:
            reg = (reg + (n * torch.roll(n, 1, dims=3)).mean() ** 2
                   + (n * torch.roll(n, 1, dims=2)).mean() ** 2)
            if n.shape[3] <= 8:
                break
            B, C, H, W = n.shape
            n = n.reshape(B, C, H // 2, 2, W // 2, 2).mean(dim=(3, 5))
    return reg


def renormalize(n: torch.Tensor) -> torch.Tensor:
    """Zero mean, unit population std (jnp.std: correction 0)."""
    return (n - n.mean()) / n.std(correction=0).clamp_min(1e-8)


def _leaf(p: torch.Tensor) -> torch.Tensor:
    """A fresh leaf that requires grad with p's values; an inference tensor
    (made under torch.inference_mode()) is copied first, since it cannot
    require grad."""
    return (p.clone() if p.is_inference() else p.detach()).requires_grad_(True)


class Projector:
    """Entry point: runs on the card unless `device="cpu"`; the parameter
    trees are moved there."""

    def __init__(self, g_params, model_cfg: sg2.SG2Config,
                 distance: Optional[Callable] = None,
                 cfg: Optional[ProjectorConfig] = None, lpips_params=None,
                 device: Optional[str] = None):
        """`lpips_params` switches the perceptual distance to LPIPS-VGG16
        (the reference's, stylegan2/project.py:239-295); otherwise
        `distance` or the downsampled-L2 stand-in is used."""
        self.device = resolve_device(device)
        self.g_params = tree_to(g_params, self.device)
        self.model_cfg = model_cfg
        # the differentiated synthesis: the plain domain throughout
        self.plain_cfg = dataclasses.replace(model_cfg, s2d_min_res=2 ** 30)
        self.cfg = cfg or ProjectorConfig()
        if lpips_params is not None:
            distance = lpips_distance(tree_to(lpips_params, self.device))
        self.distance = distance or downsampled_l2

        # dlatent statistics (reference project.py:60-97)
        gen = torch.Generator(device=self.device).manual_seed(self.cfg.seed)
        z = torch.randn((self.cfg.dlatent_samples, model_cfg.latent_size),
                        generator=gen, device=self.device)
        self.dlatent_avg, self.dlatent_std = dlatent_statistics(
            self.g_params["mapping"], z, model_cfg)

    def lr_schedule(self, t) -> np.float32:
        """Cosine rampdown + linear rampup (reference project.py:245-251), in
        fp32 as the JAX step computes it."""
        cfg = self.cfg
        t = np.float32(t)
        ramp_down = np.minimum(np.float32(1.0), (1.0 - t) / cfg.lr_rampdown)
        ramp_down = 0.5 - 0.5 * np.cos(ramp_down * math.pi)
        ramp_up = np.minimum(np.float32(1.0), t / cfg.lr_rampup)
        return cfg.initial_lr * ramp_down * ramp_up

    def noise_strength(self, t) -> torch.Tensor:
        cfg = self.cfg
        ramp = np.square(np.maximum(np.float32(0.0), 1.0 - np.float32(t) / cfg.noise_ramp))
        return self.dlatent_std * cfg.initial_noise_factor * float(ramp)

    def synthesize(self, dlatents, noises) -> torch.Tensor:
        """[B, 3, H, W] in [0, 1], the plain domain: the differentiated one."""
        imgs = sg2.synthesis_apply(self.g_params["synthesis"], dlatents, self.plain_cfg,
                                   noise=list(noises), policy=FP32)
        return ((imgs + 1.0) / 2.0).clamp(0.0, 1.0)

    def loss(self, dlatents, noises, target01, draw, t):
        """(distance + weighted noise penalty, distance) at the jittered
        dlatents; `draw` is the jitter's standard normal, dlatents' shape."""
        jitter = self.noise_strength(t) * draw
        dist = self.distance(self.synthesize(dlatents + jitter, noises), target01).sum()
        reg = noise_regularization(noises) * self.cfg.regularize_noise_weight
        return dist + reg, dist

    def step(self, opt_vars: Tuple[torch.Tensor, List[torch.Tensor]], opt_state: AdamState,
             target01: torch.Tensor, draw: torch.Tensor, t: float):
        """One optimization step. t = fraction of the whole run in [0, 1),
        from the caller's step count, so a shorter run still completes the
        learning-rate and noise schedules. Returns (opt_vars, opt_state,
        loss, dist)."""
        if torch.is_inference_mode_enabled():
            raise RuntimeError("Projector.step differentiates the synthesis: call it "
                               "outside torch.inference_mode()")
        lr = float(self.lr_schedule(t))
        dlatents, noises = opt_vars
        leaves = [_leaf(p) for p in (dlatents, *noises)]
        with torch.enable_grad():
            loss, dist = self.loss(leaves[0], leaves[1:], target01, draw, t)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        with torch.no_grad():
            updates, opt_state = adam_update(grads, opt_state)
            new = [p.detach() + u * lr for p, u in zip(leaves, updates)]
            # per-step noise renormalization (reference project.py:288-295)
            opt_vars = (new[0], [renormalize(n) for n in new[1:]])
        return opt_vars, opt_state, loss.detach(), dist.detach()

    def project(self, target01: torch.Tensor, num_steps: Optional[int] = None,
                verbose: bool = False):
        """target01: [B, 3, H, W] in [0, 1]. Returns (dlatents, images01)."""
        cfg = self.cfg
        num_steps = num_steps or cfg.num_steps
        target01 = target01.to(self.device)
        B = target01.shape[0]
        mc = self.model_cfg
        gen = torch.Generator(device=self.device).manual_seed(cfg.seed + 1)
        dlatents = self.dlatent_avg[None, None, :].expand(
            B, mc.num_latents, mc.latent_size).clone()
        noises = [torch.randn(s, generator=gen, device=self.device)
                  for s in mc.noise_shapes()]
        opt_vars = (dlatents, noises)
        opt_state = adam_init([dlatents, *noises])
        for i in range(num_steps):
            draw = torch.randn(dlatents.shape, generator=gen, device=self.device)
            opt_vars, opt_state, loss, dist = self.step(opt_vars, opt_state, target01,
                                                        draw, i / num_steps)
            if verbose and (i + 1) % max(1, num_steps // 10) == 0:
                print(f"project step {i + 1}/{num_steps} "
                      f"loss={float(loss):.4f} dist={float(dist):.4f}")
        dlatents, noises = opt_vars
        with torch.inference_mode():
            imgs = sg2.synthesis_apply(self.g_params["synthesis"], dlatents, mc,
                                       noise=list(noises), policy=FP32)
        return dlatents, ((imgs + 1.0) / 2.0).clamp(0.0, 1.0)
