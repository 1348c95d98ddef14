"""StyleGAN2 generator (mapping + synthesis) and discriminator.

Behavioral reference: stylegan2/models.py (GeneratorMapping 516-627,
GeneratorSynthesis 753-1014, Generator truncation 314-324, Discriminator
1017-1230) and stylegan2/modules.py conv blocks (1263-1601). Config-f:
channels [32,32,64,128,256,512,512,512,512], base 4x4, skip-G / resnet-D,
2-layer blocks, 18 style layers at 1024px.

The port runs the JAX package's plain execution domain (its s2d domain is an
exact rewrite of the same math for the TPU's lane layout). Activations are
NHWC; parameters come from `weights.from_jax` (OIHW convs, right-multiply
dense weights, equalized-lr coefficients folded in). Three call sites of the
synthesis go through hand-written CUDA kernels on a GPU tensor:
`noise_bias_lrelu` (every layer's epilogue), `upsample2x` (the RGB skip) and
`modulated_matmul` (ToRGB).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

import torch

from clip_glass_torch.core.dtypes import FP32, Policy
from clip_glass_torch.ops.bias_act import bias_act, minibatch_std, noise_bias_lrelu
from clip_glass_torch.ops.modulated_conv import (
    conv2d,
    conv2d_down,
    modulated_conv2d,
    modulated_conv2d_up,
    modulated_matmul,
    style_from_latent,
)
from clip_glass_torch.ops.upfirdn import upsample2x
from clip_glass_torch.weights import from_jax


@dataclasses.dataclass(frozen=True)
class SG2Config:
    latent_size: int = 512
    mapping_layers: int = 8
    mapping_lr_mul: float = 0.01
    channels: Sequence[int] = (32, 32, 64, 128, 256, 512, 512, 512, 512)
    base_size: int = 4
    data_channels: int = 3
    conv_block_size: int = 2
    kernel_size: int = 3
    filter_taps: Sequence[int] = (1, 3, 3, 1)
    mbstd_group_size: int = 4
    demodulate: bool = True
    modulate_data_out: bool = True
    noise: bool = True
    eps: float = 1e-8

    @property
    def n_blocks(self) -> int:
        return len(self.channels)

    @property
    def resolution(self) -> int:
        return self.base_size * 2 ** (self.n_blocks - 1)

    @property
    def num_latents(self) -> int:
        # reference stylegan2/models.py:890-896
        n = 1 + self.conv_block_size * (self.n_blocks - 1)
        return n + 1 if self.modulate_data_out else n

    def block_channels(self) -> List[tuple]:
        """Synthesis blocks, first->last: (in_ch, out_ch, up, n_layers)."""
        ch = list(self.channels)
        blocks = [(ch[-1], ch[-1], False, 1)]
        for i in range(1, len(ch)):
            blocks.append((ch[-i], ch[-i - 1], True, self.conv_block_size))
        return blocks

    def noise_shapes(self) -> List[tuple]:
        shapes = []
        size = self.base_size
        for _, _, up, n_layers in self.block_channels():
            if up:
                size *= 2
            shapes.extend([(size, size)] * n_layers)
        return shapes


CONFIG_F = SG2Config()

# G leaves the forward reads raw in fp32: `truncate` lerps against
# dlatent_avg. Everything else is cast to the compute dtype once.
PRECAST_EXCLUDE = ("dlatent_avg",)
# tiny variant for tests: 3 blocks -> 16px, slim channels
TINY = SG2Config(latent_size=32, mapping_layers=2,
                 channels=(16, 16, 16), mbstd_group_size=2)


# ---------------------------------------------------------------- init
#
# Random init draws a JAX-layout tree (HWIO convs, [in, out] dense) from a
# torch.Generator with the JAX package's distributions and scales, then
# converts it with weights.from_jax like any carried-across tree.

def _he_coef(shape, gain=1.0, lr_mul=1.0):
    # the JAX package's rule, called with its own shape tuples (below), so
    # the scales are the same as its random init's
    fan_in = int(math.prod(shape[:-1]))
    return gain / math.sqrt(fan_in) * lr_mul


def _randn(gen, *shape):
    return torch.randn(shape, generator=gen, device=gen.device)


def _dense_init(gen, in_f, out_f, lr_mul=1.0, bias_init=0.0):
    """Effective (runtime-coefficient-folded) equalized-lr dense params."""
    coef = _he_coef((in_f,), 1.0, lr_mul)
    return {"w": _randn(gen, in_f, out_f) * (1.0 / lr_mul) * coef,
            "b": torch.full((out_f,), bias_init * lr_mul)}


def _conv_init(gen, in_ch, out_ch, k, latent=None, lr_mul=1.0, noise=False):
    coef = _he_coef((k, k, in_ch), 1.0, lr_mul)
    p = {"w": _randn(gen, k, k, in_ch, out_ch) * (1.0 / lr_mul) * coef,
         "b": torch.zeros(out_ch)}
    if latent is not None:
        p["style"] = _dense_init(gen, latent, in_ch, lr_mul, bias_init=1.0)
    if noise:
        p["noise_scale"] = torch.zeros(())
    return p


def _generator_tree(gen, cfg: SG2Config):
    mapping = {"dense": [
        _dense_init(gen, cfg.latent_size, cfg.latent_size, cfg.mapping_lr_mul)
        for _ in range(cfg.mapping_layers)]}
    syn = {"const": _randn(gen, cfg.base_size, cfg.base_size, cfg.channels[-1]),
           "blocks": [], "to_rgb": []}
    for in_ch, out_ch, _, n_layers in cfg.block_channels():
        layers = []
        c_in = in_ch
        for _ in range(n_layers):
            layers.append(_conv_init(gen, c_in, out_ch, cfg.kernel_size,
                                     latent=cfg.latent_size, noise=cfg.noise))
            c_in = out_ch
        syn["blocks"].append({"layers": layers})
        syn["to_rgb"].append(_conv_init(
            gen, out_ch, cfg.data_channels, 1,
            latent=cfg.latent_size if cfg.modulate_data_out else None))
    return {"mapping": mapping, "synthesis": syn,
            "dlatent_avg": torch.zeros(cfg.latent_size)}


def _discriminator_tree(gen, cfg: SG2Config):
    ch = list(cfg.channels)
    tree = {"from_rgb": _conv_init(gen, cfg.data_channels, ch[0], 1),
            "blocks": []}
    for i in range(len(ch) - 1):
        tree["blocks"].append({
            "conv0": _conv_init(gen, ch[i], ch[i], cfg.kernel_size),
            "conv1": _conv_init(gen, ch[i], ch[i + 1], cfg.kernel_size),
            "skip": {"w": _randn(gen, 1, 1, ch[i], ch[i + 1])
                     * _he_coef((1, 1, ch[i]))},
        })
    mb_extra = 1 if cfg.mbstd_group_size else 0
    tree["final_conv"] = _conv_init(gen, ch[-1] + mb_extra, ch[-1], cfg.kernel_size)
    tree["dense0"] = _dense_init(gen, ch[-1] * cfg.base_size ** 2, ch[-1])
    tree["dense1"] = _dense_init(gen, ch[-1], 1)
    return tree


def generator_init(gen: torch.Generator, cfg: SG2Config = CONFIG_F):
    """Random G parameters (the JAX package's distributions and scales)."""
    return from_jax.convert_generator(_generator_tree(gen, cfg))


def discriminator_init(gen: torch.Generator, cfg: SG2Config = CONFIG_F):
    """Random D parameters (the JAX package's distributions and scales)."""
    return from_jax.convert_discriminator(_discriminator_tree(gen, cfg))


# ---------------------------------------------------------------- forward

def mapping_apply(params, latents, cfg: SG2Config = CONFIG_F,
                  policy: Policy = FP32):
    """z -> w (reference stylegan2/models.py:589-627): RMS input normalize,
    dense + lrelu*sqrt(2) layers (unconditional: no label embedding)."""
    x = policy.cast_compute(latents)
    x32 = x.float()
    x = (x32 * torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + cfg.eps)
         ).to(x.dtype)
    for d in params["dense"]:
        x = x @ policy.cast_compute(d["w"])
        x = bias_act(x, policy.cast_compute(d["b"]), act="lrelu")
    return x


def truncate(dlatents, dlatent_avg, psi: float = 1.0,
             cutoff: Optional[int] = None):
    """Truncation lerp toward dlatent_avg (reference stylegan2/models.py:265-324).
    dlatents: [B, n_latents, D]."""
    if psi == 1.0:
        return dlatents
    n = dlatents.shape[1]
    layer_psi = torch.full((n,), float(psi), device=dlatents.device)
    if cutoff is not None:
        layer_psi = torch.where(torch.arange(n, device=dlatents.device) < cutoff,
                                layer_psi, torch.ones_like(layer_psi))
    avg = dlatent_avg[None, None, :]
    return avg + layer_psi[None, :, None] * (dlatents - avg)


def distribute_latents(dlatents, num_layers: int):
    """Expand [B, N, D] per-sample latents to [B, num_layers, D] (reference
    stylegan2/models.py:425-458): N == 1 broadcasts, N == num_layers passes
    through. Style mixing (other N) is not ported."""
    B, N, D = dlatents.shape
    if N == 1:
        return dlatents.expand(B, num_layers, D)
    if N == num_layers:
        return dlatents
    raise ValueError(f"{N} latents for {num_layers} layers: only 1 or "
                     f"{num_layers} are supported (style mixing is not ported)")


def synthesis_apply(params, dlatents, cfg: SG2Config = CONFIG_F,
                    noise: Optional[Sequence[torch.Tensor]] = None,
                    policy: Policy = FP32):
    """dlatents: [B, num_latents, D] -> images [B, C, H, W] in [-1, 1]
    (reference stylegan2/models.py:969-1014). `noise`: the per-layer [H, W]
    planes (shared over batch and channels) in `cfg.noise_shapes()` order,
    or None for no noise."""
    B = dlatents.shape[0]
    dl = policy.cast_compute(dlatents)
    const = policy.cast_compute(params["const"])
    x = const[None].expand(B, *const.shape)
    y = None
    layer_idx = 0
    noise_idx = 0
    taps = tuple(cfg.filter_taps)
    for bi, (_, _, up, n_layers) in enumerate(cfg.block_channels()):
        bp = params["blocks"][bi]
        for li in range(n_layers):
            lp = bp["layers"][li]
            style = style_from_latent(dl[:, layer_idx + li],
                                      policy.cast_compute(lp["style"]["w"]),
                                      policy.cast_compute(lp["style"]["b"]))
            w = policy.cast_compute(lp["w"])
            if up and li == 0:
                x = modulated_conv2d_up(x, w, style, demodulate=cfg.demodulate,
                                        filter_taps=taps, eps=cfg.eps)
            else:
                x = modulated_conv2d(x, w, style, demodulate=cfg.demodulate,
                                     eps=cfg.eps)
            b = policy.cast_compute(lp["b"])
            nz = noise[noise_idx] if (noise is not None and cfg.noise) else None
            if nz is not None:
                x = noise_bias_lrelu(x.contiguous(), policy.cast_compute(nz),
                                     policy.cast_compute(lp["noise_scale"]), b)
            else:
                x = bias_act(x, b, act="lrelu")
            noise_idx += 1
        layer_idx += n_layers

        if y is not None:
            y = upsample2x(y.contiguous(), taps)
        rp = params["to_rgb"][bi]
        style = None
        if cfg.modulate_data_out:
            lat = dl[:, min(layer_idx, cfg.num_latents - 1)]
            style = style_from_latent(lat, policy.cast_compute(rp["style"]["w"]),
                                      policy.cast_compute(rp["style"]["b"]))
        Bx, H, W, C = x.shape
        t = modulated_matmul(x.contiguous().reshape(Bx, H * W, C), style,
                             policy.cast_compute(rp["w"]), None,
                             policy.cast_compute(rp["b"]))
        t = t.reshape(Bx, H, W, -1)
        y = t if y is None else y + t
    return y.permute(0, 3, 1, 2)  # NHWC -> NCHW view (reference layout)


def generator_apply(params, latents, cfg: SG2Config = CONFIG_F,
                    truncation_psi: float = 1.0,
                    truncation_cutoff: Optional[int] = None,
                    noise: Optional[Sequence[torch.Tensor]] = None,
                    policy: Policy = FP32):
    """Full G: z -> mapping -> distribute to num_latents -> (truncate) ->
    synthesis (reference stylegan2/models.py:326-482). `latents` may be
    [B, D] or one latent per style layer, [B, num_latents, D]."""
    if latents.ndim == 3:
        B, N, D = latents.shape
        w = mapping_apply(params["mapping"], latents.reshape(B * N, D), cfg,
                          policy).reshape(B, N, -1)
    else:
        w = mapping_apply(params["mapping"], latents, cfg, policy)[:, None, :]
    dl = distribute_latents(w, cfg.num_latents)
    dl = truncate(dl, params["dlatent_avg"], truncation_psi, truncation_cutoff)
    return synthesis_apply(params["synthesis"], dl, cfg, noise=noise,
                           policy=policy)


def discriminator_apply(params, images, cfg: SG2Config = CONFIG_F,
                        policy: Policy = FP32):
    """images: [B, C, H, W] in [-1, 1] -> score logits [B, 1]
    (reference stylegan2/models.py:1193-1230)."""
    taps = tuple(cfg.filter_taps)
    res_scale = 1.0 / math.sqrt(2.0)
    x = policy.cast_compute(images.permute(0, 2, 3, 1))  # NHWC
    fr = params["from_rgb"]
    x = conv2d(x, policy.cast_compute(fr["w"]))
    x = bias_act(x, policy.cast_compute(fr["b"]), act="lrelu")
    for bp in params["blocks"]:
        inp = x
        x = conv2d(x, policy.cast_compute(bp["conv0"]["w"]))
        x = bias_act(x, policy.cast_compute(bp["conv0"]["b"]), act="lrelu")
        x = conv2d_down(x, policy.cast_compute(bp["conv1"]["w"]), filter_taps=taps)
        x = bias_act(x, policy.cast_compute(bp["conv1"]["b"]), act="lrelu")
        proj = conv2d_down(inp, policy.cast_compute(bp["skip"]["w"]),
                           filter_taps=taps)
        x = (x + proj) * res_scale
    if cfg.mbstd_group_size:
        x = minibatch_std(x, cfg.mbstd_group_size, cfg.eps)
    x = conv2d(x, policy.cast_compute(params["final_conv"]["w"]))
    x = bias_act(x, policy.cast_compute(params["final_conv"]["b"]), act="lrelu")
    # flatten in the reference's NCHW order (stylegan2/models.py:1224)
    x = x.permute(0, 3, 1, 2).reshape(x.shape[0], -1)
    x = x @ policy.cast_compute(params["dense0"]["w"])
    x = bias_act(x, policy.cast_compute(params["dense0"]["b"]), act="lrelu")
    x = x @ policy.cast_compute(params["dense1"]["w"])
    return bias_act(x, policy.cast_compute(params["dense1"]["b"]), act="linear")
