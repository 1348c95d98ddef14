"""BigGAN-deep generator (128/256/512 px).

Behavioral reference: the generator of the `pytorch-pretrained-biggan`
package that the reference consumes (reference models.py:65-86), in the
JAX package's formulation so the numbers follow it: a shared class
embedding (a bias-free linear over the soft class vector), cond = [z,
embed], one dense to a 4x4 seed, bottleneck residual blocks with
conditional batch norm on truncation-interpolated running statistics, one
self-attention block, and BN -> ReLU -> conv -> the first 3 channels ->
tanh, emitted NCHW in [-1, 1].

Two execution domains, as in the JAX package: the mid segment of a block
whose output resolution is >= cfg.s2d_min_res (and 4*mid <= 512) runs in the
space-to-depth domain (`_block_mid_s2d`, ops/s2d.py's BigGAN ops); the
blocks' inputs and outputs stay plain. `dataclasses.replace(cfg,
s2d_min_res=2**30)` runs everything plain. The [2,2] folds of that segment
(the same-resolution 3x3 convs between opposite lattices) are the
hand-written kernel `s2d_conv2x2` on a GPU tensor, with one weight set
shared by every sample; each batch norm with the ReLU after it (and the
preceding conv's bias) is the hand-written kernel `cond_bn_relu`
(ops/norms.py) on a GPU tensor; self-attention and the dense layers are
stock PyTorch, as the JAX package leaves them to XLA.

Activations are NHWC; parameters come from `weights.from_jax` (OIHW convs,
right-multiply dense weights, [n_stats, C] running statistics).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

import torch

from clip_glass_torch.core.dtypes import FP32, Policy
from clip_glass_torch.evolve.sampling import truncnorm_core
from clip_glass_torch.ops import norms
from clip_glass_torch.ops import s2d as S
from clip_glass_torch.ops.modulated_conv import _conv_float
from clip_glass_torch.weights import from_jax


@dataclasses.dataclass(frozen=True)
class BigGANConfig:
    z_dim: int = 128
    channel_width: int = 128
    num_classes: int = 1000
    # (up_sample, in_mult, out_mult) per GenBlock, first -> last
    layers: Sequence[Tuple[bool, int, int]] = ()
    attention_layer_position: int = 8
    eps: float = 1e-4
    n_stats: int = 51
    output_dim: int = 256
    # Bottleneck mid segments whose output resolution >= this run in the
    # space-to-depth domain (_block_mid_s2d, ops/s2d.py). 2**30 disables.
    s2d_min_res: int = 256

    @property
    def cond_dim(self) -> int:
        return 2 * self.z_dim


_L128 = [(False, 16, 16), (True, 16, 16), (False, 16, 16), (True, 16, 8),
         (False, 8, 8), (True, 8, 4), (False, 4, 4), (True, 4, 2),
         (False, 2, 2), (True, 2, 1)]
_L256 = [(False, 16, 16), (True, 16, 16), (False, 16, 16), (True, 16, 8),
         (False, 8, 8), (True, 8, 8), (False, 8, 8), (True, 8, 4),
         (False, 4, 4), (True, 4, 2), (False, 2, 2), (True, 2, 1)]
_L512 = _L256 + [(False, 1, 1), (True, 1, 1)]

BIGGAN_DEEP_128 = BigGANConfig(layers=tuple(_L128), output_dim=128)
BIGGAN_DEEP_256 = BigGANConfig(layers=tuple(_L256), output_dim=256)
BIGGAN_DEEP_512 = BigGANConfig(layers=tuple(_L512), attention_layer_position=8,
                               output_dim=512)
# tiny variant for tests: 8 px out, 2 blocks, slim channels
TINY = BigGANConfig(z_dim=16, channel_width=8, num_classes=10,
                    layers=((False, 2, 2), (True, 2, 1)),
                    attention_layer_position=0, output_dim=8)

CONFIGS = {"biggan-deep-128": BIGGAN_DEEP_128,
           "biggan-deep-256": BIGGAN_DEEP_256,
           "biggan-deep-512": BIGGAN_DEEP_512}

# The BN running statistics are interpolated and applied raw in fp32; every
# other weight is read through policy.cast_compute, so staging a frozen tree
# for the compute dtype (core.dtypes.precast_params) excludes only them.
PRECAST_EXCLUDE = ("running_",)


def truncated_noise_sample(gen: torch.Generator, batch: int, dim_z: int = 128,
                           truncation: float = 1.0) -> torch.Tensor:
    """truncnorm(-2, 2) * truncation (the package helper of reference
    latent.py:9), drawn from `gen` on its device."""
    u = torch.rand((batch, dim_z), generator=gen, device=gen.device)
    return truncation * truncnorm_core(u)


# ---------------------------------------------------------------- init
#
# Random init draws a JAX-layout tree (HWIO convs, [in, out] dense) from a
# torch.Generator with the JAX package's distributions (N(0, 0.02) weights,
# zero biases, running means 0 and variances 1), then converts it with
# weights.from_jax like any carried-across tree.


def _randn(gen, *shape):
    return torch.randn(shape, generator=gen, device=gen.device)


def _linear(gen, in_f, out_f, bias=True, std=0.02):
    p = {"w": std * _randn(gen, in_f, out_f)}
    if bias:
        p["b"] = torch.zeros(out_f)
    return p


def _conv_init(gen, in_ch, out_ch, k, bias=True, std=0.02):
    p = {"w": std * _randn(gen, k, k, in_ch, out_ch)}
    if bias:
        p["b"] = torch.zeros(out_ch)
    return p


def _cond_bn(gen, ch, cond_dim, n_stats):
    return {"running_means": torch.zeros(n_stats, ch),
            "running_vars": torch.ones(n_stats, ch),
            "scale": _linear(gen, cond_dim, ch, bias=False),
            "offset": _linear(gen, cond_dim, ch, bias=False)}


def _gen_block(gen, in_ch, out_ch, cond_dim, n_stats, reduction=4):
    mid = in_ch // reduction
    return {"bn_0": _cond_bn(gen, in_ch, cond_dim, n_stats),
            "conv_0": _conv_init(gen, in_ch, mid, 1),
            "bn_1": _cond_bn(gen, mid, cond_dim, n_stats),
            "conv_1": _conv_init(gen, mid, mid, 3),
            "bn_2": _cond_bn(gen, mid, cond_dim, n_stats),
            "conv_2": _conv_init(gen, mid, mid, 3),
            "bn_3": _cond_bn(gen, mid, cond_dim, n_stats),
            "conv_3": _conv_init(gen, mid, out_ch, 1)}


def _self_attn(gen, ch):
    return {"theta": _conv_init(gen, ch, ch // 8, 1, bias=False),
            "phi": _conv_init(gen, ch, ch // 8, 1, bias=False),
            "g": _conv_init(gen, ch, ch // 2, 1, bias=False),
            "o_conv": _conv_init(gen, ch // 2, ch, 1, bias=False),
            "gamma": torch.zeros(())}


def init_tree(gen: torch.Generator, cfg: BigGANConfig = BIGGAN_DEEP_256):
    """Random parameters in the JAX layout (what a converted `.npz` holds):
    the `blocks` list carries the attention entry {"attn": ...} in place."""
    ch = cfg.channel_width
    blocks = []
    for i, (_, in_m, out_m) in enumerate(cfg.layers):
        if i == cfg.attention_layer_position:
            blocks.append({"attn": _self_attn(gen, ch * in_m)})
        blocks.append({"block": _gen_block(gen, ch * in_m, ch * out_m, cfg.cond_dim,
                                           cfg.n_stats)})
    first_mult, last_mult = cfg.layers[0][1], cfg.layers[-1][2]
    return {"embeddings": _linear(gen, cfg.num_classes, cfg.z_dim, bias=False),
            "gen_z": _linear(gen, cfg.cond_dim, 4 * 4 * first_mult * ch),
            "blocks": blocks,
            "bn": {"running_means": torch.zeros(cfg.n_stats, ch * last_mult),
                   "running_vars": torch.ones(cfg.n_stats, ch * last_mult),
                   "weight": torch.ones(ch * last_mult),
                   "bias": torch.zeros(ch * last_mult)},
            "conv_to_rgb": _conv_init(gen, ch * last_mult, ch * last_mult, 3)}


def init(gen: torch.Generator, cfg: BigGANConfig = BIGGAN_DEEP_256):
    """Random parameters (the JAX package's distributions)."""
    return from_jax.convert_biggan(init_tree(gen, cfg))


# ---------------------------------------------------------------- forward


def _interp_stats(means, variances, truncation: float, n_stats: int):
    """Running stats are recorded for truncation values linspace(0, 1,
    n_stats); combine the two neighbours exactly as the package's
    BigGANBatchNorm does: `coef, i = math.modf(truncation * (n_stats-1))`,
    `stat = stats[i]*coef + stats[i+1]*(1-coef)`. The package weights the
    LOWER grid point by the FRACTIONAL part, inverted against an ordinary
    lerp; kept verbatim for checkpoint parity (at the configs' truncation
    1.0 it lands on the grid)."""
    coef, lo = math.modf(truncation * (n_stats - 1))
    lo = int(lo)
    if coef == 0.0:
        return means[lo], variances[lo]
    return (means[lo] * coef + means[lo + 1] * (1 - coef),
            variances[lo] * coef + variances[lo + 1] * (1 - coef))


def _bn_stats(p, truncation, cfg):
    """The batch norm's fp32 statistics: the interpolated running mean and
    rsqrt(running var + eps)."""
    mean, var = _interp_stats(p["running_means"], p["running_vars"], truncation,
                              cfg.n_stats)
    return mean, torch.rsqrt(var + cfg.eps)


def _cond_bn_relu(p, x, cond, truncation, cfg, policy: Policy, b_conv=None,
                  phases: int = 1):
    """Conditional BN + ReLU (ops/norms.cond_bn_relu): the gain 1 + cond @
    scale and the bias cond @ offset in the compute dtype, the preceding
    conv's bias `b_conv` added to x in x's dtype, the normalization in fp32
    from the raw fp32 statistics, one rounding back to x's dtype. `phases`
    = 4 applies it to an s2d tensor."""
    weight = 1.0 + cond @ policy.cast_compute(p["scale"]["w"])
    bias = cond @ policy.cast_compute(p["offset"]["w"])
    return norms.cond_bn_relu(x, *_bn_stats(p, truncation, cfg), weight, bias, b_conv,
                              phases)


def _conv(p, x, policy: Policy):
    """Stride-1 conv with the package's padding, (k-1)//2 on each side, and
    no bias; never quantized, as the JAX package's lax.conv_general_dilated
    call here."""
    w = policy.cast_compute(p["w"])
    pad = (w.shape[-1] - 1) // 2
    return _conv_float(x, w, pad0=pad, pad1=pad)


def _conv_apply(p, x, policy: Policy):
    """`_conv` and the conv's bias."""
    y = _conv(p, x, policy)
    if "b" in p:
        y = y + policy.cast_compute(p["b"])
    return y


def _upsample_nearest(x):
    B, H, W, C = x.shape
    return x[:, :, None, :, None, :].expand(B, H, 2, W, 2, C).reshape(B, 2 * H, 2 * W, C)


def _maxpool2(x):
    """2x2 max pool, stride 2, VALID (a trailing odd row/col is dropped)."""
    B, H, W, C = x.shape
    x = x[:, :H // 2 * 2, :W // 2 * 2]
    return x.reshape(B, H // 2, 2, W // 2, 2, C).amax(dim=(2, 4))


def _block_mid_s2d(p, h, cond, truncation, up: bool, cfg, policy: Policy, skip=None):
    """The bottleneck mid segment (conv0 1x1 -> [nearest up] -> conv1 3x3 ->
    conv2 3x3 -> conv3 1x1) in the space-to-depth domain: conv0 folds plain
    -> s2d, the nearest upsample composes into conv1, conv2 alternates the
    lattice offset (a [2,2] fold: `s2d_conv2x2`), conv3 folds back to plain.
    Exact: every op is a re-indexed fold of the plain formulation.

    skip (up blocks only): the channel-dropped residual at the pre-up
    resolution. The up chain then runs offsets 0 -> -1 -> 0, so the exit
    sits on the aligned lattice where `h + upsample_nearest(skip)` folds into
    the exit conv (s2d_exit_conv1x1_skip). Returns the block OUTPUT
    (residual included) when skip is given, else the mid segment's.

    Every tensor that mask_phantoms_ writes is fresh: the output of the
    BN + ReLU that precedes it, read by nothing else."""
    cc = policy.cast_compute

    def bn_relu(name, t, conv):
        return _cond_bn_relu(p[name], t, cond, truncation, cfg, policy, cc(p[conv]["b"]), 4)

    hs = S.s2d_enter_conv1x1(h, cc(p["conv_0"]["w"]))
    hs = bn_relu("bn_1", hs, "conv_0")
    if up:
        off = -1 if skip is not None else 0
        hs = S.s2d_nearest_up_conv(hs, cc(p["conv_1"]["w"]), in_off=0, out_off=off)
    else:
        hs = S.s2d_conv2d(hs, cc(p["conv_1"]["w"]), 0, -1)
        off = -1
    hs = bn_relu("bn_2", hs, "conv_1")
    if off:
        hs = S.mask_phantoms_(hs)
    off2 = 0 if off else -1
    hs = S.s2d_conv2d(hs, cc(p["conv_2"]["w"]), off, off2)
    hs = bn_relu("bn_3", hs, "conv_2")
    if off2:
        hs = S.mask_phantoms_(hs)
    if skip is not None:
        out = S.s2d_exit_conv1x1_skip(hs, cc(p["conv_3"]["w"]), skip, in_off=off2)
    else:
        out = S.s2d_exit_conv1x1(hs, cc(p["conv_3"]["w"]), in_off=off2)
    return out + cc(p["conv_3"]["b"])


def _gen_block_apply(p, x, cond, truncation, up: bool, cfg, policy: Policy):
    x0 = x
    h = _cond_bn_relu(p["bn_0"], x, cond, truncation, cfg, policy)
    mid = p["conv_0"]["w"].shape[0]
    out_res = 2 * x.shape[1] if up else x.shape[1]
    if out_res >= cfg.s2d_min_res and 4 * mid <= 512:
        if up:
            # the residual's nearest-up + add ride the mid segment's exit
            # conv: the full-resolution skip broadcast is never made
            out_ch = p["conv_3"]["w"].shape[0]
            return _block_mid_s2d(p, h, cond, truncation, up, cfg, policy,
                                  skip=x0[..., :out_ch])
        h = _block_mid_s2d(p, h, cond, truncation, up, cfg, policy)
    else:
        cc = policy.cast_compute
        h = _conv(p["conv_0"], h, policy)
        h = _cond_bn_relu(p["bn_1"], h, cond, truncation, cfg, policy, cc(p["conv_0"]["b"]))
        if up:
            h = _upsample_nearest(h)
        h = _conv(p["conv_1"], h, policy)
        h = _cond_bn_relu(p["bn_2"], h, cond, truncation, cfg, policy, cc(p["conv_1"]["b"]))
        h = _conv(p["conv_2"], h, policy)
        h = _cond_bn_relu(p["bn_3"], h, cond, truncation, cfg, policy, cc(p["conv_2"]["b"]))
        h = _conv_apply(p["conv_3"], h, policy)

    out_ch = h.shape[-1]
    if x0.shape[-1] != out_ch:
        x0 = x0[..., :out_ch]  # channel-drop residual (BigGAN-deep)
    if up:
        x0 = _upsample_nearest(x0)
    return h + x0


def _self_attn_apply(p, x, policy: Policy):
    """SAGAN self-attention; the scores in fp32 from compute-dtype operands
    (the JAX package's preferred_element_type=float32), the softmax in fp32,
    rounded back to x's dtype."""
    B, H, W, C = x.shape
    theta = _conv_apply(p["theta"], x, policy).reshape(B, H * W, C // 8)
    phi = _maxpool2(_conv_apply(p["phi"], x, policy)).reshape(B, H * W // 4, C // 8)
    scores = torch.bmm(theta.float(), phi.float().transpose(1, 2))
    attn = torch.softmax(scores, dim=-1).to(x.dtype)
    g = _maxpool2(_conv_apply(p["g"], x, policy)).reshape(B, H * W // 4, C // 2)
    attn_g = torch.bmm(attn, g).reshape(B, H, W, C // 2)
    o = _conv_apply(p["o_conv"], attn_g, policy)
    return x + policy.cast_compute(p["gamma"]) * o


def apply(params, z, class_vector, truncation: float = 1.0,
          cfg: BigGANConfig = BIGGAN_DEEP_256, policy: Policy = FP32) -> torch.Tensor:
    """z: [B, z_dim]; class_vector: [B, num_classes] soft class weights
    (the softmax of the class genes, reference latent.py:21-24). Returns
    images [B, 3, H, W] in [-1, 1]."""
    cc = policy.cast_compute
    z = cc(z)
    embed = cc(class_vector) @ cc(params["embeddings"]["w"])
    cond = torch.cat([z, embed], dim=1)

    h = cond @ cc(params["gen_z"]["w"]) + cc(params["gen_z"]["b"])
    # the TF/HF layout views the seed as [B, 4, 4, C] (already NHWC)
    h = h.reshape(-1, 4, 4, cfg.layers[0][1] * cfg.channel_width)

    li = 0
    for entry in params["blocks"]:
        if "attn" in entry:
            h = _self_attn_apply(entry["attn"], h, policy)
        else:
            h = _gen_block_apply(entry["block"], h, cond, truncation, cfg.layers[li][0],
                                 cfg, policy)
            li += 1

    bn = params["bn"]
    h = norms.cond_bn_relu(h, *_bn_stats(bn, truncation, cfg), bn["weight"], bn["bias"])
    # The package's conv_to_rgb maps ch -> ch and KEEPS ONLY the first 3
    # channels; slicing the kernel's outputs gives the same numbers for 3/ch
    # of the products. The checkpoint keeps the full weight.
    w = cc(params["conv_to_rgb"]["w"][:3])
    pad = (w.shape[-1] - 1) // 2
    h = _conv_float(h, w, pad0=pad, pad1=pad).permute(0, 3, 1, 2)
    h = h + cc(params["conv_to_rgb"]["b"][:3])[:, None, None]
    return torch.tanh(h)  # NCHW like the reference
