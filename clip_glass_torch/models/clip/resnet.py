"""CLIP ModifiedResNet vision tower (RN50 family).

Behavioral reference: reference clip/model.py:9-149, in the JAX package's
formulation so the numbers follow it: a 3-conv stem with a 2x2 average
pool, bottlenecks anti-aliased by an average pool before the strided conv3
and on the downsample branch, and attention pooling (a mean token, a
learned positional embedding, separate q/k/v projections).

NCHW throughout, convs by `F.conv2d` in the compute dtype (the JAX package
leaves them to XLA). Eval-mode BatchNorm is folded to `x * scale + bias` at
conversion (`weights/convert_clip_rn.py`) and applied in fp32. Parameters
come in the port's layout (`weights.from_jax.convert_clip`): OIHW convs and
the attention pool's q/k/v projections joined into one [C, 3C] matrix.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F

from clip_glass_torch.core.dtypes import FP32, Policy
from clip_glass_torch.ops.attention import multi_head_attention


@dataclasses.dataclass(frozen=True)
class RNConfig:
    layers: Sequence[int] = (3, 4, 6, 3)   # RN50
    output_dim: int = 1024
    input_resolution: int = 224
    width: int = 64

    @property
    def heads(self) -> int:
        return self.width * 32 // 64  # reference clip/model.py:258

    @property
    def embed_dim(self) -> int:
        return self.width * 32


RN50 = RNConfig()
TINY_RN = RNConfig(layers=(1, 1, 1, 1), output_dim=64, input_resolution=32, width=16)

STAGE_STRIDES = (1, 2, 2, 2)


# ---------------------------------------------------------------- init

def _randn(gen, *shape):
    return torch.randn(shape, generator=gen, device=gen.device)


def _bn_tree(ch):
    return {"scale": torch.ones(ch), "bias": torch.zeros(ch)}


def _conv_tree(gen, in_ch, out_ch, k):
    return _randn(gen, k, k, in_ch, out_ch) * (in_ch * k * k) ** -0.5


def _bottleneck_tree(gen, inplanes, planes, stride):
    p = {"conv1": _conv_tree(gen, inplanes, planes, 1), "bn1": _bn_tree(planes),
         "conv2": _conv_tree(gen, planes, planes, 3), "bn2": _bn_tree(planes),
         "conv3": _conv_tree(gen, planes, planes * 4, 1), "bn3": _bn_tree(planes * 4)}
    if stride > 1 or inplanes != planes * 4:
        p["downsample"] = {"conv": _conv_tree(gen, inplanes, planes * 4, 1),
                           "bn": _bn_tree(planes * 4)}
    return p


def init_tree(gen: torch.Generator, cfg: RNConfig = RN50):
    """Random parameters (the JAX package's distributions and scales) in the
    JAX layout: HWIO convs, BN already folded (scale 1, bias 0)."""
    w = cfg.width
    tree = {"stem": {"conv1": _conv_tree(gen, 3, w // 2, 3), "bn1": _bn_tree(w // 2),
                     "conv2": _conv_tree(gen, w // 2, w // 2, 3), "bn2": _bn_tree(w // 2),
                     "conv3": _conv_tree(gen, w // 2, w, 3), "bn3": _bn_tree(w)}}
    inplanes = w
    for li, (blocks, stride) in enumerate(zip(cfg.layers, STAGE_STRIDES)):
        planes = w * 2 ** li
        layer = []
        for b in range(blocks):
            layer.append(_bottleneck_tree(gen, inplanes, planes, stride if b == 0 else 1))
            inplanes = planes * 4
        tree[f"layer{li + 1}"] = layer
    ed = cfg.embed_dim
    spacial = cfg.input_resolution // 32

    def linear(out_f):
        return {"w": _randn(gen, ed, out_f) * ed ** -0.5, "b": torch.zeros(out_f)}

    tree["attnpool"] = {"positional_embedding": _randn(gen, spacial ** 2 + 1, ed) / ed ** 0.5,
                        "q": linear(ed), "k": linear(ed), "v": linear(ed),
                        "c": linear(cfg.output_dim)}
    return tree


# ---------------------------------------------------------------- forward

def _bn(x, p):
    """Folded eval BN, y = x * scale + bias, in fp32."""
    return (x.float() * p["scale"][:, None, None] + p["bias"][:, None, None]).to(x.dtype)


def _conv_bn(x, w, bn, policy: Policy, stride: int = 1, pad: int = 0):
    return _bn(F.conv2d(x, policy.cast_compute(w), stride=stride, padding=pad), bn)


def _bottleneck_apply(p, x, stride: int, policy: Policy):
    identity = x
    out = torch.relu(_conv_bn(x, p["conv1"], p["bn1"], policy))
    out = torch.relu(_conv_bn(out, p["conv2"], p["bn2"], policy, pad=1))
    if stride > 1:
        out = F.avg_pool2d(out, stride)
    out = _conv_bn(out, p["conv3"], p["bn3"], policy)
    if "downsample" in p:
        if stride > 1:
            identity = F.avg_pool2d(identity, stride)
        identity = _conv_bn(identity, p["downsample"]["conv"], p["downsample"]["bn"], policy)
    return torch.relu(out + identity)


def _attnpool_apply(p, x, n_heads: int, policy: Policy):
    """Attention pooling (reference clip/model.py:55-91): the mean token
    first, the positional embedding added, one multi-head attention; token
    0's output."""
    B, C, H, W = x.shape
    t = x.reshape(B, C, H * W).transpose(1, 2)
    t = torch.cat([t.mean(dim=1, keepdim=True), t], dim=1)
    t = t + policy.cast_compute(p["positional_embedding"])
    out = multi_head_attention(t, p["in_proj_weight"], p["in_proj_bias"],
                               p["out_proj_weight"], p["out_proj_bias"], n_heads,
                               mask=None, policy=policy)
    return out[:, 0]


def apply(params, images, cfg: RNConfig = RN50, policy: Policy = FP32) -> torch.Tensor:
    """images [B, 3, H, W] -> features [B, output_dim] (reference
    clip/model.py:133-149)."""
    x = policy.cast_compute(images)
    s = params["stem"]
    x = torch.relu(_conv_bn(x, s["conv1"], s["bn1"], policy, stride=2, pad=1))
    x = torch.relu(_conv_bn(x, s["conv2"], s["bn2"], policy, pad=1))
    x = torch.relu(_conv_bn(x, s["conv3"], s["bn3"], policy, pad=1))
    x = F.avg_pool2d(x, 2)
    for li, stride in enumerate(STAGE_STRIDES):
        for b, bp in enumerate(params[f"layer{li + 1}"]):
            x = _bottleneck_apply(bp, x, stride if b == 0 else 1, policy)
    return _attnpool_apply(params["attnpool"], x, cfg.heads, policy)
