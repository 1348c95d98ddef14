"""InceptionV3 feature extractor for FID.

Behavioral reference: stylegan2/external_models/inception.py:29-276 — the
pytorch-fid InceptionV3 variant: standard torchvision InceptionV3 trunk with
FID-specific pooling patches (InceptionA/C/E_1 use count_exclude-pad average
pooling; the final InceptionE_2 uses max pooling in its pool branch), inputs
bilinearly resized to 299 and scaled from [0,1] to [-1,1], output = the
2048-d pre-logits average pool. The port of the JAX package's
`metrics/inception.py`, in NCHW on stock cuDNN convs (the trunk holds no
hand-written kernel).

Parameters: each BasicConv2d is {"w": [O, I, kh, kw], "bn_scale": [O],
"bn_bias": [O]}, the eval-mode BN applied in fp32 after the conv.
`convert_torch_inception` turns the pytorch-fid / torchvision state dict
into the JAX package's numpy tree (HWIO, BN folded to scale and bias; what
the convert CLI writes), `load_npz` reads that file into the port's tree,
and `init` draws a random-weight instance.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from clip_glass_torch.core import pytree
from clip_glass_torch.core.dtypes import FP32, Policy
from clip_glass_torch.weights import from_jax

# the trunk, in order: stem convs (name, cin, cout, kh, kw) and the Mixed
# blocks (name, kind, cin, the A blocks' pool features / the C blocks' c7)
STEM = [("Conv2d_1a_3x3", 3, 32, 3, 3), ("Conv2d_2a_3x3", 32, 32, 3, 3),
        ("Conv2d_2b_3x3", 32, 64, 3, 3), ("Conv2d_3b_1x1", 64, 80, 1, 1),
        ("Conv2d_4a_3x3", 80, 192, 3, 3)]
MIXED = [("Mixed_5b", "a", 192, 32), ("Mixed_5c", "a", 256, 64),
         ("Mixed_5d", "a", 288, 64), ("Mixed_6a", "b", 288, None),
         ("Mixed_6b", "c", 768, 128), ("Mixed_6c", "c", 768, 160),
         ("Mixed_6d", "c", 768, 160), ("Mixed_6e", "c", 768, 192),
         ("Mixed_7a", "d", 768, None), ("Mixed_7b", "e", 1280, None),
         ("Mixed_7c", "e", 2048, None)]


def branches(kind: str, cin: int, arg=None) -> Dict[str, tuple]:
    """A Mixed block's BasicConv2d branches: name -> (cin, cout, kh, kw)
    (torchvision InceptionV3's channel tables)."""
    if kind == "a":
        return {"branch1x1": (cin, 64, 1, 1), "branch5x5_1": (cin, 48, 1, 1),
                "branch5x5_2": (48, 64, 5, 5), "branch3x3dbl_1": (cin, 64, 1, 1),
                "branch3x3dbl_2": (64, 96, 3, 3), "branch3x3dbl_3": (96, 96, 3, 3),
                "branch_pool": (cin, arg, 1, 1)}
    if kind == "b":
        return {"branch3x3": (cin, 384, 3, 3), "branch3x3dbl_1": (cin, 64, 1, 1),
                "branch3x3dbl_2": (64, 96, 3, 3), "branch3x3dbl_3": (96, 96, 3, 3)}
    if kind == "c":
        c7 = arg
        return {"branch1x1": (cin, 192, 1, 1), "branch7x7_1": (cin, c7, 1, 1),
                "branch7x7_2": (c7, c7, 1, 7), "branch7x7_3": (c7, 192, 7, 1),
                "branch7x7dbl_1": (cin, c7, 1, 1), "branch7x7dbl_2": (c7, c7, 7, 1),
                "branch7x7dbl_3": (c7, c7, 1, 7), "branch7x7dbl_4": (c7, c7, 7, 1),
                "branch7x7dbl_5": (c7, 192, 1, 7), "branch_pool": (cin, 192, 1, 1)}
    if kind == "d":
        return {"branch3x3_1": (cin, 192, 1, 1), "branch3x3_2": (192, 320, 3, 3),
                "branch7x7x3_1": (cin, 192, 1, 1), "branch7x7x3_2": (192, 192, 1, 7),
                "branch7x7x3_3": (192, 192, 7, 1), "branch7x7x3_4": (192, 192, 3, 3)}
    if kind == "e":
        return {"branch1x1": (cin, 320, 1, 1), "branch3x3_1": (cin, 384, 1, 1),
                "branch3x3_2a": (384, 384, 1, 3), "branch3x3_2b": (384, 384, 3, 1),
                "branch3x3dbl_1": (cin, 448, 1, 1), "branch3x3dbl_2": (448, 384, 3, 3),
                "branch3x3dbl_3a": (384, 384, 1, 3), "branch3x3dbl_3b": (384, 384, 3, 1),
                "branch_pool": (cin, 192, 1, 1)}
    raise ValueError(f"unknown Inception block kind {kind!r}")


def conv_table() -> Dict[str, object]:
    """Every BasicConv2d of the trunk: stem name -> (cin, cout, kh, kw), Mixed
    block name -> {branch: (cin, cout, kh, kw)}, in forward order."""
    table: Dict[str, object] = {name: (ci, co, kh, kw) for name, ci, co, kh, kw in STEM}
    for name, kind, cin, arg in MIXED:
        table[name] = branches(kind, cin, arg)
    return table


# ---------------------------------------------------------------- init

def _cw(gen, cin, cout, kh, kw):
    fan = cin * kh * kw
    return {"w": torch.randn((kh, kw, cin, cout), generator=gen, device=gen.device)
            * fan ** -0.5,
            "bn_scale": torch.ones((cout,), device=gen.device),
            "bn_bias": torch.zeros((cout,), device=gen.device)}


def init_tree(gen: torch.Generator) -> Dict:
    """Random Inception parameters in the JAX layout (HWIO, He-scaled, BN an
    identity): what a converted npz holds."""
    return {name: (_cw(gen, *spec) if isinstance(spec, tuple) else
                   {br: _cw(gen, *s) for br, s in spec.items()})
            for name, spec in conv_table().items()}


def init(gen: torch.Generator) -> Dict:
    return from_jax.convert_inception(init_tree(gen))


def load_npz(path: str) -> Dict:
    """The npz the convert CLI's `inception` kind writes, as the port's tree
    (no key of it is a digit string: nothing to restore to a list)."""
    return from_jax.convert_inception(pytree.load_npz(path))


def convert_torch_inception(sd: Dict, eps: float = 1e-3) -> Dict:
    """pytorch-fid / torchvision inception_v3 state dict -> the JAX package's
    numpy tree, bitwise what its `convert_torch_inception` returns.
    BasicConv2d keys: <block>[.<branch>].conv.weight + .bn.{weight,bias,
    running_mean,running_var}; BN folded to scale and bias in fp32 (eps
    1e-3, torchvision inception); fc and bookkeeping keys ignored."""
    np32 = from_jax.to_numpy

    def conv_bn(prefix):
        w = np32(sd[f"{prefix}.conv.weight"])
        gamma = np32(sd[f"{prefix}.bn.weight"])
        beta = np32(sd[f"{prefix}.bn.bias"])
        mean = np32(sd[f"{prefix}.bn.running_mean"])
        var = np32(sd[f"{prefix}.bn.running_var"])
        scale = gamma / np.sqrt(var + eps)
        return {"w": np.transpose(w, (2, 3, 1, 0)), "bn_scale": scale,
                "bn_bias": beta - mean * scale}

    return {name: (conv_bn(name) if isinstance(spec, tuple) else
                   {br: conv_bn(f"{name}.{br}") for br in spec})
            for name, spec in conv_table().items()}


# ---------------------------------------------------------------- forward

def _conv_bn(x, p, stride=1, padding=(0, 0), policy: Policy = FP32):
    """BasicConv2d: conv (no bias) + eval BN in fp32 + relu."""
    y = F.conv2d(x, policy.cast_compute(p["w"]), stride=stride, padding=padding)
    y32 = y.float() * p["bn_scale"][:, None, None] + p["bn_bias"][:, None, None]
    return F.relu(y32).to(x.dtype)


def _maxpool(x, k=3, s=2, pad=0):
    # torch pads a max pool with -inf; pad 0 is the JAX package's VALID
    return F.max_pool2d(x, k, s, pad)


def _avgpool_excl(x, k=3, s=1, pad=1):
    """count_include_pad=False average pool (the FID patch,
    reference inception.py:159-276)."""
    return F.avg_pool2d(x, k, s, pad, count_include_pad=False)


def _a(x, p, policy):
    b1 = _conv_bn(x, p["branch1x1"], policy=policy)
    b5 = _conv_bn(x, p["branch5x5_1"], policy=policy)
    b5 = _conv_bn(b5, p["branch5x5_2"], padding=2, policy=policy)
    b3 = _conv_bn(x, p["branch3x3dbl_1"], policy=policy)
    b3 = _conv_bn(b3, p["branch3x3dbl_2"], padding=1, policy=policy)
    b3 = _conv_bn(b3, p["branch3x3dbl_3"], padding=1, policy=policy)
    bp = _conv_bn(_avgpool_excl(x), p["branch_pool"], policy=policy)
    return torch.cat([b1, b5, b3, bp], dim=1)


def _b(x, p, policy):
    b3 = _conv_bn(x, p["branch3x3"], stride=2, policy=policy)
    bd = _conv_bn(x, p["branch3x3dbl_1"], policy=policy)
    bd = _conv_bn(bd, p["branch3x3dbl_2"], padding=1, policy=policy)
    bd = _conv_bn(bd, p["branch3x3dbl_3"], stride=2, policy=policy)
    bp = _maxpool(x, 3, 2)
    return torch.cat([b3, bd, bp], dim=1)


def _c(x, p, policy):
    b1 = _conv_bn(x, p["branch1x1"], policy=policy)
    b7 = _conv_bn(x, p["branch7x7_1"], policy=policy)
    b7 = _conv_bn(b7, p["branch7x7_2"], padding=(0, 3), policy=policy)
    b7 = _conv_bn(b7, p["branch7x7_3"], padding=(3, 0), policy=policy)
    bd = _conv_bn(x, p["branch7x7dbl_1"], policy=policy)
    bd = _conv_bn(bd, p["branch7x7dbl_2"], padding=(3, 0), policy=policy)
    bd = _conv_bn(bd, p["branch7x7dbl_3"], padding=(0, 3), policy=policy)
    bd = _conv_bn(bd, p["branch7x7dbl_4"], padding=(3, 0), policy=policy)
    bd = _conv_bn(bd, p["branch7x7dbl_5"], padding=(0, 3), policy=policy)
    bp = _conv_bn(_avgpool_excl(x), p["branch_pool"], policy=policy)
    return torch.cat([b1, b7, bd, bp], dim=1)


def _d(x, p, policy):
    b3 = _conv_bn(x, p["branch3x3_1"], policy=policy)
    b3 = _conv_bn(b3, p["branch3x3_2"], stride=2, policy=policy)
    b7 = _conv_bn(x, p["branch7x7x3_1"], policy=policy)
    b7 = _conv_bn(b7, p["branch7x7x3_2"], padding=(0, 3), policy=policy)
    b7 = _conv_bn(b7, p["branch7x7x3_3"], padding=(3, 0), policy=policy)
    b7 = _conv_bn(b7, p["branch7x7x3_4"], stride=2, policy=policy)
    bp = _maxpool(x, 3, 2)
    return torch.cat([b3, b7, bp], dim=1)


def _e(x, p, policy, pool: str):
    b1 = _conv_bn(x, p["branch1x1"], policy=policy)
    b3 = _conv_bn(x, p["branch3x3_1"], policy=policy)
    b3 = torch.cat([
        _conv_bn(b3, p["branch3x3_2a"], padding=(0, 1), policy=policy),
        _conv_bn(b3, p["branch3x3_2b"], padding=(1, 0), policy=policy)], dim=1)
    bd = _conv_bn(x, p["branch3x3dbl_1"], policy=policy)
    bd = _conv_bn(bd, p["branch3x3dbl_2"], padding=1, policy=policy)
    bd = torch.cat([
        _conv_bn(bd, p["branch3x3dbl_3a"], padding=(0, 1), policy=policy),
        _conv_bn(bd, p["branch3x3dbl_3b"], padding=(1, 0), policy=policy)], dim=1)
    if pool == "max":   # FIDInceptionE_2 (reference inception.py:240-276)
        bp = _maxpool(x, 3, 1, pad=1)
    else:               # FIDInceptionE_1: count_exclude-pad avg
        bp = _avgpool_excl(x)
    bp = _conv_bn(bp, p["branch_pool"], policy=policy)
    return torch.cat([b1, b3, bd, bp], dim=1)


_BLOCK_FN = {"a": _a, "b": _b, "c": _c, "d": _d}


def resize299(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> [B, C, 299, 299]: bilinear, antialiased when it
    shrinks, as `jax.image.resize(..., "bilinear")` is (F.interpolate
    without `antialias` skips input pixels when it shrinks)."""
    return F.interpolate(x, size=(299, 299), mode="bilinear", align_corners=False,
                         antialias=True)


def features(params, images01, policy: Policy = FP32,
             resize_input: bool = True) -> torch.Tensor:
    """images01: [B, 3, H, W] in [0,1] -> [B, 2048] pool features
    (reference inception.py:96-133: resize to 299, scale to [-1,1], trunk,
    adaptive average pool)."""
    x = images01.float()
    if resize_input:
        x = resize299(x)
    x = policy.cast_compute(x * 2.0 - 1.0)

    x = _conv_bn(x, params["Conv2d_1a_3x3"], stride=2, policy=policy)
    x = _conv_bn(x, params["Conv2d_2a_3x3"], policy=policy)
    x = _conv_bn(x, params["Conv2d_2b_3x3"], padding=1, policy=policy)
    x = _maxpool(x, 3, 2)
    x = _conv_bn(x, params["Conv2d_3b_1x1"], policy=policy)
    x = _conv_bn(x, params["Conv2d_4a_3x3"], policy=policy)
    x = _maxpool(x, 3, 2)
    for name, kind, _cin, _arg in MIXED:
        if kind == "e":
            x = _e(x, params[name], policy, pool="max" if name == "Mixed_7c" else "avg")
        else:
            x = _BLOCK_FN[kind](x, params[name], policy)
    return x.float().mean(dim=(2, 3))   # [B, 2048]
