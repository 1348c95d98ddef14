"""CLIP ModifiedResNet (RN50) torch state dict -> the JAX-layout numpy tree.

Folds eval-mode BatchNorm into a per-channel scale and bias,
    scale = gamma / sqrt(var + eps),  bias = beta - mean * scale
(exact at inference), transposes convs [O, I, kh, kw] -> [kh, kw, I, O] and
linears [out, in] -> [in, out]. Key layout: reference clip/model.py:9-149.
The numpy operations are the JAX package's converter's, in its order.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from clip_glass_torch.models.clip.resnet import RNConfig
from clip_glass_torch.weights.from_jax import to_numpy as _np


def _conv(sd, key):
    return np.transpose(_np(sd[key]), (2, 3, 1, 0))


def _bn(sd, prefix, eps=1e-5):
    gamma = _np(sd[f"{prefix}.weight"])
    beta = _np(sd[f"{prefix}.bias"])
    mean = _np(sd[f"{prefix}.running_mean"])
    var = _np(sd[f"{prefix}.running_var"])
    scale = gamma / np.sqrt(var + eps)
    return {"scale": scale, "bias": beta - mean * scale}


def _linear(sd, prefix):
    return {"w": _np(sd[f"{prefix}.weight"]).T, "b": _np(sd[f"{prefix}.bias"])}


def _bottleneck(sd, prefix):
    p = {"conv1": _conv(sd, f"{prefix}.conv1.weight"), "bn1": _bn(sd, f"{prefix}.bn1"),
         "conv2": _conv(sd, f"{prefix}.conv2.weight"), "bn2": _bn(sd, f"{prefix}.bn2"),
         "conv3": _conv(sd, f"{prefix}.conv3.weight"), "bn3": _bn(sd, f"{prefix}.bn3")}
    if f"{prefix}.downsample.0.weight" in sd:
        p["downsample"] = {"conv": _conv(sd, f"{prefix}.downsample.0.weight"),
                           "bn": _bn(sd, f"{prefix}.downsample.1")}
    return p


def convert(sd: Dict, cfg: RNConfig, prefix: str = "") -> Dict:
    """`prefix`: 'visual.' for a whole CLIP state dict."""
    params = {"stem": {
        "conv1": _conv(sd, f"{prefix}conv1.weight"), "bn1": _bn(sd, f"{prefix}bn1"),
        "conv2": _conv(sd, f"{prefix}conv2.weight"), "bn2": _bn(sd, f"{prefix}bn2"),
        "conv3": _conv(sd, f"{prefix}conv3.weight"), "bn3": _bn(sd, f"{prefix}bn3"),
    }}
    for li, blocks in enumerate(cfg.layers):
        params[f"layer{li + 1}"] = [_bottleneck(sd, f"{prefix}layer{li + 1}.{b}")
                                    for b in range(blocks)]
    ap = f"{prefix}attnpool"
    params["attnpool"] = {
        "positional_embedding": _np(sd[f"{ap}.positional_embedding"]),
        "q": _linear(sd, f"{ap}.q_proj"), "k": _linear(sd, f"{ap}.k_proj"),
        "v": _linear(sd, f"{ap}.v_proj"), "c": _linear(sd, f"{ap}.c_proj"),
    }
    return params
