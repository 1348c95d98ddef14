"""LPIPS-VGG16 perceptual distance.

Behavioral reference: stylegan2/external_models/lpips.py:34-78 — VGG16
feature slices at torchvision indices [0,4,9,16,23,30], unit-normalized
feature differences, learned per-slice linear heads, input shift/scale.
Used by the reference's PPL metric and projector. The port of the JAX
package's `metrics/lpips.py`, in NCHW: its 3x3 convs are stock cuDNN ones
(the tower holds no hand-written kernel).

Parameters: `convs` keyed by torchvision layer index ("0", "2", ...), each
{"w": [O, I, 3, 3], "b": [O]}, and `heads`, a list of 5 [C] weights.
`convert_torch_lpips` turns the torchvision vgg16 state dict and the
richzhang v0.1 linear weights into the JAX package's numpy tree (HWIO, what
the convert CLI writes), `load_npz` reads that file into the port's tree,
and `init` draws a random-weight instance. The forward is exact otherwise.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from clip_glass_torch.core import pytree
from clip_glass_torch.core.device import constant
from clip_glass_torch.core.dtypes import FP32, Policy
from clip_glass_torch.weights import from_jax

# channels out of each conv in torchvision vgg16.features, by layer index
_VGG_CFG = [(0, 3, 64), (2, 64, 64), (5, 64, 128), (7, 128, 128),
            (10, 128, 256), (12, 256, 256), (14, 256, 256),
            (17, 256, 512), (19, 512, 512), (21, 512, 512),
            (24, 512, 512), (26, 512, 512), (28, 512, 512)]
# conv indices per slice (reference lpips.py:35: [0, 4, 9, 16, 23, 30]),
# and whether the slice starts with a maxpool
_SLICES = [
    ([0, 2], False),
    ([5, 7], True),
    ([10, 12, 14], True),
    ([17, 19, 21], True),
    ([24, 26, 28], True),
]
_SLICE_OUT = [64, 128, 256, 512, 512]

SHIFT = np.asarray([-0.030, -0.088, -0.188], np.float32)
SCALE = np.asarray([0.458, 0.448, 0.450], np.float32)


def _shift_scale():
    return np.stack([SHIFT, SCALE])[:, None, :, None, None]   # [2, 1, 3, 1, 1]


def init_tree(gen: torch.Generator, scale: float = 0.1) -> Dict:
    """Random LPIPS parameters in the JAX layout (HWIO convs): what a
    converted npz holds."""
    convs = {}
    for idx, cin, cout in _VGG_CFG:
        convs[str(idx)] = {
            "w": scale * torch.randn((3, 3, cin, cout), generator=gen, device=gen.device),
            "b": torch.zeros((cout,), device=gen.device),
        }
    heads = [(scale * torch.randn((c,), generator=gen, device=gen.device)).abs()
             for c in _SLICE_OUT]
    return {"convs": convs, "heads": heads}


def init(gen: torch.Generator, scale: float = 0.1) -> Dict:
    """Random-weight LPIPS (tests, smoke runs); the structure a converted
    checkpoint loads into."""
    return from_jax.convert_lpips(init_tree(gen, scale))


def convert_torch_lpips(vgg_features_sd: Dict, linear_weights: Sequence) -> Dict:
    """torchvision vgg16 `features.{i}.weight/bias` (prefix stripped) + the
    5 LPIPS linear weight tensors -> the JAX package's numpy tree (HWIO
    convs, flat heads), bitwise what its `convert_torch_lpips` returns."""
    np32 = from_jax.to_numpy
    convs = {}
    for idx, _cin, _cout in _VGG_CFG:
        w = np32(vgg_features_sd[f"{idx}.weight"])      # [O, I, 3, 3]
        convs[str(idx)] = {"w": np.transpose(w, (2, 3, 1, 0)),
                           "b": np32(vgg_features_sd[f"{idx}.bias"])}
    heads = [np32(w).reshape(-1) for w in linear_weights]
    return {"convs": convs, "heads": heads}


def load_npz(path: str) -> Dict:
    """The npz the convert CLI's `lpips` kind writes, as the port's tree.
    Only `heads` is restored from the list encoding: `convs` is keyed by
    torchvision layer index, digit strings that `restore_lists` would
    collapse into a list."""
    tree = pytree.load_npz(path)
    return from_jax.convert_lpips({"convs": tree["convs"],
                                   "heads": pytree.restore_lists(tree["heads"])})


def _unit_normalize(x, eps: float = 1e-8):
    # x * rsqrt(sum x^2 + eps), the JAX package's form (not the upstream
    # x / (sqrt(sum x^2) + eps))
    r = torch.rsqrt(x.float().square().sum(dim=1, keepdim=True) + eps)
    return x * r.to(x.dtype)


def lpips(params, x0, x1, pixel_min: float = -1.0, pixel_max: float = 1.0,
          policy: Policy = FP32) -> torch.Tensor:
    """x0, x1: [B, 3, H, W] in [pixel_min, pixel_max] -> [B] distances
    (reference lpips.py:60-78)."""
    shift, scale = constant(_shift_scale, device=x0.device)

    def prep(x):
        x = x.float()
        if pixel_min != -1.0 or pixel_max != 1.0:
            x = (2 * x - pixel_min - pixel_max) / (pixel_max - pixel_min)
        return policy.cast_compute((x - shift) / scale)

    a, b = prep(x0), prep(x1)
    dist = torch.zeros((x0.shape[0],), dtype=torch.float32, device=x0.device)
    for (conv_ids, pre_pool), head in zip(_SLICES, params["heads"]):
        if pre_pool:   # VALID 2x2 max pool: an odd last row / column drops
            a, b = F.max_pool2d(a, 2), F.max_pool2d(b, 2)
        for ci in conv_ids:
            p = params["convs"][str(ci)]
            w, bias = policy.cast_compute(p["w"]), policy.cast_compute(p["b"])
            a = F.relu(F.conv2d(a, w, bias, padding=1))
            b = F.relu(F.conv2d(b, w, bias, padding=1))
        sq = (_unit_normalize(a) - _unit_normalize(b)).float().square().mean(dim=(2, 3))
        dist = dist + sq @ head.float()
    return dist
