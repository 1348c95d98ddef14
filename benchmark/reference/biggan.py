"""BigGAN-deep's generator in plain PyTorch, float32, NCHW, as the
`pytorch-pretrained-biggan` package that CLIP-GLaSS loads computes it: a
bias-free class embedding of the soft class vector, cond = [z, embedding],
a dense layer to a 4x4 seed, bottleneck residual blocks (conditional batch
norm -> ReLU -> 1x1 -> ... -> 3x3 -> 3x3 -> 1x1, nearest 2x upsampling in
the up blocks, the residual's channels dropped to the output's), one
SAGAN self-attention block, then batch norm -> ReLU -> 3x3 conv, its first
three channels, tanh.

The batch norms read the running statistics of the row that truncation
1.0 selects (the last of the package's `n_stats` rows). The weights are
the benchmark's tree (`harness/weights.py`): conv weights OIHW, dense
weights [in, out], statistics [n_stats, C].
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference import numerics as num


def _cond_bn(p, x, cond, eps: float, stats=None):
    """Conditional batch norm. With `stats` (a list) the batch's own mean and
    variance normalize x and are appended to it (the standing statistics
    of `harness/weights.py`); otherwise the running statistics do."""
    if stats is not None:
        mean, var = x.mean(dim=(0, 2, 3)), x.var(dim=(0, 2, 3), unbiased=False)
        stats.append((mean, var))
    else:
        mean, var = p["running_means"][-1], p["running_vars"][-1]
    y = (x - mean[None, :, None, None]) * torch.rsqrt(var + eps)[None, :, None, None]
    if "scale" in p:
        gain = 1.0 + num.mm(cond, p["scale"]["w"])
        bias = num.mm(cond, p["offset"]["w"])
    else:
        gain, bias = p["weight"][None], p["bias"][None]
    return y * gain[:, :, None, None] + bias[:, :, None, None]


def _conv(p, x):
    y = num.conv2d(x, p["w"], padding=p["w"].shape[-1] // 2)
    return num.rounded(y + p["b"][None, :, None, None] if "b" in p else y)


def _block(p, x, cond, up: bool, eps: float, stats=None):
    h = _conv(p["conv_0"], F.relu(_cond_bn(p["bn_0"], x, cond, eps, stats)))
    h = F.relu(_cond_bn(p["bn_1"], h, cond, eps, stats))
    if up:
        h = F.interpolate(h, scale_factor=2, mode="nearest")
    h = _conv(p["conv_1"], h)
    h = _conv(p["conv_2"], F.relu(_cond_bn(p["bn_2"], h, cond, eps, stats)))
    h = _conv(p["conv_3"], F.relu(_cond_bn(p["bn_3"], h, cond, eps, stats)))
    x = x[:, :h.shape[1]]
    if up:
        x = F.interpolate(x, scale_factor=2, mode="nearest")
    return num.rounded(h + x)


def _attention(p, x):
    B, C, H, W = x.shape
    theta = _conv(p["theta"], x).flatten(2)                          # [B, C/8, HW]
    phi = F.max_pool2d(_conv(p["phi"], x), 2).flatten(2)            # [B, C/8, HW/4]
    g = F.max_pool2d(_conv(p["g"], x), 2).flatten(2)                # [B, C/2, HW/4]
    attn = torch.softmax(num.mm(theta.transpose(1, 2), phi), dim=-1)   # [B, HW, HW/4]
    o = num.mm(g, attn.transpose(1, 2)).reshape(B, C // 2, H, W)
    return num.rounded(x + p["gamma"] * _conv(p["o_conv"], o))


def generate(params, z, class_vector, geo: dict, stats=None):
    """z [B, z_dim], class_vector [B, classes] -> images [B, 3, R, R] in
    [-1, 1]. `stats`: see `_cond_bn`."""
    eps = geo["eps"]
    cond = torch.cat([z, num.mm(class_vector, params["embeddings"]["w"])], dim=1)
    h = num.mm(cond, params["gen_z"]["w"]) + params["gen_z"]["b"]
    h = h.reshape(z.shape[0], 4, 4, -1).permute(0, 3, 1, 2)
    li = 0
    for entry in params["blocks"]:
        if "attn" in entry:
            h = _attention(entry["attn"], h)
        else:
            h = _block(entry["block"], h, cond, bool(geo["layers"][li][0]), eps, stats)
            li += 1
    h = F.relu(_cond_bn(params["bn"], h, cond, eps, stats))
    rgb = params["conv_to_rgb"]
    h = num.conv2d(h, rgb["w"][:3], padding=1) + rgb["b"][:3][None, :, None, None]
    return torch.tanh(h)
