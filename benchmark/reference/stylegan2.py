"""StyleGAN2 config-f generator and resnet discriminator in plain PyTorch,
float32, NCHW, as CLIP-GLaSS's StyleGAN2 code (the PyTorch port of NVIDIA's
StyleGAN2, `stylegan2/models.py` and `modules.py`) computes them:

- mapping: normalize z by its RMS, then dense + leaky ReLU(0.2) x sqrt(2);
- synthesis: a learned 4x4 constant; per layer a modulated 3x3 conv
  (weights scaled by the style, demodulated per output channel; the first
  of each upsampling block a stride-2 transposed conv followed by the
  [1,3,3,1] FIR of gain 4), then noise x strength + bias, leaky ReLU x
  sqrt(2); per block a modulated 1x1 ToRGB (not demodulated) added to the
  2x FIR-upsampled RGB skip;
- discriminator: 1x1 fromRGB, per block conv0 3x3, conv1 FIR then 3x3
  stride 2, the skip FIR then 1x1 stride 2, (x + skip) / sqrt(2); the
  minibatch standard deviation over groups of 4 (with the reference's
  quirk: the features it concatenates are centred by their group mean),
  a 3x3 conv, two dense layers.

The weights are the benchmark's tree (`harness/weights.py`): equalized
learning-rate gains folded in, conv weights OIHW, dense weights [in, out],
the ToRGB weight [in, 3].
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference import numerics as num

SQRT2 = math.sqrt(2.0)


def _lrelu(x):
    return F.leaky_relu(x, 0.2) * SQRT2


def _fir_kernel(taps, gain: float, device) -> torch.Tensor:
    k = torch.tensor(taps, dtype=torch.float32, device=device)
    k = torch.outer(k, k)
    return k / k.sum() * gain


def _fir(x, k, pad0: int, pad1: int, stride: int = 1, up: int = 1):
    """Depthwise correlation of every channel with k, after zero-stuffing by
    `up` and padding (pad0 before, pad1 after)."""
    B, C, H, W = x.shape
    if up > 1:
        z = x.new_zeros(B, C, (H - 1) * up + 1, (W - 1) * up + 1)
        z[:, :, ::up, ::up] = x
        x = z
    x = F.pad(x, (pad0, pad1, pad0, pad1))
    w = k[None, None].expand(C, 1, *k.shape)
    return num.conv2d(x, w, stride=stride, groups=C)


def mapping(p, z, eps: float = 1e-8):
    x = z * torch.rsqrt(z.square().mean(dim=1, keepdim=True) + eps)
    for d in p["dense"]:
        x = num.rounded(_lrelu(num.mm(x, d["w"]) + d["b"]))
    return x


def _modconv(x, w, s, demod: bool, up: bool, taps, eps: float):
    xs = x * s[:, :, None, None]
    if up:
        y = num.conv_transpose2d(xs, w.transpose(0, 1), stride=2)
        y = _fir(y, _fir_kernel(taps, 4.0, x.device), 1, 1)
    else:
        y = num.conv2d(xs, w, padding=w.shape[-1] // 2)
    if demod:
        d = torch.rsqrt((s.square() @ w.square().sum(dim=(2, 3)).t()) + eps)
        y = y * d[:, :, None, None]
    return y


def synthesis(p, w_lat, geo: dict, noise):
    """w_lat [B, 512] -> images [B, 3, R, R] in about [-1, 1]. Every style
    layer reads the same w (no style mixing, truncation psi 1)."""
    ch = list(geo["channels"])
    taps = geo["filter_taps"]
    B = w_lat.shape[0]
    blocks = [(ch[-1], ch[-1], False, 1)] + [
        (ch[-i], ch[-i - 1], True, geo["conv_block_size"]) for i in range(1, len(ch))]
    x = p["const"].permute(2, 0, 1)[None].expand(B, -1, -1, -1)
    y = None
    ni = 0
    for bi, (_, _, up, n_layers) in enumerate(blocks):
        bp = p["blocks"][bi]
        for li in range(n_layers):
            lp = bp["layers"][li]
            s = num.mm(w_lat, lp["style"]["w"]) + lp["style"]["b"]
            x = _modconv(x, lp["w"], s, True, up and li == 0, taps, 1e-8)
            x = x + lp["noise_scale"] * noise[ni][None, None] + lp["b"][None, :, None, None]
            x = num.rounded(_lrelu(x))
            ni += 1
        rp = p["to_rgb"][bi]
        s = num.mm(w_lat, rp["style"]["w"]) + rp["style"]["b"]
        t = num.mm((x * s[:, :, None, None]).permute(0, 2, 3, 1), rp["w"]) + rp["b"]
        t = t.permute(0, 3, 1, 2)
        if y is not None:
            y = _fir(y, _fir_kernel(taps, 4.0, x.device), 3, 1, up=2)
        y = num.rounded(t if y is None else y + t)
    return y


def discriminator(p, images, geo: dict):
    """images [B, 3, R, R] in [-1, 1] -> logits [B]. B is one search's
    population (a multiple of the group size)."""
    taps = geo["filter_taps"]
    k = _fir_kernel(taps, 1.0, images.device)
    x = num.rounded(_lrelu(num.conv2d(images, p["from_rgb"]["w"])
                       + p["from_rgb"]["b"][None, :, None, None]))
    for bp in p["blocks"]:
        inp = x
        x = _lrelu(num.conv2d(x, bp["conv0"]["w"], padding=1)
                   + bp["conv0"]["b"][None, :, None, None])
        x = num.conv2d(_fir(x, k, 2, 2), bp["conv1"]["w"], stride=2)
        x = _lrelu(x + bp["conv1"]["b"][None, :, None, None])
        skip = num.conv2d(_fir(inp, k, 1, 1), bp["skip"]["w"], stride=2)
        x = num.rounded((x + skip) / SQRT2)
    g = geo["mbstd_group_size"]
    B, C, H, W = x.shape
    y = x.reshape(g, B // g, C, H, W)
    y = y - y.mean(dim=0, keepdim=True)
    s = torch.sqrt(y.square().mean(dim=0) + 1e-8).mean(dim=(1, 2, 3))   # [B // g]
    s = s.repeat(g)[:, None, None, None].expand(B, 1, H, W)
    x = torch.cat([y.reshape(B, C, H, W), s], dim=1)
    x = _lrelu(num.conv2d(x, p["final_conv"]["w"], padding=1)
               + p["final_conv"]["b"][None, :, None, None])
    x = _lrelu(num.mm(x.flatten(1), p["dense0"]["w"]) + p["dense0"]["b"])
    return (num.mm(x, p["dense1"]["w"]) + p["dense1"]["b"])[:, 0]


def generate(g, z, geo: dict, noise):
    return synthesis(g["synthesis"], mapping(g["mapping"], z), geo, noise)
