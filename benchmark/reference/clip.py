"""CLIP ViT-B/32 in plain PyTorch, float32, as OpenAI's `clip/model.py`
writes it: the stride-32 patch conv, the class token, pre-LN residual
attention blocks (QuickGELU), the projection of the class token, and the
text tower pooled at the end-of-text token under a causal mask.

An image target goes through CLIP's own preprocessing (`clip.py`'s
`_transform`): RGB, the shorter side resized to the input size (bicubic),
the centre cropped, scaled to [0, 1] and normalized by CLIP's mean and
standard deviation.

Parameters are the benchmark's tree (`harness/weights.py`): dense weights
right-multiply ([in, out]); the patch embedding is [3*P*P, width] with the
(channel, row, column) flatten order, which is reshaped here to the conv
weight [width, 3, P, P].
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import numerics as num
from benchmark.reference.tokenizer import tokenize

MEAN = (0.48145466, 0.4578275, 0.40821073)
STD = (0.26862954, 0.26130258, 0.27577711)


def _ln(x, p):
    return F.layer_norm(x, x.shape[-1:], p["scale"], p["bias"], eps=1e-5)


def _attention(x, p, heads: int, mask=None):
    B, T, D = x.shape
    q, k, v = (num.mm(x, p["in_proj_weight"]) + p["in_proj_bias"]).split(D, dim=-1)
    q, k, v = (t.reshape(B, T, heads, D // heads).transpose(1, 2) for t in (q, k, v))
    scores = num.mm(q, k.transpose(-1, -2)) / (D // heads) ** 0.5
    if mask is not None:
        scores = scores + mask
    out = num.mm(torch.softmax(scores, dim=-1), v)
    return num.mm(out.transpose(1, 2).reshape(B, T, D), p["out_proj_weight"]) + p["out_proj_bias"]


def _block(x, p, heads: int, mask=None):
    x = x + _attention(_ln(x, p["ln_1"]), p["attn"], heads, mask)
    m = p["mlp"]
    h = num.mm(_ln(x, p["ln_2"]), m["c_fc_weight"]) + m["c_fc_bias"]
    h = h * torch.sigmoid(1.702 * h)
    return x + num.mm(h, m["c_proj_weight"]) + m["c_proj_bias"]


def encode_image(params, images, geo: dict) -> torch.Tensor:
    """images [B, 3, R, R] in [0, 1] (the search feeds CLIP unnormalized
    images, as CLIP-GLaSS does) -> features [B, embed]."""
    v = params["visual"]
    P, w = geo["vision_patch_size"], geo["vision_width"]
    conv_w = v["patch_embed"]["weight"].t().reshape(w, 3, P, P)
    x = num.conv2d(images, conv_w, stride=P)                      # [B, w, G, G]
    x = x.flatten(2).transpose(1, 2)                            # [B, G*G, w]
    cls = v["class_embedding"].expand(x.shape[0], 1, w)
    x = torch.cat([cls, x], dim=1) + v["positional_embedding"]
    x = _ln(x, v["ln_pre"])
    for bp in v["blocks"]:
        x = num.rounded(_block(x, bp, w // 64))
    return num.mm(_ln(x[:, 0], v["ln_post"]), v["proj"])


def encode_text(params, ids: torch.Tensor, geo: dict) -> torch.Tensor:
    """ids [B, 77] (reference/tokenizer.py) -> features [B, embed]."""
    t = params["text"]
    n = ids.shape[1]
    x = t["token_embedding"][ids] + t["positional_embedding"]
    mask = torch.full((n, n), float("-inf"), device=x.device).triu(1)
    for bp in t["blocks"]:
        x = num.rounded(_block(x, bp, geo["transformer_heads"], mask))
    x = _ln(x, t["ln_final"])
    x = x[torch.arange(x.shape[0], device=x.device), ids.argmax(dim=-1)]
    return num.mm(x, t["text_projection"])


def cosine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return F.cosine_similarity(a, b, dim=-1, eps=1e-12)


def encode_prompts(params, prompts, geo: dict, device) -> torch.Tensor:
    """Text features [len(prompts), embed] of the prompts, tokenized here."""
    return encode_text(params, torch.as_tensor(tokenize(prompts), device=device), geo)


def image_cosine(params, images, geo: dict, text: torch.Tensor) -> torch.Tensor:
    """The cosine of images [B, 3, R, R] in [0, 1], resized bilinearly to
    CLIP's resolution, with text features [1, embed]."""
    small = F.interpolate(images, size=geo["image_resolution"], mode="bilinear",
                          align_corners=False, antialias=False)
    return cosine(encode_image(params, small, geo), text)


def preprocess(path: str, size: int) -> torch.Tensor:
    """The image file at `path` as CLIP's input [1, 3, size, size]
    (torchvision's Resize(size, BICUBIC), CenterCrop, ToTensor, Normalize)."""
    from PIL import Image

    with Image.open(path) as im:
        img = im.convert("RGB")
    w, h = img.size
    if min(w, h) != size:
        short, long = (w, h) if w <= h else (h, w)
        other = int(size * long / short)
        img = img.resize((size, other) if w <= h else (other, size), Image.BICUBIC)
    w, h = img.size
    left, top = int(round((w - size) / 2.0)), int(round((h - size) / 2.0))
    img = img.crop((left, top, left + size, top + size))
    x = torch.from_numpy(np.asarray(img, dtype=np.float32) / 255.0).permute(2, 0, 1)
    return ((x - torch.tensor(MEAN)[:, None, None]) / torch.tensor(STD)[:, None, None])[None]


def encode_images(params, paths, geo: dict, device) -> torch.Tensor:
    """Image features [len(paths), embed] of the image files, preprocessed
    here."""
    x = torch.cat([preprocess(p, geo["image_resolution"]) for p in paths])
    return encode_image(params, x.to(device), geo)
