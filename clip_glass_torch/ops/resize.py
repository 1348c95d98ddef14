"""Image resizing for CLIP scoring.

The fitness path resizes generated images to 224x224 with bilinear,
half-pixel-centers semantics and no antialiasing (`kornia.resize`,
reference generator.py:45, which is `F.interpolate(align_corners=False)`).

The img2txt target's preprocessing (reference clip/clip.py:68-74: bicubic
shorter-side resize, centre crop, CLIP mean and std) runs once a search on
the host, with numpy and Pillow.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def resize_bilinear(images: torch.Tensor,
                    size: Union[int, Tuple[int, int]] = 224) -> torch.Tensor:
    """images: [B, C, H, W] -> [B, C, size, size] (or [B, C, *size]).

    antialias=False is load-bearing: the reference does not lowpass-filter
    on downscale, and the fitness path downsamples 1024px -> 224px."""
    hw = (size, size) if isinstance(size, int) else tuple(size)
    return F.interpolate(images, size=hw, mode="bilinear",
                         align_corners=False, antialias=False)


@lru_cache(maxsize=None)
def bilinear_matrix(src: int, dst: int) -> np.ndarray:
    """The row-weight matrix [dst, src] of resize_bilinear along one axis, in
    fp32: the resize is linear and separable, so resizing the rows of an
    identity (and leaving its columns, a scale of 1, exact) gives it."""
    eye = torch.eye(src, dtype=torch.float32)[None, None]
    return resize_bilinear(eye, (dst, src))[0, 0].numpy()


def clip_preprocess_pil(pil_image, size: int = 224) -> np.ndarray:
    """A PIL image -> CLIP's input [1, 3, size, size] fp32 (reference
    generator.py:25-27): bicubic shorter-side resize, centre crop, [0, 1]
    scale, CLIP mean/std normalization."""
    from PIL import Image

    img = pil_image.convert("RGB")
    w, h = img.size
    scale = size / min(w, h)
    img = img.resize((max(size, int(round(w * scale))), max(size, int(round(h * scale)))),
                     Image.BICUBIC)
    w, h = img.size
    left, top = (w - size) // 2, (h - size) // 2
    img = img.crop((left, top, left + size, top + size))
    arr = np.asarray(img, np.float32) / 255.0
    arr = (arr - np.asarray(CLIP_MEAN)) / np.asarray(CLIP_STD)
    return np.transpose(arr, (2, 0, 1))[None].astype(np.float32)
