"""Image resizing for CLIP scoring.

The fitness path resizes generated images to 224x224 with bilinear,
half-pixel-centers semantics and no antialiasing (`kornia.resize`,
reference generator.py:45, which is `F.interpolate(align_corners=False)`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear(images: torch.Tensor, size: int = 224) -> torch.Tensor:
    """images: [B, C, H, W] -> [B, C, size, size].

    antialias=False is load-bearing: the reference does not lowpass-filter
    on downscale, and the fitness path downsamples 1024px -> 224px."""
    return F.interpolate(images, size=(size, size), mode="bilinear",
                         align_corners=False, antialias=False)
