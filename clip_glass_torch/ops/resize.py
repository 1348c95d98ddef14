"""Image resizing for CLIP scoring.

The fitness path resizes generated images to 224x224 with bilinear,
half-pixel-centers semantics and no antialiasing (`kornia.resize`,
reference generator.py:45, which is `F.interpolate(align_corners=False)`).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F


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
