"""Image grid saving (the reference's torchvision make_grid/save_image,
utils.py:5-12), through Pillow, for images quantized to uint8 on the device
(`fitness.generator.quantize_u8`): a 16 x 1024^2 grid is assembled without
any float math."""

from __future__ import annotations

import math
import os

import numpy as np


def _grid_u8(images: np.ndarray, nrow: int = 8, padding: int = 2):
    """[B, C, H, W] uint8 -> [H', W', C] uint8 grid with black padding
    (torchvision.utils.make_grid geometry), assembled HWC-native."""
    b, c, h, w = images.shape
    ncol = min(nrow, b)
    nrows = math.ceil(b / ncol)
    out = np.zeros((padding + nrows * (h + padding), padding + ncol * (w + padding), c),
                   np.uint8)
    for i in range(b):
        y = padding + (i // ncol) * (h + padding)
        x = padding + (i % ncol) * (w + padding)
        out[y:y + h, x:x + w] = images[i].transpose(1, 2, 0)
    return out


def save_grid(images: np.ndarray, path: str, nrow: int = 8):
    """Save a uint8 [B, C, H, W] batch as a grid jpg (reference
    utils.py:5-7); a single image is saved directly (reference
    generator.py:64-67)."""
    from PIL import Image

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if images.shape[0] == 1:
        arr = np.ascontiguousarray(images[0].transpose(1, 2, 0))
    else:
        arr = _grid_u8(images, nrow=nrow)
    Image.fromarray(arr).save(path)
