"""Image targets drawn from the seed, for image-to-text families: smooth
colour fields at CLIP's input size (a coarse grid of colours drawn uniform
in [0, 1], resized bicubically and clipped), each written as a uint8 PNG,
which is lossless, into a directory that the run owns. Every image has the
same size, so the seed changes the pixels and never the work."""

from __future__ import annotations

import random
from pathlib import Path
from typing import List

import torch
import torch.nn.functional as F

GRID = 6   # colours a side before the resize


def draw(rng: random.Random, n: int, size: int, workdir: Path) -> List[str]:
    """The paths of n images of size x size pixels drawn from `rng`."""
    from PIL import Image

    out = []
    for i in range(n):
        gen = torch.Generator().manual_seed(rng.getrandbits(63))
        coarse = torch.rand((1, 3, GRID, GRID), generator=gen)
        img = F.interpolate(coarse, size=(size, size), mode="bicubic", align_corners=False)
        pixels = (img[0].clamp(0, 1).permute(1, 2, 0) * 255 + 0.5).to(torch.uint8).numpy()
        path = Path(workdir) / f"target_{i}.png"
        Image.fromarray(pixels).save(path)
        out.append(str(path))
    return out
