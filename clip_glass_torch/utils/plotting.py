"""Pareto-front scatter plot (reference run.py:86-89: pymoo's `Scatter`).
Drawn with Pillow: points on axes with the objective names and ranges as
labels, no tick marks."""

from __future__ import annotations

import os

import numpy as np


def save_scatter(F: np.ndarray, path: str, labels=("similarity", "discriminator"),
                 size: int = 480, margin: int = 48, color=(220, 40, 40)):
    from PIL import Image, ImageDraw

    F = np.asarray(F, np.float64)
    if F.ndim == 1:
        F = F[None]
    img = Image.new("RGB", (size, size), (255, 255, 255))
    d = ImageDraw.Draw(img)
    lo = F.min(axis=0)
    hi = F.max(axis=0)
    span = np.where(hi - lo == 0, 1.0, hi - lo)

    # axes
    d.line([(margin, size - margin), (size - margin, size - margin)], fill=(0, 0, 0))
    d.line([(margin, margin), (margin, size - margin)], fill=(0, 0, 0))
    d.text((size // 2, size - margin // 2), labels[0], fill=(0, 0, 0), anchor="mm")
    d.text((margin // 4, margin // 2), labels[1], fill=(0, 0, 0))
    d.text((margin, size - margin + 4), f"{lo[0]:.3f}", fill=(60, 60, 60))
    d.text((size - margin, size - margin + 4), f"{hi[0]:.3f}", fill=(60, 60, 60), anchor="ra")
    d.text((4, size - margin), f"{lo[1]:.3f}" if F.shape[1] > 1 else "", fill=(60, 60, 60))
    d.text((4, margin), f"{hi[1]:.3f}" if F.shape[1] > 1 else "", fill=(60, 60, 60))

    usable = size - 2 * margin
    for row in F:
        x = margin + (row[0] - lo[0]) / span[0] * usable
        y = size - margin - ((row[1] - lo[1]) / span[1] * usable if F.shape[1] > 1 else usable / 2)
        d.ellipse([x - 3, y - 3, x + 3, y + 3], fill=color)

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    img.save(path)
