"""Image data on the host: files, one image, and a shuffled batch source.

Equivalent of the reference's ImageFolder dataset + ResizeTransform
(reference stylegan2/utils.py:212-289) and its DataLoader usage
(stylegan2/train.py:327-341): recursively collected image files, resized to
the model resolution, normalized to [-1, 1], yielded as NCHW float32 numpy
batches with shuffling, prefetched a batch ahead of their consumer by a
worker thread. The port's own copy of the JAX package's `utils/data.py`
(numpy and Pillow only).
"""

from __future__ import annotations

import os
import threading
import queue
from typing import Iterator

import numpy as np

IMAGE_EXTS = {".png", ".jpg", ".jpeg", ".bmp", ".webp"}


def find_images(root: str) -> list:
    out = []
    for dirpath, _, files in os.walk(root):
        for f in sorted(files):
            if os.path.splitext(f)[1].lower() in IMAGE_EXTS:
                out.append(os.path.join(dirpath, f))
    return out


def load_image(path: str, resolution: int) -> np.ndarray:
    """-> [3, res, res] float32 in [-1, 1] (reference ResizeTransform +
    the (x - 0.5) * 2 normalization of stylegan2/utils.py:268-289)."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    if img.size != (resolution, resolution):
        img = img.resize((resolution, resolution), Image.LANCZOS)
    arr = np.asarray(img, np.float32) / 255.0
    return np.transpose(arr * 2.0 - 1.0, (2, 0, 1))


class ImageFolder:
    """Shuffled, endlessly-iterating batch source with one-batch prefetch."""

    def __init__(self, root: str, resolution: int, batch_size: int,
                 seed: int = 0, mirror: bool = True, prefetch: bool = True):
        self.paths = find_images(root)
        if not self.paths:
            raise FileNotFoundError(f"no images under {root!r}")
        self.resolution = resolution
        self.batch_size = batch_size
        self.mirror = mirror
        self._seed = seed
        self._rng = np.random.default_rng(seed)
        self._prefetch = prefetch
        self._iters = 0
        self._stop_prev: threading.Event = None

    def __len__(self):
        return len(self.paths)

    def _make_batch(self, rng=None) -> np.ndarray:
        rng = rng if rng is not None else self._rng
        idx = rng.integers(0, len(self.paths), self.batch_size)
        imgs = np.stack([load_image(self.paths[i], self.resolution)
                         for i in idx])
        if self.mirror:
            flip = rng.random(self.batch_size) < 0.5
            imgs[flip] = imgs[flip][..., ::-1]
        return imgs

    def __iter__(self) -> Iterator[np.ndarray]:
        if not self._prefetch:
            while True:
                yield self._make_batch()
        # Each iterator gets its OWN rng (np.random.Generator is not
        # thread-safe and an abandoned iterator's worker survives until its
        # queue fills) and a stop event; starting a new iterator stops the
        # previous worker, so abandoned iterators neither race the rng nor
        # leak threads indefinitely.
        if self._stop_prev is not None:
            self._stop_prev.set()
        stop = threading.Event()
        self._stop_prev = stop
        rng = np.random.default_rng((self._seed, self._iters))
        self._iters += 1
        q: queue.Queue = queue.Queue(maxsize=2)

        def worker():
            while not stop.is_set():
                batch = self._make_batch(rng)
                while not stop.is_set():
                    try:
                        q.put(batch, timeout=0.25)
                        break
                    except queue.Full:
                        pass

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()
