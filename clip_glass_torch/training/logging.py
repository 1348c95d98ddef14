"""Training observability sinks: scalar and image logging.

Behavioral reference: stylegan2/train.py:620-635 (per-iteration scalar
summaries: losses, grad norms, regularizer values) and 761-777
(`_report_images`: periodic fixed-latent image grids from the EMA generator
Gs). The port of the JAX package's `training/logging.py`: scalars land in an
append-only CSV (one `step,tag,value` row per point), images as JPEG grids,
both under a run directory; an optional tensorboard event-file sink
(`TensorboardSink`, the reference's writer) sits behind an import guard.
"""

from __future__ import annotations

import os
from typing import Optional

import torch


class ScalarCSVSink:
    """Append-only scalar sink: `<dir>/scalars.csv` with step,tag,value rows
    (the stand-in for tensorboard add_scalar, reference train.py:620-635)."""

    def __init__(self, run_dir: str, filename: str = "scalars.csv"):
        os.makedirs(run_dir, exist_ok=True)
        self.path = os.path.join(run_dir, filename)
        self._fh = open(self.path, "a", buffering=1)
        if self._fh.tell() == 0:
            self._fh.write("step,tag,value\n")

    def add_scalar(self, tag: str, value, step: int):
        self._fh.write(f"{int(step)},{tag},{float(value):.10g}\n")

    def add_scalars(self, values: dict, step: int):
        for tag, v in values.items():
            self.add_scalar(tag, v, step)

    def flush(self):
        self._fh.flush()

    def close(self):
        self._fh.close()

    def read(self) -> list:
        """All rows as (step, tag, value) tuples."""
        with open(self.path) as f:
            next(f)
            return [(int(s), t, float(v)) for s, t, v in
                    (line.rstrip("\n").split(",", 2) for line in f if line.strip())]


class ImageGridSink:
    """Periodic image grids: `<dir>/<tag>_<step>.jpg` (the stand-in for
    tensorboard add_images, reference train.py:761-777)."""

    def __init__(self, run_dir: str):
        self.dir = run_dir
        os.makedirs(run_dir, exist_ok=True)

    def add_images(self, tag: str, images, step: int) -> str:
        """images: [N, 3, H, W] in [0, 1] (numpy or a tensor)."""
        from clip_glass_torch.fitness.generator import quantize_u8
        from clip_glass_torch.utils.image import save_grid

        path = os.path.join(self.dir, f"{tag}_{int(step)}.jpg")
        save_grid(quantize_u8(torch.as_tensor(images)).cpu().numpy(), path)
        return path


def _tb_writer_cls():
    """torch's tensorboard writer if importable, else tensorboardX's, else
    None (the import guard: neither package is a dependency)."""
    try:
        from torch.utils.tensorboard import SummaryWriter
        return SummaryWriter
    except ImportError:
        pass
    try:
        from tensorboardX import SummaryWriter
        return SummaryWriter
    except ImportError:
        return None


class TensorboardSink:
    """Tensorboard event-file sink, the reference Trainer's own writer
    (stylegan2/train.py:620-635 add_scalar, 761-777 add_images). Optional:
    construction raises ImportError when no tensorboard backend is
    installed; gate on `TensorboardSink.available()`."""

    @staticmethod
    def available() -> bool:
        return _tb_writer_cls() is not None

    def __init__(self, run_dir: str):
        cls = _tb_writer_cls()
        if cls is None:
            raise ImportError(
                "TensorboardSink needs `torch.utils.tensorboard` or "
                "`tensorboardX`; install tensorboard, or use the default "
                "CSV/JPEG sinks")
        os.makedirs(run_dir, exist_ok=True)
        self.writer = cls(log_dir=run_dir)

    def add_scalar(self, tag: str, value, step: int):
        self.writer.add_scalar(tag, float(value), int(step))

    def add_scalars(self, values: dict, step: int):
        for tag, v in values.items():
            self.add_scalar(tag, v, step)

    def add_images(self, tag: str, images, step: int):
        """images: [N, 3, H, W] in [0, 1] (numpy or a tensor)."""
        self.writer.add_images(tag, torch.as_tensor(images).float().cpu().numpy(),
                               int(step))

    def flush(self):
        self.writer.flush()

    def close(self):
        self.writer.close()


class TrainLogger:
    """The sinks behind the reference Trainer's logging surface: scalars
    every step they are produced, image grids of Gs from fixed latents at a
    chosen cadence (reference train.py:755-777). With tensorboard=True every
    scalar and image also lands in event files under <dir>/tb/."""

    def __init__(self, run_dir: str, image_every: int = 0,
                 n_image_latents: int = 8, seed: int = 0,
                 tensorboard: bool = False):
        self.scalars = ScalarCSVSink(run_dir)
        self.images = ImageGridSink(run_dir)
        self.tb: Optional[TensorboardSink] = (
            TensorboardSink(os.path.join(run_dir, "tb")) if tensorboard else None)
        self.image_every = image_every
        self.n_image_latents = n_image_latents
        self.seed = seed
        self._latents: Optional[torch.Tensor] = None

    def log_scalars(self, values: dict, step: int):
        self.scalars.add_scalars(values, step)
        if self.tb is not None:
            self.tb.add_scalars(values, step)

    def maybe_log_images(self, trainer, step: int) -> Optional[str]:
        """At every image_every-th step: Gs on the fixed latents (drawn once
        from a CPU generator seeded `seed`), no noise, in the model config's
        default domain (at 512 and 1024 px the s2d domain, kernel 4), under
        inference_mode. Returns the grid's path."""
        if not self.image_every or step % self.image_every:
            return None
        from clip_glass_torch.models.stylegan2 import model as sg2

        cfg = trainer.model_cfg
        if self._latents is None:
            self._latents = torch.randn((self.n_image_latents, cfg.latent_size),
                                        generator=torch.Generator().manual_seed(self.seed))
        with torch.inference_mode():
            imgs = sg2.generator_apply(trainer.state.gs_params,
                                       self._latents.to(trainer.device), cfg, noise=None)
            imgs = ((imgs.float() + 1.0) / 2.0).clamp(0.0, 1.0)
        if self.tb is not None:
            self.tb.add_images("fakes", imgs, step)
        return self.images.add_images("fakes", imgs, step)
