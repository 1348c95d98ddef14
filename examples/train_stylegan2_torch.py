#!/usr/bin/env python
"""Programmatic training example on the PyTorch port: the reference's
StyleGAN2 Trainer workflow (reference stylegan2/train.py:160-677) on
`clip_glass_torch.training`.

Covers the surface: TrainerConfig (overlayable from YAML/JSON), the logistic
non-saturating losses with lazy R1 and path-length regularization, style
mixing, EMA Gs, gradient-accumulation subdivisions (2 here), the scalar-CSV
and image-grid sinks (the reference's tensorboard writer with
--tensorboard), a checkpoint at the end with latest-valid discovery, and a
sample from Gs.

By default it trains the TINY model on synthetic noise images for a few
steps; --tiny false trains config-f at 1024 px, --data DIR reads an image
folder. It runs on the card unless --device cpu. --mesh (data parallelism
over cards) is ROADMAP item 16 and exits 2.

Run:
  python examples/train_stylegan2_torch.py --device cpu --iterations 4
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def synthetic_batches(batch_size: int, resolution: int, seed: int = 0):
    """Stand-in data source: [B, 3, H, W] arrays in [-1, 1] (the contract of
    Trainer.train; reference train.py:465-477)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    while True:
        yield rng.uniform(-1.0, 1.0, (batch_size, 3, resolution, resolution)
                          ).astype(np.float32)


def main():
    from clip_glass_torch.utils.misc import bool_type

    ap = argparse.ArgumentParser()
    ap.add_argument("--iterations", type=int, default=4)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--tiny", type=bool_type, default=True, nargs="?", const=True,
                    help="TINY test model (default); --tiny false trains the "
                         "full-size CONFIG_F 1024px model")
    ap.add_argument("--data", default=None,
                    help="image folder (utils.data.ImageFolder); synthetic "
                         "noise images when omitted")
    ap.add_argument("--mesh", type=bool_type, default=False, nargs="?", const=True,
                    help="not ported: data parallelism over cards is ROADMAP item 16")
    ap.add_argument("--tensorboard", type=bool_type, default=False, nargs="?", const=True,
                    help="also write tensorboard event files under <out>/logs/tb "
                         "(needs a tensorboard backend; reference train.py:620-635)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default="./tmp_train_example")
    args = ap.parse_args()
    if args.mesh:
        ap.error("--mesh: data parallelism over cards is ROADMAP item 16")

    import torch

    from clip_glass_torch.models.stylegan2 import model as sg2
    from clip_glass_torch.training.logging import TrainLogger
    from clip_glass_torch.training.trainer import Trainer, TrainerConfig

    cfg = TrainerConfig(batch_size=args.batch_size,
                        checkpoint_every=0,  # checkpoint explicitly below
                        checkpoint_dir=os.path.join(args.out, "checkpoints"),
                        subdivisions=2,      # gradient accumulation
                        seed=0)
    model_cfg = sg2.TINY if args.tiny else sg2.CONFIG_F
    trainer = Trainer(model_cfg=model_cfg, cfg=cfg, device=args.device)

    if args.data:
        from clip_glass_torch.utils.data import ImageFolder
        data = iter(ImageFolder(args.data, resolution=model_cfg.resolution,
                                batch_size=args.batch_size))
    else:
        data = synthetic_batches(args.batch_size, model_cfg.resolution)

    # scalar CSV + image-grid sinks (reference train.py:620-635, 761-777)
    sinks = TrainLogger(os.path.join(args.out, "logs"),
                        image_every=max(args.iterations // 2, 1),
                        tensorboard=args.tensorboard)
    logs = trainer.train(data, args.iterations, log_every=1, sinks=sinks)
    folder = trainer.save_checkpoint()

    # the EMA generator is what one samples from (reference train.py:293-302)
    gen = torch.Generator(device=trainer.device).manual_seed(1)
    z = torch.randn((2, model_cfg.latent_size), generator=gen, device=trainer.device)
    noise = [torch.randn(s, generator=gen, device=trainer.device)
             for s in model_cfg.noise_shapes()]
    with torch.inference_mode():
        imgs = sg2.generator_apply(trainer.state.gs_params, z, model_cfg, noise=noise)
    print(f"final logs: { {k: round(float(v), 4) for k, v in logs.items()} }")
    print(f"checkpoint: {folder}")
    print(f"Gs sample:  {tuple(imgs.shape)} in [{float(imgs.min()):.2f}, "
          f"{float(imgs.max()):.2f}]")


if __name__ == "__main__":
    main()
