#!/usr/bin/env python
"""Latent projection with the PyTorch/CUDA port: invert an image into
StyleGAN2 W space (reference stylegan2/project.py:60-295: dlatent
statistics, Adam over (dlatents, per-layer noises), noise regularization
and renormalization, cosine learning-rate ramp). The counterpart of
examples/project_image.py, with the same flags plus `--device`.

Without `--g` it projects a G sample with the TINY random-weight model
(seconds on the CPU). With the reference's or converted checkpoints:

  python examples/project_image_torch.py --g Gs.pth --image face.png \\
      --lpips lpips_vgg16.npz --steps 1000

`--g` takes the reference's `.pth` or a converted `.npz` with its
`<stem>_cfg.json`. `--lpips` is the npz that
`python -m clip_glass_torch.weights.convert_weights lpips vgg16.pth OUT.npz
--linear vgg.pth` writes, read by `metrics.lpips.load_npz`; without it a
downsampled-L2 stand-in is the distance.

Run:
  python examples/project_image_torch.py --device cpu --steps 5   # TINY, the CPU
  python examples/project_image_torch.py --g Gs.pth               # the card
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def load_generator(path):
    """(G parameters, model config) of a reference `.pth` or a converted
    `.npz` with its `_cfg.json` sidecar."""
    from clip_glass_torch.core import pytree
    from clip_glass_torch.models.stylegan2 import model as sg2
    from clip_glass_torch.weights import convert_stylegan2, from_jax
    from clip_glass_torch.weights.load import read_cfg_sidecar

    if path.endswith(".pth"):
        tree, model_cfg, _ = convert_stylegan2.load_pth(path)
    else:
        model_cfg = read_cfg_sidecar(path, sg2.SG2Config)
        if model_cfg is None:
            raise FileNotFoundError(f"{path}: its _cfg.json sidecar is missing")
        tree = pytree.restore_lists(pytree.load_npz(path))
    return from_jax.convert_generator(tree), model_cfg


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--g", default=None,
                    help="generator: the reference's .pth, or a converted .npz with "
                         "its _cfg.json sidecar; TINY random weights when omitted")
    ap.add_argument("--image", default=None,
                    help="target image path; a synthetic G sample when "
                         "omitted (so the loss has a reachable optimum)")
    ap.add_argument("--lpips", default=None,
                    help="converted LPIPS-VGG16 params (.npz of the convert CLI)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default="./tmp_project_example_torch")
    args = ap.parse_args()

    import numpy as np
    import torch

    from clip_glass_torch.fitness.generator import quantize_u8
    from clip_glass_torch.metrics import lpips
    from clip_glass_torch.models.stylegan2 import model as sg2
    from clip_glass_torch.projector import Projector, ProjectorConfig
    from clip_glass_torch.utils.image import save_grid

    dev = args.device
    if args.g:
        g_params, model_cfg = load_generator(args.g)
    else:
        model_cfg = sg2.TINY
        g_params = sg2.generator_init(torch.Generator().manual_seed(0), model_cfg)

    if args.image:
        from clip_glass_torch.utils.data import load_image
        target = torch.from_numpy(load_image(args.image, model_cfg.resolution))[None]
        target01 = ((target + 1.0) / 2.0).to(dev)
    else:
        # project a G sample: the optimum is known to exist in range
        gen = torch.Generator().manual_seed(7)
        z = torch.randn((1, model_cfg.latent_size), generator=gen)
        noise = [torch.randn(s, generator=gen) for s in model_cfg.noise_shapes()]
        with torch.inference_mode():
            img = sg2.generator_apply(g_params, z, model_cfg, noise=noise)
        target01 = ((img + 1.0) / 2.0).clamp(0.0, 1.0).to(dev)

    lpips_params = lpips.load_npz(args.lpips) if args.lpips else None
    cfg = ProjectorConfig(num_steps=args.steps,
                          dlatent_samples=1024 if args.g is None else 10000)
    proj = Projector(g_params, model_cfg, cfg=cfg, lpips_params=lpips_params, device=dev)
    dlatents, images01 = proj.project(target01, verbose=True)

    os.makedirs(args.out, exist_ok=True)
    pair = quantize_u8(torch.cat([target01, images01])).cpu().numpy()
    save_grid(pair, os.path.join(args.out, "target_vs_projected.jpg"), nrow=2)
    np.savez(os.path.join(args.out, "dlatents.npz"), dlatents=dlatents.cpu().numpy())
    with torch.inference_mode():
        d0 = float(proj.distance(target01, target01).sum())
        d1 = float(proj.distance(images01, target01).sum())
    print(f"distance(target, target) = {d0:.5f} (sanity 0)")
    print(f"distance(projected, target) = {d1:.5f} after {args.steps} steps")
    print(f"artifacts: {args.out}/target_vs_projected.jpg, dlatents.npz")


if __name__ == "__main__":
    main()
