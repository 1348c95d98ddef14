"""Checkpoint conversion CLI: the reference's checkpoints -> npz trees.

    python -m clip_glass_torch.weights.convert_weights clip         ViT-B-32.pt  out.npz
    python -m clip_glass_torch.weights.convert_weights stylegan2    <dir with G.pth> out_dir
    python -m clip_glass_torch.weights.convert_weights stylegan2-tf stylegan2-ffhq.pkl out_dir
    python -m clip_glass_torch.weights.convert_weights gpt2         gpt2-pytorch_model.bin out.npz
    python -m clip_glass_torch.weights.convert_weights biggan       biggan-deep-256.bin out.npz \\
        [--model-name biggan-deep-256|biggan-deep-512|biggan-deep-128|auto]
    python -m clip_glass_torch.weights.convert_weights lpips        vgg16-397923af.pth out.npz \\
        --linear vgg.pth
    python -m clip_glass_torch.weights.convert_weights inception    pt_inception-2015-12-05.pth out.npz

It writes what the JAX package's `scripts/convert_weights.py` writes: the
same `.npz` trees and `<stem>_cfg.json` sidecars, so either package reads the
other's output. Every format also loads without conversion (`--weights`,
`--clip-weights`), except the TF pickle, which only this CLI reads. The
metric towers' npz (`lpips`: torchvision's vgg16 state dict with the
richzhang v0.1 linear heads of `--linear`; `inception`: pytorch-fid's
pt_inception state dict, BN folded) have no sidecar; `metrics.lpips.load_npz`
and `metrics.inception.load_npz` read them.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

from clip_glass_torch.core import pytree

KINDS = ("clip", "stylegan2", "stylegan2-tf", "gpt2", "biggan", "lpips", "inception")


def _save(dst: str, tree, cfg) -> None:
    """The tree and its `<stem>_cfg.json` sidecar, byte for byte the JSON
    the JAX package's script writes."""
    pytree.save_npz(dst, tree)
    with open(os.path.splitext(dst)[0] + "_cfg.json", "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=1)


def _stylegan2(src: str, dst: str) -> None:
    from clip_glass_torch.weights import convert_stylegan2

    os.makedirs(dst, exist_ok=True)
    src_dir = src if os.path.isdir(src) else os.path.dirname(src)
    converted = 0
    for name in ("G.pth", "D.pth", "Gs.pth"):
        path = os.path.join(src_dir, name)
        if not os.path.exists(path):
            continue
        tree, cfg, kind = convert_stylegan2.load_pth(path)
        out = os.path.join(dst, name.replace(".pth", ".npz"))
        _save(out, tree, cfg)
        print(f"{name} ({kind}, {cfg.resolution}px) -> {out}")
        converted += 1
    if not converted:
        sys.exit(f"no G.pth/D.pth/Gs.pth found under {src_dir!r}")


def _stylegan2_tf(src: str, dst: str) -> None:
    from clip_glass_torch.weights import convert_stylegan2_tf

    os.makedirs(dst, exist_ok=True)
    for key, val in convert_stylegan2_tf.convert_pkl(src).items():
        if key in ("G", "Gs"):
            tree, cfg, noises = val
            pytree.save_npz(os.path.join(dst, f"{key}_noise.npz"),
                            {str(i): n for i, n in enumerate(noises)})
        else:
            tree, cfg = val
        _save(os.path.join(dst, f"{key}.npz"), tree, cfg)
        print(f"{key} ({cfg.resolution}px) -> {dst}")


def _metric(p: argparse.ArgumentParser, args) -> None:
    """The LPIPS-VGG16 or FID-Inception tree, as the JAX script writes it."""
    import torch

    sd = torch.load(args.src, map_location="cpu", weights_only=False)
    if args.kind == "lpips":
        from clip_glass_torch.metrics import lpips

        # the vgg16 zoo file: the whole model's state dict, classifier
        # included; the metric reads `features.*` only
        feats = {k[len("features."):]: v for k, v in sd.items()
                 if k.startswith("features.")} or sd
        if "0.weight" not in feats:
            p.error(f"{args.src}: no vgg16 `features.0.weight`")
        lin = torch.load(args.linear, map_location="cpu", weights_only=False)
        tree = lpips.convert_torch_lpips(feats, list(lin.values()))
        pytree.save_npz(args.dst, tree)
        print(f"LPIPS-VGG16 ({len(tree['convs'])} convs + {len(tree['heads'])} "
              f"linear heads) -> {args.dst}")
        return
    from clip_glass_torch.metrics import inception

    if "Conv2d_1a_3x3.conv.weight" not in sd:
        p.error(f"{args.src}: no `Conv2d_1a_3x3.conv.weight`: not an InceptionV3 state dict")
    pytree.save_npz(args.dst, inception.convert_torch_inception(sd))
    print(f"InceptionV3 (pytorch-fid layout, BN folded) -> {args.dst}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m clip_glass_torch.weights.convert_weights",
        description="convert the reference's checkpoints to npz trees")
    p.add_argument("kind", choices=KINDS)
    p.add_argument("src")
    p.add_argument("dst")
    p.add_argument("--model-name", default="biggan-deep-256",
                   help="the biggan kind's variant; 'auto' reads the geometry "
                        "off the checkpoint's shapes")
    p.add_argument("--linear", default=None,
                   help="the lpips kind's richzhang v0.1 linear-weights .pth")
    args = p.parse_args(argv)
    if args.kind == "lpips" and not args.linear:
        p.error("the lpips kind requires --linear <richzhang vgg.pth>")

    if args.kind == "clip":
        from clip_glass_torch.weights import convert_clip

        tree, cfg = convert_clip.load_torch_checkpoint(args.src)
        _save(args.dst, tree, cfg)
        print(f"CLIP {cfg} -> {args.dst}")
    elif args.kind == "gpt2":
        from clip_glass_torch.weights import convert_gpt2

        tree, cfg = convert_gpt2.load_torch_checkpoint(args.src)
        _save(args.dst, tree, cfg)
        print(f"GPT-2 {cfg} -> {args.dst}")
    elif args.kind == "biggan":
        from clip_glass_torch.weights import convert_biggan

        tree, cfg = convert_biggan.load_torch_checkpoint(args.src, args.model_name)
        _save(args.dst, tree, cfg)
        print(f"BigGAN {args.model_name} -> {args.dst}")
    elif args.kind in ("lpips", "inception"):
        _metric(p, args)
    elif args.kind == "stylegan2":
        _stylegan2(args.src, args.dst)
    else:
        _stylegan2_tf(args.src, args.dst)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
