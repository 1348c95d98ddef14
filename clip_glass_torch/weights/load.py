"""Reading the weight names a config gives: `random[:<seed>]` and the
converted `.npz` checkpoints with their `<stem>_cfg.json` sidecars that the
JAX package's converters write. The CLIP loader lives here, so the fitness
layer and `models/clip/api.py` share it."""

from __future__ import annotations

import dataclasses
import json
import os

import torch

from clip_glass_torch.core import pytree
from clip_glass_torch.models.clip import model as clip_model
from clip_glass_torch.weights import from_jax


def is_random(weights: str) -> bool:
    return isinstance(weights, str) and weights.startswith("random")


def random_seed(weights: str) -> int:
    return int(weights.split(":")[1]) if ":" in weights else 0


def read_cfg_sidecar(npz_path: str, cfg_cls):
    """The `<stem>_cfg.json` sidecar the JAX package's converters write next
    to a converted npz, as an instance of `cfg_cls` (fields it does not know
    are dropped, JSON lists become tuples); None when there is none."""
    path = os.path.splitext(npz_path)[0] + "_cfg.json"
    if not os.path.exists(path):
        return None
    with open(path) as f:
        d = json.load(f)

    def detuple(v):
        return tuple(detuple(x) for x in v) if isinstance(v, list) else v

    known = {f.name for f in dataclasses.fields(cfg_cls)}
    return cfg_cls(**{k: detuple(v) for k, v in d.items() if k in known})


def load_clip(clip_weights: str, clip_cfg=None):
    """CLIP parameters and config: seeded random draws, or a converted
    `.npz` with its `_cfg.json` sidecar (the JAX package's torch-free path,
    weights/convert_clip.py:127-145)."""
    if is_random(clip_weights):
        gen = torch.Generator().manual_seed(random_seed(clip_weights))
        cfg = clip_cfg or clip_model.VIT_B_32
        return clip_model.init(gen, cfg), cfg
    if not clip_weights.endswith(".npz"):
        raise NotImplementedError(
            f"CLIP weights {clip_weights!r}: only converted .npz checkpoints "
            "load here; the OpenAI .pt format is ROADMAP item 14")
    if not os.path.exists(clip_weights):
        raise FileNotFoundError(f"CLIP weights not found at {clip_weights!r}")
    cfg = read_cfg_sidecar(clip_weights, clip_model.CLIPConfig)
    if cfg is None:
        raise FileNotFoundError(f"{clip_weights}: its _cfg.json sidecar is missing")
    if not isinstance(cfg.vision_layers, int):  # per-stage counts: a ResNet
        raise NotImplementedError(
            f"CLIP weights {clip_weights!r}: the ResNet towers are ROADMAP item 11")
    return from_jax.convert_clip(pytree.load_npz(clip_weights)), cfg
