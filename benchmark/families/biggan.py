"""BigGAN-deep (G over z and a soft class vector), the configuration file's
`biggan` group."""

from __future__ import annotations

import torch

from benchmark.families import replace_fields
from benchmark.harness import weights
from benchmark.reference import biggan as ref_biggan
from benchmark.reference import clip as ref_clip
from benchmark.yardstick import flops


def make_weights(config: dict, gen: torch.Generator, log=None) -> dict:
    """G, its batch norms' statistics standing over latents drawn from `gen`."""
    geo, init = config["biggan"], config["assumed"]
    g = weights.materialize(weights.biggan_spec(geo, init), gen)
    weights.standing_stats(g, geo, gen, init["standing_stats_rows"])
    return {"g": g}


def model_config(config: dict):
    from clip_glass_torch.models.biggan import model as bg

    return replace_fields(bg.BIGGAN_DEEP_512, config["biggan"])


def block_rows(config: dict, pop: int, block: int) -> int:
    return block


def targets(config: dict, w: dict, prompts, device) -> torch.Tensor:
    """Each search's target: its prompt's CLIP text features."""
    return ref_clip.encode_prompts(w["clip"], prompts, config["clip"], device)


def score(config: dict, w: dict, x: torch.Tensor, text: torch.Tensor) -> dict:
    geo = config["biggan"]
    z, cv = x[:, :geo["z_dim"]].clamp(-2, 2), torch.softmax(x[:, geo["z_dim"]:], 1)
    img = ((ref_biggan.generate(w["g"], z, cv, geo) + 1) / 2).clamp(0, 1)
    return {"cols": [-ref_clip.image_cosine(w["clip"], img, config["clip"], text)],
            "clipped": ((img <= 0) | (img >= 1)).float().mean(), "logits": None}


def flops_per_candidate(config: dict) -> int:
    return flops.biggan(config["biggan"]) + flops.clip_image(config["clip"])
