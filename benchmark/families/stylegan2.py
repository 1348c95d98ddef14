"""StyleGAN2 (config-f G and, where the search uses it, D's hinge), the
configuration file's `stylegan2` group."""

from __future__ import annotations

import json

import torch

from benchmark.families import replace_fields
from benchmark.harness import weights
from benchmark.reference import clip as ref_clip
from benchmark.reference import stylegan2 as ref_sg2
from benchmark.yardstick import flops


def make_weights(config: dict, gen: torch.Generator, log=None) -> dict:
    """G, D (with the discriminator) and the noise planes; `log` takes a
    line that says how the ToRGB layers were scaled."""
    geo, init = config["stylegan2"], config["assumed"]
    spec = weights.stylegan2_spec(geo, init)
    out = {}
    for part in ("g", "d", "noise"):
        if part != "d" or config["search"]["use_discriminator"]:
            out[part] = weights.materialize(spec[part], gen)
    std = weights.scale_to_rgb(out["g"], out["noise"], geo, gen, init["image_std_rows"],
                               init["image_std"])
    if log is not None:
        log(json.dumps({"to_rgb": {"image_std_drawn": std, "scaled_to": init["image_std"]}}))
    return out


def model_config(config: dict):
    from clip_glass_torch.models.stylegan2 import model as sg2

    return replace_fields(sg2.CONFIG_F, config["stylegan2"])


def block_rows(config: dict, pop: int, block: int) -> int:
    """D's minibatch groups are a search's own rows: with D, a search's
    population at once."""
    return pop if config["search"]["use_discriminator"] else block


def targets(config: dict, w: dict, prompts, device) -> torch.Tensor:
    """Each search's target: its prompt's CLIP text features."""
    return ref_clip.encode_prompts(w["clip"], prompts, config["clip"], device)


def score(config: dict, w: dict, x: torch.Tensor, text: torch.Tensor) -> dict:
    img = ref_sg2.generate(w["g"], x, config["stylegan2"], w["noise"])
    img = ((img + 1) / 2).clamp(0, 1)
    out = {"cols": [-ref_clip.image_cosine(w["clip"], img, config["clip"], text)],
           "clipped": ((img <= 0) | (img >= 1)).float().mean(), "logits": None}
    if config["search"]["use_discriminator"]:
        d = ref_sg2.discriminator(w["d"], img * 2 - 1, config["stylegan2"])
        out["cols"].append(torch.relu(1 - d))
        out["logits"] = d
    return out


def flops_per_candidate(config: dict) -> int:
    g = config["stylegan2"]
    total = flops.stylegan2_generator(g) + flops.clip_image(config["clip"])
    if config["search"]["use_discriminator"]:
        total += flops.stylegan2_discriminator(g)
    return total
