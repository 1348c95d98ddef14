"""GPT-2 image to text (CLIP-GLaSS's `GPT2` configuration), the configuration
file's `gpt2` group: a genome of `n_var` token ids, then the init text, then
an argmax decode of `max_tokens_len` tokens; the caption's CLIP text
features scored against the target image's.

The targets are image files drawn from the seed (`draw_targets`,
harness/images.py). The port's decoded ids are kept while the window
records (`GENERATOR_OUTPUT`, harness/trace.py), and the reference judges
them: teacher-forced on the port's decoded tokens after the reference's
own context (the genome and the init text), it gives each step's margin
(reference/gpt2.py), and it scores the port's captions itself. Without the
port's ids (the control) it decodes its own. A traced run times the
port's decode and CLIP's text tower (`LAYER_FUNCTIONS`) as `models.G` and
`models.CLIP`.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from benchmark.families import replace_fields
from benchmark.harness import images, weights
from benchmark.reference import clip as ref_clip
from benchmark.reference import gpt2 as ref_gpt2
from benchmark.reference.tokenizer import tokenize
from benchmark.yardstick import flops

# (module, class, attribute) of the port's call whose result is the decode's
# ids [rows, n_var + init + max_tokens_len]
GENERATOR_OUTPUT = ("clip_glass_torch.fitness.generator", "Generator", "_decode_rows")
# the port's functions a traced run times beside the harness's own: the
# decode of a chunk of contexts [rows, n_var + init] and CLIP's text tower
# on the captions' tokens [rows, 77]
LAYER_FUNCTIONS = (
    ("clip_glass_torch.models.gpt2.model", "sample_sequence", "models.G"),
    ("clip_glass_torch.models.clip.model", "encode_text", "models.CLIP"),
)


@lru_cache(maxsize=4)
def _init_ids(text: str) -> tuple:
    return tuple(ref_gpt2.encode(text))


def make_weights(config: dict, gen: torch.Generator, log=None) -> dict:
    return {"g": weights.materialize(weights.gpt2_spec(config["gpt2"], config["assumed"]), gen)}


def model_config(config: dict):
    from clip_glass_torch.models.gpt2 import model as g2

    return replace_fields(g2.GPT2_124M, config["gpt2"])


def block_rows(config: dict, pop: int, block: int) -> int:
    """A caption too long for CLIP's context zeroes its whole search's
    fitness (CLIP-GLaSS's `generator.py`): a search's population at once."""
    return pop


def draw_targets(config: dict, rng, n: int, workdir) -> list:
    """n image files at CLIP's input size, drawn from `rng` into `workdir`."""
    return images.draw(rng, n, config["clip"]["image_resolution"], workdir)


def targets(config: dict, w: dict, paths, device) -> torch.Tensor:
    """Each search's target: its image's CLIP features."""
    return ref_clip.encode_images(w["clip"], paths, config["clip"], device)


def score(config: dict, w: dict, x: torch.Tensor, image: torch.Tensor, outputs=None) -> dict:
    """The reference's fitness of one search's genomes x: the captions of
    the port's decoded tokens (`outputs`, their margins judged) or, without
    them, of the reference's own decode."""
    s, geo = config["search"], config["gpt2"]
    init = _init_ids(s["init_text"])
    context = torch.cat([torch.round(x).long(),
                         torch.tensor(init, device=x.device).expand(x.shape[0], -1)], dim=1)
    start, margins = context.shape[1], None
    if outputs is None:
        ids = ref_gpt2.decode(w["g"], context, s["max_tokens_len"], geo)
    else:
        if outputs.shape[1] != start + s["max_tokens_len"]:
            raise ValueError(f"the port's ids have {outputs.shape[1]} columns, not "
                             f"{start} + {s['max_tokens_len']}")
        ids = torch.cat([context, outputs[:, start:].long()], dim=1)
        margins = ref_gpt2.margins(w["g"], ids, start, geo)
    texts = ref_gpt2.captions(ids, s["n_var"], s["max_text_len"])
    try:
        toks = torch.as_tensor(tokenize(texts), device=x.device)
    except ValueError:
        sim = torch.zeros(x.shape[0], device=x.device)
    else:
        sim = ref_clip.cosine(ref_clip.encode_text(w["clip"], toks, config["clip"]), image)
    return {"cols": [-sim], "clipped": None, "logits": None, "margins": margins,
            "outputs": ids if outputs is None else None}


def flops_per_candidate(config: dict) -> int:
    s = config["search"]
    context = s["n_var"] + len(_init_ids(s["init_text"]))
    return (flops.gpt2_decode(config["gpt2"], context, s["max_tokens_len"])
            + flops.clip_text(config["clip"]))
