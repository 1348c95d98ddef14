"""CLIP torch state dict -> the JAX-layout numpy tree.

Reads the OpenAI CLIP state-dict layout (the `build_model` input, reference
clip/model.py:363-399) of either tower family: the ViT (patch transformer)
and the ModifiedResNet (RN50; `convert_clip_rn`). Linear weights are
transposed to right-multiply [in, out]; the ViT's patch conv kernel
[width, 3, P, P] becomes the [3*P*P, width] patch-embedding matrix (flatten
order (c, ph, pw), as `models/clip/model.py` extracts patches); the
transformer blocks are stacked on a leading layer axis. The numpy
operations are the JAX package's converter's, in its order, so both give
the same bits; `weights.from_jax.convert_clip` takes the tree to the port's
layout.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from clip_glass_torch.models.clip.model import CLIPConfig
from clip_glass_torch.weights import convert_clip_rn
from clip_glass_torch.weights.from_jax import stack_layers
from clip_glass_torch.weights.from_jax import to_numpy as _np

# entries of the official archives that are not weights; build_model
# deletes them (reference clip/model.py:394-395)
SCALAR_ENTRIES = ("input_resolution", "context_length", "vocab_size")


def infer_config(sd: Dict[str, np.ndarray]) -> CLIPConfig:
    """Hyperparameters from the state dict's shapes (reference
    clip/model.py:363-381). `visual.positional_embedding` tells the tower
    families apart, as the reference's `build_model` does (clip/model.py:365):
    the ViT has it, the ModifiedResNet does not."""
    embed_dim = sd["text_projection"].shape[1]
    tw = sd["ln_final.weight"].shape[0]
    text = dict(embed_dim=embed_dim, context_length=sd["positional_embedding"].shape[0],
                vocab_size=sd["token_embedding.weight"].shape[0], transformer_width=tw,
                transformer_heads=tw // 64,
                transformer_layers=len({k.split(".")[2] for k in sd
                                        if k.startswith("transformer.resblocks.")}))
    if "visual.positional_embedding" not in sd:
        # the ModifiedResNet (reference clip/model.py:371-379)
        counts = tuple(len({k.split(".")[2] for k in sd if k.startswith(f"visual.layer{b}.")})
                       for b in (1, 2, 3, 4))
        spacial = int(round((sd["visual.attnpool.positional_embedding"].shape[0] - 1) ** 0.5))
        return CLIPConfig(image_resolution=spacial * 32, vision_layers=counts,
                          vision_width=sd["visual.layer1.0.conv1.weight"].shape[0],
                          vision_kind="rn", **text)
    patch = sd["visual.conv1.weight"].shape[-1]
    grid = int(round((sd["visual.positional_embedding"].shape[0] - 1) ** 0.5))
    vision_layers = len({k.split(".")[3] for k in sd
                         if k.startswith("visual.transformer.resblocks.")})
    return CLIPConfig(image_resolution=grid * patch, vision_layers=vision_layers,
                      vision_width=sd["visual.conv1.weight"].shape[0],
                      vision_patch_size=patch, **text)


def _block(sd, prefix: str):
    return {
        "ln_1": {"scale": _np(sd[f"{prefix}.ln_1.weight"]),
                 "bias": _np(sd[f"{prefix}.ln_1.bias"])},
        "attn": {
            "in_proj_weight": _np(sd[f"{prefix}.attn.in_proj_weight"]).T,
            "in_proj_bias": _np(sd[f"{prefix}.attn.in_proj_bias"]),
            "out_proj_weight": _np(sd[f"{prefix}.attn.out_proj.weight"]).T,
            "out_proj_bias": _np(sd[f"{prefix}.attn.out_proj.bias"]),
        },
        "ln_2": {"scale": _np(sd[f"{prefix}.ln_2.weight"]),
                 "bias": _np(sd[f"{prefix}.ln_2.bias"])},
        "mlp": {
            "c_fc_weight": _np(sd[f"{prefix}.mlp.c_fc.weight"]).T,
            "c_fc_bias": _np(sd[f"{prefix}.mlp.c_fc.bias"]),
            "c_proj_weight": _np(sd[f"{prefix}.mlp.c_proj.weight"]).T,
            "c_proj_bias": _np(sd[f"{prefix}.mlp.c_proj.bias"]),
        },
    }


def convert(sd: Dict, cfg: CLIPConfig = None):
    """State dict (tensors or arrays, any float dtype) -> (tree, cfg)."""
    cfg = cfg or infer_config({k: _np(v) for k, v in sd.items()})
    if cfg.vision_kind == "rn":
        visual = convert_clip_rn.convert(sd, cfg.rn_config(), prefix="visual.")
    else:
        conv = _np(sd["visual.conv1.weight"])  # [w, 3, P, P]
        visual = {
            "patch_embed": {"weight": conv.reshape(cfg.vision_width, -1).T},
            "class_embedding": _np(sd["visual.class_embedding"]),
            "positional_embedding": _np(sd["visual.positional_embedding"]),
            "ln_pre": {"scale": _np(sd["visual.ln_pre.weight"]),
                       "bias": _np(sd["visual.ln_pre.bias"])},
            "blocks": stack_layers([_block(sd, f"visual.transformer.resblocks.{i}")
                                    for i in range(cfg.vision_layers)]),
            "ln_post": {"scale": _np(sd["visual.ln_post.weight"]),
                        "bias": _np(sd["visual.ln_post.bias"])},
            "proj": _np(sd["visual.proj"]),
        }
    tree = {
        "visual": visual,
        "text": {
            "token_embedding": _np(sd["token_embedding.weight"]),
            "positional_embedding": _np(sd["positional_embedding"]),
            "blocks": stack_layers([_block(sd, f"transformer.resblocks.{i}")
                                    for i in range(cfg.transformer_layers)]),
            "ln_final": {"scale": _np(sd["ln_final.weight"]),
                         "bias": _np(sd["ln_final.bias"])},
            "text_projection": _np(sd["text_projection"]),
        },
        "logit_scale": _np(sd["logit_scale"]),
    }
    return tree, cfg


def read_state_dict(path: str) -> Dict:
    """The state dict of an OpenAI CLIP file, by the reference's two
    ingestion paths (clip/clip.py:60-78): a TorchScript archive (the official
    files), else a pickled state dict or model. The archive's scalar entries
    are dropped."""
    import torch

    try:
        sd = torch.jit.load(path, map_location="cpu").state_dict()
    except RuntimeError:
        # not a TorchScript archive: the reference loads it with torch.load;
        # a file that is neither raises here
        sd = torch.load(path, map_location="cpu", weights_only=False)
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
    return {k: v for k, v in sd.items() if not k.startswith(SCALAR_ENTRIES)}


def load_torch_checkpoint(path: str):
    """(tree, cfg) of an OpenAI CLIP `.pt`; fp16 archives widen to fp32."""
    return convert(read_state_dict(path))
