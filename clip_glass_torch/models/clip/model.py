"""CLIP (image + text towers), with a ViT or a ModifiedResNet image tower.

Behavioral reference: reference clip/model.py:150-335 (VisualTransformer,
Transformer/ResidualAttentionBlock, CLIP.encode_image/encode_text), in the
JAX package's formulation so the numbers follow it (the ResNet tower, the
RN50 family, is `models/clip/resnet.py`):

- the patch embedding is a reshape with a (c, ph, pw) flatten order and one
  [B*G*G, 3*P*P] x [3*P*P, width] matmul (same arithmetic as the reference's
  stride-P conv);
- blocks are pre-LN residual attention blocks over a list of per-layer
  parameter dicts;
- bf16 compute with fp32 LayerNorm, like the reference's fp16-weights /
  fp32-LN split (reference clip/model.py:152-158);
- batch-first throughout.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from clip_glass_torch.core.dtypes import FP32, Policy
from clip_glass_torch.models.clip import resnet
from clip_glass_torch.ops.attention import multi_head_attention, project
from clip_glass_torch.ops.norms import layer_norm
from clip_glass_torch.weights import from_jax


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    embed_dim: int = 512
    image_resolution: int = 224
    # vit: the block count; rn: the bottlenecks of each stage, e.g. (3, 4, 6, 3)
    vision_layers: object = 12
    vision_width: int = 768
    vision_patch_size: int = 32  # vit only
    context_length: int = 77
    vocab_size: int = 49408
    transformer_width: int = 512
    transformer_heads: int = 8
    transformer_layers: int = 12
    # the image tower's family: "vit" (patch transformer, reference
    # clip/model.py:222-269) or "rn" (ModifiedResNet, clip/model.py:9-149)
    vision_kind: str = "vit"

    @property
    def vision_heads(self) -> int:
        return self.vision_width // 64  # reference clip/model.py:270

    @property
    def grid(self) -> int:
        return self.image_resolution // self.vision_patch_size

    def rn_config(self) -> resnet.RNConfig:
        """The ModifiedResNet view of this config (vision_kind == "rn")."""
        return resnet.RNConfig(layers=tuple(self.vision_layers), output_dim=self.embed_dim,
                               input_resolution=self.image_resolution,
                               width=self.vision_width)


VIT_B_32 = CLIPConfig()
# RN50 (reference clip/clip.py:18-21 `_MODELS`; the hyperparameters
# build_model infers from the official checkpoint, clip/model.py:371-379)
RN50 = CLIPConfig(embed_dim=1024, vision_layers=(3, 4, 6, 3), vision_width=64,
                  vision_kind="rn")

# tiny variant for CPU tests
TINY = CLIPConfig(embed_dim=64, image_resolution=32, vision_layers=2,
                  vision_width=128, vision_patch_size=8, context_length=77,
                  vocab_size=49408, transformer_width=64, transformer_heads=2,
                  transformer_layers=2)

# Leaves the forward reads raw in fp32: LayerNorm scales/biases, the ResNet
# tower's folded BatchNorms (`bn*`) and logit_scale.
PRECAST_EXCLUDE = ("ln_", "bn", "logit_scale")


# ---------------------------------------------------------------- init

def _randn(gen, *shape):
    return torch.randn(shape, generator=gen, device=gen.device)


def _block_tree(gen, width: int):
    s_attn = width ** -0.5
    s_mlp = (4 * width) ** -0.5
    return {
        "ln_1": {"scale": torch.ones(width), "bias": torch.zeros(width)},
        "attn": {
            "in_proj_weight": s_attn * _randn(gen, width, 3 * width),
            "in_proj_bias": torch.zeros(3 * width),
            "out_proj_weight": s_attn * _randn(gen, width, width),
            "out_proj_bias": torch.zeros(width),
        },
        "ln_2": {"scale": torch.ones(width), "bias": torch.zeros(width)},
        "mlp": {
            "c_fc_weight": s_attn * _randn(gen, width, 4 * width),
            "c_fc_bias": torch.zeros(4 * width),
            "c_proj_weight": s_mlp * _randn(gen, 4 * width, width),
            "c_proj_bias": torch.zeros(width),
        },
    }


def _stack(blocks):
    """List of per-layer trees -> one tree stacked on a leading layer axis
    (the JAX layout the converter takes)."""
    if isinstance(blocks[0], dict):
        return {k: _stack([b[k] for b in blocks]) for k in blocks[0]}
    return torch.stack(blocks)


def init_tree(gen: torch.Generator, cfg: CLIPConfig = VIT_B_32):
    """Random parameters (the JAX package's distributions and scales) in the
    JAX layout (what a converted CLIP `.npz` holds)."""
    w, tw = cfg.vision_width, cfg.transformer_width
    scale_v, scale_t = w ** -0.5, tw ** -0.5
    if cfg.vision_kind == "rn":
        visual = resnet.init_tree(gen, cfg.rn_config())
    else:
        n_tok = cfg.grid ** 2 + 1
        patch_dim = 3 * cfg.vision_patch_size ** 2
        visual = {
            "patch_embed": {"weight": scale_v * _randn(gen, patch_dim, w)},
            "class_embedding": scale_v * _randn(gen, w),
            "positional_embedding": scale_v * _randn(gen, n_tok, w),
            "ln_pre": {"scale": torch.ones(w), "bias": torch.zeros(w)},
            "blocks": _stack([_block_tree(gen, w) for _ in range(cfg.vision_layers)]),
            "ln_post": {"scale": torch.ones(w), "bias": torch.zeros(w)},
            "proj": scale_v * _randn(gen, w, cfg.embed_dim),
        }
    text = {
        "token_embedding": scale_t * _randn(gen, cfg.vocab_size, tw),
        "positional_embedding": 0.01 * _randn(gen, cfg.context_length, tw),
        "blocks": _stack([_block_tree(gen, tw)
                          for _ in range(cfg.transformer_layers)]),
        "ln_final": {"scale": torch.ones(tw), "bias": torch.zeros(tw)},
        "text_projection": scale_t * _randn(gen, tw, cfg.embed_dim),
    }
    return {"visual": visual, "text": text,
            "logit_scale": torch.log(torch.tensor(1 / 0.07))}


def init(gen: torch.Generator, cfg: CLIPConfig = VIT_B_32):
    """Random parameters in the port's layout."""
    return from_jax.convert_clip(init_tree(gen, cfg))


# ---------------------------------------------------------------- forward

def _block_forward(x, bp, n_head: int, mask: Optional[torch.Tensor],
                   policy: Policy, reduce=None):
    """Pre-LN residual attention block (reference clip/model.py:164-187). On
    a model shard `n_head` is the shard's heads and `reduce` its sum over
    the model group: out_proj and c_proj give partial products, each summed
    once (`ops.attention.project`), so the block is the whole one's
    function, as the JAX package's under GSPMD."""
    h = layer_norm(x, bp["ln_1"]["scale"], bp["ln_1"]["bias"])
    a = bp["attn"]
    h = multi_head_attention(policy.cast_compute(h), a["in_proj_weight"],
                             a["in_proj_bias"], a["out_proj_weight"],
                             a["out_proj_bias"], n_head, mask=mask, policy=policy,
                             reduce=reduce)
    x = x + h
    h = policy.cast_compute(layer_norm(x, bp["ln_2"]["scale"], bp["ln_2"]["bias"]))
    m = bp["mlp"]
    h = h @ policy.cast_compute(m["c_fc_weight"]) + policy.cast_compute(m["c_fc_bias"])
    h = h * torch.sigmoid(1.702 * h)  # QuickGELU (reference clip/model.py:160-161)
    h = project(h, m["c_proj_weight"], m["c_proj_bias"], policy, reduce)
    return x + h


def _transformer(x, blocks, n_head: int, mask, policy: Policy, tp: int = 1, reduce=None):
    """A tower's blocks: a whole tree's (tp 1), or a model shard's
    (parallel.mesh.clip_shard: n_head / tp heads, its partial products
    summed by `reduce` over the shard's model group)."""
    if tp > 1 and reduce is None:
        raise ValueError(f"a CLIP model shard of {tp} needs the sum over its model group")
    for bp in blocks:
        x = _block_forward(x, bp, n_head // tp, mask, policy, reduce)
    return x


def encode_image(params, images, cfg: CLIPConfig = VIT_B_32,
                 policy: Policy = FP32, tp: int = 1, reduce=None) -> torch.Tensor:
    """images: [B, 3, H, W] floats (the fitness path feeds [0,1] images with
    no CLIP mean/std normalization, like the reference, generator.py:45).
    `tp` > 1: `params` is one of tp model shards (parallel.mesh.clip_shard)
    and `reduce` its sum over the model group (parallel.mesh.model_sum)."""
    if cfg.vision_kind == "rn":
        return resnet.apply(params["visual"], images, cfg.rn_config(), policy)
    v = params["visual"]
    B = images.shape[0]
    P, G = cfg.vision_patch_size, cfg.grid
    x = policy.cast_compute(images)
    # [B,3,H,W] -> [B, G*G, 3*P*P] with (c, ph, pw) flattened in conv-weight order
    x = x.reshape(B, 3, G, P, G, P).permute(0, 2, 4, 1, 3, 5).reshape(B, G * G, 3 * P * P)
    x = x @ policy.cast_compute(v["patch_embed"]["weight"])
    cls = policy.cast_compute(v["class_embedding"]).expand(B, 1, cfg.vision_width)
    x = torch.cat([cls, x], dim=1)
    x = x + policy.cast_compute(v["positional_embedding"])
    x = policy.cast_compute(layer_norm(x, v["ln_pre"]["scale"], v["ln_pre"]["bias"]))
    x = _transformer(x, v["blocks"], cfg.vision_heads, None, policy, tp, reduce)
    x = layer_norm(x[:, 0, :], v["ln_post"]["scale"], v["ln_post"]["bias"])
    return policy.cast_compute(x) @ policy.cast_compute(v["proj"])


def _causal_mask(n: int, device) -> torch.Tensor:
    # additive -inf above the diagonal (reference clip/model.py:293-299)
    return torch.full((n, n), float("-inf"), device=device).triu(1)


def encode_text(params, text_ids, cfg: CLIPConfig = VIT_B_32,
                policy: Policy = FP32, tp: int = 1, reduce=None) -> torch.Tensor:
    """text_ids: [B, 77] integer ids from tokenizers.tokenize; EOT pooling by
    argmax (EOT is the largest id in every sequence, clip/model.py:318).
    `tp` and `reduce`: a model shard's, as in `encode_image`."""
    t = params["text"]
    text_ids = text_ids.long()
    x = policy.cast_compute(t["token_embedding"][text_ids])
    x = x + policy.cast_compute(t["positional_embedding"])
    mask = _causal_mask(cfg.context_length, x.device)
    x = _transformer(x, t["blocks"], cfg.transformer_heads, mask, policy, tp, reduce)
    x = layer_norm(x, t["ln_final"]["scale"], t["ln_final"]["bias"])
    eot = text_ids.argmax(dim=-1)
    x = x[torch.arange(x.shape[0], device=x.device), eot]
    return policy.cast_compute(x) @ policy.cast_compute(t["text_projection"])
