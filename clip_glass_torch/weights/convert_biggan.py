"""BigGAN-deep HF checkpoint -> the JAX-layout numpy tree.

Reads the `pytorch-pretrained-biggan` state-dict layout (the package the
reference loads its weights through, reference models.py:69):
spectral-normed convs and linears stored as `weight_orig` / `weight_u` /
`weight_v`, conditional batch norms with [n_stats, C] running statistics.
Spectral norm is folded in here: eval-time torch spectral_norm divides by
sigma = u^T W v from the stored power-iteration vectors, a constant scale.
sigma is an fp32 numpy product, as in the JAX package's converter, whose
numpy operations this follows in its order, so both give the same bits;
`weights.from_jax.convert_biggan` takes the tree to the port's layout.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from clip_glass_torch.models.biggan.model import CONFIGS, BigGANConfig
from clip_glass_torch.weights.from_jax import to_numpy as _np


def _sn_weight(sd: Dict, prefix: str) -> np.ndarray:
    """The effective spectral-normalized weight W / (u^T W_mat v)."""
    if f"{prefix}.weight_orig" not in sd:
        return _np(sd[f"{prefix}.weight"])
    w = _np(sd[f"{prefix}.weight_orig"])
    u = _np(sd[f"{prefix}.weight_u"])
    v = _np(sd[f"{prefix}.weight_v"])
    sigma = float(u @ w.reshape(w.shape[0], -1) @ v)
    return w / sigma


def _sn_linear(sd, prefix):
    p = {"w": _sn_weight(sd, prefix).T}          # [out, in] -> [in, out]
    if f"{prefix}.bias" in sd:
        p["b"] = _np(sd[f"{prefix}.bias"])
    return p


def _sn_conv(sd, prefix):
    p = {"w": np.transpose(_sn_weight(sd, prefix), (2, 3, 1, 0))}  # -> HWIO
    if f"{prefix}.bias" in sd:
        p["b"] = _np(sd[f"{prefix}.bias"])
    return p


def _cond_bn(sd, prefix):
    return {"running_means": _np(sd[f"{prefix}.running_means"]),
            "running_vars": _np(sd[f"{prefix}.running_vars"]),
            "scale": _sn_linear(sd, f"{prefix}.scale"),
            "offset": _sn_linear(sd, f"{prefix}.offset")}


def convert(sd: Dict, cfg: BigGANConfig):
    """Whole BigGAN state dict (embeddings + generator.*) -> tree."""
    g = "generator"
    blocks = []
    for i in range(len(cfg.layers) + 1):  # the GenBlocks and the attention
        p = f"{g}.layers.{i}"
        if f"{p}.gamma" in sd:
            blocks.append({"attn": {
                **{k: _sn_conv(sd, f"{p}.snconv1x1_{k}") for k in ("theta", "phi", "g", "o_conv")},
                "gamma": _np(sd[f"{p}.gamma"]).reshape(()),
            }})
        elif f"{p}.conv_0.weight_orig" in sd or f"{p}.conv_0.weight" in sd:
            blocks.append({"block": {
                "bn_0": _cond_bn(sd, f"{p}.bn_0"), "conv_0": _sn_conv(sd, f"{p}.conv_0"),
                "bn_1": _cond_bn(sd, f"{p}.bn_1"), "conv_1": _sn_conv(sd, f"{p}.conv_1"),
                "bn_2": _cond_bn(sd, f"{p}.bn_2"), "conv_2": _sn_conv(sd, f"{p}.conv_2"),
                "bn_3": _cond_bn(sd, f"{p}.bn_3"), "conv_3": _sn_conv(sd, f"{p}.conv_3"),
            }})
    return {
        "embeddings": _sn_linear(sd, "embeddings"),  # [num_classes, z_dim]
        "gen_z": _sn_linear(sd, f"{g}.gen_z"),
        "blocks": blocks,
        "bn": {k: _np(sd[f"{g}.bn.{k}"])
               for k in ("running_means", "running_vars", "weight", "bias")},
        "conv_to_rgb": _sn_conv(sd, f"{g}.conv_to_rgb"),
    }


def infer_config(sd: Dict) -> BigGANConfig:
    """The BigGANConfig from the checkpoint's shapes, with BigGAN-deep's
    invariant that the GenBlocks alternate plain / upsampling within each
    resolution stage (every published biggan-deep-{128,256,512}): up_i =
    (i odd). Everything else is read off the shapes: the embeddings
    [z_dim, num_classes], the channel width from the last block's output
    (its multiplier is 1), each block's multipliers from conv_0's input and
    conv_3's output, the attention's position from its gamma entry, n_stats
    from the running statistics, output_dim = 4 px * 2^(up blocks)."""
    def w(prefix):
        key = f"{prefix}.weight_orig"
        return _np(sd[key if key in sd else f"{prefix}.weight"])

    z_dim, num_classes = w("embeddings").shape
    g = "generator"
    entries = []          # ("attn", i) | ("block", in_ch, out_ch, i)
    i = 0
    while True:
        p = f"{g}.layers.{i}"
        if f"{p}.gamma" in sd:
            entries.append(("attn", i))
        elif any(k.startswith(f"{p}.conv_0.") for k in sd):
            entries.append(("block", w(f"{p}.conv_0").shape[1], w(f"{p}.conv_3").shape[0], i))
        else:
            break
        i += 1
    blocks = [e for e in entries if e[0] == "block"]
    if not blocks:
        raise ValueError("no generator.layers.N GenBlocks in the checkpoint")
    ch = blocks[-1][2]
    layers = []
    for bi, (_, in_ch, out_ch, _i) in enumerate(blocks):
        if in_ch % ch or out_ch % ch:
            raise ValueError(f"block {bi} channels ({in_ch}->{out_ch}) are not "
                             f"multiples of the inferred width {ch}")
        layers.append((bi % 2 == 1, in_ch // ch, out_ch // ch))
    attn = [e[1] for e in entries if e[0] == "attn"]
    n_stats = _np(sd[f"{g}.layers.{blocks[0][3]}.bn_0.running_means"]).shape[0]
    return BigGANConfig(z_dim=z_dim, channel_width=ch, num_classes=num_classes,
                        layers=tuple(layers), attention_layer_position=attn[0] if attn else 0,
                        n_stats=n_stats, output_dim=4 * 2 ** sum(up for up, _, _ in layers))


def load_torch_checkpoint(path: str, model_name: str = "biggan-deep-256"):
    """(tree, cfg) of a `pytorch_model.bin`; `model_name` names the published
    variant (`CONFIGS`), "auto" reads the geometry off the shapes."""
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=False)
    cfg = infer_config(sd) if model_name == "auto" else CONFIGS[model_name]
    return convert(sd, cfg), cfg
