"""Carry parameters across from the JAX package's layout to the port's.

Input: parameter trees as nested dicts and lists of arrays (numpy, including
ml_dtypes bfloat16, or torch tensors): what `jax.tree.map(np.asarray,
generator.bundle)` gives for the JAX package's fitness bundle. Output: the
port's parameters, fp32 CPU tensors (bf16 inputs are widened exactly).

Layout traps handled here:
- conv weights are HWIO in JAX and OIHW here (for `F.conv2d`), with the
  equalized-lr scale already folded in on both sides;
- the ToRGB 1x1 conv becomes an [I, O] matrix (the `modulated_matmul`
  kernel's operand);
- dense and attention weights stay right-multiply [in, out];
- CLIP transformer blocks, stacked on a leading layer axis in JAX, become a
  list of per-layer dicts;
- BigGAN's batch norms keep their [n_stats, C] running statistics;
- GPT-2's Conv1D weights are [in, out] on both sides (nothing transposed),
  its blocks, stacked on a leading layer axis in JAX, become a list.

The port's own random init builds the same JAX-layout trees and passes them
through these converters, so the two structures cannot drift apart.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def to_tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        t = a.detach().cpu()
    else:
        arr = np.asarray(a)
        if arr.dtype.name == "bfloat16":
            arr = arr.astype(np.float32)
        t = torch.from_numpy(np.array(arr))
    return t.float() if t.is_floating_point() else t


def _oihw(w) -> torch.Tensor:
    return to_tensor(w).permute(3, 2, 0, 1).contiguous()


def _dense(p) -> Dict[str, torch.Tensor]:
    return {"w": to_tensor(p["w"]), "b": to_tensor(p["b"])}


def _conv(p) -> Dict[str, Any]:
    out = {"w": _oihw(p["w"])}
    if "b" in p:
        out["b"] = to_tensor(p["b"])
    if "style" in p:
        out["style"] = _dense(p["style"])
    if "noise_scale" in p:
        out["noise_scale"] = to_tensor(p["noise_scale"])
    return out


def convert_generator(tree) -> Dict[str, Any]:
    """StyleGAN2 G: mapping + synthesis + dlatent_avg."""
    mapping = {"dense": [_dense(d) for d in tree["mapping"]["dense"]]}
    syn = tree["synthesis"]
    to_rgb = []
    for rp in syn["to_rgb"]:
        w = to_tensor(rp["w"])                      # [1, 1, I, O]
        entry = {"w": w[0, 0].contiguous(), "b": to_tensor(rp["b"])}
        if "style" in rp:
            entry["style"] = _dense(rp["style"])
        to_rgb.append(entry)
    return {
        "mapping": mapping,
        "synthesis": {
            "const": to_tensor(syn["const"]),       # [H, W, C]
            "blocks": [{"layers": [_conv(lp) for lp in bp["layers"]]}
                       for bp in syn["blocks"]],
            "to_rgb": to_rgb,
        },
        "dlatent_avg": to_tensor(tree["dlatent_avg"]),
    }


def convert_discriminator(tree) -> Dict[str, Any]:
    """StyleGAN2 D (resnet architecture)."""
    return {
        "from_rgb": _conv(tree["from_rgb"]),
        "blocks": [{"conv0": _conv(bp["conv0"]), "conv1": _conv(bp["conv1"]),
                    "skip": _conv(bp["skip"])} for bp in tree["blocks"]],
        "final_conv": _conv(tree["final_conv"]),
        "dense0": _dense(tree["dense0"]),
        "dense1": _dense(tree["dense1"]),
    }


def _unstack(blocks) -> list:
    """Leading-layer-axis stacked tree -> list of per-layer trees."""
    def leaves(t, path=()):
        if isinstance(t, dict):
            for k, v in t.items():
                yield from leaves(v, path + (k,))
        else:
            yield path, to_tensor(t)

    flat = list(leaves(blocks))
    n = flat[0][1].shape[0]
    layers = []
    for i in range(n):
        layer: Dict[str, Any] = {}
        for path, t in flat:
            d = layer
            for k in path[:-1]:
                d = d.setdefault(k, {})
            d[path[-1]] = t[i].contiguous()
        layers.append(layer)
    return layers


def _ln(p) -> Dict[str, torch.Tensor]:
    return {"scale": to_tensor(p["scale"]), "bias": to_tensor(p["bias"])}


def convert_clip(tree) -> Dict[str, Any]:
    """CLIP ViT (image + text towers)."""
    v, t = tree["visual"], tree["text"]
    return {
        "visual": {
            "patch_embed": {"weight": to_tensor(v["patch_embed"]["weight"])},
            "class_embedding": to_tensor(v["class_embedding"]),
            "positional_embedding": to_tensor(v["positional_embedding"]),
            "ln_pre": _ln(v["ln_pre"]),
            "blocks": _unstack(v["blocks"]),
            "ln_post": _ln(v["ln_post"]),
            "proj": to_tensor(v["proj"]),
        },
        "text": {
            "token_embedding": to_tensor(t["token_embedding"]),
            "positional_embedding": to_tensor(t["positional_embedding"]),
            "blocks": _unstack(t["blocks"]),
            "ln_final": _ln(t["ln_final"]),
            "text_projection": to_tensor(t["text_projection"]),
        },
        "logit_scale": to_tensor(tree["logit_scale"]),
    }


def convert_noise(noise) -> list:
    """Per-layer noise planes [H, W]; the JAX package's s2d-packed planes
    (3-D) belong to an execution domain the port does not run."""
    out = []
    for nz in noise:
        t = to_tensor(nz)
        if t.ndim != 2:
            raise ValueError(f"noise plane of shape {tuple(t.shape)}: only plain "
                             "[H, W] planes are supported (pack_noise's s2d "
                             "layout is not)")
        out.append(t)
    return out


def _stats_bn(p) -> Dict[str, Any]:
    """A BigGAN batch norm: the [n_stats, C] running statistics and either the
    conditional gain/bias projections or the plain affine pair."""
    return {k: (_bias_free(v) if k in ("scale", "offset") else to_tensor(v))
            for k, v in p.items()}


def _bias_free(p) -> Dict[str, torch.Tensor]:
    return {"w": to_tensor(p["w"])}


def convert_biggan(tree) -> Dict[str, Any]:
    """BigGAN-deep G. The `blocks` list keeps its order, with the attention
    entry {"attn": ...} in place beside the {"block": ...} entries."""
    blocks = []
    for entry in tree["blocks"]:
        if "attn" in entry:
            a = entry["attn"]
            blocks.append({"attn": {**{k: _conv(a[k]) for k in ("theta", "phi", "g", "o_conv")},
                                    "gamma": to_tensor(a["gamma"])}})
        else:
            b = entry["block"]
            blocks.append({"block": {k: (_conv(v) if k.startswith("conv") else _stats_bn(v))
                                     for k, v in b.items()}})
    return {
        "embeddings": _bias_free(tree["embeddings"]),    # [num_classes, z_dim]
        "gen_z": _dense(tree["gen_z"]),
        "blocks": blocks,
        "bn": _stats_bn(tree["bn"]),
        "conv_to_rgb": _conv(tree["conv_to_rgb"]),
    }


def convert_gpt2(tree) -> Dict[str, Any]:
    """GPT-2: wte, wpe, ln_f and the per-layer blocks."""
    return {
        "wte": to_tensor(tree["wte"]),
        "wpe": to_tensor(tree["wpe"]),
        "blocks": _unstack(tree["blocks"]),
        "ln_f": {k: to_tensor(v) for k, v in tree["ln_f"].items()},
    }


def convert_bundle(bundle) -> Dict[str, Any]:
    """A fitness bundle -> the port's: StyleGAN2 {clip, g, d?, noise,
    target}, BigGAN {clip, g, target} or GPT-2 {clip, g, target}, told apart
    by the noise planes and GPT-2's token embedding."""
    if "noise" not in bundle:
        convert = convert_gpt2 if "wte" in bundle["g"] else convert_biggan
        return {"clip": convert_clip(bundle["clip"]), "g": convert(bundle["g"]),
                "target": to_tensor(bundle["target"])}
    out = {
        "clip": convert_clip(bundle["clip"]),
        "g": convert_generator(bundle["g"]),
        "noise": convert_noise(bundle["noise"]),
        "target": to_tensor(bundle["target"]),
    }
    if bundle.get("d") is not None:
        out["d"] = convert_discriminator(bundle["d"])
    return out
