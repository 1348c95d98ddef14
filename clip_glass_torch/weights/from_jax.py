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
  list of per-layer dicts; the ResNet tower's attention pool gets its q/k/v
  projections joined into one [C, 3C] in-projection (what the JAX package
  concatenates on every call);
- BigGAN's batch norms keep their [n_stats, C] running statistics;
- GPT-2's Conv1D weights are [in, out] on both sides (nothing transposed),
  its blocks, stacked on a leading layer axis in JAX, become a list;
- the metric towers (LPIPS-VGG16, the FID InceptionV3) get OIHW convs;
  Inception keeps its eval-mode BN as the JAX tree has it, `bn_scale` and
  `bn_bias` applied in fp32 after the conv, not folded into the weights
  (which would round differently).

The port's own random init builds the same JAX-layout trees and passes them
through these converters, so the two structures cannot drift apart.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from clip_glass_torch.core.dtypes import tree_leaves
from clip_glass_torch.core.optim import AdamState


def to_tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        # a meta tensor (shapes alone, core.memory) stays where it is
        t = a.detach() if a.is_meta else a.detach().cpu()
    else:
        arr = np.asarray(a)
        if arr.dtype.name == "bfloat16":
            arr = arr.astype(np.float32)
        t = torch.from_numpy(np.array(arr))
    return t.float() if t.is_floating_point() else t


def to_numpy(x) -> np.ndarray:
    """A tensor or array of any float dtype -> fp32 numpy (fp16 widens
    exactly): how the checkpoint converters read a state dict's entries."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


def stack_layers(blocks):
    """List of per-layer numpy trees -> one tree stacked on a leading layer
    axis (the JAX layout; `_unstack` inverts it)."""
    if isinstance(blocks[0], dict):
        return {k: stack_layers([b[k] for b in blocks]) for k in blocks[0]}
    return np.stack(blocks)


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


def _affine(p) -> Dict[str, torch.Tensor]:
    return {"scale": to_tensor(p["scale"]), "bias": to_tensor(p["bias"])}


def _rn_convs(p) -> Dict[str, Any]:
    """A ResNet stem or bottleneck: OIHW convs beside their folded BNs."""
    out = {k: (_oihw(v) if k.startswith("conv") else _affine(v))
           for k, v in p.items() if k != "downsample"}
    if "downsample" in p:
        out["downsample"] = {"conv": _oihw(p["downsample"]["conv"]),
                             "bn": _affine(p["downsample"]["bn"])}
    return out


def _rn_visual(v) -> Dict[str, Any]:
    """The ModifiedResNet image tower."""
    out = {"stem": _rn_convs(v["stem"])}
    for li in range(1, 5):
        out[f"layer{li}"] = [_rn_convs(bp) for bp in v[f"layer{li}"]]
    ap = v["attnpool"]
    out["attnpool"] = {
        "positional_embedding": to_tensor(ap["positional_embedding"]),
        "in_proj_weight": torch.cat([to_tensor(ap[k]["w"]) for k in "qkv"], dim=1),
        "in_proj_bias": torch.cat([to_tensor(ap[k]["b"]) for k in "qkv"]),
        "out_proj_weight": to_tensor(ap["c"]["w"]),
        "out_proj_bias": to_tensor(ap["c"]["b"]),
    }
    return out


def _vit_visual(v) -> Dict[str, Any]:
    return {
        "patch_embed": {"weight": to_tensor(v["patch_embed"]["weight"])},
        "class_embedding": to_tensor(v["class_embedding"]),
        "positional_embedding": to_tensor(v["positional_embedding"]),
        "ln_pre": _affine(v["ln_pre"]),
        "blocks": _unstack(v["blocks"]),
        "ln_post": _affine(v["ln_post"]),
        "proj": to_tensor(v["proj"]),
    }


def convert_clip(tree) -> Dict[str, Any]:
    """CLIP: the image tower (ViT, or the ModifiedResNet, told apart by its
    stem) and the text tower."""
    v, t = tree["visual"], tree["text"]
    return {
        "visual": _rn_visual(v) if "stem" in v else _vit_visual(v),
        "text": {
            "token_embedding": to_tensor(t["token_embedding"]),
            "positional_embedding": to_tensor(t["positional_embedding"]),
            "blocks": _unstack(t["blocks"]),
            "ln_final": _affine(t["ln_final"]),
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


def convert_lpips(tree) -> Dict[str, Any]:
    """LPIPS-VGG16: the 13 convs keyed by torchvision layer index, and the
    5 per-slice linear heads (a list)."""
    return {"convs": {k: {"w": _oihw(p["w"]), "b": to_tensor(p["b"])}
                      for k, p in tree["convs"].items()},
            "heads": [to_tensor(h) for h in tree["heads"]]}


def _conv_bn(p) -> Dict[str, torch.Tensor]:
    return {"w": _oihw(p["w"]), "bn_scale": to_tensor(p["bn_scale"]),
            "bn_bias": to_tensor(p["bn_bias"])}


def convert_inception(tree) -> Dict[str, Any]:
    """The FID InceptionV3 trunk: each stem conv {w, bn_scale, bn_bias}, each
    Mixed block a dict of such branches."""
    return {name: (_conv_bn(sub) if "w" in sub else
                   {br: _conv_bn(p) for br, p in sub.items()})
            for name, sub in tree.items()}


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


def convert_train_state(g, d, gs, g_opt, d_opt, pl_avg, step) -> Dict[str, Any]:
    """A JAX `TrainState` carried across, as `Trainer.load_state`'s keyword
    arguments: G, D and Gs trees; each optimizer's Adam state as (count, mu,
    nu), mu and nu param-shaped trees (`state.g_opt[0].count`, `.mu`, `.nu`
    of the JAX package's `optax.adam`), which go through the parameters' own
    layout converters (HWIO -> OIHW, the ToRGB matrix) and are listed in the
    port's leaf order; pl_avg and step. Every leaf as numpy (or a tensor).
    The JAX PRNG key does not cross: the port's generator continues."""
    def adam(opt, convert):
        count, mu, nu = opt
        return AdamState(int(np.asarray(count)), tree_leaves(convert(mu)),
                         tree_leaves(convert(nu)))

    return {"g_params": convert_generator(g), "d_params": convert_discriminator(d),
            "gs_params": convert_generator(gs),
            "g_opt": adam(g_opt, convert_generator), "d_opt": adam(d_opt, convert_discriminator),
            "pl_avg": to_tensor(pl_avg), "step": int(np.asarray(step))}
