"""StyleGAN2 torch checkpoint -> the JAX-layout numpy tree.

Reads the reference's own serialization, `{name, kwargs, state_dict}` with
the `G_mapping` / `G_synthesis` states nested for a Generator (reference
stylegan2/models.py:111-209): the `Gs.pth` / `G.pth` / `D.pth` files that
`python -m stylegan2.convert_from_tf` writes (reference
download-weights.sh:16-22).

The equalized-lr runtime coefficients (he_std * lr_mul,
stylegan2/modules.py:87-118) are folded into the arrays; conv kernels go
[O, I, kh, kw] -> [kh, kw, I, O] and dense weights [out, in] -> [in, out].
The numpy operations are the JAX package's converter's, in its order, so
both give the same bits; `weights.from_jax` takes the tree to the port's
layout.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np

from clip_glass_torch.models.stylegan2.model import SG2Config
from clip_glass_torch.weights.from_jax import to_numpy as _np


def _dense(sd, prefix, in_f, lr_mul=1.0, gain=1.0):
    coef = gain / math.sqrt(in_f) * lr_mul
    w = _np(sd[f"{prefix}.layer.weight"]).T * coef      # [in, out]
    b = _np(sd[f"{prefix}.bias"]) * lr_mul
    return {"w": w, "b": b}


def _conv_w(sd, key, lr_mul=1.0, gain=1.0):
    w = _np(sd[key])                                    # [O, I, kh, kw]
    fan_in = int(np.prod(w.shape[1:]))
    coef = gain / math.sqrt(fan_in) * lr_mul
    return np.transpose(w * coef, (2, 3, 1, 0))         # [kh, kw, I, O]


def convert_mapping(sd: Dict, cfg: SG2Config, prefix: str = ""):
    params = {"dense": []}
    in_f = cfg.latent_size * (2 if cfg.label_size else 1)
    for i in range(cfg.mapping_layers):
        params["dense"].append(_dense(sd, f"{prefix}main.{i}", in_f, cfg.mapping_lr_mul))
        in_f = cfg.latent_size
    if cfg.label_size:
        params["embedding"] = _np(sd[f"{prefix}embedding.weight"])
    return params


def convert_synthesis(sd: Dict, cfg: SG2Config, prefix: str = ""):
    params = {"const": np.transpose(_np(sd[f"{prefix}const"]), (1, 2, 0)),
              "blocks": [], "to_rgb": []}
    for bi, (_, _, _, n_layers) in enumerate(cfg.block_channels()):
        layers = []
        for li in range(n_layers):
            p = f"{prefix}conv_blocks.{bi}.conv_block.{li}"
            # the style dense: ConvLayer.dense, bias_init=1 (reference
            # stylegan2/modules.py:874-890)
            lp = {"w": _conv_w(sd, f"{p}.layer.layer.weight"),
                  "b": _np(sd[f"{p}.bias"]),
                  "style": _dense(sd, f"{p}.layer.layer.dense", cfg.latent_size)}
            if cfg.noise:
                lp["noise_scale"] = _np(sd[f"{p}.layer.weight"]).reshape(())
            layers.append(lp)
        params["blocks"].append({"layers": layers})
        p = f"{prefix}to_data_layers.{bi}"
        rp = {"w": _conv_w(sd, f"{p}.layer.weight"), "b": _np(sd[f"{p}.bias"])}
        if cfg.modulate_data_out:
            rp["style"] = _dense(sd, f"{p}.layer.dense", cfg.latent_size)
        params["to_rgb"].append(rp)
    return params


def convert_generator(sd: Dict, cfg: SG2Config):
    """Flat Generator state dict (G_mapping.* / G_synthesis.* / dlatent_avg)
    -> tree."""
    return {"mapping": convert_mapping(sd, cfg, "G_mapping."),
            "synthesis": convert_synthesis(sd, cfg, "G_synthesis."),
            "dlatent_avg": _np(sd["dlatent_avg"])}


def convert_discriminator(sd: Dict, cfg: SG2Config):
    ch = list(cfg.channels)
    n = len(ch)
    params = {"from_rgb": {"w": _conv_w(sd, "from_data_layers.0.layer.weight"),
                           "b": _np(sd["from_data_layers.0.bias"])},
              "blocks": []}
    for i in range(n - 1):
        p = f"conv_blocks.{i}"
        params["blocks"].append({
            "conv0": {"w": _conv_w(sd, f"{p}.conv_block.0.layer.weight"),
                      "b": _np(sd[f"{p}.conv_block.0.bias"])},
            "conv1": {"w": _conv_w(sd, f"{p}.conv_block.1.layer.weight"),
                      "b": _np(sd[f"{p}.conv_block.1.bias"])},
            "skip": {"w": _conv_w(sd, f"{p}.projection.weight")},
        })
    fp = f"conv_blocks.{n - 1}.1.conv_block.0"
    params["final_conv"] = {"w": _conv_w(sd, f"{fp}.layer.weight"), "b": _np(sd[f"{fp}.bias"])}
    params["dense0"] = _dense(sd, "dense.0", ch[-1] * cfg.base_size ** 2)
    params["dense1"] = _dense(sd, "dense.1", ch[-1])
    return params


def config_from_kwargs(kwargs: Dict, mapping_kwargs: Dict = None) -> SG2Config:
    """The reference model kwargs stored in the .pth -> SG2Config."""
    channels = kwargs.get("channels", 9)
    if isinstance(channels, int):
        num = channels
        channels = [min(32 * 2 ** i, 512) for i in range(min(8, num))]
        if len(channels) < num:
            channels = [32] * (num - len(channels)) + channels
    base_shape = kwargs.get("base_shape", (4, 4))
    mk = mapping_kwargs or {}
    return SG2Config(
        latent_size=kwargs.get("latent_size", 512),
        label_size=kwargs.get("label_size", 0),
        mapping_layers=mk.get("num_layers", 8),
        mapping_lr_mul=mk.get("lr_mul", 0.01),
        channels=tuple(channels),
        base_size=base_shape[0],
        data_channels=kwargs.get("data_channels", 3),
        conv_block_size=kwargs.get("conv_block_size", 2),
        kernel_size=kwargs.get("kernel_size", 3),
        filter_taps=tuple(kwargs.get("conv_filter", (1, 3, 3, 1))),
        mbstd_group_size=kwargs.get("mbstd_group_size", 4),
        demodulate=kwargs.get("demodulate", True),
        modulate_data_out=kwargs.get("modulate_data_out", True),
        noise=kwargs.get("noise", True),
    )


def load_pth(path: str):
    """(tree, cfg, kind) of a reference-format .pth; kind is 'G' or 'D'."""
    import torch

    state = torch.load(path, map_location="cpu", weights_only=False)
    name = state["name"]
    if name == "Generator":
        g_map, g_syn = state["G_mapping"], state["G_synthesis"]
        cfg = config_from_kwargs(g_syn["kwargs"], g_map["kwargs"])
        sd = {f"G_mapping.{k}": v for k, v in g_map["state_dict"].items()}
        sd.update({f"G_synthesis.{k}": v for k, v in g_syn["state_dict"].items()})
        sd.update(state["state_dict"])
        return convert_generator(sd, cfg), cfg, "G"
    if name == "Discriminator":
        cfg = config_from_kwargs(state["kwargs"])
        return convert_discriminator(state["state_dict"], cfg), cfg, "D"
    raise ValueError(f"{path}: unsupported checkpoint kind {name!r}")
