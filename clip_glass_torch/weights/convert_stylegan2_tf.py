"""NVIDIA StyleGAN2 TF checkpoint (.pkl) -> the JAX-layout numpy trees.

What the reference's `python -m stylegan2.convert_from_tf` does
(reference stylegan2/convert_from_tf.py:41-303, download-weights.sh:16-22),
mapping the TF variables straight to the tree instead of through torch
modules, with the JAX package's converter's numpy operations in its order:

- TF conv weights are HWIO, the tree's layout (no permutes); the fused
  up-conv kernels get the spatial flip of convert_from_tf.py:184-185;
- `mod_bias + 1` (convert_from_tf.py:182/226): TF applies the style bias's
  +1 at run time, the tree holds it in the bias;
- the equalized-lr coefficients are folded in;
- the per-layer noise planes (`noise0..n`) are captured.

The pickle is read with class stubs for dnnlib/tflib
(convert_from_tf.py:41-45), so neither TensorFlow nor dnnlib is needed.
"""

from __future__ import annotations

import math
import pickle
import re
from typing import Dict, List, Tuple

import numpy as np

from clip_glass_torch.models.stylegan2.model import SG2Config


class TFNetworkStub:
    """Stand-in for dnnlib.tflib.network.Network: keeps the pickled state."""

    def __setstate__(self, state):
        self.__dict__.update(state)


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if "dnnlib" in module:
            return TFNetworkStub
        return super().find_class(module, name)


def load_tf_pickle(path: str):
    """-> the (G, D, Gs) TFNetworkStub triple NVIDIA's pickles hold."""
    with open(path, "rb") as f:
        return _Unpickler(f).load()


def _he(shape_fan_in: int, lr_mul: float = 1.0, gain: float = 1.0) -> float:
    return gain / math.sqrt(shape_fan_in) * lr_mul


def _group_by_size(variables) -> Tuple[Dict, Dict]:
    """Split the variables into {resolution: {local name: array}} and the
    top-level ones."""
    by_size: Dict[int, Dict[str, np.ndarray]] = {}
    top: Dict[str, np.ndarray] = {}
    for name, var in variables:
        m = re.match(r"(\d+)x\d+/(.*)", name)
        if m:
            by_size.setdefault(int(m.group(1)), {})[m.group(2)] = np.asarray(var)
        else:
            top[name] = np.asarray(var)
    return by_size, top


def _style(mod_weight: np.ndarray, mod_bias: np.ndarray, latent: int):
    return {"w": mod_weight.astype(np.float32) * _he(latent),
            "b": mod_bias.astype(np.float32) + 1.0}


def _conv_w(w: np.ndarray, flip: bool = False) -> np.ndarray:
    w = w.astype(np.float32)
    w = w * _he(int(np.prod(w.shape[:-1])))  # fan-in kh*kw*I
    if flip:
        w = w[::-1, ::-1]
    return np.ascontiguousarray(w)


def convert_synthesis_tf(variables, latent_size: int = None) -> Tuple[dict, SG2Config, List]:
    by_size, _ = _group_by_size(variables)
    sizes = sorted(by_size)
    latent = latent_size or by_size[4]["Conv/mod_weight"].shape[0]
    channels = [int(by_size[size]["Conv/bias" if size == 4 else "Conv1/bias"].shape[0])
                for size in sizes[::-1]]
    cfg = SG2Config(latent_size=latent, channels=tuple(channels))

    params = {"const": np.transpose(by_size[4]["Const/const"].squeeze(0),
                                    (1, 2, 0)).astype(np.float32),
              "blocks": [], "to_rgb": []}
    named = dict(variables)
    noises = [np.asarray(named[name]).squeeze().astype(np.float32)
              for name in sorted((n for n, _ in variables if re.fullmatch(r"noise\d+", n)),
                                 key=lambda n: int(n[5:]))]

    def layer(v, prefix, flip):
        return {"w": _conv_w(v[f"{prefix}/weight"], flip=flip),
                "b": v[f"{prefix}/bias"].astype(np.float32),
                "style": _style(v[f"{prefix}/mod_weight"], v[f"{prefix}/mod_bias"], latent),
                "noise_scale": np.asarray(np.float32(v[f"{prefix}/noise_strength"]))}

    for size in sizes:
        v = by_size[size]
        if size == 4:
            params["blocks"].append({"layers": [layer(v, "Conv", False)]})
        else:
            params["blocks"].append({"layers": [layer(v, "Conv0_up", True),
                                                layer(v, "Conv1", False)]})
        params["to_rgb"].append({
            "w": _conv_w(v["ToRGB/weight"]),
            "b": v["ToRGB/bias"].astype(np.float32),
            "style": _style(v["ToRGB/mod_weight"], v["ToRGB/mod_bias"], latent)})
    return params, cfg, noises


def convert_mapping_tf(variables, cfg: SG2Config) -> dict:
    v = dict(variables)
    n = sum(1 for name in v if re.fullmatch(r"Dense\d+/weight", name))
    dense = []
    for i in range(n):
        w = v[f"Dense{i}/weight"].astype(np.float32)   # [in, out]
        dense.append({"w": w * _he(w.shape[0], cfg.mapping_lr_mul),
                      "b": v[f"Dense{i}/bias"].astype(np.float32) * cfg.mapping_lr_mul})
    return {"dense": dense}


def convert_generator_tf(g_state) -> Tuple[dict, SG2Config, List]:
    """The G_main network -> (tree, cfg, noise planes)."""
    syn = g_state.components["synthesis"]
    mapping = g_state.components["mapping"]
    syn_params, cfg, noises = convert_synthesis_tf(syn.variables)
    n_map = sum(1 for name, _ in mapping.variables if re.fullmatch(r"Dense\d+/weight", name))
    cfg = SG2Config(**{**cfg.__dict__, "mapping_layers": n_map})
    params = {"mapping": convert_mapping_tf(mapping.variables, cfg),
              "synthesis": syn_params,
              "dlatent_avg": dict(g_state.variables)["dlatent_avg"].astype(np.float32)}
    return params, cfg, noises


def convert_discriminator_tf(d_state) -> Tuple[dict, SG2Config]:
    by_size, top = _group_by_size(d_state.variables)
    sizes = sorted(by_size, reverse=True)  # the first block is the highest resolution
    channels = [int(by_size[size]["Conv/bias" if size == 4 else "Conv0/bias"].shape[0])
                for size in sizes]
    mbstd = (int(d_state.static_kwargs.get("mbstd_group_size", 4))
             if hasattr(d_state, "static_kwargs") else 4)
    cfg = SG2Config(channels=tuple(channels), mbstd_group_size=mbstd)

    top_v = by_size[sizes[0]]
    params = {"from_rgb": {"w": _conv_w(top_v["FromRGB/weight"]),
                           "b": top_v["FromRGB/bias"].astype(np.float32)},
              "blocks": []}
    for size in sizes[:-1]:
        v = by_size[size]
        params["blocks"].append({
            "conv0": {"w": _conv_w(v["Conv0/weight"]), "b": v["Conv0/bias"].astype(np.float32)},
            "conv1": {"w": _conv_w(v["Conv1_down/weight"]),
                      "b": v["Conv1_down/bias"].astype(np.float32)},
            "skip": {"w": _conv_w(v["Skip/weight"])},
        })
    v4 = by_size[4]
    params["final_conv"] = {"w": _conv_w(v4["Conv/weight"]),
                            "b": v4["Conv/bias"].astype(np.float32)}
    # NVIDIA's D flattens NCHW features before Dense0, as the forward does
    d0w = v4["Dense0/weight"].astype(np.float32)     # [in, out]
    params["dense0"] = {"w": d0w * _he(d0w.shape[0]),
                        "b": v4["Dense0/bias"].astype(np.float32)}
    ow = top["Output/weight"].astype(np.float32)
    params["dense1"] = {"w": ow * _he(ow.shape[0]),
                        "b": top["Output/bias"].astype(np.float32)}
    return params, cfg


def convert_pkl(path: str):
    """{"G": (tree, cfg, noise planes), "D": (tree, cfg), "Gs": (tree, cfg,
    noise planes)}, each for the networks the pickle holds."""
    nets = load_tf_pickle(path)
    G, D, Gs = nets if isinstance(nets, tuple) else (nets, None, None)
    out = {}
    if G is not None:
        out["G"] = convert_generator_tf(G)
    if D is not None:
        out["D"] = convert_discriminator_tf(D)
    if Gs is not None:
        out["Gs"] = convert_generator_tf(Gs)
    return out
