"""GPT-2 torch checkpoint -> the JAX-layout numpy tree.

Reads the legacy `gpt2-pytorch_model.bin` the reference loads (keys with
`.g/.b/.w` suffixes and/or `module.` / `transformer.` prefixes: the renames
of reference gpt2/utils.py:10-52). Conv1D weights are already [in, out];
the per-layer blocks are stacked on a leading layer axis, as in the JAX
package's converter, whose numpy operations this follows one for one, so
both give the same bits. `weights.from_jax.convert_gpt2` takes the tree to
the port's layout.
"""

from __future__ import annotations

from typing import Dict

from clip_glass_torch.models.gpt2.model import GPT2Config
from clip_glass_torch.weights.from_jax import stack_layers
from clip_glass_torch.weights.from_jax import to_numpy as _np


def normalize_keys(sd: Dict) -> Dict:
    """The reference's key renames (gpt2/utils.py:12-28)."""
    out = {}
    for k, v in sd.items():
        if k.startswith("module."):
            k = k[len("module."):]
        if k.startswith("transformer."):
            k = k[len("transformer."):]
        if k.endswith(".g"):
            k = k[:-2] + ".weight"
        elif k.endswith(".b"):
            k = k[:-2] + ".bias"
        elif k.endswith(".w"):
            k = k[:-2] + ".weight"
        out[k] = v
    return out


def infer_config(sd: Dict) -> GPT2Config:
    """The geometry from the shapes; the head count is not in them, so it is
    12 for the 768-wide model and a head width of 64 otherwise."""
    n_layer = len({k.split(".")[1] for k in sd if k.startswith("h.")})
    vocab, d = _np(sd["wte.weight"]).shape
    n_pos = _np(sd["wpe.weight"]).shape[0]
    return GPT2Config(vocab_size=vocab, n_positions=n_pos, n_embd=d,
                      n_layer=n_layer, n_head=12 if d == 768 else max(2, d // 64))


def convert(sd: Dict, cfg: GPT2Config = None):
    """State dict -> (tree, cfg)."""
    sd = normalize_keys(sd)
    cfg = cfg or infer_config(sd)

    def block(i):
        p = f"h.{i}"

        def w(key):
            # a Conv1D .w may be stored [1, in, out]
            a = _np(sd[key])
            return a.reshape(a.shape[-2], a.shape[-1])

        return {
            "ln_1": {"g": _np(sd[f"{p}.ln_1.weight"]), "b": _np(sd[f"{p}.ln_1.bias"])},
            "attn": {
                "c_attn_w": w(f"{p}.attn.c_attn.weight"),
                "c_attn_b": _np(sd[f"{p}.attn.c_attn.bias"]),
                "c_proj_w": w(f"{p}.attn.c_proj.weight"),
                "c_proj_b": _np(sd[f"{p}.attn.c_proj.bias"]),
            },
            "ln_2": {"g": _np(sd[f"{p}.ln_2.weight"]), "b": _np(sd[f"{p}.ln_2.bias"])},
            "mlp": {
                "c_fc_w": w(f"{p}.mlp.c_fc.weight"),
                "c_fc_b": _np(sd[f"{p}.mlp.c_fc.bias"]),
                "c_proj_w": w(f"{p}.mlp.c_proj.weight"),
                "c_proj_b": _np(sd[f"{p}.mlp.c_proj.bias"]),
            },
        }

    tree = {
        "wte": _np(sd["wte.weight"]),
        "wpe": _np(sd["wpe.weight"]),
        "blocks": stack_layers([block(i) for i in range(cfg.n_layer)]),
        "ln_f": {"g": _np(sd["ln_f.weight"]), "b": _np(sd["ln_f.bias"])},
    }
    return tree, cfg


def load_torch_checkpoint(path: str):
    """(tree, cfg) of a `.bin` (a pickled state dict)."""
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=False)
    return convert(sd)
