"""Reference-format checkpoints with random weights, from a seed.

Writes the on-disk layouts that the reference and the official sources
publish, at any geometry, with torch and numpy only, so that every loader
of `weights/` can be exercised where no published checkpoint is at hand:

- StyleGAN2's `Gs.pth` / `G.pth` / `D.pth` in the reference's
  `{name, kwargs, state_dict}` format, the Generator's `G_mapping` /
  `G_synthesis` nested (reference stylegan2/models.py:111-209), with the
  kwargs `convert_stylegan2.config_from_kwargs` reads;
- NVIDIA's TF pickle of a (G, D, Gs) dnnlib Network triple (reference
  convert_from_tf.py:48-76);
- OpenAI CLIP's `.pt` of either tower family (ViT, ModifiedResNet) in the
  state-dict layout of reference clip/model.py:363-399, as a TorchScript
  archive (as the official files are) or a pickled state dict, fp16 (as
  the official files are) or fp32;
- the `pytorch_pretrained_biggan` `pytorch_model.bin`: spectral-norm
  `weight_orig` / `weight_u` / `weight_v` triplets (u and v settled by power
  iteration, as a trained checkpoint's are) and [n_stats, C] running
  statistics;
- GPT-2's legacy `.bin`: `.g/.b/.w` suffixes, 2-D Conv1D weights
  (reference gpt2/utils.py:10-52);
- the metric towers' files: torchvision's vgg16 zoo state dict and the
  richzhang LPIPS v0.1 linear heads (reference external_models/lpips.py:
  36-56), at channels / div, and pytorch-fid's pt_inception state dict at
  its real geometry (reference external_models/inception.py:27).

`write_all` writes the whole set at the published geometries (about 2.4 GB):

    python -m clip_glass_torch.weights.synthesize OUT_DIR [--seed N]

Weights are drawn so that the models stay well conditioned (He-scaled
weights, BatchNorm gains near 1, positive running variances); they are not
trained and carry no meaning.
"""

from __future__ import annotations

import argparse
import math
import os
import pickle
import sys
import types
from typing import Dict

import numpy as np
import torch

from clip_glass_torch.models.biggan import model as bg
from clip_glass_torch.models.clip import model as clip_model
from clip_glass_torch.models.stylegan2 import model as sg2

# ------------------------------------------------------------- StyleGAN2


def stylegan2_generator_state(cfg: sg2.SG2Config, seed: int = 0) -> dict:
    """A Generator `.pth` state: raw equalized-lr weights (N(0, 1), the
    mapping's N(0, 1 / lr_mul)), style biases near 1 (bias_init=1), other
    biases, noise strengths and dlatent_avg small."""
    rng = np.random.default_rng(seed)

    def r(*shape, std=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * std).astype(np.float32))

    mapping = {}
    in_f = cfg.latent_size
    for i in range(cfg.mapping_layers):
        mapping[f"main.{i}.layer.weight"] = r(cfg.latent_size, in_f, std=1 / cfg.mapping_lr_mul)
        mapping[f"main.{i}.bias"] = r(cfg.latent_size, std=0.1 / cfg.mapping_lr_mul)
    k = cfg.kernel_size
    syn = {"const": r(cfg.channels[-1], cfg.base_size, cfg.base_size)}
    for bi, (in_ch, out_ch, _, n_layers) in enumerate(cfg.block_channels()):
        c_in = in_ch
        for li in range(n_layers):
            p = f"conv_blocks.{bi}.conv_block.{li}"
            syn[f"{p}.layer.layer.weight"] = r(out_ch, c_in, k, k)
            syn[f"{p}.bias"] = r(out_ch, std=0.1)
            syn[f"{p}.layer.layer.dense.layer.weight"] = r(c_in, cfg.latent_size)
            syn[f"{p}.layer.layer.dense.bias"] = 1.0 + r(c_in, std=0.1)
            if cfg.noise:
                syn[f"{p}.layer.weight"] = r(1, std=0.1)
            c_in = out_ch
        p = f"to_data_layers.{bi}"
        syn[f"{p}.layer.weight"] = r(cfg.data_channels, out_ch, 1, 1)
        syn[f"{p}.bias"] = r(cfg.data_channels, std=0.1)
        if cfg.modulate_data_out:
            syn[f"{p}.layer.dense.layer.weight"] = r(out_ch, cfg.latent_size)
            syn[f"{p}.layer.dense.bias"] = 1.0 + r(out_ch, std=0.1)
    mapping_kwargs = {"latent_size": cfg.latent_size, "num_layers": cfg.mapping_layers,
                      "lr_mul": cfg.mapping_lr_mul}
    synthesis_kwargs = {"latent_size": cfg.latent_size, "channels": list(cfg.channels),
                        "base_shape": (cfg.base_size, cfg.base_size),
                        "data_channels": cfg.data_channels,
                        "conv_block_size": cfg.conv_block_size,
                        "kernel_size": cfg.kernel_size, "conv_filter": list(cfg.filter_taps),
                        "demodulate": cfg.demodulate,
                        "modulate_data_out": cfg.modulate_data_out, "noise": cfg.noise}
    return {"name": "Generator", "kwargs": {},
            "state_dict": {"dlatent_avg": r(cfg.latent_size, std=0.1)},
            "G_mapping": {"name": "GeneratorMapping", "kwargs": mapping_kwargs,
                          "state_dict": mapping},
            "G_synthesis": {"name": "GeneratorSynthesis", "kwargs": synthesis_kwargs,
                            "state_dict": syn}}


def stylegan2_discriminator_state(cfg: sg2.SG2Config, seed: int = 0) -> dict:
    """A Discriminator `.pth` state (resnet architecture)."""
    rng = np.random.default_rng(seed)

    def r(*shape, std=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * std).astype(np.float32))

    ch, k = list(cfg.channels), cfg.kernel_size
    sd = {"from_data_layers.0.layer.weight": r(ch[0], cfg.data_channels, 1, 1),
          "from_data_layers.0.bias": r(ch[0], std=0.1)}
    for i in range(len(ch) - 1):
        p = f"conv_blocks.{i}"
        sd[f"{p}.conv_block.0.layer.weight"] = r(ch[i], ch[i], k, k)
        sd[f"{p}.conv_block.0.bias"] = r(ch[i], std=0.1)
        sd[f"{p}.conv_block.1.layer.weight"] = r(ch[i + 1], ch[i], k, k)
        sd[f"{p}.conv_block.1.bias"] = r(ch[i + 1], std=0.1)
        sd[f"{p}.projection.weight"] = r(ch[i + 1], ch[i], 1, 1)
    p = f"conv_blocks.{len(ch) - 1}.1.conv_block.0"
    sd[f"{p}.layer.weight"] = r(ch[-1], ch[-1] + (1 if cfg.mbstd_group_size else 0), k, k)
    sd[f"{p}.bias"] = r(ch[-1], std=0.1)
    sd["dense.0.layer.weight"] = r(ch[-1], ch[-1] * cfg.base_size ** 2)
    sd["dense.0.bias"] = r(ch[-1], std=0.1)
    sd["dense.1.layer.weight"] = r(max(1, cfg.label_size), ch[-1])
    sd["dense.1.bias"] = r(max(1, cfg.label_size), std=0.1)
    kwargs = {"channels": ch, "base_shape": (cfg.base_size, cfg.base_size),
              "data_channels": cfg.data_channels, "kernel_size": k,
              "conv_filter": list(cfg.filter_taps), "mbstd_group_size": cfg.mbstd_group_size}
    return {"name": "Discriminator", "kwargs": kwargs, "state_dict": sd}


def write_stylegan2_pth(root: str, cfg: sg2.SG2Config = sg2.CONFIG_F, seed: int = 0) -> Dict:
    """`Gs.pth`, `G.pth` and `D.pth` under `root` (seeds seed, seed + 1,
    seed + 2); returns {stem: path}."""
    os.makedirs(root, exist_ok=True)
    states = {"Gs": stylegan2_generator_state(cfg, seed),
              "G": stylegan2_generator_state(cfg, seed + 1),
              "D": stylegan2_discriminator_state(cfg, seed + 2)}
    paths = {}
    for stem, state in states.items():
        paths[stem] = os.path.join(root, f"{stem}.pth")
        torch.save(state, paths[stem])
    return paths


def _dnnlib_network_cls():
    """A class pickled under the path dnnlib.tflib.network.Network, so the
    pickle loads through the converters' stub unpicklers and through
    dnnlib itself."""
    mod = sys.modules.get("dnnlib.tflib.network")
    if mod is None or not hasattr(mod, "Network"):
        mod = types.ModuleType("dnnlib.tflib.network")
        network = type("Network", (), {})
        network.__module__ = "dnnlib.tflib.network"
        network.__qualname__ = "Network"
        mod.Network = network
        sys.modules.setdefault("dnnlib", types.ModuleType("dnnlib"))
        sys.modules.setdefault("dnnlib.tflib", types.ModuleType("dnnlib.tflib"))
        sys.modules["dnnlib.tflib"].network = mod
        sys.modules["dnnlib.tflib.network"] = mod
    return mod.Network


def _net(network, build_func_name, variables, static_kwargs=None, components=None):
    obj = network()
    obj.__dict__.update({"build_func_name": build_func_name, "variables": variables,
                         "static_kwargs": static_kwargs or {},
                         "components": components or {}})
    return obj


def write_stylegan2_pkl(dest: str, latent: int = 32, channels=(16, 24), seed: int = 0,
                        mapping_layers: int = 2) -> None:
    """NVIDIA's (G, D, Gs) triple in the TF variable naming: synthesis
    Const/Conv/Conv0_up/Conv1/ToRGB (+ mod_*, noise_strength, noiseN),
    mapping DenseN, discriminator FromRGB/Conv0/Conv1_down/Skip, the 4x4
    Conv/Dense0 and Output (what reference convert_from_tf.py:73-303
    reads). `channels` runs from the lowest resolution up."""
    rng = np.random.default_rng(seed)

    def r(*shape):
        return rng.normal(0, 0.5, shape).astype(np.float32)

    def conv_vars(prefix, kh, i, o, noise=True):
        v = [(f"{prefix}/weight", r(kh, kh, i, o)), (f"{prefix}/bias", r(o)),
             (f"{prefix}/mod_weight", r(latent, i)), (f"{prefix}/mod_bias", r(i))]
        if noise:
            v.append((f"{prefix}/noise_strength", np.float32(rng.normal(0, 0.3))))
        return v

    network = _dnnlib_network_cls()

    def make_g():
        c = list(channels)
        syn = [("4x4/Const/const", r(1, c[0], 4, 4))]
        syn += conv_vars("4x4/Conv", 3, c[0], c[0])
        syn += conv_vars("4x4/ToRGB", 1, c[0], 3, noise=False)
        res = 4
        for bi in range(1, len(c)):
            res *= 2
            syn += conv_vars(f"{res}x{res}/Conv0_up", 3, c[bi - 1], c[bi])
            syn += conv_vars(f"{res}x{res}/Conv1", 3, c[bi], c[bi])
            syn += conv_vars(f"{res}x{res}/ToRGB", 1, c[bi], 3, noise=False)
        syn.append(("noise0", r(1, 1, 4, 4)))
        res, k = 4, 1
        for _ in range(1, len(c)):
            res *= 2
            syn.append((f"noise{k}", r(1, 1, res, res)))
            syn.append((f"noise{k + 1}", r(1, 1, res, res)))
            k += 2
        mapping = []
        for i in range(mapping_layers):
            mapping += [(f"Dense{i}/weight", r(latent, latent)), (f"Dense{i}/bias", r(latent))]
        return _net(network, "G_main", [("dlatent_avg", r(latent))],
                    static_kwargs={"truncation_psi": 0.5},
                    components={"mapping": _net(network, "G_mapping", mapping),
                                "synthesis": _net(network, "G_synthesis_stylegan2", syn)})

    def make_d():
        c = list(channels)[::-1]  # the highest resolution first
        res = 4 * 2 ** (len(c) - 1)
        d_vars = [(f"{res}x{res}/FromRGB/weight", r(1, 1, 3, c[0])),
                  (f"{res}x{res}/FromRGB/bias", r(c[0]))]
        for bi in range(len(c) - 1):
            d_vars += [(f"{res}x{res}/Conv0/weight", r(3, 3, c[bi], c[bi])),
                       (f"{res}x{res}/Conv0/bias", r(c[bi])),
                       (f"{res}x{res}/Conv1_down/weight", r(3, 3, c[bi], c[bi + 1])),
                       (f"{res}x{res}/Conv1_down/bias", r(c[bi + 1])),
                       (f"{res}x{res}/Skip/weight", r(1, 1, c[bi], c[bi + 1]))]
            res //= 2
        cl = c[-1]
        d_vars += [("4x4/Conv/weight", r(3, 3, cl + 1, cl)), ("4x4/Conv/bias", r(cl)),
                   ("4x4/Dense0/weight", r(cl * 16, cl)), ("4x4/Dense0/bias", r(cl)),
                   ("Output/weight", r(cl, 1)), ("Output/bias", r(1))]
        return _net(network, "D_stylegan2", d_vars, static_kwargs={"mbstd_group_size": 4})

    os.makedirs(os.path.dirname(os.path.abspath(dest)), exist_ok=True)
    with open(dest, "wb") as f:
        pickle.dump((make_g(), make_d(), make_g()), f)


# ------------------------------------------------------------------ CLIP

class _Holder(torch.nn.Module):
    """A node of the module tree that carries a state dict's buffers."""

    def forward(self):
        return torch.zeros(1)


def _holder_tree(sd: Dict[str, torch.Tensor]) -> torch.nn.Module:
    root = _Holder()
    for key, val in sd.items():
        *path, leaf = key.split(".")
        mod = root
        for p in path:
            if p not in mod._modules:
                mod.add_module(p, _Holder())
            mod = mod._modules[p]
        mod.register_buffer(leaf, val)
    return root


def _clip_block(sd, prefix, w, r, ln):
    sd[f"{prefix}.attn.in_proj_weight"] = r(3 * w, w)
    sd[f"{prefix}.attn.in_proj_bias"] = r(3 * w, std=0.02)
    sd[f"{prefix}.attn.out_proj.weight"] = r(w, w)
    sd[f"{prefix}.attn.out_proj.bias"] = r(w, std=0.02)
    ln(f"{prefix}.ln_1", w)
    sd[f"{prefix}.mlp.c_fc.weight"] = r(4 * w, w)
    sd[f"{prefix}.mlp.c_fc.bias"] = r(4 * w, std=0.02)
    sd[f"{prefix}.mlp.c_proj.weight"] = r(w, 4 * w)
    sd[f"{prefix}.mlp.c_proj.bias"] = r(w, std=0.02)
    ln(f"{prefix}.ln_2", w)


def clip_state_dict(cfg: clip_model.CLIPConfig, seed: int = 0) -> Dict[str, torch.Tensor]:
    """An OpenAI CLIP state dict (fp32) of `cfg`'s geometry and tower
    family, with the archives' scalar entries. The text tower's head count
    is not stored: the loaders infer width / 64, as the reference does."""
    g = torch.Generator().manual_seed(seed)

    def r(*shape, std=None):
        t = torch.randn(shape, generator=g)
        # weights He-scaled by their last axis (the fan-in); vectors by std
        return t * (std if std is not None else shape[-1] ** -0.5)

    sd: Dict[str, torch.Tensor] = {}

    def ln(prefix, ch):
        sd[f"{prefix}.weight"] = 1.0 + r(ch, std=0.1)
        sd[f"{prefix}.bias"] = r(ch, std=0.1)

    def bn(prefix, ch):
        ln(prefix, ch)
        sd[f"{prefix}.running_mean"] = r(ch, std=0.1)
        sd[f"{prefix}.running_var"] = 0.5 + torch.rand(ch, generator=g)

    tw = cfg.transformer_width
    sd["positional_embedding"] = r(cfg.context_length, tw, std=0.01)
    sd["text_projection"] = r(tw, cfg.embed_dim, std=tw ** -0.5)
    sd["logit_scale"] = torch.tensor(math.log(1 / 0.07))
    w = cfg.vision_width
    if cfg.vision_kind == "rn":
        def conv(key, o, i, k):
            sd[key] = torch.randn((o, i, k, k), generator=g) * (i * k * k) ** -0.5

        conv("visual.conv1.weight", w // 2, 3, 3)
        bn("visual.bn1", w // 2)
        conv("visual.conv2.weight", w // 2, w // 2, 3)
        bn("visual.bn2", w // 2)
        conv("visual.conv3.weight", w, w // 2, 3)
        bn("visual.bn3", w)
        inplanes = w
        for li, blocks in enumerate(cfg.vision_layers):
            planes = w * 2 ** li
            for b in range(blocks):
                p = f"visual.layer{li + 1}.{b}"
                conv(f"{p}.conv1.weight", planes, inplanes, 1)
                bn(f"{p}.bn1", planes)
                conv(f"{p}.conv2.weight", planes, planes, 3)
                bn(f"{p}.bn2", planes)
                conv(f"{p}.conv3.weight", planes * 4, planes, 1)
                bn(f"{p}.bn3", planes * 4)
                if b == 0 and (li > 0 or inplanes != planes * 4):
                    conv(f"{p}.downsample.0.weight", planes * 4, inplanes, 1)
                    bn(f"{p}.downsample.1", planes * 4)
                inplanes = planes * 4
        ed, spacial = w * 32, cfg.image_resolution // 32
        sd["visual.attnpool.positional_embedding"] = r(spacial ** 2 + 1, ed, std=ed ** -0.5)
        for name, out in (("k_proj", ed), ("q_proj", ed), ("v_proj", ed),
                          ("c_proj", cfg.embed_dim)):
            sd[f"visual.attnpool.{name}.weight"] = r(out, ed)
            sd[f"visual.attnpool.{name}.bias"] = r(out, std=0.02)
    else:
        P = cfg.vision_patch_size
        sd["visual.class_embedding"] = r(w, std=w ** -0.5)
        sd["visual.positional_embedding"] = r(cfg.grid ** 2 + 1, w, std=w ** -0.5)
        sd["visual.proj"] = r(w, cfg.embed_dim, std=w ** -0.5)
        sd["visual.conv1.weight"] = r(w, 3, P, P, std=(3 * P * P) ** -0.5)
        ln("visual.ln_pre", w)
        for i in range(cfg.vision_layers):
            _clip_block(sd, f"visual.transformer.resblocks.{i}", w, r, ln)
        ln("visual.ln_post", w)
    for i in range(cfg.transformer_layers):
        _clip_block(sd, f"transformer.resblocks.{i}", tw, r, ln)
    sd["token_embedding.weight"] = r(cfg.vocab_size, tw, std=0.02)
    ln("ln_final", tw)
    sd["input_resolution"] = torch.tensor(cfg.image_resolution)
    sd["context_length"] = torch.tensor(cfg.context_length)
    sd["vocab_size"] = torch.tensor(cfg.vocab_size)
    return sd


def write_clip(dest: str, cfg: clip_model.CLIPConfig = clip_model.VIT_B_32, seed: int = 0,
               jit: bool = True, dtype: torch.dtype = torch.float16) -> None:
    """An OpenAI CLIP `.pt`: a TorchScript archive (jit) or a pickled state
    dict, its float entries in `dtype`."""
    sd = {k: (v.to(dtype) if v.is_floating_point() else v)
          for k, v in clip_state_dict(cfg, seed).items()}
    os.makedirs(os.path.dirname(os.path.abspath(dest)), exist_ok=True)
    if jit:
        torch.jit.save(torch.jit.script(_holder_tree(sd)), dest)
    else:
        torch.save(sd, dest)


# ---------------------------------------------------------------- BigGAN

def _unit(t: torch.Tensor) -> torch.Tensor:
    return t / t.norm().clamp_min(1e-12)


def biggan_state_dict(cfg: bg.BigGANConfig = bg.BIGGAN_DEEP_512, seed: int = 0,
                      power_iterations: int = 5) -> Dict[str, torch.Tensor]:
    """The `pytorch_pretrained_biggan` state dict of `cfg`, in its key
    order: weights N(0, 0.05), biases N(0, 0.02), u and v from a few power
    iterations (so sigma is near each weight's top singular value), running
    means N(0, 0.1), running variances in [0.5, 1.5), the final BN's gain
    near 1 and the attention gains in [0.25, 0.75)."""
    g = torch.Generator().manual_seed(seed)
    sd: Dict[str, torch.Tensor] = {}

    def randn(*shape, std):
        return torch.randn(shape, generator=g) * std

    def sn(prefix, shape, bias=True):
        if bias:
            sd[f"{prefix}.bias"] = randn(shape[0], std=0.02)
        w = randn(*shape, std=0.05)
        w_mat = w.reshape(shape[0], -1)
        u = _unit(randn(shape[0], std=1.0))
        for _ in range(power_iterations):
            v = _unit(w_mat.t() @ u)
            u = _unit(w_mat @ v)
        sd[f"{prefix}.weight_orig"] = w
        sd[f"{prefix}.weight_u"] = u
        sd[f"{prefix}.weight_v"] = v

    def cond_bn(prefix, ch):
        sd[f"{prefix}.running_means"] = randn(cfg.n_stats, ch, std=0.1)
        sd[f"{prefix}.running_vars"] = 0.5 + torch.rand((cfg.n_stats, ch), generator=g)
        sn(f"{prefix}.scale", (ch, cfg.cond_dim), bias=False)
        sn(f"{prefix}.offset", (ch, cfg.cond_dim), bias=False)

    ch = cfg.channel_width
    sd["embeddings.weight"] = randn(cfg.z_dim, cfg.num_classes, std=0.05)
    sn("generator.gen_z", (4 * 4 * cfg.layers[0][1] * ch, cfg.cond_dim))
    i = 0
    for li, (_, in_m, out_m) in enumerate(cfg.layers):
        if li == cfg.attention_layer_position:
            p, c = f"generator.layers.{i}", ch * in_m
            sd[f"{p}.gamma"] = 0.25 + 0.5 * torch.rand((1,), generator=g)
            for name, o, n_in in (("theta", c // 8, c), ("phi", c // 8, c),
                                  ("g", c // 2, c), ("o_conv", c, c // 2)):
                sn(f"{p}.snconv1x1_{name}", (o, n_in, 1, 1), bias=False)
            i += 1
        p, c_in, c_out = f"generator.layers.{i}", ch * in_m, ch * out_m
        mid = c_in // 4
        for j, (n_in, n_out, k) in enumerate(((c_in, mid, 1), (mid, mid, 3), (mid, mid, 3),
                                              (mid, c_out, 1))):
            cond_bn(f"{p}.bn_{j}", n_in)
            sn(f"{p}.conv_{j}", (n_out, n_in, k, k))
        i += 1
    c_last = ch * cfg.layers[-1][2]
    sd["generator.bn.weight"] = 1.0 + randn(c_last, std=0.1)
    sd["generator.bn.bias"] = randn(c_last, std=0.1)
    sd["generator.bn.running_means"] = randn(cfg.n_stats, c_last, std=0.1)
    sd["generator.bn.running_vars"] = 0.5 + torch.rand((cfg.n_stats, c_last), generator=g)
    sn("generator.conv_to_rgb", (c_last, c_last, 3, 3))
    return sd


def write_biggan(dest: str, cfg: bg.BigGANConfig = bg.BIGGAN_DEEP_512, seed: int = 0) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(dest)), exist_ok=True)
    torch.save(biggan_state_dict(cfg, seed), dest)


# ---------------------------------------------------------------- GPT-2

def write_gpt2(dest: str, n_embd: int = 96, n_layer: int = 2, seed: int = 0) -> None:
    """The legacy `.bin`: no `transformer.` prefix, LayerNorms as `.g/.b`,
    Conv1D weights as 2-D `.w` [in, out]; the real vocabulary and positions
    (50257, 1024), so the BPE's ids are in range."""
    g = torch.Generator().manual_seed(seed)

    def r(*shape):
        return torch.randn(*shape, generator=g) * 0.05

    d = n_embd
    sd = {"wte.weight": r(50257, d), "wpe.weight": r(1024, d)}
    for i in range(n_layer):
        p = f"h.{i}"
        sd[f"{p}.ln_1.g"] = torch.ones(d)
        sd[f"{p}.ln_1.b"] = torch.zeros(d)
        sd[f"{p}.attn.c_attn.w"] = r(d, 3 * d)
        sd[f"{p}.attn.c_attn.b"] = r(3 * d)
        sd[f"{p}.attn.c_proj.w"] = r(d, d)
        sd[f"{p}.attn.c_proj.b"] = r(d)
        sd[f"{p}.ln_2.g"] = torch.ones(d)
        sd[f"{p}.ln_2.b"] = torch.zeros(d)
        sd[f"{p}.mlp.c_fc.w"] = r(d, 4 * d)
        sd[f"{p}.mlp.c_fc.b"] = r(4 * d)
        sd[f"{p}.mlp.c_proj.w"] = r(4 * d, d)
        sd[f"{p}.mlp.c_proj.b"] = r(d)
    sd["ln_f.g"] = torch.ones(d)
    sd["ln_f.b"] = torch.zeros(d)
    os.makedirs(os.path.dirname(os.path.abspath(dest)), exist_ok=True)
    torch.save(sd, dest)


# ------------------------------------------------------------------ metrics


def write_vgg16(dest: str, div: int = 8, seed: int = 0) -> None:
    """torchvision's vgg16 zoo-file layout (the file LPIPS's constructor
    downloads, reference external_models/lpips.py:43): `features.{i}.weight/
    bias` for all 13 convs at channels / div (div 1: the published
    geometry), and a small stand-in for the classifier the metric never
    reads (its presence rehearses the converter's tolerance of extra keys)."""
    from clip_glass_torch.metrics import lpips

    g = torch.Generator().manual_seed(seed)

    def r(*shape):
        return torch.randn(*shape, generator=g) * 0.1

    sd = {}
    for idx, cin, cout in lpips._VGG_CFG:
        ci = 3 if cin == 3 else max(cin // div, 1)
        co = max(cout // div, 1)
        sd[f"features.{idx}.weight"] = r(co, ci, 3, 3)
        sd[f"features.{idx}.bias"] = r(co)
    last = max(512 // div, 1)
    for li, (i, o) in zip((0, 3, 6), [(last * 49, 64), (64, 64), (64, 10)]):
        sd[f"classifier.{li}.weight"] = r(o, i)
        sd[f"classifier.{li}.bias"] = r(o)
    os.makedirs(os.path.dirname(os.path.abspath(dest)), exist_ok=True)
    torch.save(sd, dest)


def write_lpips_linear(dest: str, div: int = 8, seed: int = 0) -> None:
    """The richzhang v0.1 `vgg.pth` layout: an ordered dict of the 5
    per-slice `lin{i}.model.1.weight` tensors, [1, C / div, 1, 1], which the
    reference reads in file order (external_models/lpips.py:36-56)."""
    import collections

    from clip_glass_torch.metrics import lpips

    g = torch.Generator().manual_seed(seed)
    sd = collections.OrderedDict()
    for i, c in enumerate(lpips._SLICE_OUT):
        sd[f"lin{i}.model.1.weight"] = torch.rand(1, max(c // div, 1), 1, 1, generator=g) * 0.2
    os.makedirs(os.path.dirname(os.path.abspath(dest)), exist_ok=True)
    torch.save(sd, dest)


def write_inception(dest: str, seed: int = 0) -> None:
    """pytorch-fid's pt_inception state dict at its real geometry: every
    BasicConv2d as `<block>[.<branch>].conv.weight` + `.bn.{weight,bias,
    running_mean,running_var,num_batches_tracked}`, and the fc head
    (fid_inception_v3 is built with num_classes=1008, aux_logits=False,
    reference external_models/inception.py:134-158), which the converter
    ignores with the bookkeeping keys."""
    from clip_glass_torch.metrics import inception

    g = torch.Generator().manual_seed(seed)

    def normal(std, *shape):
        return torch.randn(*shape, generator=g) * std

    def uniform(lo, hi, n):
        return lo + (hi - lo) * torch.rand(n, generator=g)

    sd = {}

    def fill(prefix, spec):
        ci, co, kh, kw = spec
        sd[f"{prefix}.conv.weight"] = normal(0.05, co, ci, kh, kw)
        sd[f"{prefix}.bn.weight"] = uniform(0.5, 1.5, co)
        sd[f"{prefix}.bn.bias"] = normal(0.1, co)
        sd[f"{prefix}.bn.running_mean"] = normal(0.1, co)
        sd[f"{prefix}.bn.running_var"] = uniform(0.5, 1.5, co)
        sd[f"{prefix}.bn.num_batches_tracked"] = torch.tensor(0)

    for name, spec in inception.conv_table().items():
        if isinstance(spec, tuple):
            fill(name, spec)
        else:
            for br, s in spec.items():
                fill(f"{name}.{br}", s)
    sd["fc.weight"] = normal(0.02, 1008, 2048)
    sd["fc.bias"] = torch.zeros(1008)
    os.makedirs(os.path.dirname(os.path.abspath(dest)), exist_ok=True)
    torch.save(sd, dest)


# ------------------------------------------------------------------ all

# config-f's TF channels, from 4 px up to 1024 px
CONFIG_F_TF_CHANNELS = tuple(sg2.CONFIG_F.channels[::-1])


def write_all(root: str, seed: int = 0) -> Dict[str, str]:
    """Every format at its published geometry under `root`: StyleGAN2
    config-f (`stylegan2/{Gs,G,D}.pth` and the TF pickle), CLIP ViT-B/32 and
    RN50 (each a TorchScript archive and a pickled state dict, fp16),
    BigGAN-deep-512 and GPT-2 124M. Returns {name: path}."""
    paths = {f"stylegan2/{k}.pth": v for k, v in
             write_stylegan2_pth(os.path.join(root, "stylegan2"), sg2.CONFIG_F, seed).items()}
    paths["stylegan2-ffhq-config-f.pkl"] = os.path.join(root, "stylegan2-ffhq-config-f.pkl")
    write_stylegan2_pkl(paths["stylegan2-ffhq-config-f.pkl"], latent=512,
                        channels=CONFIG_F_TF_CHANNELS, seed=seed, mapping_layers=8)
    for name, cfg in (("ViT-B-32", clip_model.VIT_B_32), ("RN50", clip_model.RN50)):
        for jit, suffix in ((True, ".pt"), (False, "-state-dict.pt")):
            path = os.path.join(root, "clip", name + suffix)
            write_clip(path, cfg, seed, jit=jit)
            paths[f"clip/{name}{suffix}"] = path
    paths["biggan-deep-512-pytorch_model.bin"] = os.path.join(
        root, "biggan-deep-512-pytorch_model.bin")
    write_biggan(paths["biggan-deep-512-pytorch_model.bin"], bg.BIGGAN_DEEP_512, seed)
    paths["gpt2-pytorch_model.bin"] = os.path.join(root, "gpt2-pytorch_model.bin")
    write_gpt2(paths["gpt2-pytorch_model.bin"], n_embd=768, n_layer=12, seed=seed)
    return paths


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m clip_glass_torch.weights.synthesize",
                                description=__doc__.split("\n")[0])
    p.add_argument("out")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    for name, path in write_all(args.out, args.seed).items():
        print(f"{name:<40s} {os.path.getsize(path):>12d} bytes  {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
