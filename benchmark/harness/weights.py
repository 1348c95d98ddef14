"""Weights made from the seed, on the card, at the published init scales.

Each model's tree is laid out as the port reads a converted checkpoint
(conv weights OIHW, dense weights [in, out], the ToRGB weight [in, 3],
CLIP's blocks as a list, BigGAN's statistics [n_stats, C]) and handed to the
port in memory as a bundle. The reference reads the same tensors.

Every leaf is a normal draw N(mean, std^2). All leaves of one model come
from one `torch.randn` on the card, scaled per leaf by two element-wise
passes, so a model costs a handful of launches whatever its leaf count.

Scales, by model (the config file's `assumed` lists the choices that no
source fixes):
- StyleGAN2 (NVIDIA's equalized learning rate): every weight N(0, 1) times
  its runtime gain 1/sqrt(fan_in), which the port's layout folds in; the
  mapping's lr multiplier 0.01 cancels between its N(0, 1/0.01^2) storage
  and its gain 0.01/sqrt(fan_in); style biases 1, the 4x4 constant N(0, 1);
  then the ToRGB layers scaled so that G's images have the std of a
  photo's pixels in [-1, 1] (`scale_to_rgb`), as a trained G's do.
- CLIP (OpenAI's `initialize_parameters`): attention in-projections
  width^-0.5, output projections and c_proj width^-0.5 (2 layers)^-0.5,
  c_fc (2 width)^-0.5, token embedding 0.02, text positions 0.01, ViT class
  token, positions and projection width^-0.5.
- GPT-2 (the published init, Hugging Face's `GPT2PreTrainedModel`): every
  weight and both embeddings N(0, 0.02), the two output projections of a
  block (`c_proj`) N(0, 0.02 / sqrt(2 n_layer)); biases and LayerNorm
  affines drawn around their init values (0, and 1 for the gains).
- BigGAN-deep (spectral normalization): each weight matrix [out, in*k*k]
  drawn with std 1/(sqrt(out) + sqrt(in*k*k)), the largest singular value
  of such a Gaussian matrix being about 1; the batch norms' running
  statistics are the standing statistics of a float32 pass over a batch
  drawn from the seed (`standing_stats`), as the published checkpoints
  hold the statistics of real activations.
"""

from __future__ import annotations

import math
from typing import Any, List, NamedTuple

import torch


class Leaf(NamedTuple):
    shape: tuple
    std: float
    mean: float = 0.0


def _leaves(tree, out: List):
    if isinstance(tree, Leaf):
        out.append(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            _leaves(v, out)
    else:
        for v in tree:
            _leaves(v, out)
    return out


def _fill(tree, it):
    if isinstance(tree, Leaf):
        return next(it)
    if isinstance(tree, dict):
        return {k: _fill(v, it) for k, v in tree.items()}
    return [_fill(v, it) for v in tree]


def materialize(spec, gen: torch.Generator, small: int = 1 << 20) -> Any:
    """The tree of `spec` with every Leaf drawn, in one randn on gen's
    device. Leaves of at most `small` values get storage of their own, so
    that a caller keeping only those does not keep the whole draw alive."""
    leaves = _leaves(spec, [])
    sizes = [math.prod(leaf.shape) for leaf in leaves]
    dev = gen.device
    flat = torch.randn(sum(sizes), generator=gen, device=dev)
    counts = torch.tensor(sizes, device=dev)
    flat.mul_(torch.repeat_interleave(
        torch.tensor([leaf.std for leaf in leaves], device=dev), counts))
    flat.add_(torch.repeat_interleave(
        torch.tensor([leaf.mean for leaf in leaves], device=dev), counts))
    parts = []
    for leaf, piece in zip(leaves, flat.split(sizes)):
        t = piece.view(leaf.shape)
        parts.append(t.clone() if t.numel() <= small else t)
    return _fill(spec, iter(parts))


# ------------------------------------------------------------- StyleGAN2

def stylegan2_spec(geo: dict, init: dict):
    """G, D and the noise planes of the geometry `geo` (the config file's
    `stylegan2` group); `init` is the file's `assumed` group."""
    d = geo["latent_size"]
    bias, noise_std = init["bias_std"], init["noise_strength_std"]
    ch = list(geo["channels"])
    k = geo["kernel_size"]

    def dense(i, o, b_mean=0.0):
        return {"w": Leaf((i, o), 1 / math.sqrt(i)), "b": Leaf((o,), bias, b_mean)}

    def conv(i, o, kk):
        return {"w": Leaf((o, i, kk, kk), 1 / math.sqrt(i * kk * kk)), "b": Leaf((o,), bias)}

    blocks = [(ch[-1], ch[-1], 1)] + [(ch[-i], ch[-i - 1], geo["conv_block_size"])
                                       for i in range(1, len(ch))]
    syn = {"const": Leaf((geo["base_size"], geo["base_size"], ch[-1]), 1.0),
           "blocks": [], "to_rgb": []}
    for c_in, c_out, n_layers in blocks:
        layers = []
        for li in range(n_layers):
            i = c_in if li == 0 else c_out
            layers.append({**conv(i, c_out, k), "style": dense(d, i, 1.0),
                           "noise_scale": Leaf((), noise_std)})
        syn["blocks"].append({"layers": layers})
        syn["to_rgb"].append({"w": Leaf((c_out, geo["data_channels"]), 1 / math.sqrt(c_out)),
                              "b": Leaf((geo["data_channels"],), bias),
                              "style": dense(d, c_out, 1.0)})
    g = {"mapping": {"dense": [dense(d, d) for _ in range(geo["mapping_layers"])]},
         "synthesis": syn, "dlatent_avg": Leaf((d,), 0.0)}
    disc = {"from_rgb": conv(geo["data_channels"], ch[0], 1), "blocks": []}
    for i in range(len(ch) - 1):
        disc["blocks"].append({"conv0": conv(ch[i], ch[i], k), "conv1": conv(ch[i], ch[i + 1], k),
                               "skip": {"w": Leaf((ch[i + 1], ch[i], 1, 1),
                                                  1 / math.sqrt(ch[i]))}})
    base = geo["base_size"]
    disc["final_conv"] = conv(ch[-1] + 1, ch[-1], k)
    disc["dense0"] = dense(ch[-1] * base * base, ch[-1])
    disc["dense1"] = dense(ch[-1], 1)
    size, noise = base, []
    for bi, (_, _, n_layers) in enumerate(blocks):
        size *= 2 if bi else 1
        noise += [Leaf((size, size), 1.0)] * n_layers
    return {"g": g, "d": disc, "noise": noise}


@torch.no_grad()
def scale_to_rgb(g, noise, geo: dict, gen: torch.Generator, rows: int,
                 image_std: float) -> float:
    """Scale every ToRGB weight and bias of G so that its images, over a
    float32 pass of `rows` latents drawn from `gen`, have the standard
    deviation `image_std`. The image is linear in the ToRGB layers' weights
    and biases together (the RGB skip is a sum of upsampled ToRGB outputs),
    so one factor gives it exactly. Returns the std before scaling."""
    from benchmark.reference import stylegan2 as ref_sg2
    from benchmark.reference.numerics import fp32_exact

    z = torch.randn((rows, geo["latent_size"]), generator=gen, device=gen.device)
    with fp32_exact():
        std = ref_sg2.generate(g, z, geo, noise).std().item()
    if not math.isfinite(std) or std <= 0:
        raise RuntimeError(f"G's images before the ToRGB scaling have std {std}")
    for rgb in g["synthesis"]["to_rgb"]:
        rgb["w"].mul_(image_std / std)
        rgb["b"].mul_(image_std / std)
    return std


# ------------------------------------------------------------------ CLIP

def clip_spec(geo: dict, init: dict):
    """CLIP ViT of the geometry `geo` (the config file's `clip` group)."""
    bias, ln = init["bias_std"], init["layernorm_std"]

    def layer_norm(w):
        return {"scale": Leaf((w,), ln, 1.0), "bias": Leaf((w,), ln)}

    def block(w, layers):
        proj = w ** -0.5 * (2 * layers) ** -0.5
        return {"ln_1": layer_norm(w),
                "attn": {"in_proj_weight": Leaf((w, 3 * w), w ** -0.5),
                         "in_proj_bias": Leaf((3 * w,), bias),
                         "out_proj_weight": Leaf((w, w), proj),
                         "out_proj_bias": Leaf((w,), bias)},
                "ln_2": layer_norm(w),
                "mlp": {"c_fc_weight": Leaf((w, 4 * w), (2 * w) ** -0.5),
                        "c_fc_bias": Leaf((4 * w,), bias),
                        "c_proj_weight": Leaf((4 * w, w), proj),
                        "c_proj_bias": Leaf((w,), bias)}}

    w, tw, p = geo["vision_width"], geo["transformer_width"], geo["vision_patch_size"]
    grid = geo["image_resolution"] // p
    visual = {"patch_embed": {"weight": Leaf((3 * p * p, w), (3 * p * p) ** -0.5)},
              "class_embedding": Leaf((w,), w ** -0.5),
              "positional_embedding": Leaf((grid * grid + 1, w), w ** -0.5),
              "ln_pre": layer_norm(w),
              "blocks": [block(w, geo["vision_layers"]) for _ in range(geo["vision_layers"])],
              "ln_post": layer_norm(w),
              "proj": Leaf((w, geo["embed_dim"]), w ** -0.5)}
    text = {"token_embedding": Leaf((geo["vocab_size"], tw), 0.02),
            "positional_embedding": Leaf((geo["context_length"], tw), 0.01),
            "blocks": [block(tw, geo["transformer_layers"])
                       for _ in range(geo["transformer_layers"])],
            "ln_final": layer_norm(tw),
            "text_projection": Leaf((tw, geo["embed_dim"]), tw ** -0.5)}
    return {"visual": visual, "text": text, "logit_scale": Leaf((), 0.0, math.log(1 / 0.07))}


# ----------------------------------------------------------------- GPT-2

def gpt2_spec(geo: dict, init: dict):
    """GPT-2 of the geometry `geo` (the config file's `gpt2` group), in the
    port's layout (reference/gpt2.py)."""
    d, std = geo["n_embd"], 0.02
    proj = std / math.sqrt(2 * geo["n_layer"])
    bias, ln = init["bias_std"], init["layernorm_std"]

    def layer_norm():
        return {"g": Leaf((d,), ln, 1.0), "b": Leaf((d,), ln)}

    def block():
        return {"ln_1": layer_norm(),
                "attn": {"c_attn_w": Leaf((d, 3 * d), std), "c_attn_b": Leaf((3 * d,), bias),
                         "c_proj_w": Leaf((d, d), proj), "c_proj_b": Leaf((d,), bias)},
                "ln_2": layer_norm(),
                "mlp": {"c_fc_w": Leaf((d, 4 * d), std), "c_fc_b": Leaf((4 * d,), bias),
                        "c_proj_w": Leaf((4 * d, d), proj), "c_proj_b": Leaf((d,), bias)}}

    return {"wte": Leaf((geo["vocab_size"], d), std), "wpe": Leaf((geo["n_positions"], d), std),
            "blocks": [block() for _ in range(geo["n_layer"])], "ln_f": layer_norm()}


# ---------------------------------------------------------------- BigGAN

def biggan_spec(geo: dict, init: dict):
    """BigGAN-deep G of the geometry `geo` (the config file's `biggan`
    group); the statistics are placeholders for `standing_stats`."""
    ch, cond, n_stats = geo["channel_width"], 2 * geo["z_dim"], geo["n_stats"]
    bias = init["bias_std"]

    def sn(o, i, kk=1):
        return 1 / (math.sqrt(o) + math.sqrt(i * kk * kk))

    def conv(i, o, kk, with_bias=True):
        p = {"w": Leaf((o, i, kk, kk), sn(o, i, kk))}
        if with_bias:
            p["b"] = Leaf((o,), bias)
        return p

    def cond_bn(c):
        return {"running_means": Leaf((n_stats, c), 0.0),
                "running_vars": Leaf((n_stats, c), 0.0, 1.0),
                "scale": {"w": Leaf((cond, c), sn(c, cond))},
                "offset": {"w": Leaf((cond, c), sn(c, cond))}}

    blocks = []
    for li, (_, im, om) in enumerate(geo["layers"]):
        if li == geo["attention_layer_position"]:
            c = ch * im
            blocks.append({"attn": {"theta": conv(c, c // 8, 1, False),
                                    "phi": conv(c, c // 8, 1, False),
                                    "g": conv(c, c // 2, 1, False),
                                    "o_conv": conv(c // 2, c, 1, False),
                                    "gamma": Leaf((), init["attention_gamma_std"],
                                                  init["attention_gamma_mean"])}})
        i, o = ch * im, ch * om
        mid = i // 4
        blocks.append({"block": {"bn_0": cond_bn(i), "conv_0": conv(i, mid, 1),
                                 "bn_1": cond_bn(mid), "conv_1": conv(mid, mid, 3),
                                 "bn_2": cond_bn(mid), "conv_2": conv(mid, mid, 3),
                                 "bn_3": cond_bn(mid), "conv_3": conv(mid, o, 1)}})
    first, last = geo["layers"][0][1] * ch, geo["layers"][-1][2] * ch
    return {"embeddings": {"w": Leaf((geo["num_classes"], geo["z_dim"]), init["embedding_std"])},
            "gen_z": {"w": Leaf((cond, 16 * first), sn(16 * first, cond)),
                      "b": Leaf((16 * first,), bias)},
            "blocks": blocks,
            "bn": {"running_means": Leaf((n_stats, last), 0.0),
                   "running_vars": Leaf((n_stats, last), 0.0, 1.0),
                   "weight": Leaf((last,), bias, 1.0), "bias": Leaf((last,), bias)},
            "conv_to_rgb": conv(last, last, 3)}


def _batch_norms(g) -> list:
    """The batch norms of a BigGAN tree in the order the forward calls them."""
    out = []
    for entry in g["blocks"]:
        if "block" in entry:
            out += [entry["block"][f"bn_{i}"] for i in range(4)]
    return out + [g["bn"]]


@torch.no_grad()
def standing_stats(g, geo: dict, gen: torch.Generator, rows: int) -> None:
    """Fill every batch norm's running statistics (all n_stats rows) with the
    mean and variance of its input over a float32 pass of `rows` latents
    drawn from `gen`, each batch norm normalized by its own batch's
    statistics, in the forward's order."""
    from benchmark.reference import biggan as ref_biggan
    from benchmark.reference.numerics import fp32_exact

    dev = gen.device
    z = torch.randn((rows, geo["z_dim"]), generator=gen, device=dev).clamp(-2, 2)
    bits = (torch.rand((rows, geo["num_classes"]), generator=gen, device=dev) < 0.005).float()
    stats: list = []
    with fp32_exact():
        ref_biggan.generate(g, z, torch.softmax(bits, dim=1), geo, stats=stats)
    norms = _batch_norms(g)
    if len(stats) != len(norms):
        raise RuntimeError(f"{len(stats)} statistics for {len(norms)} batch norms")
    for bn, (mean, var) in zip(norms, stats):
        bn["running_means"].copy_(mean.expand_as(bn["running_means"]))
        bn["running_vars"].copy_(var.expand_as(bn["running_vars"]))
