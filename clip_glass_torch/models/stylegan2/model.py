"""StyleGAN2 generator (mapping + synthesis) and discriminator.

Behavioral reference: stylegan2/models.py (GeneratorMapping 516-627,
GeneratorSynthesis 753-1014, Generator truncation 314-324, Discriminator
1017-1230) and stylegan2/modules.py conv blocks (1263-1601). Config-f:
channels [32,32,64,128,256,512,512,512,512], base 4x4, skip-G / resnet-D,
2-layer blocks, 18 style layers at 1024px.

Two execution domains, as in the JAX package: levels with output resolution
>= cfg.s2d_min_res (512 and 1024 px for config-f) run in the space-to-depth
domain (ops/s2d.py: packed tensors, phase-composed kernels, no full-res
tensor and no standalone FIR), the levels below in the plain domain.
`dataclasses.replace(cfg, s2d_min_res=2**30)` runs everything plain.
Activations are NHWC; parameters come from `weights.from_jax` (OIHW convs,
right-multiply dense weights, equalized-lr coefficients folded in); the two
domains read the same parameter tree.

Hand-written CUDA kernels on a GPU tensor: `noise_bias_lrelu` (every layer's
epilogue; at the s2d levels on a view of the packed tensor), `upsample2x`
(the plain levels' RGB skip), `modulated_matmul` (the plain levels' ToRGB)
and `s2d_conv2x2` (the s2d levels' same-resolution convs between opposite
lattices, in G and D).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

import torch

from clip_glass_torch.core.dtypes import FP32, Policy
from clip_glass_torch.ops import s2d as s2d_ops
from clip_glass_torch.ops.bias_act import bias_act, minibatch_std, noise_bias_lrelu
from clip_glass_torch.ops.modulated_conv import (
    conv2d,
    conv2d_down,
    modulated_conv2d,
    modulated_conv2d_up,
    modulated_matmul,
    style_from_latent,
)
from clip_glass_torch.ops.upfirdn import upsample2x
from clip_glass_torch.weights import from_jax


@dataclasses.dataclass(frozen=True)
class SG2Config:
    latent_size: int = 512
    # a class-conditional checkpoint's label count (the reference's
    # label_size); the searches are unconditional and the forward reads no
    # labels, so it is 0 for every model here
    label_size: int = 0
    mapping_layers: int = 8
    mapping_lr_mul: float = 0.01
    channels: Sequence[int] = (32, 32, 64, 128, 256, 512, 512, 512, 512)
    base_size: int = 4
    data_channels: int = 3
    conv_block_size: int = 2
    kernel_size: int = 3
    filter_taps: Sequence[int] = (1, 3, 3, 1)
    mbstd_group_size: int = 4
    demodulate: bool = True
    modulate_data_out: bool = True
    noise: bool = True
    eps: float = 1e-8
    # Levels with output resolution >= this run in the space-to-depth
    # execution domain (ops/s2d.py). 2**30 disables it.
    s2d_min_res: int = 512
    # Alternate the s2d lattice offset (0 <-> -1) between consecutive convs,
    # so every same-res 3x3 folds to a [2,2] kernel (s2d_conv2x2).
    s2d_offsets: bool = True
    # Carry the RGB/skip accumulator at the s2d levels in the 4x4
    # space-to-depth domain (s4d, 16 * data_channels channels).
    rgb_s4d: bool = True

    @property
    def n_blocks(self) -> int:
        return len(self.channels)

    @property
    def resolution(self) -> int:
        return self.base_size * 2 ** (self.n_blocks - 1)

    @property
    def num_latents(self) -> int:
        # reference stylegan2/models.py:890-896
        n = 1 + self.conv_block_size * (self.n_blocks - 1)
        return n + 1 if self.modulate_data_out else n

    def block_channels(self) -> List[tuple]:
        """Synthesis blocks, first->last: (in_ch, out_ch, up, n_layers)."""
        ch = list(self.channels)
        blocks = [(ch[-1], ch[-1], False, 1)]
        for i in range(1, len(ch)):
            blocks.append((ch[-i], ch[-i - 1], True, self.conv_block_size))
        return blocks

    def noise_shapes(self) -> List[tuple]:
        shapes = []
        size = self.base_size
        for _, _, up, n_layers in self.block_channels():
            if up:
                size *= 2
            shapes.extend([(size, size)] * n_layers)
        return shapes


CONFIG_F = SG2Config()

# G leaves the forward reads raw in fp32: `truncate` lerps against
# dlatent_avg. Everything else is cast to the compute dtype once. D is not
# precast at all: its s2d down-composite folds compose FIR taps with the raw
# fp32 weights and round once at the end (ops/s2d.s2d_down_kernel).
PRECAST_EXCLUDE = ("dlatent_avg",)
# tiny variant for tests: 3 blocks -> 16px, slim channels
TINY = SG2Config(latent_size=32, mapping_layers=2,
                 channels=(16, 16, 16), mbstd_group_size=2)


# ---------------------------------------------------------------- init
#
# Random init draws a JAX-layout tree (HWIO convs, [in, out] dense) from a
# torch.Generator with the JAX package's distributions and scales, then
# converts it with weights.from_jax like any carried-across tree.

def _he_coef(shape, gain=1.0, lr_mul=1.0):
    # the JAX package's rule, called with its own shape tuples (below), so
    # the scales are the same as its random init's
    fan_in = int(math.prod(shape[:-1]))
    return gain / math.sqrt(fan_in) * lr_mul


def _randn(gen, *shape):
    return torch.randn(shape, generator=gen, device=gen.device)


def _dense_init(gen, in_f, out_f, lr_mul=1.0, bias_init=0.0):
    """Effective (runtime-coefficient-folded) equalized-lr dense params."""
    coef = _he_coef((in_f,), 1.0, lr_mul)
    return {"w": _randn(gen, in_f, out_f) * (1.0 / lr_mul) * coef,
            "b": torch.full((out_f,), bias_init * lr_mul)}


def _conv_init(gen, in_ch, out_ch, k, latent=None, lr_mul=1.0, noise=False):
    coef = _he_coef((k, k, in_ch), 1.0, lr_mul)
    p = {"w": _randn(gen, k, k, in_ch, out_ch) * (1.0 / lr_mul) * coef,
         "b": torch.zeros(out_ch)}
    if latent is not None:
        p["style"] = _dense_init(gen, latent, in_ch, lr_mul, bias_init=1.0)
    if noise:
        p["noise_scale"] = torch.zeros(())
    return p


def generator_tree(gen, cfg: SG2Config = CONFIG_F):
    """Random G parameters in the JAX layout (what a converted `Gs.npz`
    holds)."""
    mapping = {"dense": [
        _dense_init(gen, cfg.latent_size, cfg.latent_size, cfg.mapping_lr_mul)
        for _ in range(cfg.mapping_layers)]}
    syn = {"const": _randn(gen, cfg.base_size, cfg.base_size, cfg.channels[-1]),
           "blocks": [], "to_rgb": []}
    for in_ch, out_ch, _, n_layers in cfg.block_channels():
        layers = []
        c_in = in_ch
        for _ in range(n_layers):
            layers.append(_conv_init(gen, c_in, out_ch, cfg.kernel_size,
                                     latent=cfg.latent_size, noise=cfg.noise))
            c_in = out_ch
        syn["blocks"].append({"layers": layers})
        syn["to_rgb"].append(_conv_init(
            gen, out_ch, cfg.data_channels, 1,
            latent=cfg.latent_size if cfg.modulate_data_out else None))
    return {"mapping": mapping, "synthesis": syn,
            "dlatent_avg": torch.zeros(cfg.latent_size)}


def discriminator_tree(gen, cfg: SG2Config = CONFIG_F):
    """Random D parameters in the JAX layout (what a converted `D.npz`
    holds)."""
    ch = list(cfg.channels)
    tree = {"from_rgb": _conv_init(gen, cfg.data_channels, ch[0], 1),
            "blocks": []}
    for i in range(len(ch) - 1):
        tree["blocks"].append({
            "conv0": _conv_init(gen, ch[i], ch[i], cfg.kernel_size),
            "conv1": _conv_init(gen, ch[i], ch[i + 1], cfg.kernel_size),
            "skip": {"w": _randn(gen, 1, 1, ch[i], ch[i + 1])
                     * _he_coef((1, 1, ch[i]))},
        })
    mb_extra = 1 if cfg.mbstd_group_size else 0
    tree["final_conv"] = _conv_init(gen, ch[-1] + mb_extra, ch[-1], cfg.kernel_size)
    tree["dense0"] = _dense_init(gen, ch[-1] * cfg.base_size ** 2, ch[-1])
    tree["dense1"] = _dense_init(gen, ch[-1], 1)
    return tree


def generator_init(gen: torch.Generator, cfg: SG2Config = CONFIG_F):
    """Random G parameters (the JAX package's distributions and scales)."""
    return from_jax.convert_generator(generator_tree(gen, cfg))


def discriminator_init(gen: torch.Generator, cfg: SG2Config = CONFIG_F):
    """Random D parameters (the JAX package's distributions and scales)."""
    return from_jax.convert_discriminator(discriminator_tree(gen, cfg))


# ---------------------------------------------------------------- forward

def mapping_apply(params, latents, cfg: SG2Config = CONFIG_F,
                  policy: Policy = FP32):
    """z -> w (reference stylegan2/models.py:589-627): RMS input normalize,
    dense + lrelu*sqrt(2) layers (unconditional: no label embedding)."""
    x = policy.cast_compute(latents)
    x32 = x.float()
    x = (x32 * torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + cfg.eps)
         ).to(x.dtype)
    for d in params["dense"]:
        x = x @ policy.cast_compute(d["w"])
        x = bias_act(x, policy.cast_compute(d["b"]), act="lrelu")
    return x


def truncate(dlatents, dlatent_avg, psi: float = 1.0,
             cutoff: Optional[int] = None):
    """Truncation lerp toward dlatent_avg (reference stylegan2/models.py:265-324).
    dlatents: [B, n_latents, D]."""
    if psi == 1.0:
        return dlatents
    n = dlatents.shape[1]
    layer_psi = torch.full((n,), float(psi), device=dlatents.device)
    if cutoff is not None:
        layer_psi = torch.where(torch.arange(n, device=dlatents.device) < cutoff,
                                layer_psi, torch.ones_like(layer_psi))
    avg = dlatent_avg[None, None, :]
    return avg + layer_psi[None, :, None] * (dlatents - avg)


def distribute_latents(dlatents, num_layers: int):
    """Expand [B, N, D] per-sample latents to [B, num_layers, D] (reference
    stylegan2/models.py:425-458): N == 1 broadcasts, N == num_layers passes
    through. Style mixing (other N) is not ported."""
    B, N, D = dlatents.shape
    if N == 1:
        return dlatents.expand(B, num_layers, D)
    if N == num_layers:
        return dlatents
    raise ValueError(f"{N} latents for {num_layers} layers: only 1 or "
                     f"{num_layers} are supported (style mixing is not ported)")


def _s2d_supported(cfg: SG2Config) -> bool:
    return cfg.kernel_size == 3 and len(cfg.filter_taps) == 4


def noise_layouts(cfg: SG2Config):
    """Replays synthesis_apply's lattice progression: for each noise layer
    (in noise_shapes order) the (is_s2d, lattice_offset) of the tensor the
    noise add sees. Keep in lockstep with the synthesis loop below."""
    out = []
    res = cfg.base_size
    x_s2d, x_off = False, 0
    for (_in_ch, _out_ch, up, n_layers) in cfg.block_channels():
        if up:
            res *= 2
        use_s2d = _s2d_supported(cfg) and res >= cfg.s2d_min_res
        for li in range(n_layers):
            if up and li == 0:
                if use_s2d:
                    x_s2d, x_off = True, 0
            else:
                if use_s2d and not x_s2d:
                    x_s2d, x_off = True, 0
                if x_s2d:
                    x_off = (0 if x_off else -1) if cfg.s2d_offsets else 0
            out.append((x_s2d, x_off))
    return out


def pack_noise(noise, cfg: SG2Config, policy: Policy = FP32):
    """Fold fixed per-layer noise planes into the lattice layouts the
    synthesis consumes, once: s2d-level planes become [nh, nw, 4]
    (phase-major, at the layer's lattice offset, phantoms zero) in the
    compute dtype. An exact reshape/pad; synthesis_apply tells packed
    planes (3-D) from raw ones (2-D) by ndim."""
    if noise is None:
        return None
    packed = []
    for nz, (is_s2d, off) in zip(noise, noise_layouts(cfg)):
        if nz is not None and is_s2d and nz.ndim == 2:
            nz = s2d_ops.s2d_hw(policy.cast_compute(nz), off)
        packed.append(nz)
    return packed


def top_level_s2d(cfg: SG2Config) -> bool:
    """Whether the top (full-resolution) level runs in the s2d domain."""
    return _s2d_supported(cfg) and cfg.resolution >= cfg.s2d_min_res


def s2d_output_offset(cfg: SG2Config) -> int:
    """Lattice offset of the tensor synthesis_apply(output_s2d=True) returns
    (and discriminator_apply(input_s2d=True) expects as input_offset).
    Irrelevant when rgb_domain(cfg) == "s4d" (s4d carries no offset)."""
    return -1 if cfg.s2d_offsets and top_level_s2d(cfg) else 0


def rgb_domain(cfg: SG2Config) -> str:
    """Layout of the image synthesis_apply(output_s2d=True) returns:
    "s4d" ([B, H/4, W/4, 16*data_channels], offset-free) when the top level
    runs s2d with rgb_s4d, else "s2d" (at s2d_output_offset(cfg))."""
    if cfg.rgb_s4d and top_level_s2d(cfg) and cfg.resolution % 4 == 0:
        return "s4d"
    return "s2d"


def _epilogue(x, nz, lp, b, x_s2d: bool, x_off: int, policy: Policy):
    """Noise + bias + leaky ReLU of one synthesis layer. At an s2d level the
    packed tensor [B, nh, nw, 4C] is, viewed as [B, nh, 4*nw, C], a plain
    tensor whose per-pixel noise is the packed plane [nh, nw, 4] viewed as
    [nh, 4*nw]: the same kernel serves both domains. Phantoms of an offset
    -1 tensor are zeroed after."""
    x = x.contiguous()
    B, H, W, C = x.shape
    if x_s2d:
        x = x.view(B, H, 4 * W, C // 4)
    if nz is not None:
        nz = policy.cast_compute(nz)
        if x_s2d:
            nz = (nz if nz.ndim == 3 else s2d_ops.s2d_hw(nz, x_off)).reshape(H, 4 * W)
        x = noise_bias_lrelu(x, nz, policy.cast_compute(lp["noise_scale"]), b)
    else:
        x = bias_act(x, b, act="lrelu")
    x = x.reshape(B, H, W, C)
    return s2d_ops.mask_phantoms_(x) if x_off else x


def synthesis_apply(params, dlatents, cfg: SG2Config = CONFIG_F,
                    noise: Optional[Sequence[torch.Tensor]] = None,
                    policy: Policy = FP32, output_s2d: bool = False):
    """dlatents: [B, num_latents, D] -> images [B, C, H, W] in [-1, 1]
    (reference stylegan2/models.py:969-1014). `noise`: the per-layer planes
    (shared over batch and channels) in `cfg.noise_shapes()` order, raw
    [H, W] or packed by `pack_noise`, or None for no noise.

    Levels with output resolution >= cfg.s2d_min_res run in the s2d domain.
    With output_s2d=True the image is returned packed, in the layout
    rgb_domain(cfg) names: "s4d" ([B, H/4, W/4, 16*data_ch]) or "s2d"
    ([B, nh, nw, 4*data_ch] at s2d_output_offset(cfg), zero phantoms)."""
    allow_s2d = _s2d_supported(cfg)
    if output_s2d and not allow_s2d:
        raise ValueError("output_s2d=True requires the s2d domain")
    B = dlatents.shape[0]
    dl = policy.cast_compute(dlatents)
    const = policy.cast_compute(params["const"])
    x = const[None].expand(B, *const.shape)
    y = None
    x_s2d = False
    y_dom = "plain"    # layout of the skip accumulator: plain | s2d | s4d
    x_off = y_off = 0  # lattice offsets (0 or -1), see ops/s2d.py
    res = cfg.base_size
    layer_idx = 0
    noise_idx = 0
    taps = tuple(cfg.filter_taps)
    for bi, (_, _, up, n_layers) in enumerate(cfg.block_channels()):
        if up:
            res *= 2
        use_s2d = allow_s2d and res >= cfg.s2d_min_res
        bp = params["blocks"][bi]
        for li in range(n_layers):
            lp = bp["layers"][li]
            style = style_from_latent(dl[:, layer_idx + li],
                                      policy.cast_compute(lp["style"]["w"]),
                                      policy.cast_compute(lp["style"]["b"]))
            w = policy.cast_compute(lp["w"])
            if up and li == 0:
                if use_s2d:
                    x = s2d_ops.s2d_modulated_conv2d_up(
                        x, w, style, demodulate=cfg.demodulate, filter_taps=taps,
                        eps=cfg.eps, input_s2d=x_s2d, in_off=x_off)
                    x_s2d, x_off = True, 0
                else:
                    x = modulated_conv2d_up(x, w, style, demodulate=cfg.demodulate,
                                            filter_taps=taps, eps=cfg.eps)
            else:
                if use_s2d and not x_s2d:
                    x = s2d_ops.s2d(x)
                    x_s2d, x_off = True, 0
                if x_s2d:
                    # alternate the lattice offset: every same-res conv
                    # between opposite lattices folds to a [2,2] kernel
                    out_off = (0 if x_off else -1) if cfg.s2d_offsets else 0
                    x = s2d_ops.s2d_modulated_conv2d(
                        x, w, style, demodulate=cfg.demodulate, eps=cfg.eps,
                        in_off=x_off, out_off=out_off)
                    x_off = out_off
                else:
                    x = modulated_conv2d(x, w, style, demodulate=cfg.demodulate,
                                         eps=cfg.eps)
            nz = noise[noise_idx] if (noise is not None and cfg.noise) else None
            x = _epilogue(x, nz, lp, policy.cast_compute(lp["b"]), x_s2d, x_off,
                          policy)
            noise_idx += 1
        layer_idx += n_layers

        use_s4d = x_s2d and cfg.rgb_s4d and res % 4 == 0
        if y is not None:
            if use_s4d:
                if y_dom == "s4d":
                    y = s2d_ops.s4d_upsample2x(y, taps)
                else:  # enter s4d from the level below, one stride-2 conv
                    if y_dom == "s2d":
                        y = s2d_ops.un_s2d_off(y, y_off)
                    y = s2d_ops.plain_to_s4d_upsample2x(y, taps)
            elif x_s2d:
                if y_dom == "s2d":  # s2d(res/2) -> s2d(res)
                    y = s2d_ops.un_s2d_off(y, y_off)
                y = s2d_ops.s2d_upsample2x(y, taps)
                if x_off:  # match the ToRGB lattice
                    y = s2d_ops.shift_to_m1(y)
            else:
                # y is a kernel's output, or the sum of two: contiguous on
                # the card (the CPU's plain version takes any strides)
                y = upsample2x(y, taps)
        rp = params["to_rgb"][bi]
        rw = policy.cast_compute(rp["w"])
        rb = policy.cast_compute(rp["b"])
        style = None
        if cfg.modulate_data_out:
            lat = dl[:, min(layer_idx, cfg.num_latents - 1)]
            style = style_from_latent(lat, policy.cast_compute(rp["style"]["w"]),
                                      policy.cast_compute(rp["style"]["b"]))
        if x_s2d:
            # the 1x1 modulation is an input scale; the fold selects (cell,
            # phase) per output phase
            xs = x
            if style is not None:
                xs = x * s2d_ops.tile_channels(style).to(x.dtype)[:, None, None, :]
            if use_s4d:
                t = s2d_ops.s4d_from_s2d_conv1x1(xs, rw, in_off=x_off)
                tile, y_dom = 16, "s4d"
            else:
                t = s2d_ops.s2d_conv2d(xs, rw.t()[:, :, None, None], x_off, x_off)
                tile, y_dom, y_off = 4, "s2d", x_off
            t = bias_act(t, s2d_ops.tile_channels(rb, tile), act="linear")
        else:
            Bx, H, W, C = x.shape
            # x is contiguous out of _epilogue
            t = modulated_matmul(x.reshape(Bx, H * W, C), style, rw,
                                 None, rb).reshape(Bx, H, W, -1)
            y_dom = "plain"
        y = t if y is None else y + t

    if output_s2d:
        if y_dom == "s4d":  # offset-free; contract: rgb_domain(cfg) == "s4d"
            return y
        target = s2d_output_offset(cfg)
        if y_dom == "plain":
            y, y_off = s2d_ops.s2d(y), 0
        if y_off != target:  # only 0 -> -1 can occur (odd-layer blocks)
            y = s2d_ops.shift_to_m1(y)
        # contract: phantom entries of the returned image are 0
        return s2d_ops.mask_phantoms_(y) if target else y
    if y_dom == "s4d":
        y = s2d_ops.un_s4d(y)
    elif y_dom == "s2d":
        y = s2d_ops.un_s2d_off(y, y_off)
    return y.permute(0, 3, 1, 2)  # NHWC -> NCHW view (reference layout)


def generator_apply(params, latents, cfg: SG2Config = CONFIG_F,
                    truncation_psi: float = 1.0,
                    truncation_cutoff: Optional[int] = None,
                    noise: Optional[Sequence[torch.Tensor]] = None,
                    policy: Policy = FP32, output_s2d: bool = False):
    """Full G: z -> mapping -> distribute to num_latents -> (truncate) ->
    synthesis (reference stylegan2/models.py:326-482). `latents` may be
    [B, D] or one latent per style layer, [B, num_latents, D]."""
    if latents.ndim == 3:
        B, N, D = latents.shape
        w = mapping_apply(params["mapping"], latents.reshape(B * N, D), cfg,
                          policy).reshape(B, N, -1)
    else:
        w = mapping_apply(params["mapping"], latents, cfg, policy)[:, None, :]
    dl = distribute_latents(w, cfg.num_latents)
    dl = truncate(dl, params["dlatent_avg"], truncation_psi, truncation_cutoff)
    return synthesis_apply(params["synthesis"], dl, cfg, noise=noise,
                           policy=policy, output_s2d=output_s2d)


def discriminator_apply(params, images, cfg: SG2Config = CONFIG_F,
                        policy: Policy = FP32, input_s2d: bool = False,
                        input_offset: int = 0, input_s4d: bool = False):
    """images: [B, C, H, W] in [-1, 1] -> score logits [B, 1]
    (reference stylegan2/models.py:1193-1230).

    input_s4d / input_s2d: `images` is the packed NHWC image of
    synthesis_apply(output_s2d=True) (s4d, or s2d at lattice `input_offset`),
    and the levels at resolution >= cfg.s2d_min_res run in the s2d domain:
    fromRGB and conv0 on phase-composed kernels (conv0 between opposite
    lattices through s2d_conv2x2), the down convs folding FIR and stride
    into one conv. Those folds read D's raw fp32 weights and round once."""
    taps = tuple(cfg.filter_taps)
    res_scale = 1.0 / math.sqrt(2.0)
    fr = params["from_rgb"]
    if input_s4d:
        # fromRGB folds s4d(0) -> s2d at the offset the conv0 chain wants
        x = policy.cast_compute(images)  # [B, H/4, W/4, 16*data_ch]
        res = 4 * images.shape[1]
        x_off = -1 if (cfg.s2d_offsets and res >= cfg.s2d_min_res) else 0
        x = s2d_ops.s2d_from_s4d_conv1x1(x, fr["w"], out_off=x_off)
        x = bias_act(x, s2d_ops.tile_channels(policy.cast_compute(fr["b"])),
                     act="lrelu")
        if x_off:
            x = s2d_ops.mask_phantoms_(x)
        x_s2d = True
    elif input_s2d:
        x = policy.cast_compute(images)  # NHWC s2d
        x_off = input_offset
        res = s2d_ops.phys_size(images.shape[1], x_off)
        x_s2d = True
        if cfg.s2d_offsets and x_off == 0 and res >= cfg.s2d_min_res:
            # the offset chain wants the first conv0 input at lattice -1
            x = s2d_ops.shift_to_m1(x)
            x_off = -1
        x = s2d_ops.s2d_conv2d(x, fr["w"], x_off, x_off)
        x = bias_act(x, s2d_ops.tile_channels(policy.cast_compute(fr["b"])),
                     act="lrelu")
        if x_off:
            x = s2d_ops.mask_phantoms_(x)
    else:
        x = policy.cast_compute(images.permute(0, 2, 3, 1))  # NHWC
        res = images.shape[2]
        x_off = 0
        x_s2d = False
        x = conv2d(x, policy.cast_compute(fr["w"]))
        x = bias_act(x, policy.cast_compute(fr["b"]), act="lrelu")

    for bp in params["blocks"]:
        use_s2d = x_s2d and _s2d_supported(cfg) and res >= cfg.s2d_min_res
        if x_s2d and not use_s2d:
            x = s2d_ops.un_s2d_off(x, x_off)
            x_s2d, x_off = False, 0
        inp = x
        if use_s2d:
            next_s2d = _s2d_supported(cfg) and res // 2 >= cfg.s2d_min_res
            next_off = -1 if (next_s2d and cfg.s2d_offsets) else 0
            x = s2d_ops.s2d_conv2d(x, bp["conv0"]["w"], x_off, 0)
            x = bias_act(x, s2d_ops.tile_channels(
                policy.cast_compute(bp["conv0"]["b"])), act="lrelu")
            x = s2d_ops.s2d_conv2d_down(x, bp["conv1"]["w"], filter_taps=taps,
                                        output_s2d=next_s2d, in_off=0,
                                        out_off=next_off)
            b1 = policy.cast_compute(bp["conv1"]["b"])
            x = bias_act(x, s2d_ops.tile_channels(b1) if next_s2d else b1,
                         act="lrelu")
            proj = s2d_ops.s2d_conv2d_down(inp, bp["skip"]["w"], filter_taps=taps,
                                           output_s2d=next_s2d, in_off=x_off,
                                           out_off=next_off)
            x = (x + proj) * res_scale
            if next_off:
                x = s2d_ops.mask_phantoms_(x)
            x_s2d, x_off = next_s2d, next_off
            res //= 2
            continue
        x = conv2d(x, policy.cast_compute(bp["conv0"]["w"]))
        x = bias_act(x, policy.cast_compute(bp["conv0"]["b"]), act="lrelu")
        x = conv2d_down(x, policy.cast_compute(bp["conv1"]["w"]), filter_taps=taps)
        x = bias_act(x, policy.cast_compute(bp["conv1"]["b"]), act="lrelu")
        proj = conv2d_down(inp, policy.cast_compute(bp["skip"]["w"]),
                           filter_taps=taps)
        x = (x + proj) * res_scale
        res //= 2

    if x_s2d:  # the s2d cutoff reached the base block: plain for the head
        x = s2d_ops.un_s2d_off(x, x_off)
    if cfg.mbstd_group_size:
        x = minibatch_std(x, cfg.mbstd_group_size, cfg.eps)
    x = conv2d(x, policy.cast_compute(params["final_conv"]["w"]))
    x = bias_act(x, policy.cast_compute(params["final_conv"]["b"]), act="lrelu")
    # flatten in the reference's NCHW order (stylegan2/models.py:1224)
    x = x.permute(0, 3, 1, 2).reshape(x.shape[0], -1)
    x = x @ policy.cast_compute(params["dense0"]["w"])
    x = bias_act(x, policy.cast_compute(params["dense0"]["b"]), act="lrelu")
    x = x @ policy.cast_compute(params["dense1"]["w"])
    return bias_act(x, policy.cast_compute(params["dense1"]["b"]), act="linear")
