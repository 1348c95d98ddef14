"""Analytic model FLOPs of the fitness pipelines: the port's copy of the
JAX package's count (clip_glass_tpu/core/flops.py), read from the port's own
config objects and equal to it for every config (tests/test_torch_flops.py).

It counts the algorithmic work of the reference-defined computation: matmul
and conv MACs x 2, at the reference's own operation inventory (plain dense
convolutions, no s2d fold redundancy, BigGAN's conv_to_rgb at its 3 live
output channels). So MFU = model FLOPs x candidates/s / the card's peak
credits useful work only: the execution domain's overheads (the s2d folds'
redundancy, FIR composites, layout copies) count against utilization, never
for it.

Elementwise work (bias, activation, norms, noise, resize taps) is O(HWC)
against the convs' O(HWC·k²C) and is not counted; neither is the
evolutionary engine (O(pop²·n_var) a generation).

bench_torch.py reports FLOPs a candidate and MFU from it. Reference op
inventories: stylegan2/modules.py:920-967 (modulated conv),
clip/model.py:218-320 (towers), gpt2/model.py:45-95, and the
pytorch_pretrained_biggan architecture (models/biggan/model.py docstrings).
"""

from __future__ import annotations

from typing import Optional

# Dense bf16 tensor-core peak FLOP/s by `torch.cuda.get_device_name()`
# (NVIDIA's H100 data sheet, without sparsity): the SXM part, which names
# itself "NVIDIA H100 80GB HBM3", 989.4 TFLOP/s; the PCIe part 756; the NVL
# part 835. These rates assume the card's full power limit. Other cards: None.
CHIP_PEAK_FLOPS = (
    ("h100 nvl", 835e12),
    ("h100 pcie", 756e12),
    ("h100 80gb hbm3", 989.4e12),
)


def chip_peak_flops(device_name: str) -> Optional[float]:
    """The card's dense bf16 peak, or None for a card not in the table (and
    for "cpu")."""
    name = device_name.lower()
    for sub, peak in CHIP_PEAK_FLOPS:
        if sub in name:
            return peak
    return None


def _conv(h, w, cin, cout, k=3):
    return 2 * h * w * cin * cout * k * k


def _dense(i, o):
    return 2 * i * o


# ------------------------------------------------------------- StyleGAN2

def stylegan2_generator_flops(cfg) -> int:
    """Per-candidate G FLOPs: mapping + modulated synthesis + ToRGB skips
    (reference stylegan2/models.py:326-482, 969-1014)."""
    d = cfg.latent_size
    total = cfg.mapping_layers * _dense(d, d)  # mapping MLP
    res = cfg.base_size
    for in_ch, out_ch, up, n_layers in cfg.block_channels():
        if up:
            res *= 2
        for li in range(n_layers):
            cin = in_ch if li == 0 else out_ch
            total += _dense(d, cin)                       # style projection
            total += 2 * cfg.kernel_size ** 2 * cin * out_ch  # demodulation
            total += _conv(res, res, cin, out_ch, cfg.kernel_size)
        # ToRGB 1x1 (modulated, no demod) + style
        total += _dense(d, out_ch) + _conv(res, res, out_ch,
                                           cfg.data_channels, 1)
        # skip-accumulator FIR upsample (depthwise, data channels)
        t = len(cfg.filter_taps)
        total += 2 * res * res * cfg.data_channels * t * t
    return total


def stylegan2_discriminator_flops(cfg) -> int:
    """Per-candidate D FLOPs (reference stylegan2/models.py:1193-1230)."""
    ch = list(cfg.channels)
    res = cfg.resolution
    total = _conv(res, res, cfg.data_channels, ch[0], 1)  # fromRGB
    t = len(cfg.filter_taps)
    for i in range(len(ch) - 1):
        cin, cout = ch[i], ch[i + 1]
        total += _conv(res, res, cin, cin, cfg.kernel_size)       # conv0
        total += _conv(res // 2, res // 2, cin, cout,
                       cfg.kernel_size)                            # conv1 down
        total += _conv(res // 2, res // 2, cin, cout, 1)           # skip 1x1
        # two FIR passes (conv1-down pre-filter + skip pre-filter), depthwise
        total += 2 * 2 * res * res * cin * t * t
        res //= 2
    cin = ch[-1] + (1 if cfg.mbstd_group_size else 0)
    total += _conv(res, res, cin, ch[-1], cfg.kernel_size)         # final
    total += _dense(ch[-1] * res * res, ch[-1]) + _dense(ch[-1],
                                                         max(cfg.label_size, 1))
    return total


# ------------------------------------------------------------------ CLIP

def clip_image_flops(cfg) -> int:
    """Per-image visual-tower FLOPs: ViT (reference clip/model.py:196-235)
    or ModifiedResNet when cfg.vision_kind == 'rn' (clip/model.py:94-149)."""
    if getattr(cfg, "vision_kind", "vit") == "rn":
        return _clip_rn_image_flops(cfg)
    p = cfg.vision_patch_size
    g = cfg.image_resolution // p
    seq = g * g + 1
    w = cfg.vision_width
    total = _conv(g, g, 3 * p * p, w, 1)                  # patch embed
    total += cfg.vision_layers * _transformer_layer(seq, w)
    total += _dense(w, cfg.embed_dim)                     # projection
    return total


def _clip_rn_image_flops(cfg) -> int:
    """ModifiedResNet tower (models/clip/resnet.py; reference
    clip/model.py:94-149): 3-conv stem, four bottleneck stages with
    avgpool-before-stride, attention pooling head."""
    w = cfg.vision_width
    r = cfg.image_resolution // 2                     # stem conv1 stride 2
    total = _conv(r, r, 3, w // 2, 3)                 # stem conv1
    total += _conv(r, r, w // 2, w // 2, 3)           # stem conv2
    total += _conv(r, r, w // 2, w, 3)                # stem conv3
    r //= 2                                           # stem avgpool 2
    inplanes = w
    for blocks, planes, stride in zip(cfg.vision_layers,
                                      (w, 2 * w, 4 * w, 8 * w), (1, 2, 2, 2)):
        for b in range(blocks):
            s = stride if b == 0 else 1
            ro = r // s
            total += _conv(r, r, inplanes, planes, 1)      # conv1 1x1
            total += _conv(r, r, planes, planes, 3)        # conv2 3x3
            total += _conv(ro, ro, planes, planes * 4, 1)  # conv3 (post-pool)
            if s > 1 or inplanes != planes * 4:
                total += _conv(ro, ro, inplanes, planes * 4, 1)  # downsample
            inplanes = planes * 4
            r = ro
    # attention pooling: only token 0's output is live (resnet.py returns
    # out[:, 0]; the reference likewise keeps x[0], clip/model.py:88-91), so
    # by this module's discarded-work-is-not-model-work rule the live
    # algorithmic work is q/c_proj for ONE query token, k/v for all S+1
    # keys, and one query row of QK^T/AV. (The implementation executes the
    # full MHA like the reference — the difference counts against
    # utilization, never for it.)
    seq = r * r + 1
    ed = inplanes  # embed_dim = width * 32
    total += _dense(ed, ed) + 2 * seq * _dense(ed, ed)   # q (1 tok) + k,v
    total += 2 * 2 * seq * ed                            # QK^T + AV, 1 query
    total += _dense(ed, cfg.embed_dim)                   # c_proj, 1 token
    return total


def clip_text_flops(cfg) -> int:
    """Per-text FLOPs at full padded context (reference clip/model.py:307-320
    always runs the full 77-token context)."""
    seq = cfg.context_length
    w = cfg.transformer_width
    total = cfg.transformer_layers * _transformer_layer(seq, w)
    total += _dense(w, cfg.embed_dim)
    return total


def _transformer_layer(seq, width, mlp_ratio=4):
    attn = 4 * seq * _dense(width, width)          # q,k,v,o projections
    attn += 2 * 2 * seq * seq * width              # QK^T + AV
    mlp = 2 * seq * _dense(width, mlp_ratio * width)
    return attn + mlp


# ---------------------------------------------------------------- BigGAN

def biggan_flops(cfg) -> int:
    """Per-candidate BigGAN-deep FLOPs. conv_to_rgb counts its 3 LIVE
    output channels (the reference computes ch and discards all but 3 —
    models/biggan/model.py conv_to_rgb docstring — discarded work is not
    model work)."""
    ch = cfg.channel_width
    cond = cfg.cond_dim
    total = _dense(cfg.num_classes, cfg.z_dim)            # class embedding
    first = cfg.layers[0][1] * ch
    total += _dense(cond, 16 * first)                     # gen_z
    res = 4
    for i, (up, im, om) in enumerate(cfg.layers):
        if i == cfg.attention_layer_position:
            c = im * ch
            # theta/phi/g/o_conv 1x1s + the two attention matmuls
            total += _conv(res, res, c, c // 8, 1) * 2
            total += _conv(res, res, c, c // 2, 1)
            total += _conv(res, res, c // 2, c, 1)
            n, m = res * res, res * res // 4
            total += 2 * n * m * (c // 8) + 2 * n * m * (c // 2)
        i_ch, o_ch, m_ch = im * ch, om * ch, im * ch // 4
        for c in (i_ch, m_ch, m_ch, m_ch):                # 4 cond BN pairs
            total += 2 * _dense(cond, c)
        total += _conv(res, res, i_ch, m_ch, 1)           # conv_0
        if up:
            res *= 2
        total += 2 * _conv(res, res, m_ch, m_ch, 3)       # conv_1, conv_2
        total += _conv(res, res, m_ch, o_ch, 1)           # conv_3
    total += _conv(res, res, cfg.layers[-1][2] * ch, 3, 3)  # conv_to_rgb[:3]
    return total


# ----------------------------------------------------------------- GPT-2

def gpt2_decode_flops(cfg, context_len: int, gen_len: int) -> int:
    """Per-candidate decode FLOPs: prefill over `context_len` tokens +
    `gen_len` single-token steps against the KV cache, tied-head logits on
    each sampled position (reference gpt2/sample.py:21-36)."""
    w = cfg.n_embd
    per_tok = cfg.n_layer * (4 * _dense(w, w) + 2 * _dense(w, 4 * w))
    total_positions = context_len + gen_len
    total = total_positions * per_tok
    # attention scores/values: position t attends to t keys
    attended = total_positions * (total_positions + 1) // 2
    total += cfg.n_layer * 2 * 2 * attended * w
    # logits head on the last prefill position + every decode step
    total += (1 + gen_len) * _dense(w, cfg.vocab_size)
    return total


# ------------------------------------------------------------- dispatch

def fitness_flops_per_candidate(config, model_cfg, clip_cfg) -> int:
    """Model FLOPs to score ONE candidate under `config` (the work of
    reference problem.py:14-29 per population row)."""
    if config.model == "stylegan2":
        total = stylegan2_generator_flops(model_cfg)
        total += clip_image_flops(clip_cfg)
        if config.use_discriminator:
            total += stylegan2_discriminator_flops(model_cfg)
        return total
    if config.model == "biggan":
        return biggan_flops(model_cfg) + clip_image_flops(clip_cfg)
    if config.model == "gpt2":
        ctx = config.n_var + 3  # genome tokens + "the picture of"
        total = gpt2_decode_flops(model_cfg, ctx, config.max_tokens_len)
        total += clip_text_flops(clip_cfg)
        return total
    raise ValueError(f"unknown model family {config.model!r}")
