"""Model FLOPs a candidate, frozen here so that the program cannot move the
yardstick: a copy of the port's analytic count (`core/flops.py` as it
stood when the benchmark was written), read from the config file's
geometry groups instead of the port's config objects; each model family
(benchmark/families/) sums its models' counts.

It counts the reference-defined computation: matmul and conv MACs x 2 at
the reference's own inventory (plain dense convs, no space-to-depth fold
redundancy, BigGAN's conv_to_rgb at its 3 live channels, GPT-2's decode at
the positions and logits it needs: `gpt2_decode`). Elementwise work
and the evolutionary engine are not counted. So `step.mfu` credits useful
work only.
"""

from __future__ import annotations


def _conv(h, w, cin, cout, k=3):
    return 2 * h * w * cin * cout * k * k


def _dense(i, o):
    return 2 * i * o


def _sg2_blocks(g: dict):
    ch = list(g["channels"])
    return [(ch[-1], ch[-1], False, 1)] + [(ch[-i], ch[-i - 1], True, g["conv_block_size"])
                                            for i in range(1, len(ch))]


def stylegan2_generator(g: dict) -> int:
    d = g["latent_size"]
    k = g["kernel_size"]
    total = g["mapping_layers"] * _dense(d, d)
    res = g["base_size"]
    t = len(g["filter_taps"])
    for in_ch, out_ch, up, n_layers in _sg2_blocks(g):
        if up:
            res *= 2
        for li in range(n_layers):
            cin = in_ch if li == 0 else out_ch
            total += _dense(d, cin)
            total += 2 * k ** 2 * cin * out_ch
            total += _conv(res, res, cin, out_ch, k)
        total += _dense(d, out_ch) + _conv(res, res, out_ch, g["data_channels"], 1)
        total += 2 * res * res * g["data_channels"] * t * t
    return total


def stylegan2_discriminator(g: dict) -> int:
    ch = list(g["channels"])
    k = g["kernel_size"]
    res = g["base_size"] * 2 ** (len(ch) - 1)
    total = _conv(res, res, g["data_channels"], ch[0], 1)
    t = len(g["filter_taps"])
    for i in range(len(ch) - 1):
        cin, cout = ch[i], ch[i + 1]
        total += _conv(res, res, cin, cin, k)
        total += _conv(res // 2, res // 2, cin, cout, k)
        total += _conv(res // 2, res // 2, cin, cout, 1)
        total += 2 * 2 * res * res * cin * t * t
        res //= 2
    cin = ch[-1] + (1 if g["mbstd_group_size"] else 0)
    total += _conv(res, res, cin, ch[-1], k)
    total += _dense(ch[-1] * res * res, ch[-1]) + _dense(ch[-1], max(g.get("label_size", 0), 1))
    return total


def _transformer_layer(seq, width, mlp_ratio=4):
    attn = 4 * seq * _dense(width, width)
    attn += 2 * 2 * seq * seq * width
    mlp = 2 * seq * _dense(width, mlp_ratio * width)
    return attn + mlp


def clip_image(c: dict) -> int:
    p = c["vision_patch_size"]
    grid = c["image_resolution"] // p
    seq = grid * grid + 1
    w = c["vision_width"]
    total = _conv(grid, grid, 3 * p * p, w, 1)
    total += c["vision_layers"] * _transformer_layer(seq, w)
    return total + _dense(w, c["embed_dim"])


def biggan(b: dict) -> int:
    ch = b["channel_width"]
    cond = 2 * b["z_dim"]
    total = _dense(b["num_classes"], b["z_dim"])
    total += _dense(cond, 16 * b["layers"][0][1] * ch)
    res = 4
    for i, (up, im, om) in enumerate(b["layers"]):
        if i == b["attention_layer_position"]:
            c = im * ch
            total += _conv(res, res, c, c // 8, 1) * 2
            total += _conv(res, res, c, c // 2, 1)
            total += _conv(res, res, c // 2, c, 1)
            n, m = res * res, res * res // 4
            total += 2 * n * m * (c // 8) + 2 * n * m * (c // 2)
        i_ch, o_ch, m_ch = im * ch, om * ch, im * ch // 4
        for c in (i_ch, m_ch, m_ch, m_ch):
            total += 2 * _dense(cond, c)
        total += _conv(res, res, i_ch, m_ch, 1)
        if up:
            res *= 2
        total += 2 * _conv(res, res, m_ch, m_ch, 3)
        total += _conv(res, res, m_ch, o_ch, 1)
    return total + _conv(res, res, b["layers"][-1][2] * ch, 3, 3)


def clip_text(c: dict) -> int:
    """CLIP's text tower on one text, at the full 77-token context that it
    always runs."""
    w = c["transformer_width"]
    return (c["transformer_layers"] * _transformer_layer(c["context_length"], w)
            + _dense(w, c["embed_dim"]))


def gpt2_decode(g: dict, context_len: int, steps: int) -> int:
    """GPT-2's argmax decode of `steps` tokens after a context of
    `context_len`: the blocks at every position but the last decoded one,
    which is never fed back (position t attends to t keys), and the tied
    head at each position that picks a token. The port's own count
    (`core/flops.gpt2_decode_flops`) adds one position and one head."""
    w = g["n_embd"]
    positions = context_len + steps - 1
    total = positions * g["n_layer"] * (4 * _dense(w, w) + 2 * _dense(w, 4 * w))
    total += g["n_layer"] * 2 * 2 * (positions * (positions + 1) // 2) * w
    return total + steps * _dense(w, g["vocab_size"])
