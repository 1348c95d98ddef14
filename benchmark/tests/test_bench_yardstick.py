"""The frozen yardsticks equal the port's own functions as they stood when
the benchmark was written, for both configurations."""

from __future__ import annotations

import dataclasses
import json

import torch

from benchmark.families import family
from benchmark.harness.cell import BENCH
from benchmark.yardstick import kernels, peaks


def _config(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def test_flops_per_candidate_match_the_port_for_both_configurations():
    from clip_glass_torch.config import get_config
    from clip_glass_torch.core import flops as port_flops
    from clip_glass_torch.models.biggan import model as bg
    from clip_glass_torch.models.clip import model as clip_model
    from clip_glass_torch.models.stylegan2 import model as sg2

    sg = _config("StyleGAN2_ffhq_d")
    config_f = dataclasses.replace(sg2.CONFIG_F, channels=tuple(sg["stylegan2"]["channels"]))
    assert family(sg).flops_per_candidate(sg) == port_flops.fitness_flops_per_candidate(
        get_config("StyleGAN2_ffhq_d"), config_f, clip_model.VIT_B_32)
    big = _config("DeepMindBigGAN512")
    assert family(big).flops_per_candidate(big) == port_flops.fitness_flops_per_candidate(
        get_config("DeepMindBigGAN512"), bg.BIGGAN_DEEP_512, clip_model.VIT_B_32)


def test_gpt2_flops_are_the_ports_count_less_its_extra_position_and_head():
    """The decode's count (yardstick/flops.py's `gpt2_decode`) runs the blocks
    at 52 positions of the 53 and the head at the 30 that pick a token; the
    port's `gpt2_decode_flops` counts 53 and 31."""
    from benchmark.tests import tiny
    from clip_glass_torch.config import get_config
    from clip_glass_torch.core import flops as port_flops
    from clip_glass_torch.models.clip import model as clip_model
    from clip_glass_torch.models.gpt2 import model as g2

    geo = {"vocab_size": 50257, "n_positions": 1024, "n_embd": 768, "n_layer": 12, "n_head": 12,
           "layer_norm_epsilon": 1e-5}
    clip = _config("StyleGAN2_ffhq_d")["clip"]
    cfg = {**tiny.GPT2, "gpt2": geo, "clip": clip}
    w, n = 768, 53
    extra = 12 * (4 * 2 * w * w + 2 * 2 * w * 4 * w) + 12 * 2 * 2 * n * w + 2 * w * 50257
    assert family(cfg).flops_per_candidate(cfg) + extra == \
        port_flops.fitness_flops_per_candidate(get_config("GPT2"), g2.GPT2_124M,
                                               clip_model.VIT_B_32)


def config_f_channels(resolution: int = 1024) -> list:
    """NVlabs/stylegan2 config-f's feature maps, 1024 px first: nf(stage) =
    min(fmap_base / 2**stage, fmap_max), fmap_base 16 << 10, fmap_max 512,
    stage = log2(resolution) - 1."""
    top = resolution.bit_length() - 1
    return [min((16 << 10) >> (res - 1), 512) for res in range(top, 1, -1)]


def test_configuration_files_state_the_published_geometry():
    """Each file states its registry name's geometry in the port, but for
    StyleGAN2's channels, which are config-f's (the port's CONFIG_F is
    narrower at 64-512 px, and the harness hands config-f's to it)."""
    from clip_glass_torch.config import get_config
    from clip_glass_torch.models.biggan import model as bg
    from clip_glass_torch.models.clip import model as clip_model
    from clip_glass_torch.models.stylegan2 import model as sg2

    def same(group, cfg):
        for k, v in group.items():
            want = getattr(cfg, k)
            got = tuple(tuple(x) if isinstance(x, list) else x for x in v) \
                if isinstance(v, list) else v
            assert got == want, (k, got, want)

    for name, model_cfg, group in (("StyleGAN2_ffhq_d", sg2.CONFIG_F, "stylegan2"),
                                   ("DeepMindBigGAN512", bg.BIGGAN_DEEP_512, "biggan")):
        cfg = _config(name)
        assert cfg["reduced"] == []
        if group == "stylegan2":
            assert cfg[group]["channels"] == config_f_channels() \
                == [32, 64, 128, 256, 512, 512, 512, 512, 512]
            model_cfg = dataclasses.replace(model_cfg, channels=tuple(config_f_channels()))
        same(cfg[group], model_cfg)
        same(cfg["clip"], clip_model.VIT_B_32)
        same(cfg["search"], get_config(name))


def test_peaks_match_the_port_table():
    from clip_glass_torch.core import flops as port_flops

    assert peaks.BF16_FLOPS == port_flops.CHIP_PEAK_FLOPS
    assert peaks.bf16_peak("NVIDIA H100 80GB HBM3") == port_flops.chip_peak_flops(
        "NVIDIA H100 80GB HBM3")


def test_kernel_counts_follow_chip_smoke_and_the_port_operands():
    # kernel 1: chip_smoke's _nbl_cost: x, noise, scale, bias read, the
    # output written; 5 operations a value
    B, H, W, C = 2, 8, 8, 16
    n_bytes, ops, peak = kernels.noise_bias_lrelu((B, H, W, C), 2)
    assert n_bytes == 2 * (2 * B * H * W * C + H * W + 1 + C)
    assert ops == 5 * B * H * W * C and peak == peaks.FP32_FLOPS
    # kernel 4: chip_smoke's _s2d_cost operations; bytes of the operands
    # the kernel reads (x, the folded weight sets the port's
    # conv2x2_weights hands it) and of its output
    from clip_glass_torch.ops import s2d

    n, Cp = 6, 64
    x = torch.zeros(B, n, n, Cp, dtype=torch.bfloat16)
    K = torch.zeros(2, 2, Cp, Cp)
    style = torch.ones(B, Cp)
    for pad0, sty in ((1, style), (0, None)):
        out = s2d.s2d_conv2x2_plain(x, K, sty, sty, pad0)
        sets = B if sty is not None else 1
        n_bytes, ops, peak = kernels.s2d_conv2x2(tuple(x.shape), 2, pad0, sets)
        n_out = out.shape[1]
        assert ops == 2 * B * n_out * n_out * 4 * Cp * Cp
        assert n_bytes == 2 * (x.numel() + sets * 4 * Cp * Cp + out.numel())
        assert peak == peaks.BF16_FLOPS[-1][1]


def test_trace_records_the_operands_the_yardstick_prices():
    from benchmark.harness.trace import _kernel_record

    x = torch.zeros(3, 5, 5, 8, dtype=torch.bfloat16)
    assert _kernel_record("s2d_conv2x2", (x, None, torch.ones(3, 8), None, 1)) == \
        ((3, 5, 5, 8), 2, 1, 3)
    assert _kernel_record("s2d_conv2x2", (x, None, None, None, 0))[-1] == 1
    assert _kernel_record("noise_bias_lrelu", (x,)) == ((3, 5, 5, 8), 2)
