"""The plain reference against the port at small widths on the CPU, both in
float32 and given the same tensors: the tokenizer, CLIP's towers, StyleGAN2's
G and D (the port's s2d path at the top levels), BigGAN-deep's G (its s2d
mid segments), and the draw, which saturates neither image nor logit."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from benchmark.harness import weights
from benchmark.families import replace_fields
from benchmark.harness.cell import make_weights
from benchmark.reference import biggan as ref_biggan
from benchmark.reference import clip as ref_clip
from benchmark.reference import stylegan2 as ref_sg2
from benchmark.reference.numerics import fp32_exact
from benchmark.reference.tokenizer import tokenize
from benchmark.tests import tiny
from benchmark.tests.helpers import SEED

CPU = torch.device("cpu")
PROMPTS = ["a red flower", "the face of a man with brown eyes", "a dog, 2 cats & 13 birds!",
           "  An   OLD house's door at night  "]


def _close(a, b, tol=1e-4):
    scale = b.abs().max().clamp_min(1e-6)
    assert ((a - b).abs().max() / scale).item() < tol


def test_tokenizer_matches_the_port():
    from clip_glass_torch.tokenizers import tokenize as port_tokenize

    assert (tokenize(PROMPTS) == port_tokenize(PROMPTS)).all()


def test_clip_towers_match_the_port():
    from clip_glass_torch.models.clip import model as clip_model

    w = make_weights(tiny.SG2, SEED, CPU)["clip"]
    cfg = replace_fields(clip_model.VIT_B_32, tiny.CLIP)
    imgs = torch.rand(3, 3, 32, 32, generator=torch.Generator().manual_seed(1))
    ids = torch.as_tensor(tokenize(PROMPTS))
    with fp32_exact():
        _close(ref_clip.encode_image(w, imgs, tiny.CLIP), clip_model.encode_image(w, imgs, cfg))
        _close(ref_clip.encode_text(w, ids, tiny.CLIP), clip_model.encode_text(w, ids, cfg))


@pytest.mark.parametrize("s2d_min_res", [16, 2 ** 30])
def test_stylegan2_g_and_d_match_the_port(s2d_min_res):
    from clip_glass_torch.models.stylegan2 import model as sg2

    w = make_weights(tiny.SG2, SEED, CPU)
    cfg = dataclasses.replace(replace_fields(sg2.CONFIG_F, tiny.SG2["stylegan2"]),
                              s2d_min_res=s2d_min_res)
    z = torch.randn(8, 32, generator=torch.Generator().manual_seed(2))
    geo = tiny.SG2["stylegan2"]
    with fp32_exact():
        img = ref_sg2.generate(w["g"], z, geo, w["noise"])
        _close(img, sg2.generator_apply(w["g"], z, cfg, noise=w["noise"]))
        x = img.clamp(-1, 1)
        _close(ref_sg2.discriminator(w["d"], x, geo), sg2.discriminator_apply(w["d"], x, cfg)[:, 0])


@pytest.mark.parametrize("s2d_min_res", [8, 2 ** 30])
def test_biggan_g_matches_the_port(s2d_min_res):
    from clip_glass_torch.models.biggan import model as bg

    geo = tiny.BIGGAN["biggan"]
    w = make_weights(tiny.BIGGAN, SEED, CPU)["g"]
    cfg = dataclasses.replace(replace_fields(bg.BIGGAN_DEEP_512, geo), s2d_min_res=s2d_min_res)
    gen = torch.Generator().manual_seed(3)
    z = torch.randn(4, 16, generator=gen).clamp(-2, 2)
    cv = torch.softmax(torch.randn(4, 10, generator=gen), dim=1)
    with fp32_exact():
        _close(ref_biggan.generate(w, z, cv, geo), bg.apply(w, z, cv, 1.0, cfg))


def test_standing_stats_normalize_every_batch_norm():
    geo = tiny.BIGGAN["biggan"]
    w = make_weights(tiny.BIGGAN, SEED, CPU)["g"]
    norms = [e["block"][f"bn_{i}"] for e in w["blocks"] if "block" in e for i in range(4)]
    for bn in norms + [w["bn"]]:
        assert (bn["running_vars"] > 0).all()
        assert torch.equal(bn["running_vars"][0], bn["running_vars"][-1])
    assert len(norms) == 4 * len(geo["layers"])


def test_the_to_rgb_scaling_gives_g_the_stated_image_std():
    geo = tiny.SG2["stylegan2"]
    spec = weights.stylegan2_spec(geo, tiny.SG2["assumed"])
    g = weights.materialize(spec["g"], torch.Generator().manual_seed(6))
    noise = weights.materialize(spec["noise"], torch.Generator().manual_seed(6))
    before = weights.scale_to_rgb(g, noise, geo, torch.Generator().manual_seed(7), 4, 0.5)
    z = torch.randn((4, geo["latent_size"]), generator=torch.Generator().manual_seed(7))
    with fp32_exact():
        after = ref_sg2.generate(g, z, geo, noise).std().item()
    assert before != pytest.approx(0.5, rel=0.05)
    assert after == pytest.approx(0.5, rel=1e-5)


def test_the_draw_saturates_neither_image_nor_logit():
    from benchmark.harness import check

    for cfg in (tiny.SG2, tiny.BIGGAN):
        w = make_weights(cfg, SEED, CPU)
        X = torch.randn(1, 8, cfg["search"]["n_var"], generator=torch.Generator().manual_seed(4))
        out = check.reference_fitness(cfg, w, X, PROMPTS[:1], 8)
        assert not check.saturated(out["clip_share"].item(),
                                   None if out["logit_max"] is None else out["logit_max"].item())
        assert torch.isfinite(out["F"]).all()
