"""The plain reference against the port at small widths on the CPU, both in
float32 and given the same tensors: the tokenizer (on prompts and on
decoded captions of any script), CLIP's towers and image preprocessing,
StyleGAN2's G and D (the port's s2d path at the top levels), BigGAN-deep's
G (its s2d mid segments), GPT-2's logits, decode and captions, and the
draw, which saturates neither image nor logit."""

from __future__ import annotations

import dataclasses
import random
import tempfile

import pytest
import torch

from benchmark.harness import images, weights
from benchmark.families import replace_fields
from benchmark.harness.cell import make_weights
from benchmark.reference import biggan as ref_biggan
from benchmark.reference import clip as ref_clip
from benchmark.reference import gpt2 as ref_gpt2
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


def test_tokenizer_matches_the_port_on_decoded_captions():
    """Captions of random GPT-2 ids, any script, cut at 50 characters."""
    import numpy as np

    from clip_glass_torch.tokenizers import get_gpt2_tokenizer
    from clip_glass_torch.tokenizers import tokenize as port_tokenize

    enc, rng = get_gpt2_tokenizer(), np.random.default_rng(5)
    texts = [enc.decode(rng.integers(0, 50257, size=rng.integers(1, 12)).tolist())[:50]
             for _ in range(600)]
    texts += ["caf\u00c3\u00a9 &amp;amp; \u2019s x\u00b2 \u00bd \u0130 \ufb01",
              "a\x1c b\u3000c  \t d", "<|endoftext|>'s 's'S"]
    assert sum(not t.isascii() for t in texts) > 20
    for t in texts:
        try:
            want = port_tokenize([t])
        except RuntimeError:
            with pytest.raises(ValueError):
                tokenize([t])
            continue
        assert (tokenize([t]) == want).all(), repr(t)


def test_the_pattern_reads_a_special_token_as_the_published_regex_does():
    """`regex.findall` of CLIP's pattern (`simple_tokenizer.py`) takes a run
    of other characters whole, a special token's text in it included; the
    port's scanner breaks the run where the special begins (PERF.md)."""
    from benchmark.reference.tokenizer import _pieces

    assert _pieces("!<|endoftext|> 's's") == ["!<|", "endoftext", "|>", "'s", "'s"]
    assert _pieces("<|endoftext|>x2") == ["<|endoftext|>", "x", "2"]


def test_clip_preprocessing_matches_the_port(tmp_path):
    from PIL import Image

    from clip_glass_torch.ops.resize import clip_preprocess_pil

    (path,) = images.draw(random.Random(3), 1, 32, tmp_path)
    with Image.open(path) as im:
        want = torch.from_numpy(clip_preprocess_pil(im, 32))
    # the port normalizes in float64, the reference in float32: one rounding
    assert (ref_clip.preprocess(path, 32) - want).abs().max().item() < 1e-6


def _gpt2(seed=SEED):
    from clip_glass_torch.models.gpt2 import model as g2

    cfg = replace_fields(g2.GPT2_124M, tiny.GPT2["gpt2"])
    return g2, cfg, make_weights(tiny.GPT2, seed, CPU)["g"]


def test_gpt2_spec_lays_out_the_ports_tree():
    g2, cfg, w = _gpt2()
    port = g2.init(torch.Generator().manual_seed(0), cfg)

    def shapes(t):
        if isinstance(t, torch.Tensor):
            return tuple(t.shape)
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        return [shapes(v) for v in t]

    assert shapes(w) == shapes(port)
    big = weights.gpt2_spec({**tiny.GPT2["gpt2"], "n_layer": 12}, tiny.GPT2["assumed"])
    assert big["blocks"][0]["mlp"]["c_proj_w"].std == pytest.approx(0.02 / 24 ** 0.5)
    assert big["blocks"][0]["attn"]["c_attn_w"].std == 0.02 == big["wte"].std


def test_gpt2_logits_match_the_port():
    """Teacher-forced logits of the reference against the port's forward,
    float32, within 1e-4 of the largest logit (summation order alone)."""
    g2, cfg, w = _gpt2()
    ids = torch.randint(0, 50257, (4, 40), generator=torch.Generator().manual_seed(8))
    with fp32_exact():
        want, _ = g2.forward(w, ids, cfg)
        got = ref_gpt2.head(w, ref_gpt2.hidden(w, ids, tiny.GPT2["gpt2"]))
    _close(got, want)


def test_gpt2_decode_agrees_with_the_port_where_no_near_tie_is():
    """The port's cached argmax decode and the reference's uncached one:
    every port token within rounding of the reference's best, and the same
    ids in every row whose steps all have a clear best."""
    g2, cfg, w = _gpt2()
    geo = tiny.GPT2["gpt2"]
    context = torch.randint(0, 50257, (8, 23), generator=torch.Generator().manual_seed(9))
    with fp32_exact():
        port = g2.sample_sequence(w, context, 30, cfg).long()
        ref = ref_gpt2.decode(w, context, 30, geo)
        margin = ref_gpt2.margins(w, port, 23, geo)
        logits = ref_gpt2.head(w, ref_gpt2.hidden(w, ref[:, :-1], geo)[:, 22:])
    assert margin.abs().max().item() < 1e-4
    top2 = logits.topk(2, dim=-1).values
    clear = ((top2[..., 0] - top2[..., 1]) / logits.std(-1) > 1e-3).all(-1)
    assert clear.sum() >= 4
    assert torch.equal(port[clear], ref[clear])


def test_gpt2_captions_and_init_ids_match_the_port():
    from types import SimpleNamespace

    from clip_glass_torch.config import get_config
    from clip_glass_torch.fitness.generator import Generator
    from clip_glass_torch.tokenizers import get_gpt2_tokenizer

    cfg = get_config("GPT2")
    assert ref_gpt2.encode(cfg.init_text) == get_gpt2_tokenizer().encode(cfg.init_text)
    ids = torch.randint(0, 50257, (64, 53), generator=torch.Generator().manual_seed(10))
    ids[1, 30], ids[2, 5], ids[3, 52] = 50256, 50256, 50256
    want = Generator.decode_texts(SimpleNamespace(config=cfg), ids.numpy())
    assert ref_gpt2.captions(ids, cfg.n_var, cfg.max_text_len) == want
    assert want[2] == ""


def test_the_gpt2_reference_runs_with_tf32_off(monkeypatch):
    """The check runs the GPT-2 reference inside fp32_exact: TF32 off for
    every forward."""
    from benchmark.harness import check

    seen = []
    original = ref_gpt2.hidden

    def hidden(*a, **k):
        seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
                     torch.get_float32_matmul_precision()))
        return original(*a, **k)

    monkeypatch.setattr(ref_gpt2, "hidden", hidden)
    w = make_weights(tiny.GPT2, SEED, CPU)
    X = torch.randint(0, 50257, (1, 4, 20), generator=torch.Generator().manual_seed(11)).float()
    with tempfile.TemporaryDirectory() as d:
        paths = images.draw(random.Random(1), 1, 32, d)
        out = check.reference_fitness(tiny.GPT2, w, X, paths, 4)
    assert seen and all(s == (False, False, "highest") for s in seen)
    assert out["outputs"].shape == (1, 4, 53) and out["clip_share"] is None
    assert torch.isfinite(out["F"]).all()
