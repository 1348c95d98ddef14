"""The port's FLOP count (clip_glass_torch/core/flops.py) against the JAX
package's (clip_glass_tpu/core/flops.py): integers, so exactly equal, each
package reading its own config objects; and the card's peak table."""

import dataclasses

import pytest

from clip_glass_tpu import config as jconfig
from clip_glass_tpu.core import flops as jflops
from clip_glass_tpu.models.biggan import model as jbg
from clip_glass_tpu.models.clip import model as jclip
from clip_glass_tpu.models.gpt2 import model as jg2
from clip_glass_tpu.models.stylegan2 import model as jsg2

from clip_glass_torch import config as tconfig
from clip_glass_torch.core import flops as tflops
from clip_glass_torch.models.biggan import model as tbg
from clip_glass_torch.models.clip import model as tclip
from clip_glass_torch.models.gpt2 import model as tg2
from clip_glass_torch.models.stylegan2 import model as tsg2

CONFIGS = tconfig.list_configs()


def _model_cfgs(config, jax_pkg: bool):
    """The model config the fitness runs at full size for `config`."""
    sg2, bg, g2 = (jsg2, jbg, jg2) if jax_pkg else (tsg2, tbg, tg2)
    if config.model == "stylegan2":
        return sg2.CONFIG_F
    if config.model == "biggan":
        return bg.CONFIGS[f"biggan-deep-{config.resolution}"]
    return g2.GPT2_124M


def test_nine_configs():
    assert len(CONFIGS) == 9 and CONFIGS == jconfig.list_configs()


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("clip_name", ["VIT_B_32", "RN50"])
def test_fitness_flops_per_candidate_equals_jax(name, clip_name):
    tcfg, jcfg = tconfig.get_config(name), jconfig.get_config(name)
    got = tflops.fitness_flops_per_candidate(tcfg, _model_cfgs(tcfg, False),
                                             getattr(tclip, clip_name))
    want = jflops.fitness_flops_per_candidate(jcfg, _model_cfgs(jcfg, True),
                                              getattr(jclip, clip_name))
    assert isinstance(got, int) and got == want > 0


def test_flagship_count():
    """G 109.88 + D 66.35 + ViT-B/32 8.82 GFLOP a candidate."""
    got = tflops.fitness_flops_per_candidate(tconfig.get_config("StyleGAN2_ffhq_d"),
                                             tsg2.CONFIG_F, tclip.VIT_B_32)
    assert round(got / 1e9, 2) == 185.05


# (function name, the port's configs, the JAX package's configs, extra args)
PER_MODEL = [
    ("stylegan2_generator_flops", [tsg2.CONFIG_F, tsg2.TINY], [jsg2.CONFIG_F, jsg2.TINY], ()),
    ("stylegan2_discriminator_flops", [tsg2.CONFIG_F, tsg2.TINY],
     [jsg2.CONFIG_F, jsg2.TINY], ()),
    ("clip_image_flops", [tclip.VIT_B_32, tclip.RN50, tclip.TINY],
     [jclip.VIT_B_32, jclip.RN50, jclip.TINY], ()),
    ("clip_text_flops", [tclip.VIT_B_32, tclip.TINY], [jclip.VIT_B_32, jclip.TINY], ()),
    ("biggan_flops", [tbg.BIGGAN_DEEP_256, tbg.BIGGAN_DEEP_512, tbg.TINY],
     [jbg.BIGGAN_DEEP_256, jbg.BIGGAN_DEEP_512, jbg.TINY], ()),
    ("gpt2_decode_flops", [tg2.GPT2_124M, tg2.TINY], [jg2.GPT2_124M, jg2.TINY], (23, 30)),
]


@pytest.mark.parametrize("fn,tcfgs,jcfgs,extra", PER_MODEL, ids=[c[0] for c in PER_MODEL])
def test_per_model_counts_equal_jax_full_size_and_tiny(fn, tcfgs, jcfgs, extra):
    for tcfg, jcfg in zip(tcfgs, jcfgs):
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
        got, want = getattr(tflops, fn)(tcfg, *extra), getattr(jflops, fn)(jcfg, *extra)
        assert got == want > 0, (fn, tcfg)


@pytest.mark.parametrize("name,peak", [("NVIDIA H100 80GB HBM3", 989.4e12),
                                       ("NVIDIA H100 PCIe", 756e12),
                                       ("NVIDIA H100 NVL", 835e12),
                                       ("cpu", None), ("NVIDIA A100-SXM4-80GB", None)])
def test_chip_peak_flops(name, peak):
    assert tflops.chip_peak_flops(name) == peak


def test_no_tpu_peak_in_the_port():
    assert tflops.chip_peak_flops("TPU v5 lite") is None
    assert all("h100" in sub for sub, _ in tflops.CHIP_PEAK_FLOPS)
