"""clip_glass_torch's BigGAN-deep generator against the JAX package's.

Weights: the JAX package's tree (bg.init) with every leaf redrawn from a
seeded numpy generator (weights at 1/sqrt(fan_in), random running
statistics, biases, BN affines and attention gain), so that no term of the
forward is zero; the port reads the same tree through
weights.from_jax.convert_biggan. Inputs: z and a softmax class vector made
with numpy. fp32 on both sides.

Tolerance: rtol = atol = 2e-4, the JAX package's own s2d tolerance
(tests/test_biggan.py); the two packages differ in summation order only.
Configs: bg.TINY and the 4-block config of
tests/test_biggan.py::test_s2d_interblock_threading_matches_plain (with
attention), in three domains (plain, s2d from 4 px and from 8 px), at
truncation 1.0 (on the statistics' grid) and 0.37 (off it)."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import torch

from clip_glass_tpu.core.dtypes import FP32 as JFP32
from clip_glass_tpu.models.biggan import model as jbg

from clip_glass_torch.core.dtypes import BF16, FP32, precast_params
from clip_glass_torch.evolve import sampling as tsmp
from clip_glass_torch.models.biggan import model as bg
from clip_glass_torch.ops import s2d as S
from clip_glass_torch.weights import from_jax

from torch_parity import N, T

TOL = dict(rtol=2e-4, atol=2e-4)


def _mid4(mod):
    return mod.BigGANConfig(
        z_dim=16, channel_width=8, num_classes=10,
        layers=((False, 2, 2), (True, 2, 2), (False, 2, 1), (True, 1, 1)),
        attention_layer_position=1, output_dim=16)


CONFIGS = {"TINY": (jbg.TINY, bg.TINY), "MID4": (_mid4(jbg), _mid4(bg))}
DOMAINS = {"plain": 2 ** 30, "s2d4": 4, "s2d8": 8}


def random_tree(cfg, seed):
    """The JAX package's tree for `cfg` with every leaf redrawn (numpy)."""
    rng = np.random.default_rng(seed)
    tree = jbg.init(jax.random.PRNGKey(seed), cfg)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        shape = np.shape(leaf)
        if name.endswith("['w']"):
            v = rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))
        elif "running_vars" in name:
            v = rng.uniform(0.5, 1.5, size=shape)
        elif name.endswith("['weight']"):
            v = 1.0 + 0.2 * rng.normal(size=shape)
        else:  # running means, biases, BN bias, attention gamma
            v = 0.3 * rng.normal(size=shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(draw, tree)


def _inputs(cfg, B=3, seed=0):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(B, cfg.z_dim)).astype(np.float32)
    logits = 2.0 * rng.normal(size=(B, cfg.num_classes))
    cv = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)).astype(np.float32)
    return z, cv


@pytest.fixture(scope="module")
def trees():
    return {name: random_tree(jcfg, i + 1) for i, (name, (jcfg, _)) in enumerate(CONFIGS.items())}


@pytest.mark.parametrize("truncation", [1.0, 0.37])
@pytest.mark.parametrize("domain", sorted(DOMAINS))
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_apply_matches_jax(trees, config, domain, truncation):
    jcfg, tcfg = (dataclasses.replace(c, s2d_min_res=DOMAINS[domain])
                  for c in CONFIGS[config])
    tree = trees[config]
    z, cv = _inputs(jcfg)
    want = np.asarray(jbg.apply(jax.tree.map(jnp.asarray, tree), jnp.asarray(z),
                                jnp.asarray(cv), truncation, jcfg, JFP32))
    got = N(bg.apply(from_jax.convert_biggan(tree), T(z), T(cv), truncation, tcfg, FP32))
    res = 4 * 2 ** sum(up for up, _, _ in jcfg.layers)
    assert got.shape == want.shape == (3, 3, res, res)
    assert np.abs(want).max() > 0.1  # the forward is not flat
    np.testing.assert_allclose(got, want, **TOL)


def test_s2d_domain_launches_the_folds_it_should(trees, monkeypatch):
    """MID4 from 4 px: every block's mid segment runs s2d; the [2,2] folds
    (two per same-resolution block, one per up block) go through
    s2d_conv2x2 with one shared weight set."""
    calls = []
    real = S.s2d_conv2x2

    def spy(x, K, style, demod, pad0):
        calls.append((tuple(x.shape), style, demod, pad0))
        return real(x, K, style, demod, pad0)

    monkeypatch.setattr(S, "s2d_conv2x2", spy)
    cfg = dataclasses.replace(CONFIGS["MID4"][1], s2d_min_res=4)
    z, cv = _inputs(cfg)
    bg.apply(from_jax.convert_biggan(trees["MID4"]), T(z), T(cv), 1.0, cfg, FP32)
    # block 0 (4 px, mid 4: C' 16): 0 -> -1 (pad0 1), -1 -> 0; block 1 (up to
    # 8 px): -1 -> 0; block 2 (8 px): both; block 3 (up to 16 px, mid 2): one
    assert [(c[0], c[3]) for c in calls] == [
        ((3, 2, 2, 16), 1), ((3, 3, 3, 16), 0), ((3, 5, 5, 16), 0),
        ((3, 4, 4, 16), 1), ((3, 5, 5, 16), 0), ((3, 9, 9, 8), 0)]
    assert all(c[1] is None and c[2] is None for c in calls)


def test_interp_stats_matches_jax_and_the_inverted_lerp():
    """The package's BigGANBatchNorm rule, verbatim: the lower grid point is
    weighted by the FRACTIONAL part."""
    rng = np.random.default_rng(3)
    means = rng.normal(size=(51, 4)).astype(np.float32)
    variances = rng.uniform(0.5, 1.5, size=(51, 4)).astype(np.float32)
    for t in (1.0, 0.5, 0.49, 0.482, 0.37, 0.0):
        want = jbg._interp_stats(jnp.asarray(means), jnp.asarray(variances), t, 51)
        got = bg._interp_stats(T(means), T(variances), t, 51)
        for g, w in zip(got, want):
            np.testing.assert_allclose(N(g), np.asarray(w), rtol=1e-6, atol=1e-7)
    m, _ = bg._interp_stats(T(means), T(variances), 0.482, 51)   # idx 24.1
    np.testing.assert_allclose(N(m), 0.1 * means[24] + 0.9 * means[25], rtol=1e-4)


def test_precast_params_exact(trees):
    """Staging the frozen tree to bf16 with PRECAST_EXCLUDE is bitwise for
    the bf16 forward, and keeps the running statistics fp32; both domains.
    The final BN reads its affine raw in fp32 (as the JAX package's
    _plain_bn_apply does) while staging rounds it: bitwise only for
    bf16-exact affines, such as the random init's 1 and 0, so the test
    rounds them first (ROADMAP §3)."""
    params = from_jax.convert_biggan(trees["MID4"])
    for k in ("weight", "bias"):
        params["bn"][k] = params["bn"][k].bfloat16().float()
    p16 = precast_params(params, BF16, bg.PRECAST_EXCLUDE)
    assert p16["blocks"][0]["block"]["bn_0"]["running_means"].dtype == torch.float32
    assert p16["blocks"][0]["block"]["conv_0"]["w"].dtype == torch.bfloat16
    z, cv = _inputs(CONFIGS["MID4"][1], seed=4)
    for min_res in (2 ** 30, 4):
        cfg = dataclasses.replace(CONFIGS["MID4"][1], s2d_min_res=min_res)
        for trunc in (1.0, 0.5):
            a = bg.apply(params, T(z), T(cv), trunc, cfg, BF16)
            b = bg.apply(p16, T(z), T(cv), trunc, cfg, BF16)
            assert a.dtype == torch.bfloat16
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_convert_biggan_keeps_the_blocks_list(trees):
    params = from_jax.convert_biggan(trees["MID4"])
    kinds = [next(iter(e)) for e in params["blocks"]]
    assert kinds == ["block", "attn", "block", "block", "block"]
    blk = params["blocks"][0]["block"]
    assert tuple(blk["conv_1"]["w"].shape) == (4, 4, 3, 3)           # OIHW
    assert tuple(blk["bn_1"]["running_means"].shape) == (51, 4)
    assert tuple(params["embeddings"]["w"].shape) == (10, 16)
    assert tuple(params["conv_to_rgb"]["w"].shape) == (8, 8, 3, 3)


def test_port_init_tree_has_the_jax_structure():
    """The port's random tree: the JAX package's structure, shapes and
    distributions (zero biases, unit variances, N(0, 0.02) weights)."""
    for cfg, jcfg in ((bg.TINY, jbg.TINY), (_mid4(bg), _mid4(jbg))):
        got = bg.init_tree(torch.Generator().manual_seed(0), cfg)
        want = jbg.init(jax.random.PRNGKey(0), jcfg)
        gl = jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, got))
        wl = jax.tree_util.tree_leaves_with_path(want)
        assert [jax.tree_util.keystr(p) for p, _ in gl] == [jax.tree_util.keystr(p) for p, _ in wl]
        assert [np.shape(a) for _, a in gl] == [np.shape(a) for _, a in wl]
    full = bg.init_tree(torch.Generator().manual_seed(0), bg.BIGGAN_DEEP_256)
    w = full["blocks"][0]["block"]["conv_0"]["w"]
    assert abs(w.std().item() - 0.02) < 1e-3 and abs(w.mean().item()) < 1e-3


def test_truncated_noise_sample_matches_the_distribution():
    x = bg.truncated_noise_sample(torch.Generator().manual_seed(0), 4000, 128, 0.5)
    assert x.shape == (4000, 128) and x.abs().max().item() <= 1.0
    # truncnorm(-2, 2) has variance 0.7737; times 0.5 squared
    assert abs(x.var().item() - 0.25 * 0.7737) < 0.005
    u = torch.rand(1000, generator=torch.Generator().manual_seed(1))
    assert torch.equal(tsmp.truncnorm_core(u), tsmp.truncnorm_core(u.clone()))


def test_output_shape_range_and_class_dependence(trees):
    params = from_jax.convert_biggan(trees["TINY"])
    z = T(np.random.default_rng(5).normal(size=(1, 16)))
    a = bg.apply(params, z, torch.nn.functional.one_hot(torch.tensor([0]), 10).float(),
                 1.0, bg.TINY)
    b = bg.apply(params, z, torch.nn.functional.one_hot(torch.tensor([7]), 10).float(),
                 1.0, bg.TINY)
    assert a.shape == (1, 3, 8, 8) and a.abs().max() <= 1.0
    assert not torch.allclose(a, b)


@pytest.mark.parametrize("name,calls", [("biggan-deep-512", 57), ("biggan-deep-256", 49),
                                        ("biggan-deep-128", 41)])
def test_batch_norms_of_one_forward(name, calls):
    """chip_smoke.cond_bn_calls, from which the smoke run and the card's
    tests take the batch norm's calls: four in each block and the final
    one, read from a forward on meta tensors; the s2d mid segments' with
    phases 4 and the conv's bias, the final one with a shared affine."""
    import chip_smoke

    cfg = bg.CONFIGS[name]
    got = chip_smoke.cond_bn_calls(cfg, 2)
    assert len(got) == 4 * len(cfg.layers) + 1 == calls
    assert [per_sample for _, _, per_sample, _ in got] == [True] * (calls - 1) + [False]
    assert sum(shape[-1] == 4 * C for shape, C, _, _ in got) == 3 * sum(
        2 * res >= cfg.s2d_min_res if up else res >= cfg.s2d_min_res
        for (up, _, _), res in zip(cfg.layers, _block_resolutions(cfg)))
    assert got[-1] == ((2, cfg.output_dim, cfg.output_dim, cfg.channel_width), 128, False, False)


def _block_resolutions(cfg):
    res, out = 4, []
    for up, _, _ in cfg.layers:
        out.append(res)
        res *= 2 if up else 1
    return out


def _eager_bn_relu(x, mean, var, eps, weight, bias, b_conv, phases):
    """The batch norm + ReLU as the model computed it before the kernel, step
    by step: the conv bias added in x's dtype, the vectors tiled across the
    phases, the normalization in fp32, one rounding, the ReLU."""
    if b_conv is not None:
        x = x + S.tile_channels(b_conv, phases)
    if phases > 1:
        mean, var, weight, bias = (S.tile_channels(t, phases) for t in (mean, var, weight, bias))
    y = (x.float() - mean) * torch.rsqrt(var + eps)
    if weight.dim() == 2:
        y = y * weight.float()[:, None, None, :] + bias.float()[:, None, None, :]
    else:
        y = y * weight + bias
    return torch.relu(y.to(x.dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("phases,per_sample,with_bias", [(1, True, False), (1, True, True),
                                                         (4, True, True), (1, False, False)])
def test_cond_bn_relu_on_the_cpu_is_the_eager_chain(dtype, phases, per_sample, with_bias):
    """On the CPU the wrapper takes its plain version, bitwise the model's
    eager chain before the kernel (the oracle the card's tests hold the
    kernel to), and launches nothing."""
    from clip_glass_torch.core.profiling import TRACER
    from clip_glass_torch.ops import norms

    g = torch.Generator().manual_seed(7)
    C, B = 12, 3
    x = torch.randn((B, 5, 6, phases * C), generator=g).to(dtype)
    mean = 0.3 * torch.randn(C, generator=g)
    var = 0.5 + torch.rand(C, generator=g)
    size, adt = ((B, C), dtype) if per_sample else ((C,), torch.float32)
    weight = (1 + 0.2 * torch.randn(size, generator=g)).to(adt)
    bias = (0.3 * torch.randn(size, generator=g)).to(adt)
    b_conv = (0.3 * torch.randn(C, generator=g)).to(dtype) if with_bias else None
    before = (norms.cond_bn_relu.launches, TRACER.counters().get("kernels.cond_bn", 0))
    got = norms.cond_bn_relu(x, mean, torch.rsqrt(var + 1e-4), weight, bias, b_conv, phases)
    assert (norms.cond_bn_relu.launches, TRACER.counters().get("kernels.cond_bn", 0)) == before
    want = _eager_bn_relu(x, mean, var, 1e-4, weight, bias, b_conv, phases)
    assert got.dtype == dtype and (got > 0).any() and (got == 0).any()
    as_int = torch.int32 if dtype == torch.float32 else torch.int16
    assert torch.equal(got.view(as_int), want.view(as_int))
