"""clip_glass_torch ops against the JAX package's ops, and the port's plain
kernel versions against the Pallas kernels themselves (interpret mode on
the CPU, at the shapes of tests/test_pallas_kernels.py).

Inputs are made with numpy from a seed; both sides compute in fp32, so they
differ only in summation order: tolerance 1e-5 unless stated."""

import numpy as np
import pytest

import jax.numpy as jnp

import torch

from clip_glass_tpu.ops import bias_act as jba
from clip_glass_tpu.ops import modulated_conv as jmc
from clip_glass_tpu.ops import resize as jrs
from clip_glass_tpu.ops import upfirdn as jup
from clip_glass_tpu.ops.pallas.fused_bias_act import noise_bias_lrelu_pallas
from clip_glass_tpu.ops.pallas.modulated_matmul import modulated_matmul_pallas
from clip_glass_tpu.ops.pallas.upfirdn2d import upsample2x_pallas

from clip_glass_torch.ops import bias_act as tba
from clip_glass_torch.ops import modulated_conv as tmc
from clip_glass_torch.ops import resize as trs
from clip_glass_torch.ops import upfirdn as tup

from torch_parity import N, T, oihw

TOL = dict(rtol=1e-5, atol=1e-5)


def _x(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(2, 8, 8, 16), (1, 5, 7, 3)])
@pytest.mark.parametrize("taps,gain", [((1, 3, 3, 1), 1.0), ((1, 3, 3, 1), 2.0),
                                       ((1, 2, 1), 1.0)])
def test_upsample2x_matches_jax(rng, shape, taps, gain):
    x = _x(rng, *shape)
    want = np.asarray(jup.upsample2x(jnp.asarray(x), taps, gain))
    got = N(tup.upsample2x(T(x), taps, gain))
    assert got.shape == (shape[0], 2 * shape[1], 2 * shape[2], shape[3])
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("shape", [(2, 8, 8, 4), (1, 9, 7, 3)])
def test_downsample2x_matches_jax(rng, shape):
    x = _x(rng, *shape)
    want = np.asarray(jup.downsample2x(jnp.asarray(x)))
    np.testing.assert_allclose(N(tup.downsample2x(T(x))), want, **TOL)


@pytest.mark.parametrize("pad0,pad1,stride", [(1, 2, 1), (2, 1, 2), (0, 0, 1),
                                              (-1, 2, 1)])
def test_fir_matches_jax(rng, pad0, pad1, stride):
    x = _x(rng, 2, 9, 8, 3)
    k = tup.setup_filter_kernel((1, 3, 3, 1), 1.0, 2)
    want = np.asarray(jup.fir(jnp.asarray(x), k, pad0, pad1, stride))
    got = N(tup.fir(T(x), (1, 3, 3, 1), 4.0, pad0, pad1, stride))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("act,gain", [("linear", None), ("lrelu", None),
                                      ("lrelu", 3.0), ("linear", 0.5)])
def test_bias_act_matches_jax(rng, act, gain):
    x, b = _x(rng, 2, 4, 4, 6), _x(rng, 6)
    want = np.asarray(jba.bias_act(jnp.asarray(x), jnp.asarray(b), act, gain))
    np.testing.assert_allclose(N(tba.bias_act(T(x), T(b), act, gain)), want, **TOL)


@pytest.mark.parametrize("B,group", [(8, 4), (4, 2), (6, 0)])
@pytest.mark.parametrize("center", [True, False])
def test_minibatch_std_matches_jax(rng, B, group, center):
    x = _x(rng, B, 4, 4, 5) * 2.0 + 1.0
    want = np.asarray(jba.minibatch_std(jnp.asarray(x), group, center_input=center))
    got = N(tba.minibatch_std(T(x), group, center_input=center))
    assert got.shape == (B, 4, 4, 6)
    np.testing.assert_allclose(got, want, **TOL)


def test_style_and_demod_match_jax(rng):
    lat, sw, sb = _x(rng, 3, 8), _x(rng, 8, 5), _x(rng, 5)
    want = np.asarray(jmc.style_from_latent(jnp.asarray(lat), jnp.asarray(sw),
                                            jnp.asarray(sb)))
    style = tmc.style_from_latent(T(lat), T(sw), T(sb))
    np.testing.assert_allclose(N(style), want, **TOL)
    w = _x(rng, 3, 3, 5, 7)
    want_d = np.asarray(jmc.demod_coef(jnp.asarray(w), jnp.asarray(want)))
    np.testing.assert_allclose(N(tmc.demod_coef(oihw(w), style)), want_d, **TOL)


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("demod", [True, False])
def test_modulated_conv2d_matches_jax(rng, k, demod):
    x, w = _x(rng, 2, 7, 6, 5), _x(rng, k, k, 5, 4) * 0.3
    style = _x(rng, 2, 5) * 0.5 + 1.0
    want = np.asarray(jmc.modulated_conv2d(jnp.asarray(x), jnp.asarray(w),
                                           jnp.asarray(style), demodulate=demod))
    got = N(tmc.modulated_conv2d(T(x), oihw(w), T(style), demodulate=demod))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("k", [1, 3, 4, 5])
@pytest.mark.parametrize("hw", [(4, 4), (5, 7)])
def test_modulated_conv2d_up_matches_jax(rng, k, hw):
    """Transposed conv + FIR with pad0=(pad+1)//2+1, pad1=pad//2+1, including
    the kernel sizes where pad is negative (k=4: -1, k=5: -2)."""
    x, w = _x(rng, 2, *hw, 5), _x(rng, k, k, 5, 4) * 0.3
    style = _x(rng, 2, 5) * 0.5 + 1.0
    want = np.asarray(jmc.modulated_conv2d_up(jnp.asarray(x), jnp.asarray(w),
                                              jnp.asarray(style)))
    got = N(tmc.modulated_conv2d_up(T(x), oihw(w), T(style)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("k,stride", [(1, 1), (3, 1), (3, 2), (4, 1)])
def test_conv2d_matches_jax(rng, k, stride):
    x, w = _x(rng, 2, 7, 8, 3), _x(rng, k, k, 3, 4) * 0.3
    want = np.asarray(jmc.conv2d(jnp.asarray(x), jnp.asarray(w), stride=stride))
    np.testing.assert_allclose(N(tmc.conv2d(T(x), oihw(w), stride=stride)), want, **TOL)


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("hw", [(8, 8), (9, 7)])
def test_conv2d_down_matches_jax(rng, k, hw):
    """FIR pad ((pad+1)//2, pad//2) with pad=(fk-2)+(k-1), then a VALID
    stride-2 conv."""
    x, w = _x(rng, 2, *hw, 3), _x(rng, k, k, 3, 4) * 0.3
    want = np.asarray(jmc.conv2d_down(jnp.asarray(x), jnp.asarray(w)))
    got = N(tmc.conv2d_down(T(x), oihw(w)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("shape,size", [((2, 3, 16, 16), 32), ((2, 3, 16, 16), 224),
                                        ((1, 3, 1024, 1024), 224)])
def test_resize_bilinear_matches_jax(rng, shape, size):
    """Includes the flagship's 1024 -> 224 downscale (no antialias)."""
    x = rng.uniform(size=shape).astype(np.float32)
    want = np.asarray(jrs.resize_bilinear(jnp.asarray(x), size))
    np.testing.assert_allclose(N(trs.resize_bilinear(T(x), size)), want, **TOL)


# ------------------------------------------------ plain versions vs Pallas

def test_upsample2x_plain_matches_pallas(rng):
    x = _x(rng, 2, 8, 8, 16)
    want = np.asarray(upsample2x_pallas(jnp.asarray(x)))
    np.testing.assert_allclose(N(tup.upsample2x_plain(T(x))), want, **TOL)


def test_upsample2x_plain_matches_pallas_blocked_rows(rng):
    x = _x(rng, 1, 32, 8, 8)
    want = np.asarray(upsample2x_pallas(jnp.asarray(x), block_h=8))
    np.testing.assert_allclose(N(tup.upsample2x_plain(T(x))), want, **TOL)


def test_polyphase_taps_reproduce_filter_kernel():
    """The upsample kernel's per-axis factors, `fir_taps` at the upsample's
    gain x4, are the 2-D kernel's separable factors (checked here, where the
    kernel itself cannot run)."""
    for taps, gain in [((1, 3, 3, 1), 1.0), ((1, 3, 3, 1), 2.0), ((1, 2, 2, 1), 1.0)]:
        k = np.asarray(tup.fir_taps(taps, 4.0 * gain))
        np.testing.assert_allclose(np.outer(k, k),
                                   tup.setup_filter_kernel(taps, gain, 2), rtol=1e-6)


def test_noise_bias_lrelu_plain_matches_pallas(rng):
    B, H, W, C = 2, 8, 8, 16
    x, noise, bias = _x(rng, B, H, W, C), _x(rng, H, W), _x(rng, C)
    want = np.asarray(noise_bias_lrelu_pallas(
        jnp.asarray(x), jnp.asarray(noise), jnp.asarray(0.7, jnp.float32),
        jnp.asarray(bias)))
    got = N(tba.noise_bias_lrelu_plain(T(x), T(noise), torch.tensor(0.7), T(bias)))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("demod", [True, False])
def test_modulated_matmul_plain_matches_pallas(rng, demod):
    """The demod case of tests/test_pallas_kernels.py, and d = ones (ToRGB)."""
    B, P, I, O = 2, 16, 8, 12
    x, w, bias = _x(rng, B, P, I), _x(rng, I, O), _x(rng, O)
    style = _x(rng, B, I) + 1.0
    d = (np.abs(_x(rng, B, O)) + 0.5) if demod else np.ones((B, O), np.float32)
    want = np.asarray(modulated_matmul_pallas(
        jnp.asarray(x), jnp.asarray(style), jnp.asarray(w), jnp.asarray(d),
        jnp.asarray(bias)))
    got = N(tmc.modulated_matmul_plain(T(x), T(style), T(w),
                                       T(d) if demod else None, T(bias)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


# ------------------------- what the kernels' wrappers decide in Python

@pytest.mark.parametrize("taps,gain,want", [
    ((1, 3, 3, 1), 1.0, (0.25, 0.75, 0.75, 0.25)),
    ((1, 2, 4, 1), 4.0, (0.5, 1.0, 2.0, 0.5)),
])
def test_polyphase_taps_cached_values(taps, gain, want):
    """The upsample's cached factors (`fir_taps` at its gain x4) are
    normalized taps * 2 * sqrt(gain), whether the taps come as a tuple or a
    list and the gain as an int or a float, and a second call hands back the
    same tuple."""
    got = tup.fir_taps(taps, 4.0 * gain)
    assert got == pytest.approx(want, rel=1e-12)
    assert tup.fir_taps(list(taps), 4 * int(gain)) is got
    k1 = np.asarray(taps, np.float64)
    assert got == tuple(float(v) for v in k1 / k1.sum() * 2.0 * gain ** 0.5)


@pytest.mark.parametrize("dtype,shape,want", [
    # the flagship's RGB-skip calls: launch-sized up to 16 px, then tiled
    (torch.bfloat16, (16, 4, 4, 3), "rows"), (torch.bfloat16, (16, 16, 16, 3), "rows"),
    (torch.bfloat16, (16, 32, 32, 3), "tiled"), (torch.bfloat16, (16, 512, 512, 3), "tiled"),
    (torch.float32, (16, 512, 512, 3), "tiled"),    # 5 rows of 6144 B fit 32 KB
    (torch.float32, (1, 64, 546, 3), "tiled"),      # 5 * 6552 = 32760
    (torch.float32, (1, 64, 547, 3), "rows"),       # 5 * 6564 = 32820
    (torch.bfloat16, (1, 16, 1024, 3), "tiled"), (torch.bfloat16, (1, 16, 1024, 16), "rows"),
    (torch.float32, (1, 64, 64, 4), "rows"), (torch.float32, (1, 64, 65, 4), "tiled"),
])
def test_upsample2x_variant_rule(dtype, shape, want):
    assert tup.upsample2x_variant(dtype, *shape) == want
    assert want in tup.UPSAMPLE2X_ENTRY and want in tup.upsample2x.launches_by_variant


@pytest.mark.parametrize("dtype,P,I,O,vec,want", [
    # the ToRGB calls of the flagship (B = 16, bf16 rows of whole 16-byte
    # vectors): launch-sized up to 16 px, then the tensor cores
    (torch.bfloat16, 16, 512, 3, 8, "chunked"), (torch.bfloat16, 256, 512, 3, 8, "chunked"),
    (torch.bfloat16, 1024, 512, 3, 8, "mma"), (torch.bfloat16, 4096, 256, 3, 8, "mma"),
    (torch.bfloat16, 2 ** 14, 128, 3, 8, "mma"), (torch.bfloat16, 2 ** 16, 64, 3, 8, "mma"),
    (torch.bfloat16, 2 ** 20, 32, 3, 8, "mma"),
    (torch.bfloat16, 2 ** 20, 8, 3, 8, "chunked"), (torch.bfloat16, 2 ** 20, 16, 3, 8, "chunked"),
    (torch.bfloat16, 2 ** 20, 96, 3, 8, "chunked"),   # no power of two
    (torch.bfloat16, 2 ** 20, 24, 3, 8, "chunked"),
    (torch.bfloat16, 2 ** 20, 1024, 3, 8, "chunked"),  # wider than the widest ToRGB
    (torch.bfloat16, 2 ** 20, 32, 3, 1, "chunked"),    # an unaligned x
    (torch.bfloat16, 2 ** 20, 64, 5, 8, "chunked"), (torch.bfloat16, 2 ** 20, 64, 12, 8, "chunked"),
    # fp32 has one kernel
    (torch.float32, 16, 512, 3, 4, "chunked"), (torch.float32, 2 ** 20, 32, 3, 4, "chunked"),
    (torch.float32, 50, 12, 3, 4, "chunked"), (torch.float32, 50, 96, 3, 4, "chunked"),
    (torch.float32, 50, 20, 3, 4, "chunked"), (torch.float32, 50, 1024, 3, 4, "chunked"),
    (torch.float32, 50, 7, 3, 1, "chunked"),
])
def test_modulated_matmul_variant_rule(dtype, P, I, O, vec, want):
    assert tmc.modulated_matmul_variant(dtype, 16, P, I, O, vec) == want
    assert want in tmc.MODULATED_MATMUL_ENTRY
    assert want in tmc.modulated_matmul.launches_by_variant


# the FIR calls of modulated_conv2d_up (gain 4 = up_factor ** 2, pads (1, 1)
# at k = 3) and of conv2d_down (gain 1; pads (2, 2) at k = 3, (1, 1) at k = 1)
FIR_CALLS = [(4.0, 2, 1, 1), (1.0, 1, 2, 2), (1.0, 1, 1, 1)]


@pytest.mark.parametrize("taps", [(1, 3, 3, 1), (1, 2, 4, 1)])
@pytest.mark.parametrize("gain,up,pad0,pad1", FIR_CALLS)
def test_fir_taps_reproduce_filter_kernel(taps, gain, up, pad0, pad1):
    """The kernel's per-axis factors are the 2-D kernel's separable factors
    for both callers' gains (checked here, where the kernel cannot run);
    for (1, 3, 3, 1) exactly, and each factor a bf16 value."""
    k = np.asarray(tup.fir_taps(taps, gain), np.float32)
    want = tup.setup_filter_kernel(taps, 1.0, up)
    if taps == (1, 3, 3, 1):
        np.testing.assert_array_equal(np.outer(k, k), want)
        assert torch.equal(torch.tensor(k).bfloat16().float(), torch.tensor(k))
    else:
        np.testing.assert_allclose(np.outer(k, k), want, rtol=1e-6)
    assert tup.fir_taps(list(taps), gain) is tup.fir_taps(taps, float(gain))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gain,up,pad0,pad1", FIR_CALLS + [(1.0, 1, 0, 3)])
def test_fir_on_the_cpu_is_the_depthwise_route(rng, dtype, gain, up, pad0, pad1):
    """`fir` on a CPU tensor is the route it took before its kernel, the
    grouped conv with setup_filter_kernel's 2-D kernel, bitwise; and it
    equals the separable sum (rows of 4-tap sums, then 4 of those rows) in
    float64 within fp32's rounding, or bf16's."""
    x = T(_x(rng, 2, 9, 7, 5)).to(dtype)
    got = tup.fir(x, (1, 3, 3, 1), gain, pad0, pad1)
    want = tup._depthwise(x, tup.setup_filter_kernel((1, 3, 3, 1), 1.0, up),
                          pad0=pad0, pad1=pad1)
    assert got.dtype == dtype and torch.equal(got, want)
    k = np.asarray(tup.fir_taps((1, 3, 3, 1), gain))
    xp = np.pad(x.double().numpy(), ((0, 0), (pad0, pad1), (pad0, pad1), (0, 0)))
    Ho, Wo = xp.shape[1] - 3, xp.shape[2] - 3
    rows = sum(k[j] * xp[:, :, j:j + Wo] for j in range(4))
    ref = sum(k[i] * rows[:, i:i + Ho] for i in range(4))
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    np.testing.assert_allclose(got.double().numpy(), ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,pad0,pad1,want", [
    ((16, 17, 17, 512), 1, 1, (16, 16, 16, 512)),        # G at 16 px
    ((16, 257, 257, 128), 1, 1, (16, 256, 256, 128)),    # G at 256 px
    ((16, 256, 256, 128), 2, 2, (16, 257, 257, 128)),    # D's conv1 at 256 px
    ((16, 8, 8, 512), 1, 1, (16, 7, 7, 512)),            # D's skip at 8 px
    ((3, 5, 9, 7), 0, 2, (3, 4, 8, 7)),                  # asymmetric, C odd
])
def test_fir_meta_rule_is_the_kernels_shape(dtype, shape, pad0, pad1, want):
    """On meta operands (core.memory's estimates) `fir` allocates the
    kernel's output, [B, H+pad0+pad1-3, W+pad0+pad1-3, C] in x's dtype,
    contiguous, and launches nothing."""
    before = (tup.fir.launches, dict(tup.fir.launches_by_variant))
    got = tup.fir(torch.empty(shape, dtype=dtype, device="meta"), (1, 3, 3, 1), 1.0,
                  pad0, pad1)
    assert got.is_meta and tuple(got.shape) == want and got.dtype == dtype
    assert got.is_contiguous()
    assert before == (tup.fir.launches, tup.fir.launches_by_variant)


@pytest.mark.parametrize("taps,pad0,pad1,stride", [
    ((1, 2, 1), 1, 1, 1), ((1, 3, 3, 3, 1), 2, 2, 1), ((1, 3, 3, 1), 1, 1, 2),
    ((1, 3, 3, 1), -1, 2, 1), ((1, 3, 3, 1), 0, 0, 1),
])
def test_fir_meta_rule_refuses_what_the_kernel_does_not_take(taps, pad0, pad1, stride):
    """The shape rule raises where the kernel's wrapper does: other tap
    counts, a stride, a negative pad, no output pixel (3 px unpadded)."""
    x = torch.empty((2, 3, 3, 8), device="meta")
    with pytest.raises(ValueError, match="fir"):
        tup.fir(x, taps, 1.0, pad0, pad1, stride)
    tup.fir_plain(torch.zeros(2, 3, 3, 8), (1, 3, 3, 1), 1.0, 1, 1, 2)  # the CPU takes all


@pytest.mark.parametrize("model,calls,g_values,d_values", [
    ("config_f", 18, 30_992_768, 61_477_632),     # the s2d path: 8-256 px
    ("config_f_plain", 24, 131_787_232, 262_804_416),
    ("tiny", 6, 11_040, 20_544),
])
def test_fir_calls_of_one_evaluation(model, calls, g_values, d_values):
    """chip_smoke.fir_calls, which the smoke run and the card's tests time
    and count: an evaluation's FIR calls and the values they read and
    write a candidate (config-f's widths on the s2d path: G about 31 M, D
    about 61.5 M, 185 MB in bf16, 55 us at 3.35 TB/s)."""
    import chip_smoke
    from clip_glass_torch.models.stylegan2 import model as sg2

    cfg = {"config_f": chip_smoke.config_f_widths(),
           "config_f_plain": chip_smoke.config_f_widths(s2d_min_res=2 ** 30),
           "tiny": sg2.TINY}[model]
    got = chip_smoke.fir_calls(cfg, pop=1)
    assert len(got) == calls
    values = {4.0: 0, 1.0: 0}
    for (_, H, W, C), pad0, pad1, gain in got:
        values[gain] += H * W * C + (H + pad0 + pad1 - 3) * (W + pad0 + pad1 - 3) * C
    assert (values[4.0], values[1.0]) == (g_values, d_values)


@pytest.mark.parametrize("config,s2d_min_res", [
    ("StyleGAN2_ffhq_d", 512),      # the plain domain throughout
    ("StyleGAN2_ffhq_d", 16),       # 8 px plain, 16 px in the s2d domain
    ("StyleGAN2_ffhq_nod", 512),    # G alone
])
def test_fir_calls_are_an_evaluations(monkeypatch, config, s2d_min_res):
    """chip_smoke.fir_calls, from which the smoke run takes the FIR's
    launches on every StyleGAN2 path, lists the `fir` calls of one TINY
    evaluation on the CPU in order, (shape, pad0, pad1, gain): G's up levels
    and D's blocks below s2d_min_res, G's alone without D; and PER_EVAL, the
    flagship's launches an evaluation, holds their number on both paths."""
    import dataclasses

    import chip_smoke
    from clip_glass_torch.config import get_config
    from clip_glass_torch.fitness.problem import GenerationProblem
    from clip_glass_torch.models.clip import model as clip_model
    from clip_glass_torch.models.stylegan2 import model as sg2

    calls = []
    plain = tup.fir_plain

    def counted(x, filter_taps, gain, pad0, pad1, stride=1):
        calls.append((tuple(x.shape), pad0, pad1, gain))
        return plain(x, filter_taps, gain, pad0, pad1, stride)
    monkeypatch.setattr(tup, "fir_plain", counted)
    cfg = get_config(config).replace(pop_size=4, dim_z=32, n_var=32, weights="random:0",
                                     target="a red flower", compute_dtype="float32")
    model_cfg = dataclasses.replace(sg2.TINY, s2d_min_res=s2d_min_res)
    gen = GenerationProblem(cfg, device="cpu", clip_cfg=clip_model.TINY,
                            model_cfg=model_cfg).generator
    gen.eval_population(torch.randn((4, 32), generator=torch.Generator().manual_seed(0)))
    want = chip_smoke.fir_calls(model_cfg, pop=4)
    if config.endswith("_nod"):
        want = [c for c in want if c[3] == 4.0]
    assert calls == want and len(calls) == {16: 3, 512: 6 if cfg.n_obj == 2 else 2}[
        s2d_min_res]
    assert {p: n["fir"] for p, n in chip_smoke.PER_EVAL.items()} == {
        p: len(chip_smoke.fir_calls(chip_smoke._model_cfg(p))) for p in ("s2d", "plain")}


@pytest.mark.parametrize("dtype,C,want", [
    (torch.bfloat16, 512, "vector"), (torch.bfloat16, 128, "vector"),
    (torch.bfloat16, 16, "vector"), (torch.bfloat16, 8, "vector"),
    (torch.bfloat16, 12, "scalar"), (torch.bfloat16, 3, "scalar"),
    (torch.float32, 4, "vector"), (torch.float32, 20, "vector"), (torch.float32, 6, "scalar"),
])
def test_fir_variant_rule(dtype, C, want):
    """A thread of the kernel owns 16 bytes of channels where C holds whole
    16-byte vectors (every flagship call, and TINY's 16), one value else."""
    assert tup.fir_variant(dtype, C) == want
    assert want in tup.fir.launches_by_variant


def test_kernel_wrappers_take_the_plain_version_on_the_cpu(rng):
    """A CPU tensor goes to the plain version, counts no launch and needs no
    contiguous input (the skip accumulator of the CPU path is a permuted
    view)."""
    before = (tup.upsample2x.launches, dict(tup.upsample2x.launches_by_variant),
              tmc.modulated_matmul.launches,
              dict(tmc.modulated_matmul.launches_by_variant),
              tup.fir.launches, dict(tup.fir.launches_by_variant))
    y = T(_x(rng, 2, 3, 4, 4)).permute(0, 2, 3, 1)      # NHWC view of NCHW
    assert not y.is_contiguous()
    np.testing.assert_array_equal(N(tup.upsample2x(y)),
                                  N(tup.upsample2x_plain(y.contiguous())))
    np.testing.assert_array_equal(N(tup.fir(y, (1, 3, 3, 1), 1.0, 2, 2)),
                                  N(tup.fir_plain(y.contiguous(), (1, 3, 3, 1), 1.0, 2, 2)))
    x, s, w, b = T(_x(rng, 2, 9, 8)), T(_x(rng, 2, 8)), T(_x(rng, 8, 3)), T(_x(rng, 3))
    np.testing.assert_array_equal(N(tmc.modulated_matmul(x, s, w, None, b)),
                                  N(tmc.modulated_matmul_plain(x, s, w, None, b)))
    assert before == (tup.upsample2x.launches, tup.upsample2x.launches_by_variant,
                      tmc.modulated_matmul.launches,
                      tmc.modulated_matmul.launches_by_variant,
                      tup.fir.launches, tup.fir.launches_by_variant)


def test_require_cuda_refuses_cpu_tensors_in_one_pass():
    """The kernels' argument check, where it can run without a card: a CPU
    tensor is refused with the error of the first failing check, None
    entries are skipped."""
    from clip_glass_torch.ops import cuda

    x = torch.zeros(2, 3)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        cuda.require_cuda("kernel", x, None, x, dtype=x.dtype)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        cuda.require_cuda("kernel", x.half(), dtype=torch.float16)
