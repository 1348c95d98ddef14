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
    np.testing.assert_allclose(N(tup.fir(T(x), k, pad0, pad1, stride)), want, **TOL)


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
    """The CUDA kernel's per-axis factors are the 2-D kernel's separable
    factors (checked here, where the kernel itself cannot run)."""
    for taps, gain in [((1, 3, 3, 1), 1.0), ((1, 3, 3, 1), 2.0), ((1, 2, 2, 1), 1.0)]:
        k = np.asarray(tup.polyphase_taps(taps, gain))
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
