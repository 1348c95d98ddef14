"""clip_glass_torch.ops.s2d against the JAX package's ops/s2d.py, and the
port's kernel-4 plain version against the Pallas kernel s2d_conv2x2_pallas
run in interpret mode.

Inputs are made with numpy from a seed and handed to both sides; weights
are HWIO for JAX and OIHW ([I, O] for the ToRGB matrix) for the port. Both
sides compute in fp32, so they differ only in summation order. Layout ops
must agree exactly; folded kernels at 1e-6; ops at 1e-4 relative to the
output's scale (torch_parity.assert_close_scaled)."""

import numpy as np
import pytest

import jax.numpy as jnp

import torch

from clip_glass_tpu.ops import modulated_conv as jmc
from clip_glass_tpu.ops import s2d as J
from clip_glass_tpu.ops.pallas.s2d_conv2x2 import s2d_conv2x2_pallas

from clip_glass_torch.ops import modulated_conv as tmc
from clip_glass_torch.ops import resize as trs
from clip_glass_torch.ops import s2d as S
from clip_glass_torch.ops.upfirdn import pad_hw, zero_stuff

from torch_parity import N, T, assert_close_scaled, oihw

B, H, I, O = 2, 16, 6, 5
RTOL = 1e-4


def _x(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _to_off(x, off, mod):
    """Plain NHWC -> s2d at lattice `off` (offset -1: zero phantoms)."""
    return mod.shift_to_m1(mod.s2d(x)) if off else mod.s2d(x)


def _j(x):
    return jnp.asarray(x)


def _hwio(t):
    """The port's HWIO fold output, as numpy (the JAX layout)."""
    return N(t)


# ------------------------------------------------------------ layout


def test_layout_ops_match_jax_exactly(rng):
    x = _x(rng, B, H, H, I)
    jx, tx = _j(x), T(x)
    pairs = [(J.s2d(jx), S.s2d(tx)),
             (J.un_s2d(J.s2d(jx)), S.un_s2d(S.s2d(tx))),
             (J.shift_to_m1(J.s2d(jx)), S.shift_to_m1(S.s2d(tx))),
             (J.un_s2d_off(J.shift_to_m1(J.s2d(jx)), -1),
              S.un_s2d_off(S.shift_to_m1(S.s2d(tx)), -1)),
             (J.s4d(jx), S.s4d(tx)),
             (J.un_s4d(J.s4d(jx)), S.un_s4d(S.s4d(tx))),
             (J.s2d_to_s4d(J.s2d(jx)), S.s2d_to_s4d(S.s2d(tx))),
             (J.tile_channels(jx[:, 0, 0]), S.tile_channels(tx[:, 0, 0])),
             (J.tile_channels(jx[:, 0, 0], 16), S.tile_channels(tx[:, 0, 0], 16))]
    for want, got in pairs:
        np.testing.assert_array_equal(N(got), np.asarray(want))
    assert S.n_cells(H, -1) == J.n_cells(H, -1) == H // 2 + 1
    assert S.phys_size(H // 2 + 1, -1) == J.phys_size(H // 2 + 1, -1) == H


@pytest.mark.parametrize("off", [0, -1])
def test_s2d_hw_matches_jax(rng, off):
    n = _x(rng, H, H)
    np.testing.assert_array_equal(N(S.s2d_hw(T(n), off)), np.asarray(J.s2d_hw(_j(n), off)))


def test_mask_phantoms_matches_jax(rng):
    x = _x(rng, B, H // 2 + 1, H // 2 + 1, 4 * I)
    want = np.asarray(J.mask_phantoms(_j(x)))
    t = T(x)
    got = S.mask_phantoms_(t)
    assert got is t  # in place
    np.testing.assert_array_equal(N(got), want)


# ------------------------------------------------------------ kernel folds


@pytest.mark.parametrize("in_off,out_off", [(0, 0), (0, -1), (-1, 0), (-1, -1)])
@pytest.mark.parametrize("k", [3, 1])
def test_same_kernel_fold_matches_jax(rng, in_off, out_off, k):
    w = _x(rng, k, k, I, O)
    Kw, pw = J.s2d_same_kernel(_j(w), in_off, out_off)
    Kt, pt = S.s2d_same_kernel(oihw(w), in_off, out_off)
    assert pt == pw
    np.testing.assert_allclose(_hwio(Kt), np.asarray(Kw), rtol=1e-6, atol=1e-6)
    if k == 3 and in_off != out_off:
        assert Kt.shape[:2] == (2, 2)  # the [2,2] fold is the point


@pytest.mark.parametrize("in_off", [0, -1])
def test_up_kernel_folds_match_jax(rng, in_off):
    w = _x(rng, 3, 3, I, O)
    np.testing.assert_allclose(
        N(tmc._polyphase_up_kernels(oihw(w), (1, 3, 3, 1))),
        np.asarray(jmc._polyphase_up_kernels(_j(w), (1, 3, 3, 1))), rtol=1e-6, atol=1e-6)
    Kw, pw = J.s2d_up_kernel(_j(w))
    Kt, pt = S.s2d_up_kernel(oihw(w))
    assert pt == pw
    np.testing.assert_allclose(_hwio(Kt), np.asarray(Kw), rtol=1e-6, atol=1e-6)
    Kw, pw = J.s2d_up_kernel_from_s2d(_j(w), in_off=in_off)
    Kt, pt = S.s2d_up_kernel_from_s2d(oihw(w), in_off=in_off)
    assert pt == pw
    np.testing.assert_allclose(_hwio(Kt), np.asarray(Kw), rtol=1e-6, atol=1e-6)


def test_polyphase_kernels_round_once_to_the_weight_dtype(rng):
    """bf16 weights: composed in fp32, rounded once to bf16, as in JAX."""
    w = _x(rng, 3, 3, I, O)
    wb = jnp.asarray(w, jnp.bfloat16)
    want = np.asarray(jmc._polyphase_up_kernels(wb, (1, 3, 3, 1))).astype(np.float32)
    got = tmc._polyphase_up_kernels(oihw(np.asarray(wb, np.float32)).bfloat16(),
                                    (1, 3, 3, 1))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(N(got), want, rtol=1e-2, atol=1e-6)


# (in_off, out_off, k, out_s2d); a plain output has no lattice offset
DOWN_CASES = [(i, o, k, s) for i in (0, -1) for o in (0, -1) for k in (3, 1)
              for s in (True, False) if s or not o]


@pytest.mark.parametrize("in_off,out_off,k,out_s2d", DOWN_CASES)
def test_down_kernel_fold_matches_jax(rng, in_off, out_off, k, out_s2d):
    w = _x(rng, k, k, I, O)
    Kw, pw, sw = J.s2d_down_kernel(_j(w), out_s2d=out_s2d, in_off=in_off, out_off=out_off)
    Kt, pt, st = S.s2d_down_kernel(oihw(w), out_s2d=out_s2d, in_off=in_off,
                                   out_off=out_off)
    assert (pt, st) == (pw, sw)
    np.testing.assert_allclose(_hwio(Kt), np.asarray(Kw), rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------ the conv itself


@pytest.mark.parametrize("k,stride,pad0,pad1", [
    (4, 1, 1, 1), (4, 1, 2, 3), (3, 1, 2, 2), (3, 1, 1, 0), (4, 1, -1, 2), (2, 2, 0, 0),
    (3, 2, 2, 2)])
def test_conv_lhs_dilation_matches_zero_stuffed_form(rng, k, stride, pad0, pad1):
    """_conv's transposed-conv form of an input dilation equals the dilated
    input padded by (pad0, pad1) (negative: cropped) and correlated."""
    x, w = T(_x(rng, 2, 7, 7, 3)), T(_x(rng, 4, 3, k, k))
    want = torch.nn.functional.conv2d(
        pad_hw(zero_stuff(x.permute(0, 3, 1, 2), stride), pad0, pad1), w)
    got = tmc._conv(x, w, pad0=pad0, pad1=pad1, lhs_dilation=stride)
    np.testing.assert_allclose(N(got), N(want.permute(0, 2, 3, 1)), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k,stride,pad0,pad1", [(3, 1, 1, 0), (3, 1, 0, 2), (4, 2, 1, 1),
                                                (4, 2, 1, 2), (6, 2, 2, 3), (3, 1, -1, 2)])
def test_conv_asymmetric_pads_match_jax(rng, k, stride, pad0, pad1):
    x, w = _x(rng, 2, 9, 9, 3), _x(rng, k, k, 3, 4)
    want = np.asarray(jmc._conv(_j(x), _j(w), stride=stride, pad0=pad0, pad1=pad1))
    got = N(tmc._conv(T(x), oihw(w), stride=stride, pad0=pad0, pad1=pad1))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ modulated ops


@pytest.mark.parametrize("in_off,out_off", [(0, 0), (0, -1), (-1, 0), (-1, -1)])
@pytest.mark.parametrize("k,demod,O", [(3, True, 5), (3, False, 5), (1, False, 5),
                                       (3, True, I), (3, False, I)])
def test_s2d_modulated_conv_matches_jax(rng, in_off, out_off, k, demod, O):
    """O == I between opposite lattices takes s2d_conv2x2 (its plain version
    on the CPU) where JAX takes the lax fold."""
    x, w = _x(rng, B, H, H, I), _x(rng, k, k, I, O)
    style = _x(rng, B, I) * 0.5 + 1.0
    want = J.s2d_modulated_conv2d(_to_off(_j(x), in_off, J), _j(w), _j(style),
                                  demodulate=demod, in_off=in_off, out_off=out_off)
    got = S.s2d_modulated_conv2d(_to_off(T(x), in_off, S), oihw(w), T(style),
                                 demodulate=demod, in_off=in_off, out_off=out_off)
    assert got.shape[1] == S.n_cells(H, out_off)
    assert_close_scaled(N(got), np.asarray(want), RTOL)


@pytest.mark.parametrize("input_s2d,in_off", [(False, 0), (True, 0), (True, -1)])
def test_s2d_modulated_conv_up_matches_jax(rng, input_s2d, in_off):
    x, w = _x(rng, B, H, H, I), _x(rng, 3, 3, I, O)
    style = _x(rng, B, I) * 0.5 + 1.0
    jx, tx = _j(x), T(x)
    if input_s2d:
        jx, tx = _to_off(jx, in_off, J), _to_off(tx, in_off, S)
    want = J.s2d_modulated_conv2d_up(jx, _j(w), _j(style), input_s2d=input_s2d,
                                     in_off=in_off)
    got = S.s2d_modulated_conv2d_up(tx, oihw(w), T(style), input_s2d=input_s2d,
                                    in_off=in_off)
    assert_close_scaled(N(got), np.asarray(want), RTOL)


@pytest.mark.parametrize("in_off,out_off", [(0, 0), (0, -1), (-1, 0), (-1, -1)])
@pytest.mark.parametrize("k,O", [(3, 5), (1, 5), (3, I)])
def test_s2d_conv2d_matches_jax(rng, in_off, out_off, k, O):
    x, w = _x(rng, B, H, H, I), _x(rng, k, k, I, O)
    want = J.s2d_conv2d(_to_off(_j(x), in_off, J), _j(w), in_off, out_off)
    got = S.s2d_conv2d(_to_off(T(x), in_off, S), oihw(w), in_off, out_off)
    assert_close_scaled(N(got), np.asarray(want), RTOL)


@pytest.mark.parametrize("in_off,out_off,k,out_s2d", DOWN_CASES)
def test_s2d_conv2d_down_matches_jax(rng, in_off, out_off, k, out_s2d):
    x, w = _x(rng, B, H, H, I), _x(rng, k, k, I, O)
    want = J.s2d_conv2d_down(_to_off(_j(x), in_off, J), _j(w), output_s2d=out_s2d,
                             in_off=in_off, out_off=out_off)
    got = S.s2d_conv2d_down(_to_off(T(x), in_off, S), oihw(w), output_s2d=out_s2d,
                            in_off=in_off, out_off=out_off)
    assert_close_scaled(N(got), np.asarray(want), RTOL)


def test_s2d_upsample2x_matches_jax(rng):
    y = _x(rng, B, H, H, 3)
    assert_close_scaled(N(S.s2d_upsample2x(T(y))), np.asarray(J.s2d_upsample2x(_j(y))), RTOL)


# ------------------------------------------------------------ BigGAN ops


@pytest.mark.parametrize("out_off", [0, -1])
def test_s2d_enter_conv1x1_matches_jax(rng, out_off):
    x, w = _x(rng, B, H, H, I), _x(rng, 1, 1, I, O)
    want = J.s2d_enter_conv1x1(_j(x), _j(w), out_off=out_off)
    got = S.s2d_enter_conv1x1(T(x), oihw(w), out_off=out_off)
    assert_close_scaled(N(got), np.asarray(want), RTOL)
    if out_off:  # the entry writes zero phantoms
        np.testing.assert_array_equal(N(S.mask_phantoms_(got.clone())), N(got))


@pytest.mark.parametrize("in_off", [0, -1])
def test_s2d_exit_conv1x1_matches_jax(rng, in_off):
    x, w = _x(rng, B, H, H, I), _x(rng, 1, 1, I, O)
    want = J.s2d_exit_conv1x1(_to_off(_j(x), in_off, J), _j(w), in_off=in_off)
    got = S.s2d_exit_conv1x1(_to_off(T(x), in_off, S), oihw(w), in_off=in_off)
    assert got.shape == (B, H, H, O)
    assert_close_scaled(N(got), np.asarray(want), RTOL)


@pytest.mark.parametrize("in_off,out_off", [(0, 0), (-1, 0), (0, -1), (-1, -1)])
@pytest.mark.parametrize("k", [3, 1])
def test_nearest_up_fold_map_matches_jax(k, in_off, out_off):
    M, pad0 = S._nearest_up_fold_map(k, in_off, out_off)
    Mj, pad0j = J._nearest_up_fold_map(k, in_off, out_off)
    np.testing.assert_array_equal(M, Mj)
    assert pad0 == pad0j


@pytest.mark.parametrize("in_off,out_off", [(0, 0), (-1, 0), (0, -1), (-1, -1)])
def test_s2d_nearest_up_conv_matches_jax(rng, in_off, out_off):
    """Against JAX on the whole tensor (phantoms included: both folds are
    the same exact rewrite), and, phantoms masked, against the plain
    nearest upsample + 'SAME' 3x3 conv."""
    x, w = _x(rng, B, H, H, I), _x(rng, 3, 3, I, O)
    want = J.s2d_nearest_up_conv(_to_off(_j(x), in_off, J), _j(w), in_off=in_off,
                                 out_off=out_off)
    got = S.s2d_nearest_up_conv(_to_off(T(x), in_off, S), oihw(w), in_off=in_off,
                                out_off=out_off)
    assert_close_scaled(N(got), np.asarray(want), RTOL)
    up = T(x).repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    plain = tmc._conv(up, oihw(w), pad0=1, pad1=1)
    if out_off:
        got = S.mask_phantoms_(got)
    assert_close_scaled(N(S.un_s2d_off(got, out_off)), N(plain), RTOL)


def test_s2d_exit_conv1x1_skip_matches_jax(rng):
    x, w = _x(rng, B, H, H, I), _x(rng, 1, 1, I, O)
    skip = _x(rng, B, H // 2, H // 2, O)   # the pre-up resolution: x's cells
    want = J.s2d_exit_conv1x1_skip(J.s2d(_j(x)), _j(w), _j(skip), in_off=0)
    got = S.s2d_exit_conv1x1_skip(S.s2d(T(x)), oihw(w), T(skip), in_off=0)
    assert_close_scaled(N(got), np.asarray(want), RTOL)
    plain = tmc._conv(T(x), oihw(w)) + T(skip).repeat_interleave(2, 1).repeat_interleave(2, 2)
    assert_close_scaled(N(got), N(plain), RTOL)
    with pytest.raises(AssertionError, match="offset-0"):
        S.s2d_exit_conv1x1_skip(_to_off(T(x), -1, S), oihw(w), T(skip), in_off=-1)


# ------------------------------------------------------------ s4d RGB domain


@pytest.mark.parametrize("in_off", [0, -1])
def test_s4d_from_s2d_conv1x1_matches_jax(rng, in_off):
    x, w = _x(rng, B, H, H, I), _x(rng, 1, 1, I, 3)
    want = J.s4d_from_s2d_conv1x1(_to_off(_j(x), in_off, J), _j(w), in_off=in_off)
    got = S.s4d_from_s2d_conv1x1(_to_off(T(x), in_off, S), T(w[0, 0]), in_off=in_off)
    assert_close_scaled(N(got), np.asarray(want), RTOL)


@pytest.mark.parametrize("Hh,C", [(8, 3), (16, 5)])
def test_s4d_upsamples_match_jax(rng, Hh, C):
    y = _x(rng, B, Hh, Hh, C)
    assert_close_scaled(N(S.s4d_upsample2x(S.s4d(T(y)))),
                        np.asarray(J.s4d_upsample2x(J.s4d(_j(y)))), RTOL)
    assert_close_scaled(N(S.plain_to_s4d_upsample2x(T(y))),
                        np.asarray(J.plain_to_s4d_upsample2x(_j(y))), RTOL)


@pytest.mark.parametrize("out_off", [0, -1])
def test_s2d_from_s4d_conv1x1_matches_jax(rng, out_off):
    y, w = _x(rng, B, H, H, 3), _x(rng, 1, 1, 3, O)
    want = J.s2d_from_s4d_conv1x1(J.s4d(_j(y)), _j(w), out_off=out_off)
    got = S.s2d_from_s4d_conv1x1(S.s4d(T(y)), oihw(w), out_off=out_off)
    assert_close_scaled(N(got), np.asarray(want), RTOL)


# ------------------------------------------------------------ resize


@pytest.mark.parametrize("src,dst", [(32, 12), (1024, 224), (16, 224)])
def test_bilinear_matrix_matches_jax(src, dst):
    np.testing.assert_allclose(trs.bilinear_matrix(src, dst), J._bilinear_matrix(src, dst),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("domain", ["s4d", "s2d", "s2d_off"])
def test_resize_from_packed_matches_jax(rng, domain):
    img = _x(rng, B, 32, 32, 3)
    if domain == "s4d":
        want = J.resize_bilinear_from_s4d(J.s4d(_j(img)), 12)
        got = S.resize_bilinear_from_s4d(S.s4d(T(img)), 12)
    else:
        off = -1 if domain == "s2d_off" else 0
        want = J.resize_bilinear_from_s2d(_to_off(_j(img), off, J), 12, in_off=off)
        got = S.resize_bilinear_from_s2d(_to_off(T(img), off, S), 12, in_off=off)
    assert got.shape == (B, 3, 12, 12) and got.dtype == torch.float32
    assert_close_scaled(N(got), np.asarray(want), RTOL)


def test_resize_from_s4d_rounds_as_jax_in_bf16(rng):
    """bf16 image: fp32 contractions of bf16 operands, the intermediate
    rounded to bf16, an fp32 result, as the JAX package's einsums."""
    img = np.asarray(jnp.asarray(rng.uniform(size=(B, 32, 32, 3)), jnp.bfloat16), np.float32)
    want = J.resize_bilinear_from_s4d(J.s4d(jnp.asarray(img, jnp.bfloat16)), 12)
    got = S.resize_bilinear_from_s4d(S.s4d(T(img).bfloat16()), 12)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(N(got), np.asarray(want), rtol=1e-2, atol=1e-2)


# ------------------------------------------------------------ kernel 4


@pytest.mark.parametrize("pad0", [1, 0])
@pytest.mark.parametrize("modulated", [True, False])
def test_s2d_conv2x2_plain_matches_pallas(rng, pad0, modulated):
    """The port's plain version against the Pallas kernel in interpret mode,
    on the offset-lattice fold of a 3x3 conv: tile 4 over 13 / 11 output
    rows leaves a ragged last tile; the zero halos are the phantoms."""
    Bc, C, n_full = 2, 8, 24
    w = _x(rng, 3, 3, C, C) * 0.3
    xp = _x(rng, Bc, n_full, n_full, C)
    in_off, out_off = (0, -1) if pad0 == 1 else (-1, 0)
    jx = J.s2d(_j(xp)) if pad0 == 1 else J.mask_phantoms(J.shift_to_m1(J.s2d(_j(xp))))
    style = _x(rng, Bc, C) * 0.5 + 1.0
    d = (np.asarray(jmc.demod_coef(_j(w), _j(style))) if modulated
         else np.ones((Bc, C), np.float32))
    Kw, kpad0 = J.s2d_same_kernel(_j(w), in_off, out_off)
    assert Kw.shape[0] == 2 and kpad0 == pad0
    st, dt = J.tile_channels(_j(style)), J.tile_channels(_j(d))
    want = np.asarray(s2d_conv2x2_pallas(jx, Kw, st, dt, pad0=pad0, tile_v=4))
    got = S.s2d_conv2x2_plain(T(np.asarray(jx)), T(np.asarray(Kw)), T(np.asarray(st)),
                              T(np.asarray(dt)), pad0)
    n_out = jx.shape[1] + (1 if pad0 else -1)
    assert got.shape == (Bc, n_out, n_out, 4 * C) == want.shape
    assert_close_scaled(N(got), want, RTOL)


def test_s2d_conv2x2_plain_rounds_kb_once_in_bf16(rng):
    """bf16: Kb folded in fp32 and rounded to bf16, four products summed in
    fp32, one rounding: equal to an fp32 reference on the same bf16
    operands to one bf16 rounding."""
    Bc, n, C = 2, 5, 12
    x = torch.from_numpy(_x(rng, Bc, n, n, C)).bfloat16()
    K, s, d = (torch.from_numpy(_x(rng, 2, 2, C, C)), torch.from_numpy(_x(rng, Bc, C)),
               torch.from_numpy(_x(rng, Bc, C)))
    got = S.s2d_conv2x2_plain(x, K, s, d, 1)
    assert got.dtype == torch.bfloat16 and got.shape == (Bc, n + 1, n + 1, C)
    Kb = (K[None] * s[:, None, None, :, None] * d[:, None, None, None, :]).bfloat16().float()
    xp = torch.nn.functional.pad(x.float(), (0, 0, 1, 1, 1, 1))
    want = sum(torch.einsum("bhwi,bio->bhwo", xp[:, a:a + n + 1, c:c + n + 1], Kb[:, a, c])
               for a in range(2) for c in range(2))
    torch.testing.assert_close(got.float(), want, rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pad0", [1, 0])
@pytest.mark.parametrize("modulated", [False, True])
def test_s2d_conv2x2_none_is_bitwise_ones(rng, dtype, pad0, modulated):
    """style/demod None stand for ones: demod None beside a style, or both
    None (one weight set shared by every sample, as D passes it), give
    bitwise the output of folding with ones, in the plain version and
    through the wrapper on the CPU."""
    Bc, n, C = 3, 6, 8
    x = torch.from_numpy(_x(rng, Bc, n, n, C)).to(dtype)
    K = torch.from_numpy(_x(rng, 2, 2, C, C))
    ones = torch.ones((Bc, C))
    style = torch.from_numpy(_x(rng, Bc, C)) if modulated else None
    want = S.s2d_conv2x2_plain(x, K, ones if style is None else style, ones, pad0)
    for fn in (S.s2d_conv2x2_plain, S.s2d_conv2x2):
        assert torch.equal(fn(x, K, style, None, pad0), want)


@pytest.mark.parametrize("variant", ["wgmma", "wgmma_stream", "wmma", "fp32"])
@pytest.mark.parametrize("shared", [False, True])
def test_conv2x2_weights_hold_the_folded_values(rng, variant, shared):
    """The kernel's weight operand holds `_fold_style(...).to(dtype)`, each
    tap [out, in] for the wgmma variants and [in, out] otherwise, contiguous;
    one shared copy, round(K), for style = demod = None."""
    Bc, C = 3, 16
    dtype = torch.float32 if variant == "fp32" else torch.bfloat16
    K = torch.from_numpy(_x(rng, 2, 2, C, C))
    style, demod = (None, None) if shared else (
        torch.from_numpy(_x(rng, Bc, C)), torch.from_numpy(_x(rng, Bc, C)))
    got = S.conv2x2_weights(K, style, demod, dtype, variant)
    assert got.dtype == dtype and got.is_contiguous()
    assert got.shape == (1 if shared else Bc, 2, 2, C, C)
    if variant.startswith("wgmma"):
        got = got.transpose(-1, -2)
    assert torch.equal(got, S._fold_style(K, style, demod).to(dtype))
    if shared:
        assert torch.equal(got[0], K.to(dtype))


@pytest.mark.parametrize("dtype,C,variant", [
    (torch.bfloat16, 128, "wgmma"), (torch.bfloat16, 64, "wgmma"),
    (torch.bfloat16, 20, "wmma"), (torch.bfloat16, 32, "wmma"),
    (torch.bfloat16, 256, "wmma"), (torch.float32, 128, "fp32"),
    (torch.float32, 20, "fp32")])
def test_conv2x2_variant_rule(dtype, C, variant):
    """bf16 with C' of 64 or 128 (every flagship launch) takes the TMA/wgmma
    kernel; other bf16 widths and fp32 keep the first design's kernels, and
    so do per-sample weights at C' = 256, which no config runs."""
    assert S.conv2x2_variant(dtype, C) == variant
    assert S.conv2x2_variant(dtype, C, shared=False) == variant


@pytest.mark.parametrize("dtype,C,variant", [
    (torch.bfloat16, 256, "wgmma_stream"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 20, "wmma"),
    (torch.bfloat16, 512, "wmma"), (torch.float32, 256, "fp32")])
def test_conv2x2_variant_rule_with_one_shared_set(dtype, C, variant):
    """One weight set for every sample (an unmodulated fold: BigGAN-deep's
    mid segments, D's convs): bf16 at C' = 256 streams the weights by TMA
    (wgmma_stream); 64 and 128 keep them resident (wgmma)."""
    assert S.conv2x2_variant(dtype, C, shared=True) == variant


def test_biggan_folds_take_no_wmma():
    """Every [2,2] fold of both BigGAN-deep configs (C' = 4 * mid of the
    blocks whose mid segment runs in the s2d domain, one shared set) takes
    a wgmma variant: wgmma_stream at C' = 256, wgmma at 128."""
    from clip_glass_torch.models.biggan import model as bg

    seen = set()
    for name in ("biggan-deep-256", "biggan-deep-512"):
        cfg = bg.CONFIGS[name]
        res = 4
        for up, in_m, _ in cfg.layers:
            out_res = 2 * res if up else res
            mid = cfg.channel_width * in_m // 4
            if out_res >= cfg.s2d_min_res and 4 * mid <= 512:
                seen.add((4 * mid, S.conv2x2_variant(torch.bfloat16, 4 * mid, shared=True)))
            res = out_res
    assert seen == {(256, "wgmma_stream"), (128, "wgmma")}
