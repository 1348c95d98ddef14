"""clip_glass_torch's CUDA kernels against their plain PyTorch versions on the
card, and the TINY search through them. Marked `gpu`: they need a CUDA
device, nvcc and sm_90a, and skip where there is none. Run on the card with
`python -m pytest --noconftest -m gpu tests/test_torch_cuda.py` (the card's
machine has no JAX, which tests/conftest.py imports).

Tolerances: fp32 1e-5 (summation order and FMA contraction only); bf16
2e-2, one to two bf16 ulps (the kernel rounds once, the plain version at
other places). Kernel 4's outputs are sums of 4C' products: its absolute
tolerance is taken relative to the output's scale."""

import math

import pytest

import torch

from clip_glass_torch.ops import bias_act, modulated_conv, s2d, upfirdn

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, *shape, dtype=torch.float32):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _close(got, want, dtype):
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(2, 8, 8, 32), (3, 5, 7, 20), (2, 3, 5, 7)])
def test_noise_bias_lrelu_kernel(gpu, dtype, shape):
    B, H, W, C = shape
    x, noise = _randn(gpu, *shape, dtype=dtype), _randn(gpu, H, W, dtype=dtype)
    ns, b = torch.tensor(0.7, device="cuda").to(dtype), _randn(gpu, C, dtype=dtype)
    n0 = bias_act.noise_bias_lrelu.launches
    got = bias_act.noise_bias_lrelu(x, noise, ns, b)
    assert bias_act.noise_bias_lrelu.launches == n0 + 1
    _close(got, bias_act.noise_bias_lrelu_plain(x, noise, ns, b), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(2, 8, 8, 16), (1, 32, 8, 8), (3, 5, 7, 3)])
def test_upsample2x_kernel(gpu, dtype, shape):
    x = _randn(gpu, *shape, dtype=dtype)
    _close(upfirdn.upsample2x(x), upfirdn.upsample2x_plain(x), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,demod", [((2, 16, 32, 3), False), ((2, 16, 8, 12), True),
                                         ((3, 37, 24, 3), False), ((2, 33, 7, 5), True)])
def test_modulated_matmul_kernel(gpu, dtype, shape, demod):
    B, P, I, O = shape
    x = _randn(gpu, B, P, I, dtype=dtype)
    s = (1.0 + 0.5 * _randn(gpu, B, I)).to(dtype)
    w = (_randn(gpu, I, O) / math.sqrt(I)).to(dtype)
    d = (0.5 + torch.rand((B, O), generator=gpu, device="cuda")).to(dtype) if demod else None
    b = _randn(gpu, O, dtype=dtype)
    _close(modulated_conv.modulated_matmul(x, s, w, d, b),
           modulated_conv.modulated_matmul_plain(x, s, w, d, b), dtype)


def _s2d_args(gen, B, n, C, modulated, dtype):
    x = _randn(gen, B, n, n, C, dtype=dtype)
    K = _randn(gen, 2, 2, C, C) / math.sqrt(4 * C)
    if modulated:
        style = 1.0 + 0.5 * _randn(gen, B, C)
        demod = 0.5 + torch.rand((B, C), generator=gen, device="cuda")
    else:
        style = demod = torch.ones((B, C), device="cuda")
    return x, K, style, demod


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("C", [20, 64, 128])
@pytest.mark.parametrize("pad0,n", [(1, 13), (0, 11), (1, 11), (0, 13)])
@pytest.mark.parametrize("modulated", [True, False])
def test_s2d_conv2x2_kernel(gpu, dtype, C, pad0, n, modulated):
    x, K, style, demod = _s2d_args(gpu, 2, n, C, modulated, dtype)
    variant = s2d.conv2x2_variant(dtype, C)
    n0, v0 = s2d.s2d_conv2x2.launches, s2d.s2d_conv2x2.launches_by_variant[variant]
    got = s2d.s2d_conv2x2(x, K, style, demod, pad0)
    assert s2d.s2d_conv2x2.launches == n0 + 1
    assert s2d.s2d_conv2x2.launches_by_variant[variant] == v0 + 1
    want = s2d.s2d_conv2x2_plain(x, K, style, demod, pad0)
    assert got.shape == want.shape == (2, n + 2 * pad0 - 1, n + 2 * pad0 - 1, C)
    _close_scaled(got, want, dtype)


def _close_scaled(got, want, dtype):
    torch.cuda.synchronize()
    scale = want.float().abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype] * scale)


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("n", [11, 70, 129])
@pytest.mark.parametrize("pad0", [0, 1])
@pytest.mark.parametrize("C", [64, 128])
def test_s2d_conv2x2_wgmma_kernel(gpu, C, pad0, n, B, shared):
    """The TMA/wgmma variant against the plain version: n_out below one
    32-cell tile row (n = 11), ragged rows (70), one past a multiple of 64
    (129, 130) and the halo at both pad0; per-sample and shared weights."""
    x, K, style, demod = _s2d_args(gpu, B, n, C, True, torch.bfloat16)
    if shared:
        style = demod = None
    v0 = s2d.s2d_conv2x2.launches_by_variant["wgmma"]
    got = s2d.s2d_conv2x2(x, K, style, demod, pad0)
    assert s2d.s2d_conv2x2.launches_by_variant["wgmma"] == v0 + 1
    want = s2d.s2d_conv2x2_plain(x, K, style, demod, pad0)
    assert got.shape == want.shape == (B, n + 2 * pad0 - 1, n + 2 * pad0 - 1, C)
    _close_scaled(got, want, torch.bfloat16)


@pytest.mark.parametrize("dtype,C", [(torch.bfloat16, 128), (torch.bfloat16, 20),
                                     (torch.float32, 64)])
def test_s2d_conv2x2_shared_weights_equal_folded_ones(gpu, dtype, C):
    """One shared weight set (style = demod = None) gives bitwise the output
    of B folded copies with unit style and demod, in every variant."""
    x, K, ones, _ = _s2d_args(gpu, 3, 12, C, False, dtype)
    got = s2d.s2d_conv2x2(x, K, None, None, 1)
    torch.cuda.synchronize()
    assert torch.equal(got, s2d.s2d_conv2x2(x, K, ones, ones, 1))


def test_s2d_conv2x2_rejects_what_the_kernel_does_not_take(gpu):
    x, K, style, demod = _s2d_args(gpu, 2, 9, 16, True, torch.float32)
    with pytest.raises(ValueError):        # CPU/CUDA mix
        s2d.s2d_conv2x2(x, K.cpu(), style, demod, 1)
    with pytest.raises(TypeError):         # a dtype the kernel does not take
        s2d.s2d_conv2x2(x.half(), K, style, demod, 1)
    with pytest.raises(ValueError):        # not contiguous
        s2d.s2d_conv2x2(x.transpose(1, 2), K, style, demod, 1)
    with pytest.raises(ValueError):        # not a [2,2] fold on x's channels
        s2d.s2d_conv2x2(x, K[:, :, :8], style, demod, 1)
    with pytest.raises(ValueError):
        s2d.s2d_conv2x2(x, K, style, demod, 2)


def test_wrappers_reject_what_the_kernels_do_not_take(gpu):
    x = _randn(gpu, 2, 4, 4, 8)
    with pytest.raises(TypeError):
        bias_act.noise_bias_lrelu(x, _randn(gpu, 4, 4, dtype=torch.bfloat16),
                                  torch.tensor(0.1, device="cuda"), _randn(gpu, 8))
    with pytest.raises(ValueError):
        upfirdn.upsample2x(x.transpose(1, 2))
    with pytest.raises(TypeError):
        upfirdn.upsample2x(x.half())


def test_tiny_search_fitness_on_gpu_matches_cpu(gpu):
    """The smoke run's agreement phase: TINY fitness through the kernels on the
    card against the plain versions on the CPU, fp32, with the launch counts,
    in the plain domain (TINY) and the s2d domain (TINY_S2D: 4 launches of
    kernel 4 per evaluation)."""
    import chip_smoke

    chip_smoke.phase_agreement()
