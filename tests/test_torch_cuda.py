"""clip_glass_torch's CUDA kernels against their plain PyTorch versions on the
card, and the TINY search through them. Marked `gpu`: they need a CUDA
device, nvcc and sm_90a, and skip where there is none. Run on the card with
`python -m pytest --noconftest -m gpu tests/test_torch_cuda.py` (the card's
machine has no JAX, which tests/conftest.py imports).

Tolerances: fp32 1e-5 (summation order and FMA contraction only); bf16
2e-2, one to two bf16 ulps (the kernel rounds once, the plain version at
other places). Kernel 4's outputs are sums of 4C' products: its absolute
tolerance is taken relative to the output's scale."""

import dataclasses
import math

import pytest

import torch

import chip_smoke
from clip_glass_torch.core.profiling import TRACER
from clip_glass_torch.models.biggan import model as bg
from clip_glass_torch.ops import bias_act, modulated_conv, norms, s2d, upfirdn

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


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [
    (1, 21, 8, 3),    # rows of 48 B (16-byte copies), tiles of 8 + 8 + 5 rows
    (3, 9, 32, 3),    # H != W, one row past a tile, B = 3
    (1, 8, 4, 3),     # rows of 24 B in bf16: plain loads, exactly one tile
    (3, 13, 5, 7),    # C != 3, ragged rows and a ragged last output vector
    (2, 11, 8, 16),   # C = 16: one output vector inside one pixel
    (1, 5, 256, 3),   # long rows, a last segment of one row
    (2, 6, 544, 3),   # 5 rows fill a stage in fp32: tiles of 4 + 2 rows
    (1, 70, 64, 3),   # more tiles than one block's two stages
])
def test_upsample2x_tiled_kernel(gpu, dtype, shape):
    """The tiled variant across its tile, segment and vector edges."""
    x = _randn(gpu, *shape, dtype=dtype)
    v0 = upfirdn.upsample2x.launches_by_variant["tiled"]
    got = upfirdn.upsample2x_launch(x, upfirdn.fir_taps(gain=4.0), "tiled")
    assert upfirdn.upsample2x.launches_by_variant["tiled"] == v0 + 1
    _close(got, upfirdn.upsample2x_plain(x), dtype)


@pytest.mark.parametrize("shape,variant", [((2, 16, 16, 3), "rows"), ((16, 32, 32, 3), "tiled"),
                                           ((1, 3, 16, 512), "rows")])
def test_upsample2x_takes_the_variant_of_its_rule(gpu, shape, variant):
    """Launch-sized inputs and rows too long for a stage take "rows"."""
    x = _randn(gpu, *shape)
    assert upfirdn.upsample2x_variant(x.dtype, *shape) == variant
    v0 = upfirdn.upsample2x.launches_by_variant[variant]
    got = upfirdn.upsample2x(x)
    assert upfirdn.upsample2x.launches_by_variant[variant] == v0 + 1
    _close(got, upfirdn.upsample2x_plain(x), torch.float32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("taps,gain", [((1, 3, 3, 1), 1.0), ((1, 2, 4, 1), 2.0)])
@pytest.mark.parametrize("variant", ["tiled", "rows"])
def test_upsample2x_variants_agree_with_plain(gpu, dtype, taps, gain, variant):
    """Both variants on one input, through `upsample2x_launch`, with an
    asymmetric filter and a gain; "rows" is also what long rows take."""
    x = _randn(gpu, 2, 6, 10, 3, dtype=dtype)
    got = upfirdn.upsample2x_launch(x, upfirdn.fir_taps(taps, 4.0 * gain), variant)
    _close(got, upfirdn.upsample2x_plain(x, taps, gain), dtype)


def test_upsample2x_edges_stay_exact_beside_infinities(gpu):
    """The zero column and row are zeros, not products with a neighbour:
    an infinity at the edge gives the plain version's infinities and no NaN."""
    x = _randn(gpu, 1, 4, 4, 3)
    x[0, 0, 0, 0] = float("inf")
    x[0, 2, 3, 1] = float("-inf")
    got = upfirdn.upsample2x_launch(x, upfirdn.fir_taps(gain=4.0), "tiled")
    # every tap is positive: the outputs an infinity reaches are those that
    # the indicator of the infinities reaches
    reached = upfirdn.upsample2x_plain(torch.isinf(x).float()) > 0
    torch.cuda.synchronize()
    assert not torch.isnan(got).any()
    assert torch.equal(torch.isinf(got), reached)


# ------------------------------------------------------------ the FIR kernel
#
# Its tolerances are TOL's: in fp32 the kernel sums each row's 4 taps and
# then 4 rows, the plain version's grouped conv the 16 products in its own
# order (1e-5); in bf16 both sum in fp32 and round once, so they differ by
# one bf16 ulp where the two fp32 sums fall on either side of a rounding
# boundary (2e-2 at values near 1).

def _fir_id(call):
    shape, pad0, pad1, gain = call
    return f"{'x'.join(map(str, shape))}-pad{pad0}{pad1}-gain{gain:g}"


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("call", chip_smoke.fir_calls(chip_smoke.config_f_widths()),
                         ids=_fir_id)
def test_fir_kernel_at_the_flagship_calls(gpu, dtype, call):
    """One flagship evaluation's calls at config-f's widths, pop 16: G's up
    levels at 8-256 px, then D's blocks at 256-8 px."""
    shape, pad0, pad1, gain = call
    x = _randn(gpu, *shape, dtype=dtype)
    n0, v0 = upfirdn.fir.launches, upfirdn.fir.launches_by_variant["vector"]
    got = upfirdn.fir(x, (1, 3, 3, 1), gain, pad0, pad1)
    assert (upfirdn.fir.launches, upfirdn.fir.launches_by_variant["vector"]) == (n0 + 1, v0 + 1)
    _close(got, upfirdn.fir_plain(x, (1, 3, 3, 1), gain, pad0, pad1), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("taps", [(1, 3, 3, 1), (1, 2, 4, 1)])
@pytest.mark.parametrize("shape,pad0,pad1,gain", [
    ((2, 9, 7, 16), 0, 2, 1.0),      # C = 16 (TINY), asymmetric pads
    ((3, 10, 11, 12), 3, 1, 4.0),    # C = 12: scalar in bf16, vector in fp32
    ((1, 6, 5, 20), 1, 2, 1.0),      # C = 20, odd width
    ((2, 4, 4, 8), 0, 0, 1.0),       # one output pixel
    ((1, 33, 70, 64), 2, 1, 4.0),    # 73 output columns: 3 tiles of 25
    ((2, 13, 5, 3), 1, 3, 2.0),      # C = 3: scalar in both types
])
def test_fir_kernel_at_odd_shapes(gpu, dtype, taps, shape, pad0, pad1, gain):
    """Both variants where C holds whole 16-byte vectors, the scalar one
    otherwise; an asymmetric filter fixes the orientation of the taps."""
    x = _randn(gpu, *shape, dtype=dtype)
    want = upfirdn.fir_plain(x, taps, gain, pad0, pad1)
    _close(upfirdn.fir(x, taps, gain, pad0, pad1), want, dtype)
    for variant in {upfirdn.fir_variant(dtype, shape[-1]), "scalar"}:
        got = upfirdn.fir_launch(x, upfirdn.fir_taps(taps, gain), pad0, pad1, variant)
        _close(got, want, dtype)


def test_fir_variants_agree_on_one_input(gpu):
    """The vector and scalar variants on one bf16 input: both round the
    same fp32 sums, so they agree bitwise."""
    x = _randn(gpu, 2, 17, 17, 64, dtype=torch.bfloat16)
    taps = upfirdn.fir_taps((1, 3, 3, 1), 4.0)
    v0 = dict(upfirdn.fir.launches_by_variant)
    a = upfirdn.fir_launch(x, taps, 1, 1, "vector")
    b = upfirdn.fir_launch(x, taps, 1, 1, "scalar")
    assert upfirdn.fir.launches_by_variant == {k: n + 1 for k, n in v0.items()}
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_fir_rejects_what_the_kernel_does_not_take(gpu):
    x = _randn(gpu, 2, 6, 6, 8)
    for taps, pads, stride in [((1, 2, 1), (1, 1), 1), ((1, 3, 3, 1), (1, 1), 2),
                               ((1, 3, 3, 1), (-1, 2), 1), ((1, 3, 3, 1), (0, 0), 1)]:
        with pytest.raises(ValueError, match="fir"):
            upfirdn.fir(x[:, :3, :3] if pads == (0, 0) else x, taps, 1.0, *pads, stride)
    with pytest.raises(ValueError, match="contiguous"):
        upfirdn.fir(x.transpose(1, 2), (1, 3, 3, 1), 1.0, 2, 2)
    with pytest.raises(TypeError):
        upfirdn.fir(x.half(), (1, 3, 3, 1), 1.0, 2, 2)
    # contiguous, but 4 bytes past a 16-byte boundary: the vector variant's
    # loads would fault
    skewed = torch.empty(2 * 6 * 6 * 8 + 1, device="cuda")[1:].view(2, 6, 6, 8)
    with pytest.raises(ValueError, match="alignment"):
        upfirdn.fir(skewed, (1, 3, 3, 1), 1.0, 2, 2)
    with pytest.raises(ValueError, match="variant"):
        upfirdn.fir_launch(_randn(gpu, 2, 6, 6, 12, dtype=torch.bfloat16),
                           upfirdn.fir_taps(), 1, 1, "vector")


@pytest.mark.parametrize("dtype", DTYPES)
def test_fir_gradient_is_the_plain_versions(gpu, dtype):
    """Under grad the kernel's forward, and plain autograd's gradient."""
    x = _randn(gpu, 2, 9, 9, 16, dtype=dtype).requires_grad_(True)
    out = upfirdn.fir(x, (1, 3, 3, 1), 1.0, 2, 2)
    assert type(out.grad_fn).__name__ == "_KernelGradBackward"
    r = _randn(gpu, *out.shape, dtype=dtype)
    (got,) = torch.autograd.grad((out * r).sum(), [x])
    (want,) = torch.autograd.grad((upfirdn.fir_plain(x, (1, 3, 3, 1), 1.0, 2, 2) * r).sum(), [x])
    assert torch.equal(got, want)


@pytest.mark.parametrize("model", ["tiny", "config_f"])
def test_stylegan2_g_and_d_synchronize_nothing(gpu, model):
    """One StyleGAN2_ffhq_d evaluation's G and D on the card under
    set_sync_debug_mode("error") (any synchronizing call raises): TINY in
    the plain domain, and config-f's widths on the s2d path at pop 16, the
    FIR kernel at each of their calls (6 and 18), counted by `fir.launches`
    and by the tracer's `kernels.fir`, in G and D and in the whole
    evaluation."""
    from clip_glass_torch.models.stylegan2 import model as sg2

    cfg = sg2.TINY if model == "tiny" else chip_smoke.config_f_widths()
    rec = chip_smoke.fir_evaluation(cfg, tiny=model == "tiny")
    want = len(chip_smoke.fir_calls(cfg))
    assert want == {"tiny": 6, "config_f": 18}[model]
    assert rec["fir_launches_g_and_d"] == rec["kernels_fir_g_and_d"] == want
    assert rec["fir_launches_evaluation"] == want


def test_biggan_launches_no_fir(gpu):
    """BigGAN-deep never calls the FIR: the TINY BigGAN agreement phase
    (both domains, on the card) moves neither count."""
    from clip_glass_torch.core.profiling import TRACER

    before = (upfirdn.fir.launches, TRACER.counters().get("kernels.fir", 0))
    chip_smoke.phase_agreement_biggan()
    assert (upfirdn.fir.launches, TRACER.counters().get("kernels.fir", 0)) == before


# every distinct batch-norm call of a BigGAN-deep-512 forward at 32 rows
# (plain and s2d, per-sample and shared affines, with and without the conv
# bias), then TINY's in both domains (C = 4: one value a thread in bf16)
COND_BN_CALLS = list(dict.fromkeys(
    chip_smoke.cond_bn_calls(bg.BIGGAN_DEEP_512, 32)
    + chip_smoke.cond_bn_calls(bg.TINY, 3)
    + chip_smoke.cond_bn_calls(dataclasses.replace(bg.TINY, s2d_min_res=4), 3)))


def _bn_id(call):
    shape, C, per_sample, with_bias = call
    return (f"{'x'.join(map(str, shape))}-C{C}-{'sample' if per_sample else 'shared'}"
            f"{'-bconv' if with_bias else ''}")


def _cond_bn_counts():
    return norms.cond_bn_relu.launches, TRACER.counters().get("kernels.cond_bn", 0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("call", COND_BN_CALLS, ids=_bn_id)
def test_cond_bn_kernel_at_the_biggan512_calls(gpu, dtype, call):
    """One launch a call, counted by the wrapper and the tracer's
    `kernels.cond_bn`, bitwise the plain version's output (the eager chain
    of the model before the kernel)."""
    args = chip_smoke.cond_bn_args(call, dtype, gpu)
    n0, k0 = _cond_bn_counts()
    got = norms.cond_bn_relu(*args)
    assert _cond_bn_counts() == (n0 + 1, k0 + 1)
    want = norms.cond_bn_relu_plain(*args)
    torch.cuda.synchronize()
    assert chip_smoke.same_bits(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("view,variant", [("crop", "vector"), ("crop_odd", "scalar"),
                                          ("hw_swapped", "vector"),
                                          ("channels_strided", "vector")])
def test_cond_bn_kernel_takes_strided_x(gpu, dtype, view, variant):
    """x as a crop of a larger NHWC buffer (its own b, h and w strides; an
    odd channel count in the buffer leaves one value a thread), with h and
    w swapped, and with channels not contiguous (copied first): bitwise the
    plain version's output, on the variant the strides allow."""
    _, mean, rstd, weight, bias, b_conv, _ = chip_smoke.cond_bn_args(
        ((3, 7, 9, 64), 16, True, True), dtype, gpu)
    x = {"crop": lambda: _randn(gpu, 3, 10, 12, 72, dtype=dtype)[:, 1:8, 2:11, :64],
         "crop_odd": lambda: _randn(gpu, 3, 10, 12, 66, dtype=dtype)[:, 1:8, 2:11, :64],
         "hw_swapped": lambda: _randn(gpu, 3, 9, 7, 64, dtype=dtype).transpose(1, 2),
         "channels_strided": lambda: _randn(gpu, 3, 64, 7, 9, dtype=dtype).permute(0, 2, 3, 1),
         }[view]()
    v0 = norms.cond_bn_relu.launches_by_variant[variant]
    got = norms.cond_bn_relu(x, mean, rstd, weight, bias, b_conv, 4)
    assert norms.cond_bn_relu.launches_by_variant[variant] == v0 + 1
    assert got.is_contiguous()
    want = norms.cond_bn_relu_plain(x, mean, rstd, weight, bias, b_conv, 4)
    torch.cuda.synchronize()
    assert chip_smoke.same_bits(got, want)


def test_cond_bn_rejects_what_the_kernel_does_not_take(gpu):
    args = chip_smoke.cond_bn_args(((2, 4, 4, 32), 8, True, True), torch.float32, gpu)
    x, mean, rstd, weight, bias, b_conv, phases = args
    with pytest.raises(ValueError, match="shapes"):
        norms.cond_bn_relu(x, mean, rstd, weight, bias, b_conv, 2)
    with pytest.raises(ValueError, match="shapes"):
        norms.cond_bn_relu(x, mean, rstd, weight[:1], bias[:1], b_conv, phases)
    for bad in [(x.half(), mean, rstd, weight, bias, b_conv),
                (x, mean.bfloat16(), rstd, weight, bias, b_conv),
                (x, mean, rstd, weight, bias.bfloat16(), b_conv),
                (x, mean, rstd, weight, bias, b_conv.bfloat16()),
                (x, mean, rstd, weight.bfloat16(), bias.bfloat16(), b_conv)]:
        with pytest.raises(TypeError):
            norms.cond_bn_relu(*bad, phases)
    with pytest.raises(ValueError, match="cpu"):
        norms.cond_bn_relu(x, mean.cpu(), rstd.cpu(), weight, bias, b_conv, phases)


@pytest.mark.parametrize("dtype", DTYPES)
def test_cond_bn_gradient_is_the_plain_versions(gpu, dtype):
    """Under grad the kernel's forward, and plain autograd's gradient."""
    x, mean, rstd, weight, bias, b_conv, phases = chip_smoke.cond_bn_args(
        ((2, 5, 5, 32), 8, True, True), dtype, gpu)
    x.requires_grad_(True)
    weight.requires_grad_(True)
    out = norms.cond_bn_relu(x, mean, rstd, weight, bias, b_conv, phases)
    assert type(out.grad_fn).__name__ == "_KernelGradBackward"
    r = _randn(gpu, *out.shape, dtype=dtype)
    got = torch.autograd.grad((out * r).sum(), [x, weight])
    plain = norms.cond_bn_relu_plain(x, mean, rstd, weight, bias, b_conv, phases)
    want = torch.autograd.grad((plain * r).sum(), [x, weight])
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_biggan256_g_on_the_kernel_is_the_eager_route(gpu, monkeypatch):
    """BigGAN-deep-256's G on the card at 2 rows, bf16, in its s2d domain,
    lively weights: its 49 batch norms launch the kernel (the wrapper's
    count and the tracer's `kernels.cond_bn`), and the images equal
    bitwise those of the same forward with the wrapper replaced by its
    plain version, the eager chain (which launches none)."""
    from clip_glass_torch.core.dtypes import BF16, map_tree

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    cfg = bg.BIGGAN_DEEP_256
    params = map_tree(lambda _, t: t.cuda(), chip_smoke.lively_biggan(cfg, 1))
    g = torch.Generator().manual_seed(2)
    z = bg.truncated_noise_sample(g, 2, cfg.z_dim).cuda()
    cv = torch.softmax(2.0 * torch.randn((2, cfg.num_classes), generator=g), dim=1).cuda()
    with torch.inference_mode():
        n0, k0 = _cond_bn_counts()
        got = bg.apply(params, z, cv, 1.0, cfg, BF16)
        n1, k1 = _cond_bn_counts()
        monkeypatch.setattr(norms, "cond_bn_relu", norms.cond_bn_relu_plain)
        want = bg.apply(params, z, cv, 1.0, cfg, BF16)
        torch.cuda.synchronize()
    assert (n1 - n0, k1 - k0) == (49, 49)
    assert TRACER.counters().get("kernels.cond_bn", 0) == k1
    assert got.dtype == torch.bfloat16 and got.shape == (2, 3, 256, 256)
    assert chip_smoke.same_bits(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("I", [32, 64, 128, 256, 512])
@pytest.mark.parametrize("P", [1, 77, 1037])
def test_modulated_matmul_flagship_widths(gpu, dtype, I, P):
    """O = 3 ("mma" in bf16, "chunked" in fp32) at every flagship
    width, with pixel counts that end inside a warp's run and inside a
    block's tile; style given, demod given for odd P."""
    B = 3
    x = _randn(gpu, B, P, I, dtype=dtype)
    s = (1.0 + 0.5 * _randn(gpu, B, I)).to(dtype)
    w = (_randn(gpu, I, 3) / math.sqrt(I)).to(dtype)
    d = (0.5 + torch.rand((B, 3), generator=gpu, device="cuda")).to(dtype) if P % 2 else None
    b = _randn(gpu, 3, dtype=dtype)
    variant = "mma" if dtype == torch.bfloat16 else "chunked"
    v0 = modulated_conv.modulated_matmul.launches_by_variant[variant]
    got = modulated_conv.modulated_matmul_launch(x, s, w, d, b, variant)
    assert modulated_conv.modulated_matmul.launches_by_variant[variant] == v0 + 1
    _close(got, modulated_conv.modulated_matmul_plain(x, s, w, d, b), dtype)


@pytest.mark.parametrize("dtype,shape,variant", [
    (torch.bfloat16, (2, 40000, 32, 3), "mma"),      # above 2 Mi input values
    (torch.bfloat16, (3, 1400, 512, 3), "mma"),
    (torch.bfloat16, (16, 256, 512, 3), "chunked"),  # launch-sized
    (torch.bfloat16, (2, 50, 16, 3), "chunked"), (torch.float32, (2, 40000, 32, 3), "chunked"),
    (torch.bfloat16, (2, 50, 24, 3), "chunked"), (torch.float32, (2, 50, 64, 5), "chunked"),
])
def test_modulated_matmul_takes_the_variant_of_its_rule(gpu, dtype, shape, variant):
    B, P, I, O = shape
    x = _randn(gpu, B, P, I, dtype=dtype)
    s = (1.0 + 0.5 * _randn(gpu, B, I)).to(dtype)
    w = (_randn(gpu, I, O) / math.sqrt(I)).to(dtype)
    b = _randn(gpu, O, dtype=dtype)
    v0 = modulated_conv.modulated_matmul.launches_by_variant[variant]
    got = modulated_conv.modulated_matmul(x, s, w, None, b)
    assert modulated_conv.modulated_matmul.launches_by_variant[variant] == v0 + 1
    _close(got, modulated_conv.modulated_matmul_plain(x, s, w, None, b), dtype)


@pytest.mark.parametrize("I", [32, 128, 512])
@pytest.mark.parametrize("variant", ["mma", "chunked"])
def test_modulated_matmul_variants_on_one_input(gpu, I, variant):
    """Both variants take a bf16 ToRGB call; each agrees with the plain
    version on the same operands (through `modulated_matmul_launch`)."""
    x = _randn(gpu, 2, 300, I, dtype=torch.bfloat16)
    s = (1.0 + 0.5 * _randn(gpu, 2, I)).bfloat16()
    w = (_randn(gpu, I, 3) / math.sqrt(I)).bfloat16()
    b = _randn(gpu, 3, dtype=torch.bfloat16)
    got = modulated_conv.modulated_matmul_launch(x, s, w, None, b, variant)
    _close(got, modulated_conv.modulated_matmul_plain(x, s, w, None, b), torch.bfloat16)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("style", [True, False])
@pytest.mark.parametrize("demod", [True, False])
@pytest.mark.parametrize("I,O,variant", [(64, 3, "mma"), (16, 3, "chunked"), (20, 3, "chunked"),
                                         (7, 3, "chunked"), (64, 5, "chunked")])
def test_modulated_matmul_variants(gpu, dtype, style, demod, I, O, variant):
    """style and demod each given and None, on both variants with O = 3, on
    rows that are no whole 16-byte vectors (vec = 1, or 2.5 vectors in
    bf16), and on O != 3; an output run that starts off a 16-byte line
    (B = 2, P = 35)."""
    B, P = 2, 35
    if dtype == torch.float32:
        variant = "chunked"
    x = _randn(gpu, B, P, I, dtype=dtype)
    s = (1.0 + 0.5 * _randn(gpu, B, I)).to(dtype) if style else None
    w = (_randn(gpu, I, O) / math.sqrt(I)).to(dtype)
    d = (0.5 + torch.rand((B, O), generator=gpu, device="cuda")).to(dtype) if demod else None
    b = _randn(gpu, O, dtype=dtype)
    got = modulated_conv.modulated_matmul_launch(x, s, w, d, b, variant)
    _close(got, modulated_conv.modulated_matmul_plain(x, s, w, d, b), dtype)


@pytest.mark.parametrize("I", [32, 64, 128, 256, 512])
@pytest.mark.parametrize("variant", ["mma", "chunked"])
def test_modulated_matmul_folds_the_weights_in_fp32(gpu, I, variant):
    """The folded weights s*w are not rounded to bf16. With s = 1 + 2^-7 on
    even k (1 on odd), w = 1 + 2^-7 and x = +1, -1 alternating, the fp32
    folds 1 + 2^-6 + 2^-14 and 1 + 2^-7 sum to I/2 * (2^-7 + 2^-14), a bf16
    value; folds rounded to bf16 would lose the 2^-14 and give I/2 * 2^-7."""
    e = 2.0 ** -7
    k = torch.arange(I, device="cuda")
    x = (1.0 - 2.0 * (k % 2)).expand(2, 70, I).contiguous().bfloat16()
    s = (1.0 + e * (1 - k % 2)).expand(2, I).contiguous().bfloat16()
    w = torch.full((I, 3), 1.0 + e, device="cuda").bfloat16()
    b = torch.zeros(3, device="cuda").bfloat16()
    got = modulated_conv.modulated_matmul_launch(x, s, w, None, b, variant)
    torch.cuda.synchronize()
    want = I / 2 * (e + e * e)
    assert torch.equal(got.float(), torch.full_like(got, want).float())
    assert torch.equal(got, modulated_conv.modulated_matmul_plain(x, s, w, None, b))


def test_modulated_matmul_unaligned_x_takes_scalar_rows(gpu):
    """A view that starts off a 16-byte line: vec = 1, the chunked variant."""
    base = _randn(gpu, 2 * 16 * 32 + 1, dtype=torch.bfloat16)
    x = base[1:].view(2, 16, 32)
    s, w, b = (_randn(gpu, 2, 32, dtype=torch.bfloat16),
               _randn(gpu, 32, 3, dtype=torch.bfloat16), _randn(gpu, 3, dtype=torch.bfloat16))
    v0 = modulated_conv.modulated_matmul.launches_by_variant["chunked"]
    got = modulated_conv.modulated_matmul(x, s, w, None, b)
    assert modulated_conv.modulated_matmul.launches_by_variant["chunked"] == v0 + 1
    _close(got, modulated_conv.modulated_matmul_plain(x, s, w, None, b), torch.bfloat16)


def test_modulated_matmul_rejects_what_the_kernel_does_not_take(gpu):
    x, s = _randn(gpu, 2, 16, 32), _randn(gpu, 2, 32)
    w, b = _randn(gpu, 32, 3), _randn(gpu, 3)
    with pytest.raises(ValueError):        # style of another batch
        modulated_conv.modulated_matmul(x, s[:1], w, None, b)
    with pytest.raises(TypeError):         # operands of two dtypes
        modulated_conv.modulated_matmul(x, s.bfloat16(), w, None, b)
    with pytest.raises(ValueError):        # not contiguous
        modulated_conv.modulated_matmul(x.transpose(0, 1), s, w, None, b)
    with pytest.raises(ValueError):        # CPU/CUDA mix
        modulated_conv.modulated_matmul(x, s, w.cpu(), None, b)
    with pytest.raises(ValueError):        # the tensor-core variant is bf16 only
        modulated_conv.modulated_matmul_launch(x, s, w, None, b, "mma")
    with pytest.raises(ValueError):        # nor any other O
        modulated_conv.modulated_matmul_launch(
            x.bfloat16(), s.bfloat16(), _randn(gpu, 32, 5, dtype=torch.bfloat16), None,
            _randn(gpu, 5, dtype=torch.bfloat16), "mma")


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


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("pad0,n", [(0, 17), (1, 16)])
def test_s2d_conv2x2_shared_weights_at_c256(gpu, dtype, pad0, n):
    """C' = 256, BigGAN-deep's 256 px fold (one shared weight set): bf16
    takes the wgmma_stream variant, fp32 the fp32 one, which reads set 0 for
    every sample; against the plain version, and against B folded copies of
    unit scales (the wmma variant in bf16, within the tolerance, since the
    two sum in other orders; fp32 bitwise, one kernel)."""
    x, K, ones, _ = _s2d_args(gpu, 3, n, 256, False, dtype)
    variant = s2d.conv2x2_variant(dtype, 256, shared=True)
    assert variant == ("wgmma_stream" if dtype == torch.bfloat16 else "fp32")
    v0 = s2d.s2d_conv2x2.launches_by_variant[variant]
    got = s2d.s2d_conv2x2(x, K, None, None, pad0)
    assert s2d.s2d_conv2x2.launches_by_variant[variant] == v0 + 1
    want = s2d.s2d_conv2x2_plain(x, K, None, None, pad0)
    assert got.shape == want.shape == (3, n + 2 * pad0 - 1, n + 2 * pad0 - 1, 256)
    _close_scaled(got, want, dtype)
    folded = s2d.s2d_conv2x2(x, K, ones, ones, pad0)
    if dtype == torch.bfloat16:
        _close_scaled(got, folded, dtype)
    else:
        assert torch.equal(got, folded)


@pytest.mark.parametrize("B,n,pad0", [
    (1, 11, 0), (3, 11, 1),        # below one 32-cell tile row
    (2, 70, 0), (1, 70, 1),        # ragged rows, both halos
    (3, 129, 1), (5, 33, 0),       # 130 cells; more tiles than blocks per sample
    (64, 129, 0), (32, 129, 0)])   # BigGAN-deep-256's and -512's block 11 (pop 64, 32)
def test_s2d_conv2x2_wgmma_stream_kernel(gpu, B, n, pad0):
    """The C' = 256 route with weights streamed by TMA against the plain
    version, at BigGAN-deep's shapes and the edges of its tiles."""
    x, K, _, _ = _s2d_args(gpu, B, n, 256, False, torch.bfloat16)
    v0 = dict(s2d.s2d_conv2x2.launches_by_variant)
    got = s2d.s2d_conv2x2(x, K, None, None, pad0)
    assert s2d.s2d_conv2x2.launches_by_variant["wgmma_stream"] == v0["wgmma_stream"] + 1
    assert s2d.s2d_conv2x2.launches_by_variant["wmma"] == v0["wmma"]
    want = s2d.s2d_conv2x2_plain(x, K, None, None, pad0)
    assert got.shape == want.shape == (B, n + 2 * pad0 - 1, n + 2 * pad0 - 1, 256)
    _close_scaled(got, want, torch.bfloat16)


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


def test_tiny_biggan_fitness_on_gpu_matches_cpu(gpu):
    """The smoke run's BigGAN agreement phase: the TINY BigGAN fitness
    through kernel 4 on the card against the plain versions on the CPU,
    fp32, plain and with both blocks' mid segments in the s2d domain (3
    launches per evaluation)."""
    import chip_smoke

    chip_smoke.phase_agreement_biggan()


def test_tiny_gpt2_img2txt_on_gpu_matches_cpu(gpu):
    """The smoke run's GPT-2 agreement phase: the TINY GPT2 fitness and a
    24-token argmax decode on the card against the CPU, fp32: ids
    token-exact, F within 1e-6, both tokenizers on the native core, no
    kernel of the package launched."""
    import chip_smoke

    chip_smoke.phase_agreement_gpt2()


def test_gpt2_argmax_takes_the_first_of_tied_maxima_on_gpu(gpu):
    """A planted tie at the largest bf16 logit of a [100, 50257] row block
    on the card: the first index wins, as on the CPU and in jnp.argmax."""
    from clip_glass_torch.models.gpt2 import model as g2

    logits = _randn(gpu, 100, 50257).to(torch.bfloat16)
    logits[:, 777] = logits[:, 31000] = logits[:, 50000] = 9.0
    logits[5, 3] = 9.0
    got = g2._select_next(logits, 1.0, 40, False, None)
    want = torch.full((100,), 777, device="cuda")
    want[5] = 3
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), g2._select_next(logits.cpu(), 1.0, 40, False, None))


def test_tiny_batched_fitness_on_gpu_matches_cpu(gpu):
    """The smoke run's batched agreement phase: K = 3 searches' fitness in
    one batched evaluation on the card against the CPU, TINY models, fp32:
    StyleGAN2 `_d` (plain and s2d), `_nod`, BigGAN and GPT-2, each kernel
    launched once per call site."""
    import chip_smoke

    chip_smoke.phase_agreement_batched()


@pytest.mark.parametrize("kernel,variant", [("noise_bias_lrelu", None), ("upsample2x", "tiled"),
                                            ("modulated_matmul", "mma"),
                                            ("s2d_conv2x2", "wgmma")])
def test_kernels_at_a_batch_of_64(gpu, kernel, variant):
    """Each kernel against its plain version at a batch of 64 rows (four
    searches of 16), bf16, on the variant its rule names for the shape."""
    dtype = torch.bfloat16
    if kernel == "noise_bias_lrelu":
        x, noise = _randn(gpu, 64, 32, 32, 64, dtype=dtype), _randn(gpu, 32, 32, dtype=dtype)
        ns, b = torch.tensor(0.7, device="cuda").to(dtype), _randn(gpu, 64, dtype=dtype)
        args, wrapper = (x, noise, ns, b), bias_act.noise_bias_lrelu
        plain = bias_act.noise_bias_lrelu_plain
    elif kernel == "upsample2x":
        args, wrapper = (_randn(gpu, 64, 64, 64, 3, dtype=dtype),), upfirdn.upsample2x
        plain = upfirdn.upsample2x_plain
    elif kernel == "modulated_matmul":
        x = _randn(gpu, 64, 64 * 64, 64, dtype=dtype)
        s = (1.0 + 0.5 * _randn(gpu, 64, 64)).to(dtype)
        w = (_randn(gpu, 64, 3) / 8.0).to(dtype)
        args = (x, s, w, None, _randn(gpu, 3, dtype=dtype))
        wrapper, plain = modulated_conv.modulated_matmul, modulated_conv.modulated_matmul_plain
    else:
        args = (*_s2d_args(gpu, 64, 33, 128, True, dtype), 1)
        wrapper, plain = s2d.s2d_conv2x2, s2d.s2d_conv2x2_plain
    n0 = wrapper.launches
    v0 = dict(getattr(wrapper, "launches_by_variant", {}))
    got = wrapper(*args)
    assert wrapper.launches == n0 + 1
    if variant is not None:
        assert wrapper.launches_by_variant[variant] == v0[variant] + 1
    (_close_scaled if kernel == "s2d_conv2x2" else _close)(got, plain(*args), dtype)


# (B, H, W, I, O, k, stride, pad0, pad1, lhs_dilation): odd channels (the
# byte gather), I % 16 == 0 (the 16-byte gather), every geometry of `_conv`,
# tiles with ragged M, N and K edges
CONV_S8_GEOMETRIES = [
    (2, 7, 5, 3, 5, 3, 1, 1, 1, 1),
    (2, 8, 8, 16, 24, 3, 2, 1, 0, 1),
    (1, 5, 6, 8, 7, 3, 1, 2, 2, 2),
    (2, 9, 9, 32, 16, 2, 1, 0, -1, 1),
    (1, 6, 6, 12, 4, 4, 1, 2, 1, 2),
    (2, 10, 10, 20, 9, 1, 2, -1, -1, 1),
    (3, 17, 17, 128, 128, 2, 1, 1, 1, 1),
    (2, 9, 9, 64, 200, 3, 1, 1, 1, 2),
    (1, 33, 31, 48, 65, 3, 2, 1, 1, 1),
]


@pytest.mark.parametrize("out_dtype", [torch.int32, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("geom", CONV_S8_GEOMETRIES, ids=lambda g: "x".join(map(str, g)))
def test_conv_s8_kernel_is_bitwise_its_plain_version(gpu, geom, out_dtype):
    """The int8 conv's int32 accumulators, and its dequantized outputs, equal
    the exact plain version bitwise."""
    from clip_glass_torch.ops.conv_s8 import conv_s8, conv_s8_plain

    B, H, W, I, O, k, stride, pad0, pad1, d = geom
    xq = torch.randint(-127, 128, (B, H, W, I), generator=gpu, device="cuda").to(torch.int8)
    wq = torch.randint(-127, 128, (O, I, k, k), generator=gpu, device="cuda").to(torch.int8)
    scale = torch.rand(O, generator=gpu, device="cuda") * 1e-3
    kw = dict(stride=stride, pad0=pad0, pad1=pad1, lhs_dilation=d, out_dtype=out_dtype)
    n0 = conv_s8.launches
    got = conv_s8(xq, wq, scale, **kw)
    assert conv_s8.launches == n0 + 1
    want = conv_s8_plain(xq, wq, scale, **kw)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == out_dtype and got.shape == want.shape
    assert torch.equal(got, want)


# dilated geometries of the polyphase split: the s2d 4x4 up conv's (k 4, pad
# 1), the plain levels' 3x3 up conv's (k 3, pad 2), k 1 (phases without a
# tap), cropped and uneven pads; and sites with many K steps, several N
# tiles and more tiles than SMs
CONV_S8_WGMMA_GEOMETRIES = [
    (2, 9, 7, 32, 40, 4, 1, 1, 1, 2),
    (1, 8, 8, 16, 16, 3, 1, 2, 2, 2),
    (2, 5, 6, 16, 8, 1, 1, 0, 0, 2),
    (2, 7, 6, 48, 24, 3, 1, -1, 2, 2),
    (1, 6, 5, 16, 130, 4, 1, 3, 0, 2),
    (1, 12, 12, 512, 256, 3, 1, 1, 1, 1),
    (8, 64, 64, 32, 64, 3, 1, 1, 1, 1),
    (2, 17, 17, 64, 128, 3, 2, 0, 0, 1),
]


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("out_dtype", [torch.int32, torch.bfloat16])
@pytest.mark.parametrize("geom", CONV_S8_GEOMETRIES + CONV_S8_WGMMA_GEOMETRIES,
                         ids=lambda g: "x".join(map(str, g)))
def test_conv_s8_fused_entry_is_bitwise_its_plain_version(gpu, geom, out_dtype, x_dtype):
    """A float x with x_inv_scale: quantized in the wgmma route's gather (or
    by `quantize` before the mma_sync route), bitwise the plain version of
    the quantized x; each call on the route `conv_s8_variant` names, and
    the int8 entry on the same route bitwise the same."""
    from clip_glass_torch.ops import quant
    from clip_glass_torch.ops.conv_s8 import conv_s8, conv_s8_plain, conv_s8_variant, quantize

    B, H, W, I, O, k, stride, pad0, pad1, d = geom
    x = (3.0 * torch.randn((B, H, W, I), generator=gpu, device="cuda")).to(x_dtype)
    wq = torch.randint(-127, 128, (O, I, k, k), generator=gpu, device="cuda").to(torch.int8)
    scale = torch.rand(O, generator=gpu, device="cuda") * 1e-3
    inv = quant.activation_inv_scale(6.0)   # some entries saturate, some round to .5
    kw = dict(stride=stride, pad0=pad0, pad1=pad1, lhs_dilation=d, out_dtype=out_dtype)
    variant = conv_s8_variant(I, stride, d)
    v0 = conv_s8.launches_by_variant[variant]
    got = conv_s8(x, wq, scale, x_inv_scale=inv, **kw)
    assert conv_s8.launches_by_variant[variant] == v0 + 1
    xq = quantize(x, inv)
    want = conv_s8_plain(xq, wq, scale, **kw)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == out_dtype and got.shape == want.shape
    assert torch.equal(got, want)
    assert torch.equal(conv_s8(xq, wq, scale, **kw), want)


@pytest.mark.parametrize("d", [1, 2])
def test_conv_s8_routes_agree_bitwise(gpu, d):
    """The wgmma route and the mma_sync route on the same int8 operands."""
    from clip_glass_torch.ops.conv_s8 import conv_s8_launch

    xq = torch.randint(-127, 128, (2, 21, 19, 64), generator=gpu, device="cuda").to(torch.int8)
    wq = torch.randint(-127, 128, (96, 64, 3, 3), generator=gpu, device="cuda").to(torch.int8)
    scale = torch.rand(96, generator=gpu, device="cuda")
    geom = dict(stride=1, pad0=2 if d == 2 else 1, pad1=2 if d == 2 else 1, lhs_dilation=d)
    a = conv_s8_launch(xq, wq, scale, geom, torch.int32, None, "wgmma")
    b = conv_s8_launch(xq, wq, scale, geom, torch.int32, None, "mma_sync")
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_conv_s8_rejects_what_the_kernel_does_not_take(gpu):
    from clip_glass_torch.ops.conv_s8 import conv_s8

    xq = torch.zeros((1, 4, 4, 8), dtype=torch.int8, device="cuda")
    wq = torch.zeros((4, 8, 3, 3), dtype=torch.int8, device="cuda")
    scale = torch.ones(4, device="cuda")
    with pytest.raises(TypeError):
        conv_s8(xq.float(), wq, scale)
    with pytest.raises(ValueError):
        conv_s8(xq, wq[:, :4], scale)
    with pytest.raises(ValueError):
        conv_s8(xq, wq, scale.cpu())
    with pytest.raises(TypeError):
        conv_s8(xq, wq, scale, out_dtype=torch.float16)


def test_tiny_int8_fitness_on_gpu_matches_cpu(gpu):
    """The smoke run's int8 agreement phase: the TINY int8 fitness (every
    conv a call site) on the card against the CPU with the CPU's scales,
    conv_s8 once per call site and kernel 4 at none."""
    import chip_smoke

    chip_smoke.phase_agreement_int8()


@pytest.mark.parametrize("name,shape", [
    ("noise_bias_lrelu", (2, 16, 16, 32)), ("upsample2x", (2, 16, 16, 3)),
    ("modulated_matmul", (2, 256, 32, 3)), ("s2d_conv2x2", (2, 33, 128, 1, True)),
    ("s2d_conv2x2", (2, 17, 256, 0, False)), ("s2d_conv2x2", (2, 13, 20, 1, True))])
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_gradient_equals_plain_autograd(gpu, name, shape, dtype):
    """The smoke run's gradient check at small shapes: the wrapper launches
    its kernel and returns a grad_fn, and its input gradients equal the
    plain version's autograd on the card; under inference_mode the direct
    launch."""
    import chip_smoke

    err, _, _ = chip_smoke._grad_case(name, shape, dtype, gpu)
    assert err <= TOL[dtype]


def test_tiny_generator_gradient_on_gpu_matches_cpu(gpu):
    """The TINY StyleGAN2 G (plain domain, fp32): its latent gradient on the
    card (kernels 1-3 under autograd) against the CPU's (plain versions)."""
    import chip_smoke

    got, want = chip_smoke._tiny_g_latent_grad("cuda"), chip_smoke._tiny_g_latent_grad("cpu")
    assert ((got - want).abs().max() / want.abs().max()).item() <= chip_smoke.GRAD_G_TOL


def test_conv_s8_raises_under_grad_on_gpu(gpu):
    from clip_glass_torch.ops.conv_s8 import conv_s8

    x = torch.randn((1, 6, 6, 32), device="cuda", requires_grad=True)
    wq = torch.zeros((8, 32, 3, 3), dtype=torch.int8, device="cuda")
    with pytest.raises(RuntimeError, match="inference-only"):
        conv_s8(x, wq, torch.ones(8, device="cuda"), pad0=1, pad1=1, x_inv_scale=2.0)
    with torch.inference_mode():
        conv_s8(x, wq, torch.ones(8, device="cuda"), pad0=1, pad1=1, x_inv_scale=2.0)


def _projector_model(tmp_path):
    """config-f cut to its top 5 levels (64 px, 512 channels at 4 px) from a
    synthesized Gs.pth, and LPIPS-VGG16 at channels / 8 through the convert
    CLI (chip_smoke's writers)."""
    import dataclasses

    import chip_smoke
    from clip_glass_torch.models.stylegan2 import model as sg2

    cfg = dataclasses.replace(sg2.CONFIG_F, channels=tuple(sg2.CONFIG_F.channels[4:]))
    g, cfg = chip_smoke.synth_generator(str(tmp_path), cfg)
    return g, cfg, chip_smoke.lpips_weights(str(tmp_path), div=8)


def test_projector_step_on_gpu_matches_cpu(gpu, tmp_path):
    """The first projector step at 64 px, card against CPU, TF32 off: loss,
    distance, dlatents and noise planes within chip_smoke.STEP_TOL of their
    scale, Adam's first moment within STEP_GRAD_TOL and its second within
    twice that (`chip_smoke.projector_step_card_vs_cpu` raises past them)."""
    import chip_smoke

    rec = chip_smoke.projector_step_card_vs_cpu(*_projector_model(tmp_path))
    assert rec["loss"] <= chip_smoke.STEP_TOL and rec["mu"] <= chip_smoke.STEP_GRAD_TOL


def test_projector_gradient_through_kernels_equals_plain_route(gpu, tmp_path):
    """The projector's dlatent gradient on the card through kernels 1-3 (each
    recording through cuda._KernelGrad) against every wrapper taking its
    plain version, within chip_smoke.PROJ_GRAD_TOL of its scale."""
    import chip_smoke
    from clip_glass_torch.projector import Projector, ProjectorConfig

    g, cfg, lp = _projector_model(tmp_path)
    proj = Projector(g, cfg, cfg=ProjectorConfig(dlatent_samples=256), lpips_params=lp,
                     device="cuda")
    target = torch.rand((1, 3, 64, 64), generator=gpu, device="cuda")
    err, _ = chip_smoke.projector_grad_kernels_vs_plain(proj, target)
    assert err <= chip_smoke.PROJ_GRAD_TOL


def test_lpips_and_inception_on_gpu_match_cpu(gpu, tmp_path):
    """LPIPS-VGG16 (real geometry) and the FID Inception features (real
    geometry; one input upsampled to 299, one downsampled) on the card
    against the CPU, fp32, TF32 off: the distances within 1e-5 of their
    scale, the features within 1e-4 (94 convs deep)."""
    import chip_smoke
    from clip_glass_torch.core.dtypes import tree_to
    from clip_glass_torch.metrics import inception, lpips

    lp = chip_smoke.lpips_weights(str(tmp_path))
    inc = chip_smoke.inception_weights(str(tmp_path))
    gen = torch.Generator().manual_seed(3)
    x0, x1 = torch.rand((2, 2, 3, 96, 96), generator=gen)
    want = lpips.lpips(lp, x0, x1, 0.0, 1.0)
    got = lpips.lpips(tree_to(lp, "cuda"), x0.cuda(), x1.cuda(), 0.0, 1.0).cpu()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * want.abs().max().item())
    inc_gpu = tree_to(inc, "cuda")
    for size in (160, 512):
        x = torch.rand((1, 3, size, size), generator=gen)
        want = inception.features(inc, x)
        got = inception.features(inc_gpu, x.cuda()).cpu()
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * want.abs().max().item())


@pytest.mark.parametrize("name,shape", [
    ("noise_bias_lrelu", (2, 16, 16, 32)), ("upsample2x", (2, 16, 16, 3)),
    ("modulated_matmul", (2, 256, 32, 3)), ("s2d_conv2x2", (2, 33, 128, 1, True)),
    ("s2d_conv2x2", (2, 17, 256, 0, False))])
def test_kernel_second_derivative_equals_plain_version(gpu, name, shape):
    """A second derivative through each kernel's wrapper (the kernel's
    forward, `cuda._KernelGrad`'s graph-keeping backward) against the plain
    version's on the card, fp32, within TOL of its scale."""
    import chip_smoke

    assert chip_smoke._second_derivative_case(name, shape, gpu) <= TOL[torch.float32]


def test_trainer_step_on_gpu_matches_cpu(gpu, tmp_path):
    """Step 0 of the trainer (R1 and the path length penalty, batch 4) on
    config-f cut to its top 5 levels (64 px) from synthesized G.pth / D.pth,
    card against CPU, TF32 off, at learning rates 0 and at the defaults: the
    losses within chip_smoke.STEP_TOL, the gradients, grad norms and pl_avg
    within STEP_GRAD_TOL of their scale, the default rates' Adam update
    element by element (`chip_smoke.trainer_step_card_vs_cpu` raises past
    them)."""
    import dataclasses

    import chip_smoke
    from clip_glass_torch.models.stylegan2 import model as sg2

    cfg = dataclasses.replace(sg2.CONFIG_F, channels=tuple(sg2.CONFIG_F.channels[4:]))
    g, _, d, cfg = chip_smoke.trainer_weights(str(tmp_path), cfg)
    rec = chip_smoke.trainer_step_card_vs_cpu(g, d, cfg)
    assert rec["g_mu"] <= chip_smoke.STEP_GRAD_TOL and rec["d_loss"] <= chip_smoke.STEP_TOL
    assert rec["real_rate"]["d_loss"] <= chip_smoke.STEP_TOL


@pytest.mark.parametrize("phase", ["g", "pl"])
def test_trainer_gradient_through_kernels_equals_plain_route(gpu, tmp_path, phase):
    """A G gradient of the trainer on the card through the kernels against
    every wrapper taking its plain version, at 64 px, within
    chip_smoke.STEP_GRAD_TOL of its scale: G's loss (through D, so through
    the kernels' outputs) and the path length penalty (kernels 2 and 3's
    graph-keeping backward)."""
    import dataclasses

    import chip_smoke
    from clip_glass_torch.models.stylegan2 import model as sg2
    from clip_glass_torch.training.trainer import Trainer, TrainerConfig

    cfg = dataclasses.replace(sg2.CONFIG_F, channels=tuple(sg2.CONFIG_F.channels[4:]))
    g, _, d, cfg = chip_smoke.trainer_weights(str(tmp_path), cfg)
    tr = Trainer(cfg, TrainerConfig(checkpoint_every=0), g, d, device="cuda")
    err, _, counts = chip_smoke.trainer_grad_kernels_vs_plain(tr, phase)
    assert err <= chip_smoke.STEP_GRAD_TOL and counts[0]
    assert bool(counts[1]) == (phase == "pl")


def test_sharded_tiny_fitness_on_gpu_matches_unsharded(gpu):
    """The TINY `_d` fitness on the card split over a mesh of two shards on
    that card (one thread each, D's minibatch-std gathered across them)
    against the unsharded evaluation, both domains, fp32, TF32 off: cuDNN may
    take other algorithms at 4 rows than at 8, hence rtol 1e-4, atol 1e-5;
    each kernel (1-4 and the FIR) launches once a shard a call site, the
    batch norm never."""
    import dataclasses

    import chip_smoke
    from clip_glass_torch.config import get_config
    from clip_glass_torch.fitness.problem import GenerationProblem
    from clip_glass_torch.models.clip import model as clip_model
    from clip_glass_torch.models.stylegan2 import model as sg2
    from clip_glass_torch.parallel import make_mesh

    cfg = get_config("StyleGAN2_ffhq_d").replace(
        pop_size=8, dim_z=32, n_var=32, weights="random:0", target="a face",
        compute_dtype="float32")
    X = torch.randn((8, 32), generator=torch.Generator().manual_seed(1)).cuda()
    for model_cfg, per_eval in ((sg2.TINY, (5, 2, 3, 0, 6, 0)),
                                (dataclasses.replace(sg2.TINY, s2d_min_res=8),
                                 (5, 0, 1, 4, 0, 0))):
        F = {}
        for label, mesh in (("whole", None), ("sharded", make_mesh(["cuda:0", "cuda:0"]))):
            p = GenerationProblem(cfg, device="cuda", clip_cfg=clip_model.TINY,
                                  model_cfg=model_cfg, mesh=mesh)
            before = [k.launches for k in chip_smoke._kernels()]
            F[label] = p.generator.eval_population(X)
            moved = tuple(k.launches - n for k, n in zip(chip_smoke._kernels(), before))
            assert moved == tuple(n * (2 if mesh else 1) for n in per_eval), (label, moved)
        torch.testing.assert_close(F["sharded"], F["whole"], rtol=1e-4, atol=1e-5)


def test_launch_device_guard(gpu):
    """A wrapper launches under its tensor's card: nothing to switch when it
    is the current one."""
    from clip_glass_torch.ops import cuda

    x = _randn(gpu, 2, 4, 4, 8)
    assert isinstance(cuda.launch_device(x), type(cuda._CURRENT))


def test_kernels_launch_on_the_tensors_card():
    """Every kernel on tensors of card 1 while card 0 is current (a process
    that drives two cards of a mesh): the result equals the plain version,
    and card 0 stays current."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards: the guard makes a tensor's card current for "
                    "its launch, which one card cannot show")
    gen = torch.Generator(device="cuda:1").manual_seed(0)

    def r(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda:1").to(dtype)

    torch.cuda.set_device(0)
    x, noise, ns, b = r(2, 8, 8, 64), r(8, 8), torch.tensor(0.7, device="cuda:1").bfloat16(), r(64)
    _close(bias_act.noise_bias_lrelu(x, noise, ns, b),
           bias_act.noise_bias_lrelu_plain(x, noise, ns, b), torch.bfloat16)
    x = r(4, 32, 32, 3)
    _close(upfirdn.upsample2x(x), upfirdn.upsample2x_plain(x), torch.bfloat16)
    x, style, w, demod, bias = r(2, 1024, 64), r(2, 64), r(64, 3), None, r(3)
    _close(modulated_conv.modulated_matmul(x, style, w, demod, bias),
           modulated_conv.modulated_matmul_plain(x, style, w, demod, bias), torch.bfloat16)
    x, K, s, d = r(2, 9, 9, 64), r(2, 2, 64, 64), r(2, 64), r(2, 64)
    got, want = s2d.s2d_conv2x2(x, K, s, d, 0), s2d.s2d_conv2x2_plain(x, K, s, d, 0)
    torch.cuda.synchronize(1)
    scale = want.float().abs().max()
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2 * scale)
    assert torch.cuda.current_device() == 0


# ------------------------------------------------------------ meta rules, CLIP tensor parallelism

def _kernel_operands(gen, dtype):
    """name -> (wrapper, operands on the card) at a flagship-like shape."""
    r = lambda *shape: _randn(gen, *shape, dtype=dtype)  # noqa: E731
    return {
        "noise_bias_lrelu": (bias_act.noise_bias_lrelu,
                             (r(2, 16, 16, 64), r(16, 16), torch.tensor(0.5, device="cuda")
                              .to(dtype), r(64))),
        "upsample2x": (upfirdn.upsample2x, (r(4, 32, 32, 3),)),
        "modulated_matmul": (modulated_conv.modulated_matmul,
                             (r(2, 1024, 64), r(2, 64), r(64, 3), r(2, 3), r(3))),
        "s2d_conv2x2": (s2d.s2d_conv2x2, (r(2, 9, 9, 64), r(2, 2, 64, 64), r(2, 64),
                                          r(2, 64), 1)),
        "fir": (upfirdn.fir, (r(2, 17, 17, 64), (1, 3, 3, 1), 4.0, 1, 1)),
    }


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ["noise_bias_lrelu", "upsample2x", "modulated_matmul",
                                  "s2d_conv2x2", "fir"])
def test_meta_rule_equals_the_kernels_output(gpu, dtype, name):
    """A wrapper on meta operands (core.memory's estimates) allocates what
    its kernel returns on the card: shape, dtype and strides."""
    wrapper, args = _kernel_operands(gpu, dtype)[name]
    got = wrapper(*args)
    meta = wrapper(*(a.to("meta") if isinstance(a, torch.Tensor) else a for a in args))
    assert meta.is_meta
    assert (meta.shape, meta.dtype, meta.stride()) == (got.shape, got.dtype, got.stride())


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16, torch.int32])
def test_conv_s8_meta_rule_equals_the_kernels_output(gpu, out_dtype):
    from clip_glass_torch.ops.conv_s8 import conv_s8

    x = _randn(gpu, 2, 16, 16, 64, dtype=torch.bfloat16)
    wq = torch.randint(-127, 128, (32, 64, 3, 3), generator=gpu, device="cuda",
                       dtype=torch.int8)
    scale = torch.rand(32, generator=gpu, device="cuda")
    kw = dict(stride=1, pad0=1, pad1=1, out_dtype=out_dtype, x_inv_scale=10.0)
    got = conv_s8(x, wq, scale, **kw)
    meta = conv_s8(x.to("meta"), wq.to("meta"), scale.to("meta"), **kw)
    assert (meta.shape, meta.dtype) == (got.shape, got.dtype)


@pytest.mark.parametrize("tower", ["image", "text"])
def test_clip_tensor_parallel_equals_the_whole_tower(gpu, tower):
    """TINY CLIP at fp32 on a (1, 2) mesh of the card listed twice: the
    heads and MLP columns split over the model group, the partial products
    summed; the features equal the whole tower's."""
    import dataclasses

    from clip_glass_torch.core.dtypes import FP32, tree_to
    from clip_glass_torch.models.clip import model as clip_model
    from clip_glass_torch.parallel.mesh import make_mesh, model_sum, shard_clip_tp

    cfg = dataclasses.replace(clip_model.TINY, vision_width=256, transformer_heads=4)
    params = tree_to(clip_model.init(torch.Generator().manual_seed(0), cfg), "cuda")
    if tower == "image":
        x = torch.rand((4, 3, 32, 32), generator=gpu, device="cuda")
        fn = clip_model.encode_image
    else:
        x = torch.randint(1, 49406, (4, 77), generator=gpu, device="cuda")
        x[:, 5] = 49407
        fn = clip_model.encode_text
    want = fn(params, x, cfg, FP32)
    mesh = make_mesh(["cuda:0", "cuda:0"], model_axis_size=2)
    shards = shard_clip_tp(params, mesh)
    got = mesh.map(lambda i, rows: fn(shards[i], rows, cfg, FP32, tp=2, reduce=model_sum),
                   [x, x])
    for g in got:
        torch.testing.assert_close(g, want, rtol=1e-5, atol=1e-5)
