"""The int8 quantized fitness of the port (clip_glass_torch/ops/quant.py,
ops/conv_s8.py) against the JAX package's (clip_glass_tpu/ops/quant.py),
on the CPU, TINY models, numpy inputs from a seed, fp32, with the JAX side
run as tests/test_quant.py runs it (its default path: no
CLIP_GLASS_PALLAS_S2D).

- (a) the eligibility predicate on the port's OIHW layout;
- (b) on the power-of-two grid of tests/test_quant.py every step of the
  int8 path is exact, so the port's int8 output equals its float output
  bitwise: conv2d, the s2d folds (0, 0) and (0, -1), the lhs_dilation=2 up
  conv and the stride-2 down conv;
- (c) `conv_s8_plain` on identical int8 operands: its int32 output equals
  JAX's lax.conv_general_dilated(..., preferred_element_type=int32)
  bitwise, and a scope's dequantized conv equals JAX's quant.conv_hook
  bitwise (fp32 and bf16), at odd shapes and every geometry `_conv` takes;
- (d) saturation stays finite, running out of scales raises, a dead scale
  keeps the float path;
- (e) the calibration of the whole fitness walks JAX's call sites: the same
  count and the same absmax values (rtol 1e-5, fp32) on the same X0, for
  StyleGAN2 `_d` plain and s2d, `_nod`, BigGAN with s2d mid segments (whose
  plain convs are no sites) and GPT-2 (no site);
- (f) with JAX's scales handed to the port, the int8 F equals JAX's int8 F:
  the similarity within 5e-3 absolute, the hinge within 1e-2 of
  max(|hinge|, 1) (ten times tighter than tests/test_quant.py's int8 vs
  float bounds, 0.05 and 0.25): float rounding may move an activation
  across a rounding boundary of its int8 grid, nothing more;
- (g) microbatching (a fresh scope per chunk), K = 3 batched int8 against
  each search's own int8 evaluation (rtol 1e-4, tests/test_batched.py's),
  a full NSGA-II step with finite F, and GPT-2 int8 equal to its exact F
  bitwise.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax import lax

import torch

from clip_glass_tpu.config import get_config as jget_config
from clip_glass_tpu.fitness.problem import GenerationProblem as JProblem
from clip_glass_tpu.models.clip import model as jclip
from clip_glass_tpu.models.stylegan2 import model as jsg2
from clip_glass_tpu.ops import modulated_conv as jmc
from clip_glass_tpu.ops import quant as jquant

from clip_glass_torch.config import get_config
from clip_glass_torch.fitness.problem import GenerationProblem
from clip_glass_torch.models.clip import model as tclip
from clip_glass_torch.models.gpt2 import model as tg2
from clip_glass_torch.models.stylegan2 import model as tsg2
from clip_glass_torch.ops import quant
from clip_glass_torch.ops import s2d as S
from clip_glass_torch.ops.conv_s8 import conv_s8, conv_s8_plain, out_size
from clip_glass_torch.ops.modulated_conv import _conv, conv2d
from clip_glass_torch.weights import from_jax

from torch_parity import N, T, oihw

POP = 8
TARGETS = ["a red flower", "a blue car", "an old house"]
DOG = "examples/gpt2_images/dog.jpeg"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread a test (the lane runs six test processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ (a)


def test_eligibility_predicate_on_port_layouts():
    """OIHW [O, I, kh, kw]: both channel counts count, the taps do not."""
    assert quant.eligible((64, 64, 3, 3), 64)
    assert not quant.eligible((128, 48, 3, 3), 64)   # I = 48: RGB-class folds stay float
    assert not quant.eligible((12, 128, 1, 1), 64)   # O = 12
    assert quant.eligible((128, 128, 2, 2), 64)
    assert quant.eligible((3, 5, 1, 1), 1)
    # JAX's HWIO predicate on the same convs
    for o, i in ((64, 64), (128, 48), (12, 128), (128, 128)):
        assert quant.eligible((o, i, 3, 3), 64) == jquant.eligible((3, 3, i, o), 64)
    assert not quant.hooked((64, 64, 3, 3))          # no scope, no site
    with quant.calibration(64):
        assert quant.hooked((64, 64, 3, 3)) and not quant.hooked((3, 64, 1, 1))


# ------------------------------------------------------------ (b)


def _int_grid_inputs(seed=0, b=2, hw=8, c=64):
    """tests/test_quant.py's inputs: weights on the int8 grid * 2^-10 and
    activations on an integer grid * 2^-3, the absmax entries pinned so
    every scale is a power of two and the int8 path is exact. HWIO."""
    rng = np.random.default_rng(seed)
    w = rng.integers(-127, 128, size=(3, 3, c, c)).astype(np.float32) * 2**-10
    w[0, 0, 0, :] = 127 * 2**-10
    x = rng.integers(-127, 128, size=(b, hw, hw, c)).astype(np.float32) * 2**-3
    x[0, 0, 0, :] = 127 * 2**-3
    return x, w


def _calibrated(fn, *args, min_ch=1, margin=1.0):
    with quant.calibration(min_ch) as rec:
        y = fn(*args)
    return y, torch.stack(rec).double().numpy() * margin


def _int8(fn, scales, *args, min_ch=1):
    with quant.int8_scope(scales, min_ch):
        return fn(*args)


def _exact_case(name):
    x, w = _int_grid_inputs(seed={"conv2d": 0, "fold_0_0": 1, "fold_0_m1": 2,
                                  "up": 5, "down": 6}[name])
    xt, wt = T(x), oihw(w)
    if name == "conv2d":
        return conv2d, (xt, wt)
    if name.startswith("fold"):
        out_off = 0 if name == "fold_0_0" else -1
        return (lambda xx, ww: S.s2d_conv2d(xx, ww, 0, out_off)), (S.s2d(xt), wt)
    if name == "up":   # modulated_conv2d_up's conv: the flipped kernel, 2-dilated input
        return (lambda xx, ww: _conv(xx, ww.flip(2, 3), lhs_dilation=2, pad0=2, pad1=2)), (xt, wt)
    return (lambda xx, ww: _conv(xx, ww, stride=2, pad0=1, pad1=0)), (xt, wt)


@pytest.mark.parametrize("name", ["conv2d", "fold_0_0", "fold_0_m1", "up", "down"])
def test_int8_exact_on_pow2_grid(name):
    fn, args = _exact_case(name)
    plain, scales = _calibrated(fn, *args)
    assert scales.shape == (1,) and scales[0] == 127 * 2**-3   # the pinned absmax
    out = _int8(fn, scales, *args)
    torch.testing.assert_close(out, plain, rtol=0, atol=0)
    # the [2,2] fold under no scope is kernel 4's plain version: the same values
    if name == "fold_0_m1":
        torch.testing.assert_close(fn(*args), plain, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_up_conv_forms_agree(dtype):
    """modulated_conv2d_up outside a scope keeps its conv_transpose2d form;
    inside one it takes the JAX package's dilated `_conv` form (a call
    site). On the same inputs the two forms give the same output bitwise."""
    from clip_glass_torch.ops.modulated_conv import modulated_conv2d_up

    rng = np.random.default_rng(7)
    x = T(rng.standard_normal((2, 5, 6, 8)).astype(np.float32)).to(dtype)
    w = T(rng.standard_normal((7, 8, 3, 3)).astype(np.float32)).to(dtype)
    style = T(1.0 + 0.1 * rng.standard_normal((2, 8)).astype(np.float32))
    outside = modulated_conv2d_up(x, w, style)
    with quant.calibration(1) as rec:
        inside = modulated_conv2d_up(x, w, style)
    assert len(rec) == 1
    torch.testing.assert_close(inside, outside, rtol=0, atol=0)


# ------------------------------------------------------------ (c)

# (B, H, W, I, O, k, stride, pad0, pad1, lhs_dilation)
GEOMETRIES = [
    (2, 7, 5, 3, 5, 3, 1, 1, 1, 1),        # odd channels, SAME
    (2, 8, 8, 16, 24, 3, 2, 1, 0, 1),      # stride 2, the down conv
    (1, 5, 6, 8, 7, 3, 1, 2, 2, 2),        # lhs_dilation 2, the up conv
    (2, 9, 9, 32, 16, 2, 1, 0, -1, 1),     # a [2,2] fold, a negative pad
    (1, 6, 6, 12, 4, 4, 1, 2, 1, 2),       # [4,4] dilated, uneven pads
    (2, 10, 10, 20, 9, 1, 2, -1, -1, 1),   # 1x1, stride 2, cropped
]


def _int8_operands(B, H, W, I, O, k, seed):
    rng = np.random.default_rng(seed)
    xq = rng.integers(-127, 128, size=(B, H, W, I)).astype(np.int8)
    wq = rng.integers(-127, 128, size=(k, k, I, O)).astype(np.int8)   # HWIO
    return xq, wq


@pytest.mark.parametrize("geom", GEOMETRIES, ids=lambda g: "x".join(map(str, g)))
def test_conv_s8_plain_equals_jax_int32_conv(geom):
    B, H, W, I, O, k, stride, pad0, pad1, d = geom
    xq, wq = _int8_operands(B, H, W, I, O, k, seed=sum(geom))
    want = np.asarray(lax.conv_general_dilated(
        jnp.asarray(xq), jnp.asarray(wq), window_strides=(stride, stride),
        padding=((pad0, pad1), (pad0, pad1)), lhs_dilation=(d, d),
        dimension_numbers=jmc._DN, preferred_element_type=jnp.int32))
    scale = torch.ones(O)
    kw = dict(stride=stride, pad0=pad0, pad1=pad1, lhs_dilation=d)
    got = conv_s8_plain(torch.from_numpy(xq), torch.from_numpy(wq).permute(3, 2, 0, 1),
                        scale, out_dtype=torch.int32, **kw)
    assert got.dtype == torch.int32
    assert tuple(got.shape) == (B, out_size(H, k, stride, pad0, pad1, d),
                                out_size(W, k, stride, pad0, pad1, d), O) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    # the wrapper takes the plain version for a CPU tensor
    same = conv_s8(torch.from_numpy(xq), torch.from_numpy(wq).permute(3, 2, 0, 1), scale,
                   out_dtype=torch.int32, **kw)
    np.testing.assert_array_equal(same.numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("geom", GEOMETRIES, ids=lambda g: "x".join(map(str, g)))
def test_scoped_conv_equals_jax_conv_hook(geom, dtype):
    """The whole int8 site, quantize + int32 conv + dequantize, from the same
    float operands in both packages: bitwise."""
    B, H, W, I, O, k, stride, pad0, pad1, d = geom
    rng = np.random.default_rng(sum(geom) + 1)
    x = rng.normal(size=(B, H, W, I)).astype(np.float32)
    w = (rng.normal(size=(k, k, I, O)) / np.sqrt(k * k * I)).astype(np.float32)
    sx = float(np.abs(x).max()) * 0.8   # some entries saturate
    kw = dict(stride=stride, pad0=pad0, pad1=pad1, lhs_dilation=d)
    jd = getattr(jnp, dtype)

    def jfn(xx, ww):
        with jquant.int8_scope(np.asarray([sx]), min_ch=1):
            return jmc._conv(xx, ww, **kw)
    want = np.asarray(jax.jit(jfn)(jnp.asarray(x, jd), jnp.asarray(w, jd)).astype(jnp.float32))
    td = getattr(torch, dtype)
    with quant.int8_scope([sx], 1):
        got = _conv(T(x).to(td), oihw(w).to(td), **kw)
    assert got.dtype == td
    np.testing.assert_array_equal(N(got), want)


def _scoped_site(geom_x, w_shape_oihw, geometry, dtype, seed):
    """The port's `_conv` and JAX's, each inside an int8 scope of one site,
    on the same float operands (a scale that saturates some entries):
    (port output, JAX output) as float32 numpy."""
    B, H, W, I = geom_x
    O, _, kh, kw = w_shape_oihw
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, H, W, I)).astype(np.float32)
    w = (rng.normal(size=(kh, kw, I, O)) / np.sqrt(kh * kw * I)).astype(np.float32)
    sx = float(np.abs(x).max()) * 0.8
    jd = getattr(jnp, dtype)

    def jfn(xx, ww):
        with jquant.int8_scope(np.asarray([sx]), min_ch=1):
            return jmc._conv(xx, ww, **geometry)
    want = np.asarray(jax.jit(jfn)(jnp.asarray(x, jd), jnp.asarray(w, jd)).astype(jnp.float32))
    td = getattr(torch, dtype)
    with quant.int8_scope([sx], 1):
        got = _conv(T(x).to(td), oihw(w).to(td), **geometry)
    return N(got), want


def test_fused_entry_equals_jax_conv_hook_at_the_tiny_flagship_sites():
    """Every conv_s8 call of the TINY int8 flagship evaluation (both
    domains) takes the fused entry, the float activation and its
    x_inv_scale = float32(127/sx), and at each of its geometries the port's
    site equals JAX's conv_hook bitwise (fp32 and bf16)."""
    from clip_glass_torch.ops import modulated_conv

    sites = {}
    real = modulated_conv.conv_s8

    def record(x, wq, scale, **kw):
        assert x.is_floating_point() and kw["x_inv_scale"] is not None
        geometry = {k: v for k, v in kw.items() if k not in ("out_dtype", "x_inv_scale")}
        sites[(tuple(x.shape), tuple(wq.shape), tuple(sorted(geometry.items())))] = geometry
        return real(x, wq, scale, **kw)

    for family in ("d", "d_s2d"):
        _, _, tprob = _pair(family)
        modulated_conv.conv_s8 = record
        try:
            with torch.inference_mode():
                tprob.generator.eval_population(torch.from_numpy(_X(family, seed=3)))
        finally:
            modulated_conv.conv_s8 = real
    assert len(sites) >= 10
    for i, ((x_shape, w_shape, _), geometry) in enumerate(sorted(sites.items())):
        for dtype in ("float32", "bfloat16"):
            got, want = _scoped_site(x_shape, w_shape, geometry, dtype, seed=40 + i)
            np.testing.assert_array_equal(got, want)


# (H, W, k, pad0, pad1): the flagship's 2x-up convs (k 3 at pad 2: the plain
# levels; k 4 at pad 1: the s2d up conv) and odd extents, cropped and uneven
# pads, k 1 (a phase without a tap) and k 2
POLYPHASE_CASES = [(4, 4, 3, 2, 2), (5, 7, 3, 2, 2), (5, 5, 4, 1, 1), (6, 3, 4, 1, 1),
                   (5, 6, 4, 2, 1), (4, 5, 3, -1, 2), (3, 4, 3, 0, 0), (5, 4, 1, 0, 0),
                   (4, 4, 2, 1, 0), (6, 5, 4, 3, 0)]


@pytest.mark.parametrize("case", POLYPHASE_CASES, ids=lambda c: "x".join(map(str, c)))
def test_polyphase_packing_equals_the_dilated_conv(case):
    """The per-phase weight packing (`phases`, `pack_weights`), applied phase
    by phase through the plain reference of the split
    (`conv_s8_phases_plain`), equals `conv_s8_plain` at lhs_dilation 2
    bitwise; the undilated conv is its one phase."""
    from clip_glass_torch.ops.conv_s8 import conv_s8_phases_plain, pack_weights, phases

    H, W, k, pad0, pad1 = case
    B, I, O = 2, 16, 5
    rng = np.random.default_rng(sum(case) + 50)
    xq = torch.from_numpy(rng.integers(-127, 128, size=(B, H, W, I)).astype(np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, size=(O, I, k, k)).astype(np.int8))
    for d, stride in ((2, 1), (1, 1), (1, 2)):
        Ho, Wo = out_size(H, k, stride, pad0, pad1, d), out_size(W, k, stride, pad0, pad1, d)
        if Ho < 1 or Wo < 1:
            continue
        plist = phases(k, k, stride, pad0, d, Ho, Wo)
        assert len(plist) == (4 if d == 2 and Ho > 1 and Wo > 1 else len(plist))
        got = conv_s8_phases_plain(xq, pack_weights(wq, plist, d), plist, stride=stride,
                                   lhs_dilation=d, Ho=Ho, Wo=Wo)
        want = conv_s8_plain(xq, wq, torch.ones(O), stride=stride, pad0=pad0, pad1=pad1,
                             lhs_dilation=d, out_dtype=torch.int32)
        assert torch.equal(got, want), (d, stride)


@pytest.mark.parametrize("k,pad0", [(3, 2), (4, 1), (1, 0), (4, 2), (3, -1)])
def test_each_phase_packs_only_real_taps(k, pad0):
    """Per axis, phase r's taps are exactly those whose dilated position
    r + ky - pad0 is even (a sample, not a hole); its packed row holds their
    K = kh' * kw' * I weights and zeros after; the phases' products cover
    each (output, tap) pair that meets a sample once."""
    from clip_glass_torch.ops.conv_s8 import pack_weights, phases

    I, O, n_out = 16, 3, 9
    wq = torch.arange(1, O * I * k * k + 1, dtype=torch.int32).remainder(251).sub(125)
    wq = wq.to(torch.int8).reshape(O, I, k, k)
    plist = phases(k, k, 1, pad0, 2, n_out, n_out)
    packed = pack_weights(wq, plist, 2)
    pairs = 0
    for q, (ky0, kx0, khp, kwp, _, _, Hp, Wp, ry, rx) in enumerate(plist):
        taps_y = [t for t in range(k) if (ry + t - pad0) % 2 == 0]
        taps_x = [t for t in range(k) if (rx + t - pad0) % 2 == 0]
        assert list(range(ky0, k, 2)) == taps_y and khp == len(taps_y)
        assert list(range(kx0, k, 2)) == taps_x and kwp == len(taps_x)
        K = khp * kwp * I
        assert torch.equal(packed[q, :, :K],
                           wq[:, :, taps_y][:, :, :, taps_x].permute(0, 2, 3, 1).reshape(O, K))
        assert not packed[q, :, K:].any()
        pairs += Hp * Wp * khp * kwp
    per_axis = sum(1 for o in range(n_out) for t in range(k) if (o + t - pad0) % 2 == 0)
    assert pairs == per_axis ** 2


@pytest.mark.parametrize("I,stride,d,route", [
    (512, 1, 1, "wgmma"), (128, 2, 1, "wgmma"), (128, 1, 2, "wgmma"), (64, 2, 1, "wgmma"),
    (16, 1, 2, "wgmma"), (513, 1, 1, "mma_sync"), (3, 1, 1, "mma_sync"),
    (12, 1, 2, "mma_sync"), (128, 2, 2, "mma_sync"), (128, 1, 3, "mma_sync")])
def test_conv_s8_variant_rule(I, stride, d, route):
    """The wgmma route takes 16-byte channel gathers (I % 16 == 0), undilated
    or 2-dilated at stride 1; D's last conv (I = 513) and odd widths keep
    the first design."""
    from clip_glass_torch.ops.conv_s8 import conv_s8_variant

    assert conv_s8_variant(I, stride, d) == route


def test_conv_s8_entries_refuse_a_mismatch():
    """A float x needs x_inv_scale, an int8 x takes none."""
    x = torch.zeros((1, 4, 4, 16))
    wq = torch.zeros((4, 16, 3, 3), dtype=torch.int8)
    with pytest.raises(TypeError):
        conv_s8(x, wq, torch.ones(4))
    with pytest.raises(TypeError):
        conv_s8(x.to(torch.int8), wq, torch.ones(4), x_inv_scale=1.0)
    with pytest.raises(TypeError):
        conv_s8(x.half(), wq, torch.ones(4), x_inv_scale=1.0)


# ------------------------------------------------------------ (d)


def test_saturation_is_finite():
    x, w = (T(a) for a in _int_grid_inputs(seed=3))
    _, scales = _calibrated(conv2d, x, oihw(w.numpy()))
    out = _int8(conv2d, scales, x * 1000.0, oihw(w.numpy()))
    assert torch.isfinite(out).all()


def test_scale_exhaustion_raises():
    x, w = _int_grid_inputs(seed=4)
    wt = oihw(w)
    with pytest.raises(RuntimeError, match="no calibrated scale"):
        _int8(lambda a, b: conv2d(conv2d(a, b), b), np.asarray([1.0]), T(x), wt)


@pytest.mark.parametrize("dead", [0.0, float("nan"), -1.0])
def test_dead_scale_keeps_the_float_path(dead):
    """A scale that is not finite or not positive runs its site in float and
    still uses up its index: the second conv takes the second scale."""
    x, w = _int_grid_inputs(seed=7)
    xt, wt = T(x), oihw(w)
    with quant.calibration(1) as rec:
        plain = conv2d(conv2d(xt, wt), wt)
    scales = [dead, float(rec[1])]
    got = _int8(lambda a, b: conv2d(conv2d(a, b), b), scales, xt, wt)
    first = conv2d(xt, wt)
    want = _int8(lambda a, b: conv2d(a, b), scales[1:], first, wt)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert not torch.equal(got, plain)   # the second site did quantize


# ------------------------------------------------------------ (e), (f): the whole fitness


def _sg2_config(get, name, **kw):
    return get(name).replace(pop_size=POP, dim_z=32, n_var=32, weights="random:0",
                             target=TARGETS[0], compute_dtype="float32",
                             quantize_min_ch=1, **kw)


def _bg_config(get, **kw):
    return get("DeepMindBigGAN512").replace(
        pop_size=POP, dim_z=16, num_classes=10, n_var=26, resolution=8,
        weights="random:0", target=TARGETS[0], compute_dtype="float32",
        quantize_min_ch=1, **kw)


def _pair(family, **kw):
    """(JAX problem, its bundle, port problem on the converted bundle) of a
    TINY family; the port's is built with quantize="int8"."""
    if family == "BigGAN":
        from clip_glass_tpu.models.biggan import model as jbg

        from clip_glass_torch.models.biggan import model as tbg
        from test_torch_biggan import random_tree

        jcfg = dataclasses.replace(jbg.TINY, s2d_min_res=4)
        jprob = JProblem(_bg_config(jget_config, **kw), clip_cfg=jclip.TINY, model_cfg=jcfg)
        jbundle = dict(jprob.generator.bundle)
        jbundle["g"] = jax.tree.map(jnp.asarray, random_tree(jbg.TINY, 5))
        tconfig = _bg_config(get_config, quantize="int8", **kw)
        tcfg = dataclasses.replace(tbg.TINY, s2d_min_res=4)
    else:
        name, mkw = {"d": ("StyleGAN2_ffhq_d", {}),
                     "d_s2d": ("StyleGAN2_ffhq_d", dict(s2d_min_res=8)),
                     "nod": ("StyleGAN2_ffhq_nod", {})}[family]
        jprob = JProblem(_sg2_config(jget_config, name, **kw), clip_cfg=jclip.TINY,
                         model_cfg=dataclasses.replace(jsg2.TINY, **mkw))
        # the plain problem's bundle (raw noise planes), which the s2d
        # domain reads too (tests/test_torch_fitness.py's _s2d_problems)
        jbundle = dict(JProblem(_sg2_config(jget_config, name), clip_cfg=jclip.TINY,
                                model_cfg=jsg2.TINY).generator.bundle)
        tconfig = _sg2_config(get_config, name, quantize="int8", **kw)
        tcfg = dataclasses.replace(tsg2.TINY, **mkw)
    tbundle = from_jax.convert_bundle(jax.tree.map(np.asarray, jbundle))
    tprob = GenerationProblem(tconfig, device="cpu", clip_cfg=tclip.TINY, model_cfg=tcfg,
                              bundle=tbundle)
    return jprob, jbundle, tprob


def _X(family, seed=0, n=POP):
    n_var = 26 if family == "BigGAN" else 32
    X = np.random.default_rng(seed).normal(size=(n, n_var)).astype(np.float32)
    if family == "BigGAN":   # the class genes are bits
        X[:, 16:] = X[:, 16:] > 0.8
    return X


def _jax_scales(jprob, jbundle, X0):
    """The JAX package's `_calibrate_quant` on a given X0."""
    gen, cfg = jprob.generator, jprob.config

    def calib(X, b):
        with jquant.calibration(cfg.quantize_min_ch) as rec:
            F = gen._eval_batch_raw(X, b, jax.random.PRNGKey(0))
        return F, list(rec)
    _, recs = jax.jit(calib)(jnp.asarray(X0), jbundle)
    return np.asarray(jax.device_get(recs), np.float64) * cfg.quantize_margin


def _jax_int8_F(jprob, jbundle, scales, X):
    gen = jprob.generator
    gen._quant_scales = scales
    try:
        return np.asarray(jax.jit(gen.eval_population)(jnp.asarray(X), jbundle))
    finally:
        gen._quant_scales = None


FAMILIES = ["d", "d_s2d", "nod", "BigGAN"]
SITES = {"d": 16, "d_s2d": 18, "nod": 8}   # TINY at quantize_min_ch = 1


@pytest.fixture(scope="module")
def pairs():
    return {}


def _cached_pair(pairs, family):
    if family not in pairs:
        pairs[family] = _pair(family)
    return pairs[family]


@pytest.mark.parametrize("family", FAMILIES)
def test_calibration_walks_the_jax_call_sites(pairs, family):
    jprob, jbundle, tprob = _cached_pair(pairs, family)
    X0 = _X(family, 11)
    want = _jax_scales(jprob, jbundle, X0)
    gen = tprob.generator
    assert gen._quant_scales is not None   # the constructor calibrated from its own draw
    gen._calibrate_quant(T(X0))
    got = gen._quant_scales
    assert got.dtype == np.float64
    assert len(got) == len(want) == SITES.get(family, len(want)) > 0
    np.testing.assert_allclose(got, want, rtol=1e-5)
    if family == "BigGAN":
        # JAX's plain BigGAN convs (lax.conv_general_dilated) are no sites:
        # only the s2d mid segments' convs count, none without them
        assert len(want) == 4 * 2   # two blocks x conv0, conv1, conv2, conv3
        assert _jax_scales(JProblem(jprob.config, clip_cfg=jclip.TINY,
                                    model_cfg=dataclasses.replace(
                                        jprob.generator.model_cfg, s2d_min_res=2**30)),
                           jbundle, X0).size == 0


@pytest.mark.parametrize("family", FAMILIES)
def test_int8_fitness_equals_jax_with_jax_scales(pairs, family):
    jprob, jbundle, tprob = _cached_pair(pairs, family)
    scales = _jax_scales(jprob, jbundle, _X(family, 11))
    X = _X(family, 12)
    want = _jax_int8_F(jprob, jbundle, scales, X)
    gen = tprob.generator
    gen._quant_scales = scales
    got = N(gen.eval_population(T(X)))
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=0, atol=5e-3)
    rel = (np.abs(got[:, 1] - want[:, 1]) / np.maximum(np.abs(want[:, 1]), 1.0)
           if got.shape[1] == 2 else np.zeros(1))
    assert (rel <= 1e-2).all(), rel.max()
    print(f"{family}: largest |similarity difference| "
          f"{np.abs(got[:, 0] - want[:, 0]).max():.3e}, hinge {rel.max():.3e} of scale")
    # the int8 F is not the float F: the mode did engage
    assert not np.array_equal(got, N(gen._eval_batch_raw(T(X), gen.bundle)))


# ------------------------------------------------------------ (g)


def test_int8_microbatches_each_take_a_fresh_scope(pairs):
    """eval_microbatch=4: each chunk consumes the scales from the first (an
    eager evaluation per chunk), so the chunked F is each chunk's own."""
    _, _, tprob = _cached_pair(pairs, "d")
    gen = tprob.generator
    scales = gen._quant_scales
    chunked = GenerationProblem(dataclasses.replace(tprob.config, eval_microbatch=4),
                                device="cpu", clip_cfg=tclip.TINY, model_cfg=gen.model_cfg,
                                bundle=gen.bundle)
    chunked.generator._quant_scales = scales
    X = T(_X("d", 13))
    got = chunked.generator.eval_population(X)
    want = torch.cat([gen.eval_population(X[:4]), gen.eval_population(X[4:])])
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("family", ["d", "BigGAN"])
def test_int8_batched_equals_each_search(pairs, family):
    _, _, tprob = _cached_pair(pairs, family)
    gen = tprob.generator
    Xb = np.stack([_X(family, 20 + i) for i in range(3)])
    feats = gen.encode_targets(TARGETS)
    got = gen.eval_population_batched(T(Xb), feats)
    for i in range(3):
        want = gen.eval_population(T(Xb[i]), {**gen.bundle, "target": feats[i:i + 1]})
        torch.testing.assert_close(got[i], want, rtol=1e-4, atol=1e-5)


def test_int8_full_nsga2_step(pairs):
    _, _, tprob = _cached_pair(pairs, "d")
    algo = tprob.make_algorithm()
    rng = algo.generator(0)
    state = algo.init(rng)
    state = algo.step_fn()(state, rng)
    assert state.gen == 1 and torch.isfinite(state.F).all()


def test_gpt2_int8_is_the_exact_fitness():
    """img2txt has no eligible conv: no scales, and F equal to the exact F
    bitwise (the JAX package's test_gpt2_quantize_disables_gracefully)."""
    def config(q):
        return get_config("GPT2").replace(weights="random:0", target=DOG, pop_size=4, dim_z=6,
                                          n_var=6, max_tokens_len=5, compute_dtype="float32",
                                          quantize=q)
    pq = GenerationProblem(config("int8"), device="cpu", clip_cfg=tclip.TINY,
                           model_cfg=tg2.TINY)
    pf = GenerationProblem(config(""), device="cpu", clip_cfg=tclip.TINY, model_cfg=tg2.TINY)
    assert pq.generator._quant_scales is None
    X = T(np.random.default_rng(3).integers(0, 40, (4, 6)))
    torch.testing.assert_close(pq.generator.eval_population(X),
                               pf.generator.eval_population(X), rtol=0, atol=0)
    # the JAX package keeps no scales either
    jcfg = jget_config("GPT2").replace(weights="random:0", target=DOG, pop_size=4, dim_z=6,
                                       n_var=6, max_tokens_len=5, compute_dtype="float32",
                                       quantize="int8")
    from clip_glass_tpu.models.gpt2 import model as jg2
    assert JProblem(jcfg, clip_cfg=jclip.TINY, model_cfg=jg2.TINY).generator._quant_scales is None


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="unknown quantize mode"):
        GenerationProblem(_sg2_config(get_config, "StyleGAN2_ffhq_nod", quantize="int4"),
                          device="cpu", clip_cfg=tclip.TINY, model_cfg=tsg2.TINY)


def test_calibration_is_a_function_of_the_seed(pairs):
    """Two constructions calibrate to the same scales (a resumed search
    recalibrates to its first run's); another seed draws other rows."""
    _, _, tprob = _cached_pair(pairs, "nod")
    gen = tprob.generator
    again = GenerationProblem(tprob.config, device="cpu", clip_cfg=tclip.TINY,
                              model_cfg=gen.model_cfg, bundle=gen.bundle).generator
    gen._calibrate_quant()
    np.testing.assert_array_equal(again._quant_scales, gen._quant_scales)
    other = GenerationProblem(dataclasses.replace(tprob.config, seed=1), device="cpu",
                              clip_cfg=tclip.TINY, model_cfg=gen.model_cfg,
                              bundle=gen.bundle).generator
    assert not np.array_equal(other._quant_scales, gen._quant_scales)


def test_render_stays_in_the_float_path(pairs):
    """`generate` is never inside a scope: the same images with and without
    the int8 mode."""
    _, _, tprob = _cached_pair(pairs, "nod")
    gen = tprob.generator
    X = T(_X("nod", 14, n=2))
    scales, gen._quant_scales = gen._quant_scales, None
    want = gen.generate(X)
    gen._quant_scales = scales
    torch.testing.assert_close(gen.generate(X), want, rtol=0, atol=0)


def test_scope_is_per_thread():
    """A scope on one thread is not seen on another (the server's pumping
    thread and the CLI's saver)."""
    import threading

    seen = []
    with quant.calibration(1):
        th = threading.Thread(target=lambda: seen.append(quant.hooked((8, 8, 3, 3))))
        th.start()
        th.join(timeout=30)
        assert not th.is_alive()
        assert quant.hooked((8, 8, 3, 3))
    assert seen == [False]
