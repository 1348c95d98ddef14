"""The port's metrics (clip_glass_torch.metrics: LPIPS-VGG16, the FID
InceptionV3, FID, PPL) against the JAX package's on the CPU, fp32, on the
same numpy inputs and weights from a seed (the JAX side at
jax_default_matmul_precision "highest", as tests/conftest.py sets it).

Tolerances, relative to the output's scale (`assert_close_scaled`):
- LPIPS: 1e-5 (the same convs, summed in another order);
- Inception blocks and `features`: 1e-4 (up to 94 convs deep; the
  antialiased resize of `jax.image.resize` and `F.interpolate` agree to
  1.5e-5 of the [0, 1] range);
- `frechet_distance`: 1e-8 (the same numpy and scipy calls on the same
  doubles; the port's copy must not drift);
- PPL's batch distances: 1e-5, one batch with the JAX draws, at epsilon
  1e-1; at the default 1e-4 the fp32 difference quotient itself is good to
  ~1e-3 (PPL_CASES).
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import torch

from clip_glass_tpu.metrics import fid as jfid
from clip_glass_tpu.metrics import inception as jinc
from clip_glass_tpu.metrics import lpips as jlp
from clip_glass_tpu.metrics import ppl as jppl
from clip_glass_tpu.models.stylegan2 import model as jsg2

from clip_glass_torch.metrics import fid as tfid
from clip_glass_torch.metrics import inception as tinc
from clip_glass_torch.metrics import lpips as tlp
from clip_glass_torch.metrics import ppl as tppl
from clip_glass_torch.models.stylegan2 import model as tsg2
from clip_glass_torch.weights import from_jax

from torch_parity import N, T, assert_close_scaled


def lpips_tree(seed: int, div: int = 8):
    """A JAX-layout LPIPS tree at channels / div, biases and heads nonzero."""
    rng = np.random.default_rng(seed)
    convs = {}
    for idx, cin, cout in jlp._VGG_CFG:
        ci, co = (cin if cin == 3 else cin // div), cout // div
        convs[str(idx)] = {
            "w": (rng.standard_normal((3, 3, ci, co)) * (9 * ci) ** -0.5).astype(np.float32),
            "b": rng.normal(0, 0.05, co).astype(np.float32)}
    heads = [np.abs(rng.normal(0, 0.1, c // div)).astype(np.float32) for c in jlp._SLICE_OUT]
    return {"convs": convs, "heads": heads}


def inception_tree(seed: int, table=None):
    """A JAX-layout Inception tree (HWIO, He-scaled) with an eval BN that is
    not an identity."""
    rng = np.random.default_rng(seed)

    def cw(cin, cout, kh, kw):
        return {"w": (rng.standard_normal((kh, kw, cin, cout))
                      * (cin * kh * kw) ** -0.5).astype(np.float32),
                "bn_scale": rng.uniform(0.7, 1.3, cout).astype(np.float32),
                "bn_bias": rng.normal(0, 0.1, cout).astype(np.float32)}

    table = table or tinc.conv_table()
    return {name: (cw(*spec) if isinstance(spec, tuple) else
                   {br: cw(*s) for br, s in spec.items()})
            for name, spec in table.items()}


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


# ---------------------------------------------------------------- LPIPS

@pytest.mark.parametrize("pixel_range", [(-1.0, 1.0), (0.0, 1.0)])
def test_lpips_matches_jax(pixel_range):
    """div 8 widths, a 36 x 44 input (the VALID pools drop a row or column
    at 9 x 11 and 4 x 5)."""
    lo, hi = pixel_range
    tree = lpips_tree(0)
    rng = np.random.default_rng(1)
    x0 = rng.uniform(lo, hi, (3, 3, 36, 44)).astype(np.float32)
    x1 = rng.uniform(lo, hi, (3, 3, 36, 44)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, a, b: jlp.lpips(p, a, b, lo, hi))(
        _jax(tree), x0, x1))
    got = N(tlp.lpips(from_jax.convert_lpips(tree), T(x0), T(x1), lo, hi))
    assert got.shape == (3,) and (got > 0).all()
    assert_close_scaled(got, want, 1e-5)


def test_lpips_of_an_image_with_itself_is_zero():
    x = T(np.random.default_rng(2).uniform(-1, 1, (2, 3, 32, 32)))
    d = tlp.lpips(tlp.init(torch.Generator().manual_seed(0)), x, x)
    assert torch.equal(d, torch.zeros(2))


def test_lpips_load_npz_keeps_convs_keyed_by_index(tmp_path):
    """The convert CLI's npz: `convs` stays a dict keyed by layer index (its
    keys are all digit strings, which restore_lists would turn into a
    list), `heads` comes back as a list; the distance equals the tree's."""
    from clip_glass_torch.core import pytree

    tree = lpips_tree(3)
    path = str(tmp_path / "lpips.npz")
    pytree.save_npz(path, tree)
    params = tlp.load_npz(path)
    assert sorted(params["convs"], key=int) == [str(i) for i, _, _ in tlp._VGG_CFG]
    assert isinstance(params["heads"], list) and len(params["heads"]) == 5
    assert tuple(params["convs"]["0"]["w"].shape) == (8, 3, 3, 3)   # OIHW
    x = T(np.random.default_rng(4).uniform(-1, 1, (2, 3, 24, 24)))
    y = x.flip(-1)
    assert torch.equal(tlp.lpips(params, x, y), tlp.lpips(from_jax.convert_lpips(tree), x, y))


def test_lpips_init_has_the_vgg16_geometry():
    p = tlp.init(torch.Generator().manual_seed(0))
    assert [tuple(p["convs"][str(i)]["w"].shape) for i, _, _ in tlp._VGG_CFG] == [
        (co, ci, 3, 3) for _, ci, co in tlp._VGG_CFG]
    assert [h.shape[0] for h in p["heads"]] == tlp._SLICE_OUT
    assert all((h >= 0).all() for h in p["heads"])


# ---------------------------------------------------------------- Inception

BLOCKS = {"a": ("Mixed_5c", 9), "b": ("Mixed_6a", 9), "c": ("Mixed_6c", 7),
          "d": ("Mixed_7a", 9), "e_avg": ("Mixed_7b", 5), "e_max": ("Mixed_7c", 5)}


@pytest.mark.parametrize("block", list(BLOCKS))
def test_inception_block_matches_jax(block):
    """Each Mixed block kind at its real widths on a small spatial input
    (E with the avg-pool branch of Mixed_7b and the max-pool one of 7c)."""
    name, size = BLOCKS[block]
    spec = next(m for m in tinc.MIXED if m[0] == name)
    kind, cin = spec[1], spec[2]
    tree = inception_tree(5, {name: tinc.branches(kind, cin, spec[3])})[name]
    x = np.random.default_rng(6).normal(size=(2, size, size, cin)).astype(np.float32)
    jfn = {"a": jinc._a, "b": jinc._b, "c": jinc._c, "d": jinc._d}
    tfn = {"a": tinc._a, "b": tinc._b, "c": tinc._c, "d": tinc._d}
    from clip_glass_tpu.core.dtypes import FP32 as JFP32
    from clip_glass_torch.core.dtypes import FP32
    if kind == "e":
        pool = block[2:]
        want = jax.jit(lambda p, a: jinc._e(a, p, JFP32, pool))(_jax(tree), x)
        got = tinc._e(T(x).permute(0, 3, 1, 2), from_jax.convert_inception(
            {name: tree})[name], FP32, pool)
    else:
        want = jax.jit(lambda p, a: jfn[kind](a, p, JFP32))(_jax(tree), x)
        got = tfn[kind](T(x).permute(0, 3, 1, 2),
                        from_jax.convert_inception({name: tree})[name], FP32)
    want = np.asarray(want)
    assert got.shape[1] == want.shape[-1]
    assert_close_scaled(N(got.permute(0, 2, 3, 1)), want, 1e-4)


@pytest.mark.parametrize("pool", ["max_valid", "max_pad", "avg_excl"])
def test_inception_pools_match_jax(pool):
    x = np.random.default_rng(7).normal(size=(2, 9, 10, 4)).astype(np.float32)
    jf, tf = {"max_valid": (lambda a: jinc._maxpool(a, 3, 2), lambda a: tinc._maxpool(a, 3, 2)),
              "max_pad": (lambda a: jinc._maxpool(a, 3, 1, pad=1),
                          lambda a: tinc._maxpool(a, 3, 1, pad=1)),
              "avg_excl": (jinc._avgpool_excl, tinc._avgpool_excl)}[pool]
    got = N(tf(T(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1))
    np.testing.assert_allclose(got, np.asarray(jf(jnp.asarray(x))), rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def inception_params():
    tree = inception_tree(8)
    return tree, from_jax.convert_inception(tree)


def _jax_trunk(params, x01):
    """The FID trunk of torchvision / pytorch-fid in the JAX package's own
    functions, Mixed_6e included: JAX `features` skips that block (it calls
    `_c` three times, not four; `test_jax_features_skip_mixed_6e`), and the
    port does not copy the fault."""
    from clip_glass_tpu.core.dtypes import FP32 as JFP32

    x = jnp.transpose(x01 * 2.0 - 1.0, (0, 2, 3, 1))
    for name, stride, pad in (("Conv2d_1a_3x3", 2, 0), ("Conv2d_2a_3x3", 1, 0),
                              ("Conv2d_2b_3x3", 1, 1), (None, 0, 0),
                              ("Conv2d_3b_1x1", 1, 0), ("Conv2d_4a_3x3", 1, 0), (None, 0, 0)):
        x = (jinc._maxpool(x, 3, 2) if name is None else
             jinc._conv_bn(x, params[name], stride=stride, padding=pad))
    block = {"a": jinc._a, "b": jinc._b, "c": jinc._c, "d": jinc._d}
    for name, kind, _cin, _arg in tinc.MIXED:
        x = (jinc._e(x, params[name], JFP32, "max" if name == "Mixed_7c" else "avg")
             if kind == "e" else block[kind](x, params[name], JFP32))
    return jnp.mean(x, axis=(1, 2))


def test_inception_features_match_jax(inception_params):
    """The whole trunk at real geometry, one image upsampled to 299 (from
    160 px) and one downsampled (from 512 px, antialiased): the JAX side
    resizes with jax.image.resize and runs the JAX package's blocks jitted
    once on both."""
    tree, params = inception_params
    rng = np.random.default_rng(9)
    images = [rng.uniform(0, 1, (1, 3, s, s)).astype(np.float32) for s in (160, 512)]
    resized = jnp.concatenate([jax.image.resize(jnp.asarray(x), (1, 3, 299, 299), "bilinear")
                               for x in images])
    want = np.asarray(jax.jit(_jax_trunk)(_jax(tree), resized))
    got = np.concatenate([N(tinc.features(params, T(x))) for x in images])
    assert got.shape == (2, 2048) and np.isfinite(got).all()
    for i in range(2):
        assert_close_scaled(got[i], want[i], 1e-4)


def test_jax_features_skip_mixed_6e(inception_params):
    """The fault the port does not copy: the JAX package's `features` equals
    its own trunk with Mixed_6e left out (torchvision's InceptionV3, which
    pytorch-fid and the reference run, has it between Mixed_6d and
    Mixed_7a), so its FID features are not the FID network's."""
    tree, _ = inception_params
    x = jnp.asarray(np.random.default_rng(17).uniform(0, 1, (1, 3, 299, 299)), jnp.float32)
    jt = _jax(tree)
    skipped = dict(jt, Mixed_6e=None)
    want = jax.jit(lambda p, a: jinc.features(p, a, resize_input=False))(jt, x)
    mixed = [m for m in tinc.MIXED if m[0] != "Mixed_6e"]
    orig = tinc.MIXED
    try:
        tinc.MIXED = mixed
        without = jax.jit(_jax_trunk)(skipped, x)
    finally:
        tinc.MIXED = orig
    np.testing.assert_allclose(np.asarray(want), np.asarray(without), rtol=1e-6, atol=1e-6)
    full = np.asarray(jax.jit(_jax_trunk)(jt, x))
    assert np.abs(full - np.asarray(want)).max() > 1e-2


def test_inception_resize_matches_jax_both_ways():
    rng = np.random.default_rng(10)
    for size in (128, 1024):
        x = rng.uniform(0, 1, (1, 3, size, size)).astype(np.float32)
        want = np.asarray(jax.image.resize(jnp.asarray(x), (1, 3, 299, 299), "bilinear"))
        np.testing.assert_allclose(N(tinc.resize299(T(x))), want, rtol=0, atol=2e-5)


def test_inception_init_has_the_trunk_geometry():
    """The port's random init: every conv of conv_table() in OIHW, BN an
    identity, about 21.8M conv weights (the torchvision trunk, no fc)."""
    p = tinc.init(torch.Generator().manual_seed(0))
    n = 0
    for name, spec in tinc.conv_table().items():
        for br, (ci, co, kh, kw) in ({name: spec} if isinstance(spec, tuple) else spec).items():
            q = p[name] if isinstance(spec, tuple) else p[name][br]
            assert tuple(q["w"].shape) == (co, ci, kh, kw)
            assert torch.equal(q["bn_scale"], torch.ones(co))
            n += q["w"].numel()
    assert 21_000_000 < n < 22_500_000


def test_inception_tables_match_the_jax_init():
    """conv_table() is the JAX package's init structure and shapes."""
    shapes = jax.eval_shape(jinc.init, jax.random.PRNGKey(0))
    table = tinc.conv_table()
    assert sorted(table) == sorted(shapes)
    for name, spec in table.items():
        sub = shapes[name]
        got = {name: spec} if isinstance(spec, tuple) else spec
        want = {name: sub} if "w" in sub else sub
        assert sorted(got) == sorted(want)
        for br, (ci, co, kh, kw) in got.items():
            assert want[br]["w"].shape == (kh, kw, ci, co)


# ---------------------------------------------------------------- FID

def _feature_sets(seed):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(300, 16))
    b = rng.normal(0.3, 1.2, size=(300, 16)) + 0.2 * a
    return a, b


@pytest.mark.parametrize("case", ["full_rank", "rank_deficient", "identical"])
def test_frechet_distance_matches_jax(case):
    a, b = _feature_sets(11)
    if case == "rank_deficient":   # fewer samples than dimensions
        a, b = a[:10], b[:10]
    if case == "identical":
        b = a
    stats = [(x.mean(0), np.cov(x, rowvar=False)) for x in (a, b)]
    got = tfid.frechet_distance(*stats[0], *stats[1])
    want = jfid.frechet_distance(*stats[0], *stats[1])
    assert got == pytest.approx(want, rel=1e-8, abs=1e-8)


def test_fid_matches_jax_on_the_same_features():
    """FID over batches of features, a tensor-returning feature_fn on the
    port's side (the JAX side gets numpy)."""
    a, b = _feature_sets(12)

    def batches(x):
        for i in range(0, len(x), 64):
            yield x[i:i + 64]

    want = jfid.FID(lambda x: x, num_samples=256).set_real_stats(batches(a)).evaluate(batches(b))
    fid = tfid.FID(lambda x: torch.from_numpy(x), num_samples=256)
    got = fid.set_real_stats(batches(a)).evaluate(batches(b))
    assert got == pytest.approx(want, rel=1e-8)
    assert fid.evaluate(batches(a)) == pytest.approx(0.0, abs=1e-6)


def test_fid_warns_when_undersampled():
    a, _ = _feature_sets(13)
    fid = tfid.FID(lambda x: x, num_samples=1000)
    with pytest.warns(UserWarning, match="exhausted at 300"):
        fid.set_real_stats(iter([a]))
    with pytest.raises(ValueError, match="no samples"):
        fid.evaluate(iter([]))


# ---------------------------------------------------------------- PPL

def test_lerp_and_slerp_match_jax():
    rng = np.random.default_rng(14)
    a, b = rng.normal(size=(2, 5, 32)).astype(np.float32)
    t = rng.uniform(size=(5, 1)).astype(np.float32)
    for jf, tf in ((jppl.lerp, tppl.lerp), (jppl.slerp, tppl.slerp)):
        want = np.asarray(jf(jnp.asarray(a), jnp.asarray(b), jnp.asarray(t)))
        assert_close_scaled(N(tf(T(a), T(b), T(t))), want, 1e-6)
    np.testing.assert_allclose(N(tppl.slerp(T(a), T(b), torch.zeros(5, 1))), a, rtol=1e-5,
                               atol=1e-5)


def _jax_ppl_draws(key, cfg, B, full_sampling=True):
    """The draws of the JAX PPL's _batch_distances for `key`."""
    k1, k2, kt, kn = jax.random.split(key, 4)
    z0 = jax.random.normal(k1, (B, cfg.latent_size))
    z1 = jax.random.normal(k2, (B, cfg.latent_size))
    t = jax.random.uniform(kt, (B, 1)) if full_sampling else jnp.zeros((B, 1))
    shapes = cfg.noise_shapes()
    noise = [jax.random.normal(k, s) for k, s in zip(jax.random.split(kn, len(shapes)), shapes)]
    return [T(z0), T(z1), T(t), [T(n) for n in noise]]


@pytest.fixture(scope="module")
def tiny_g():
    tree = tsg2.generator_tree(torch.Generator().manual_seed(3), tsg2.TINY)
    np_tree = jax.tree.map(lambda t: t.numpy(), tree)
    return _jax(np_tree), tsg2.generator_init(torch.Generator().manual_seed(3), tsg2.TINY)


# (s2d_min_res, use_dlatent, epsilon, tolerance). At epsilon 1e-1 the
# difference quotient is well conditioned: 1e-5. At the default 1e-4 the two
# images of a pair differ by ~1e-4 of their scale, so fp32 rounding (~6e-8)
# leaves ~1e-3 of the difference, squared by the distance: the JAX package's
# own jitted and eager batches differ by 2.3e-3 of the scale there. 1e-2.
PPL_CASES = {"plain-lerp_w": (512, True, 1e-1, 1e-5),
             "plain-slerp_z": (512, False, 1e-1, 1e-5),
             "s2d-lerp_w": (8, True, 1e-1, 1e-5),
             "s2d-slerp_z": (8, False, 1e-1, 1e-5),
             "plain-lerp_w-eps1e-4": (512, True, 1e-4, 1e-2)}


@pytest.mark.parametrize("case", list(PPL_CASES))
def test_ppl_batch_matches_jax(tiny_g, case):
    """One batch of 8 pairs on the TINY G with LPIPS (div 8) as the distance,
    the JAX draws fed to the port's `batch_distances`; TINY with
    s2d_min_res=8 runs its 8 and 16 px levels in the s2d domain on both
    sides."""
    s2d_min_res, use_dlatent, eps, tol = PPL_CASES[case]
    jg, tg = tiny_g
    tree = lpips_tree(15)
    jcfg = dataclasses.replace(jsg2.TINY, s2d_min_res=s2d_min_res)
    tcfg = dataclasses.replace(tsg2.TINY, s2d_min_res=s2d_min_res)
    jdist = lambda a, b: jlp.lpips(_jax(tree), a, b, 0.0, 1.0)  # noqa: E731
    tparams = from_jax.convert_lpips(tree)
    tdist = lambda a, b: tlp.lpips(tparams, a, b, 0.0, 1.0)  # noqa: E731
    jm = jppl.PPL(jg, jcfg, jdist, batch_size=8, epsilon=eps, use_dlatent=use_dlatent)
    tm = tppl.PPL(tg, tcfg, tdist, batch_size=8, epsilon=eps, use_dlatent=use_dlatent,
                  device="cpu")
    key = jax.random.PRNGKey(16)
    want = np.asarray(jm._jit_batch(key))
    got = N(tm.batch_distances(*_jax_ppl_draws(key, jcfg, 8)))
    assert got.shape == (8,) and np.isfinite(got).all() and (got > 0).all()
    assert_close_scaled(got, want, tol)


def test_ppl_evaluate_filters_and_is_positive(tiny_g):
    from clip_glass_torch.projector import downsampled_l2

    ppl = tppl.PPL(tiny_g[1], tsg2.TINY, downsampled_l2, num_samples=32, batch_size=8,
                   device="cpu")
    val = ppl.evaluate()
    assert np.isfinite(val) and val > 0
    assert ppl.evaluate() == val   # the PPL's own generator, from its seed


# ---------------------------------------------------------------- from_jax

def test_convert_lpips_carries_the_jax_init_across():
    """from_jax.convert_lpips of the JAX package's own init tree: each conv
    HWIO -> OIHW bitwise, its bias and the 5 heads unchanged."""
    jtree = jax.tree.map(np.asarray, jax.jit(jlp.init)(jax.random.PRNGKey(0)))
    got = from_jax.convert_lpips(jtree)
    assert sorted(got["convs"]) == sorted(jtree["convs"])
    for k, p in jtree["convs"].items():
        assert np.array_equal(N(got["convs"][k]["w"]), p["w"].transpose(3, 2, 0, 1))
        assert np.array_equal(N(got["convs"][k]["b"]), p["b"])
    assert len(got["heads"]) == 5
    for g, w in zip(got["heads"], jtree["heads"]):
        assert np.array_equal(N(g), w)


def test_convert_inception_keeps_the_bn_as_the_jax_tree_has_it():
    """from_jax.convert_inception: OIHW convs, bn_scale and bn_bias carried
    bitwise (applied in fp32 after the conv, not folded into w)."""
    tree = inception_tree(18)
    got = from_jax.convert_inception(tree)
    assert sorted(got) == sorted(tree)
    for name, sub in tree.items():
        pairs = [(got[name], sub)] if "w" in sub else [(got[name][b], p) for b, p in sub.items()]
        for g, p in pairs:
            assert np.array_equal(N(g["w"]), p["w"].transpose(3, 2, 0, 1))
            assert np.array_equal(N(g["bn_scale"]), p["bn_scale"])
            assert np.array_equal(N(g["bn_bias"]), p["bn_bias"])


@pytest.mark.parametrize("writer", ["vgg16", "lpips_linear"])
def test_metric_writers_draw_what_the_jax_synthesizer_draws(writer, tmp_path):
    """weights/synthesize.py's vgg16 and LPIPS-linear files equal the JAX
    package's synth_vgg16 / synth_lpips_linear ones (the same torch draws)."""
    from clip_glass_torch.weights import synthesize
    from test_torch_weights import jax_synth

    port, ref = str(tmp_path / "port.pth"), str(tmp_path / "jax.pth")
    getattr(synthesize, f"write_{writer}")(port, div=8, seed=3)
    getattr(jax_synth(), f"synth_{writer}")(ref, div=8, seed=3)
    a, b = torch.load(port), torch.load(ref)
    assert list(a) == list(b)
    assert all(torch.equal(a[k], b[k]) for k in a)
