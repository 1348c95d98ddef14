"""clip_glass_torch StyleGAN2 G and D against the JAX package's, on TINY in
fp32: the port's plain domain against the JAX plain domain (s2d=False) and
against its s2d domain (TINY with s2d_min_res=8), which is an exact rewrite
of the same math; the port's s2d domain against the JAX s2d domain (1e-4,
with and without lattice offsets and the s4d RGB path) and against the
port's own plain domain (2e-3).

The JAX weights (random init, with random biases and noise scales so that
every term of the synthesis epilogue counts) and the JAX noise planes are
carried across with weights/from_jax.py. The random-init weights reach
large magnitudes, so outputs are compared relative to their scale
(torch_parity.assert_close_scaled): 1e-4 for the plain domain, 2e-3 for the
s2d domain (the JAX package's own s2d-vs-plain tolerance)."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import torch

from clip_glass_tpu.core.dtypes import FP32 as JFP32
from clip_glass_tpu.models.stylegan2 import model as jsg2
from clip_glass_tpu.ops import s2d as S

from clip_glass_torch.core.dtypes import FP32
from clip_glass_torch.models.stylegan2 import model as tsg2
from clip_glass_torch.ops import s2d as TS
from clip_glass_torch.weights import from_jax

from torch_parity import N, T, assert_close_scaled

TINY = jsg2.TINY
TINY_S2D = dataclasses.replace(TINY, s2d_min_res=8)
PORT_TINY = tsg2.TINY
# the s2d variants, as (JAX config, port config)
S2D_VARIANTS = {
    name: (dataclasses.replace(TINY_S2D, **kw),
           dataclasses.replace(PORT_TINY, s2d_min_res=8, **kw))
    for name, kw in [("offsets_s4d", {}), ("no_offsets", {"s2d_offsets": False}),
                     ("no_s4d", {"rgb_s4d": False})]}


def _perturb(tree, rng):
    """Random biases and noise scales (the JAX init leaves them zero)."""
    def f(path, leaf):
        key = getattr(path[-1], "key", None)
        if key in ("b", "noise_scale") and "style" not in str(path):
            return jnp.asarray(rng.normal(size=np.shape(leaf)).astype(np.float32) * 0.5)
        return leaf
    return jax.tree_util.tree_map_with_path(f, tree)


@pytest.fixture(scope="module")
def params():
    rng = np.random.default_rng(11)
    kg, kd = jax.random.split(jax.random.PRNGKey(3))
    gp = _perturb(jsg2.generator_init(kg, TINY), rng)
    dp = _perturb(jsg2.discriminator_init(kd, TINY), rng)
    noise = [jax.random.normal(k, s) for k, s in zip(
        jax.random.split(jax.random.PRNGKey(7), len(TINY.noise_shapes())),
        TINY.noise_shapes())]
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return {"jg": gp, "jd": dp, "jnoise": noise,
            "tg": from_jax.convert_generator(to_np(gp)),
            "td": from_jax.convert_discriminator(to_np(dp)),
            "tnoise": from_jax.convert_noise(to_np(noise))}


def test_port_config_matches_jax():
    for a, b in [(jsg2.CONFIG_F, tsg2.CONFIG_F), (jsg2.TINY, tsg2.TINY)]:
        for f in dataclasses.fields(tsg2.SG2Config):
            assert getattr(a, f.name) == getattr(b, f.name), f.name
        assert a.noise_shapes() == b.noise_shapes()
        assert a.block_channels() == b.block_channels()
        assert a.num_latents == b.num_latents


def test_mapping_matches_jax(params, rng):
    z = rng.normal(size=(4, TINY.latent_size)).astype(np.float32)
    want = np.asarray(jsg2.mapping_apply(params["jg"]["mapping"], jnp.asarray(z),
                                         TINY, policy=JFP32))
    got = N(tsg2.mapping_apply(params["tg"]["mapping"], T(z), PORT_TINY, policy=FP32))
    assert_close_scaled(got, want, 1e-5)


@pytest.mark.parametrize("cfg,rtol", [(TINY, 1e-4), (TINY_S2D, 2e-3)],
                         ids=["plain", "s2d"])
def test_generator_matches_jax(params, rng, cfg, rtol):
    z = rng.normal(size=(4, TINY.latent_size)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, zz, nz: jsg2.generator_apply(
        p, zz, cfg, noise=nz, policy=JFP32, s2d=cfg is TINY_S2D))(
            params["jg"], jnp.asarray(z), params["jnoise"]))
    got = N(tsg2.generator_apply(params["tg"], T(z), PORT_TINY,
                                 noise=params["tnoise"], policy=FP32))
    assert got.shape == (4, 3, 16, 16)
    assert_close_scaled(got, want, rtol)


def test_generator_without_noise_matches_jax(params, rng):
    z = rng.normal(size=(2, TINY.latent_size)).astype(np.float32)
    want = np.asarray(jsg2.generator_apply(params["jg"], jnp.asarray(z), TINY,
                                           noise="none", policy=JFP32, s2d=False))
    got = N(tsg2.generator_apply(params["tg"], T(z), PORT_TINY, noise=None,
                                 policy=FP32))
    assert_close_scaled(got, want, 1e-4)


def test_generator_multilatent_and_truncation_match_jax(params, rng):
    """Per-layer latents [B, num_latents, D] and a truncation lerp with a
    cutoff (against a non-zero dlatent_avg)."""
    n = TINY.num_latents
    z = rng.normal(size=(2, n, TINY.latent_size)).astype(np.float32)
    avg = rng.normal(size=(TINY.latent_size,)).astype(np.float32)
    jg = dict(params["jg"], dlatent_avg=jnp.asarray(avg))
    tg = dict(params["tg"], dlatent_avg=T(avg))
    want = np.asarray(jsg2.generator_apply(
        jg, jnp.asarray(z), TINY, truncation_psi=0.7, truncation_cutoff=3,
        noise=params["jnoise"], policy=JFP32, s2d=False))
    got = N(tsg2.generator_apply(tg, T(z), PORT_TINY, truncation_psi=0.7,
                                 truncation_cutoff=3, noise=params["tnoise"],
                                 policy=FP32))
    assert_close_scaled(got, want, 1e-4)


def test_distribute_latents_matches_jax(rng):
    n = 6
    one = rng.normal(size=(3, 1, 4)).astype(np.float32)
    full = rng.normal(size=(3, n, 4)).astype(np.float32)
    for x in (one, full):
        want = np.asarray(jsg2.distribute_latents(jnp.asarray(x), n))
        np.testing.assert_array_equal(N(tsg2.distribute_latents(T(x), n)), want)
    # style mixing (1 < N < num_layers) is not ported; more latents than
    # layers is an error on both sides
    for bad in (2, 7):
        with pytest.raises(ValueError):
            tsg2.distribute_latents(T(rng.normal(size=(1, bad, 4))), n)


@pytest.mark.parametrize("domain", ["plain", "s4d", "s2d"])
def test_discriminator_matches_jax(params, rng, domain):
    img = rng.uniform(-1, 1, size=(4, 3, 16, 16)).astype(np.float32)
    jimg = jnp.asarray(img)
    if domain == "plain":
        want = jsg2.discriminator_apply(params["jd"], jimg, TINY, policy=JFP32)
        rtol = 1e-4
    elif domain == "s4d":
        want = jsg2.discriminator_apply(
            params["jd"], S.s4d(jnp.transpose(jimg, (0, 2, 3, 1))), TINY_S2D,
            policy=JFP32, input_s4d=True)
        rtol = 2e-3
    else:
        want = jsg2.discriminator_apply(
            params["jd"], S.s2d(jnp.transpose(jimg, (0, 2, 3, 1))), TINY_S2D,
            policy=JFP32, input_s2d=True, input_offset=0)
        rtol = 2e-3
    got = N(tsg2.discriminator_apply(params["td"], T(img), PORT_TINY, policy=FP32))
    assert got.shape == (4, 1)
    assert_close_scaled(got, np.asarray(want), rtol)


def test_generator_to_discriminator_matches_jax_s2d_chain(params, rng):
    """The JAX s2d fitness chain (G emits the packed s4d image, D consumes
    it) against the port's plain G -> D."""
    z = rng.normal(size=(4, TINY.latent_size)).astype(np.float32)
    img = jsg2.generator_apply(params["jg"], jnp.asarray(z), TINY_S2D,
                               noise=params["jnoise"], policy=JFP32,
                               output_s2d=True)
    want = np.asarray(jsg2.discriminator_apply(
        params["jd"], jnp.clip(img, -1, 1), TINY_S2D, policy=JFP32,
        input_s4d=True))
    timg = tsg2.generator_apply(params["tg"], T(z), PORT_TINY,
                                noise=params["tnoise"], policy=FP32)
    got = N(tsg2.discriminator_apply(params["td"], timg.clamp(-1, 1), PORT_TINY,
                                     policy=FP32))
    assert_close_scaled(got, want, 2e-3)


def _shapes(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _shapes(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _shapes(v, path + (i,))
    else:
        yield path, tuple(np.shape(tree))


@pytest.mark.parametrize("which", ["g", "d"])
def test_port_init_matches_jax_structure_and_scale(params, which):
    """The port's own random init: the same tree and shapes as the JAX init
    (after the same conversion) and, leaf by leaf, the same spread."""
    gen = torch.Generator().manual_seed(0)
    if which == "g":
        port = tsg2.generator_init(gen, PORT_TINY)
        ref = from_jax.convert_generator(jax.tree.map(
            np.asarray, jsg2.generator_init(jax.random.PRNGKey(0), TINY)))
    else:
        port = tsg2.discriminator_init(gen, PORT_TINY)
        ref = from_jax.convert_discriminator(jax.tree.map(
            np.asarray, jsg2.discriminator_init(jax.random.PRNGKey(0), TINY)))
    assert list(_shapes(port)) == list(_shapes(ref))

    def leaves(t):
        return [v for _, v in sorted(
            ((p, v) for p, v in _flat(t)), key=lambda pv: str(pv[0]))]

    for a, b in zip(leaves(port), leaves(ref)):
        if a.numel() >= 256:
            ratio = a.std().item() / b.std().item()
            assert 0.8 < ratio < 1.25, ratio


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, path + (i,))
    else:
        yield path, tree


# ------------------------------------------------------------ s2d domain


@pytest.mark.parametrize("variant", sorted(S2D_VARIANTS))
def test_s2d_generator_matches_jax_s2d_and_port_plain(params, rng, variant):
    jcfg, tcfg = S2D_VARIANTS[variant]
    z = rng.normal(size=(4, TINY.latent_size)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, zz, nz: jsg2.generator_apply(
        p, zz, jcfg, noise=nz, policy=JFP32))(params["jg"], jnp.asarray(z),
                                              params["jnoise"]))
    got = N(tsg2.generator_apply(params["tg"], T(z), tcfg, noise=params["tnoise"],
                                 policy=FP32))
    assert got.shape == (4, 3, 16, 16)
    assert_close_scaled(got, want, 1e-4)
    plain = N(tsg2.generator_apply(params["tg"], T(z),
                                   dataclasses.replace(tcfg, s2d_min_res=2 ** 30),
                                   noise=params["tnoise"], policy=FP32))
    assert_close_scaled(got, plain, 2e-3)


@pytest.mark.parametrize("variant", sorted(S2D_VARIANTS))
def test_s2d_generator_packed_output_matches_jax(params, rng, variant):
    """output_s2d=True: the packed image (s4d, or s2d at the output offset
    with zero phantoms), from packed noise, against JAX's."""
    jcfg, tcfg = S2D_VARIANTS[variant]
    assert tsg2.rgb_domain(tcfg) == jsg2.rgb_domain(jcfg)
    assert tsg2.s2d_output_offset(tcfg) == jsg2.s2d_output_offset(jcfg)
    z = rng.normal(size=(4, TINY.latent_size)).astype(np.float32)
    want = np.asarray(jsg2.generator_apply(params["jg"], jnp.asarray(z), jcfg,
                                           noise=params["jnoise"], policy=JFP32,
                                           output_s2d=True))
    got = N(tsg2.generator_apply(params["tg"], T(z), tcfg,
                                 noise=tsg2.pack_noise(params["tnoise"], tcfg, FP32),
                                 policy=FP32, output_s2d=True))
    assert_close_scaled(got, want, 1e-4)


@pytest.mark.parametrize("variant", sorted(S2D_VARIANTS))
def test_noise_layouts_and_packing_match_jax(params, rng, variant):
    jcfg, tcfg = S2D_VARIANTS[variant]
    assert tsg2.noise_layouts(tcfg) == jsg2.noise_layouts(jcfg)
    jp = jsg2.pack_noise(params["jnoise"], jcfg, JFP32)
    tp = tsg2.pack_noise(params["tnoise"], tcfg, FP32)
    for a, b in zip(tp, jp):
        np.testing.assert_array_equal(N(a), np.asarray(b))
    # packed planes give exactly the output of raw planes folded in the loop
    z = T(rng.normal(size=(2, TINY.latent_size)).astype(np.float32))
    np.testing.assert_array_equal(
        N(tsg2.generator_apply(params["tg"], z, tcfg, noise=tp, policy=FP32)),
        N(tsg2.generator_apply(params["tg"], z, tcfg, noise=params["tnoise"], policy=FP32)))


@pytest.mark.parametrize("domain", ["s4d", "s2d", "s2d_off"])
@pytest.mark.parametrize("variant", ["offsets_s4d", "no_offsets"])
def test_s2d_discriminator_matches_jax_s2d_and_port_plain(params, rng, domain, variant):
    jcfg, tcfg = S2D_VARIANTS[variant]
    img = rng.uniform(-1, 1, size=(4, 3, 16, 16)).astype(np.float32)
    nhwc = np.transpose(img, (0, 2, 3, 1))
    if domain == "s4d":
        jin, tin, kw = S.s4d(jnp.asarray(nhwc)), TS.s4d(T(nhwc)), {"input_s4d": True}
    else:
        off = -1 if domain == "s2d_off" else 0
        jin, tin = S.s2d(jnp.asarray(nhwc)), TS.s2d(T(nhwc))
        if off:
            jin, tin = S.shift_to_m1(jin), TS.shift_to_m1(tin)
        kw = {"input_s2d": True, "input_offset": off}
    want = np.asarray(jsg2.discriminator_apply(params["jd"], jin, jcfg, policy=JFP32, **kw))
    got = N(tsg2.discriminator_apply(params["td"], tin, tcfg, policy=FP32, **kw))
    assert got.shape == (4, 1)
    assert_close_scaled(got, want, 1e-4)
    plain = N(tsg2.discriminator_apply(params["td"], T(img), PORT_TINY, policy=FP32))
    assert_close_scaled(got, plain, 2e-3)


def test_output_s2d_needs_the_s2d_domain(params):
    """A config the s2d folds do not cover (a 3-tap FIR) has no packed
    output; below s2d_min_res the packed output is the plain image packed."""
    z = T(np.zeros((1, TINY.latent_size), np.float32))
    unsupported = dataclasses.replace(PORT_TINY, filter_taps=(1, 2, 1))
    assert not tsg2.top_level_s2d(unsupported)
    with pytest.raises(ValueError, match="requires the s2d domain"):
        tsg2.generator_apply(params["tg"], z, unsupported, output_s2d=True)
    plain = dataclasses.replace(PORT_TINY, s2d_min_res=2 ** 30)
    assert not tsg2.top_level_s2d(plain) and tsg2.rgb_domain(plain) == "s2d"
    packed = tsg2.generator_apply(params["tg"], z, plain, output_s2d=True)
    np.testing.assert_array_equal(
        N(packed), N(TS.s2d(tsg2.generator_apply(params["tg"], z, plain).permute(0, 2, 3, 1))))
