"""The slice as a whole: F[pop, 2] of the TINY StyleGAN2_ffhq_d problem
(built as in tests/test_end_to_end.py) from clip_glass_torch against the JAX
package's Generator.eval_population, with the JAX weights, noise planes and
target carried across by weights/from_jax.py. fp32 on both sides; tolerance
1e-4 relative to each objective's scale (G, D and CLIP in sequence).

The s2d fitness path (TINY with s2d_min_res=8, with and without lattice
offsets and the s4d RGB path) runs on the same converted bundle: against
the JAX s2d fitness at 1e-4 and against the port's plain fitness at 2e-3
(the JAX package's own s2d-vs-plain tolerance)."""

import dataclasses
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import torch

from clip_glass_tpu.config import get_config as jget_config
from clip_glass_tpu.fitness.problem import GenerationProblem as JProblem
from clip_glass_tpu.models.clip import model as jclip
from clip_glass_tpu.models.stylegan2 import model as jsg2

from clip_glass_torch.config import get_config
from clip_glass_torch.core.dtypes import BF16
from clip_glass_torch.fitness.generator import Generator
from clip_glass_torch.fitness.problem import GenerationProblem
from clip_glass_torch.models.clip import model as tclip
from clip_glass_torch.models.gpt2 import model as tg2
from clip_glass_torch.models.stylegan2 import model as tsg2
from clip_glass_torch.weights import from_jax

from torch_parity import N, T, assert_close_scaled

POP = 8


def _config(get, **kw):
    return get("StyleGAN2_ffhq_d").replace(
        pop_size=POP, batch_size=4, dim_z=32, n_var=32, weights="random:0",
        target="a red flower", compute_dtype="float32", **kw)


def _perturb(bundle, rng):
    """Random biases and noise scales, so the whole synthesis epilogue and
    D's biases count (the random init leaves them zero)."""
    def f(path, leaf):
        names = [str(getattr(p, "key", "")) for p in path]
        if names[0] in ("g", "d") and names[-1] in ("b", "noise_scale") \
                and "style" not in names:
            return jnp.asarray(rng.normal(size=np.shape(leaf)).astype(np.float32) * 0.3)
        return leaf
    return jax.tree_util.tree_map_with_path(f, bundle)


@pytest.fixture(scope="module")
def problems():
    jprob = JProblem(_config(jget_config), clip_cfg=jclip.TINY, model_cfg=jsg2.TINY)
    jbundle = _perturb(jprob.generator.bundle, np.random.default_rng(2))
    tbundle = from_jax.convert_bundle(jax.tree.map(np.asarray, jbundle))
    tprob = GenerationProblem(_config(get_config), device="cpu",
                              clip_cfg=tclip.TINY, model_cfg=tsg2.TINY,
                              bundle=tbundle)
    return jprob, jbundle, tprob, tbundle


def _X(seed=0):
    return np.random.default_rng(seed).normal(size=(POP, 32)).astype(np.float32)


DOG = "examples/gpt2_images/dog.jpeg"


def _g2_config(get, **kw):
    return get("GPT2").replace(**{**dict(
        pop_size=POP, batch_size=POP, dim_z=6, n_var=6, max_tokens_len=5,
        weights="random:0", target=DOG, compute_dtype="float32"), **kw})


def _g2_X(seed):
    return np.random.default_rng(seed).integers(0, 50257, (POP, 6)).astype(np.float32)


def test_eval_population_matches_jax(problems):
    jprob, jbundle, tprob, _ = problems
    X = _X()
    want = np.asarray(jax.jit(jprob.generator.eval_population)(jnp.asarray(X), jbundle))
    got = N(tprob.generator.eval_population(T(X)))
    assert got.shape == (POP, 2) and np.isfinite(got).all()
    assert (got[:, 1] >= 0).all()
    for j in range(2):
        assert_close_scaled(got[:, j], want[:, j], 1e-4)


def test_generate_matches_jax(problems):
    jprob, jbundle, tprob, _ = problems
    X = _X(1)
    want = np.asarray(jax.jit(jprob.generator.generate)(jnp.asarray(X), jbundle))
    got = N(tprob.generator.generate(T(X)))
    assert got.shape == (POP, 3, 16, 16)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_target_encoding_matches_jax(problems):
    """The port encodes the target text itself when the bundle carries none."""
    jprob, _, _, tbundle = problems
    bundle = {k: v for k, v in tbundle.items() if k != "target"}
    tprob = GenerationProblem(_config(get_config), device="cpu",
                              clip_cfg=tclip.TINY, model_cfg=tsg2.TINY,
                              bundle=bundle)
    assert_close_scaled(N(tprob.generator.text_features),
                        np.asarray(jprob.generator.text_features), 1e-4)


def test_eval_microbatch_matches_jax(problems):
    """eval_microbatch=4: chunked evaluation (whole minibatch-std groups)."""
    jprob0, jbundle, _, tbundle = problems
    jprob = JProblem(_config(jget_config, eval_microbatch=4),
                     clip_cfg=jclip.TINY, model_cfg=jsg2.TINY)
    tprob = GenerationProblem(_config(get_config, eval_microbatch=4), device="cpu",
                              clip_cfg=tclip.TINY, model_cfg=tsg2.TINY,
                              bundle=tbundle)
    X = _X(2)
    want = np.asarray(jax.jit(jprob.generator.eval_population)(jnp.asarray(X), jbundle))
    got = N(tprob.generator.eval_population(T(X)))
    for j in range(2):
        assert_close_scaled(got[:, j], want[:, j], 1e-4)


def test_eval_microbatch_non_dividing_raises(problems):
    *_, tbundle = problems
    tprob = GenerationProblem(_config(get_config, eval_microbatch=3), device="cpu",
                              clip_cfg=tclip.TINY, model_cfg=tsg2.TINY,
                              bundle=tbundle)
    with pytest.raises(ValueError, match="must divide"):
        tprob.generator.eval_population(T(_X()))


def test_port_random_problem_is_seeded():
    """weights='random:<seed>': the port's own draws, reproducible."""
    cfg = _config(get_config)
    a = GenerationProblem(cfg, device="cpu", clip_cfg=tclip.TINY, model_cfg=tsg2.TINY)
    b = GenerationProblem(cfg, device="cpu", clip_cfg=tclip.TINY, model_cfg=tsg2.TINY)
    X = T(_X(3))
    Fa, Fb = a.generator.eval_population(X), b.generator.eval_population(X)
    torch.testing.assert_close(Fa, Fb, rtol=0, atol=0)
    assert torch.isfinite(Fa).all() and Fa.shape == (POP, 2)


def test_unported_configs_raise():
    """GPT-2 is ported (item 10): its config's default weights (the
    reference's .bin, absent here) raise FileNotFoundError, as in the JAX
    package, and its TINY problem evaluates; a StyleGAN2 checkpoint
    directory that does not exist raises FileNotFoundError."""
    with pytest.raises(FileNotFoundError):
        GenerationProblem(get_config("GPT2"), device="cpu")
    F = GenerationProblem(_g2_config(get_config), device="cpu", clip_cfg=tclip.TINY,
                          model_cfg=tg2.TINY).generator.eval_population(T(_g2_X(0)))
    assert F.shape == (POP, 1) and torch.isfinite(F).all() and (F.abs() <= 1).all()
    with pytest.raises(FileNotFoundError):
        GenerationProblem(_config(get_config).replace(weights="./weights/x"),
                          device="cpu", clip_cfg=tclip.TINY, model_cfg=tsg2.TINY)


# ------------------------------------------------------------ s2d fitness

S2D_VARIANTS = {name: kw for name, kw in [
    ("offsets_s4d", {}), ("no_offsets", {"s2d_offsets": False}),
    ("no_s4d", {"rgb_s4d": False})]}


def _s2d_problems(problems, variant):
    """The JAX and port problems on the s2d TINY config, the port's built
    from the converted bundle of the plain TINY problem (the same weights,
    raw noise planes and target; the s2d domain reads the same tree)."""
    kw = S2D_VARIANTS[variant]
    jcfg = dataclasses.replace(jsg2.TINY, s2d_min_res=8, **kw)
    tcfg = dataclasses.replace(tsg2.TINY, s2d_min_res=8, **kw)
    _, jbundle, tplain, tbundle = problems
    jprob = JProblem(_config(jget_config), clip_cfg=jclip.TINY, model_cfg=jcfg)
    tprob = GenerationProblem(_config(get_config), device="cpu", clip_cfg=tclip.TINY,
                              model_cfg=tcfg, bundle=tbundle)
    return jprob, jbundle, tprob, tplain


@pytest.mark.parametrize("variant", sorted(S2D_VARIANTS))
def test_s2d_eval_population_matches_jax_and_port_plain(problems, variant):
    jprob, jbundle, tprob, tplain = _s2d_problems(problems, variant)
    assert jprob.generator._s2d_active and tprob.generator._s2d_active
    assert not tplain.generator._s2d_active
    X = _X(4)
    want = np.asarray(jax.jit(jprob.generator.eval_population)(jnp.asarray(X), jbundle))
    got = N(tprob.generator.eval_population(T(X)))
    plain = N(tplain.generator.eval_population(T(X)))
    assert got.shape == (POP, 2) and np.isfinite(got).all() and (got[:, 1] >= 0).all()
    for j in range(2):
        assert_close_scaled(got[:, j], want[:, j], 1e-4)
        assert_close_scaled(got[:, j], plain[:, j], 2e-3)


def test_s2d_generate_returns_full_resolution(problems):
    jprob, jbundle, tprob, tplain = _s2d_problems(problems, "offsets_s4d")
    X = _X(5)
    got = N(tprob.generator.generate(T(X)))
    assert got.shape == (POP, 3, 16, 16)
    want = np.asarray(jax.jit(jprob.generator.generate)(jnp.asarray(X), jbundle))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, N(tplain.generator.generate(T(X))), rtol=2e-3, atol=2e-3)
    # the staged noise is packed once for the s2d levels (8 and 16 px)
    assert [nz.ndim for nz in tprob.generator.noise] == [2, 3, 3, 3, 3]


def test_s2d_path_is_the_flagship_default():
    """CONFIG_F takes the s2d fitness path; the plain domain is reached
    through the config's own switch, s2d_min_res."""
    def active(cfg):
        return Generator._s2d_active.fget(types.SimpleNamespace(model_cfg=cfg))
    assert active(tsg2.CONFIG_F)
    assert not active(dataclasses.replace(tsg2.CONFIG_F, s2d_min_res=2 ** 30))
    assert tsg2.rgb_domain(tsg2.CONFIG_F) == "s4d"


def test_discriminator_stays_fp32_after_staging(problems, rng):
    """bf16 policy: G is precast (but dlatent_avg), D stays fp32, and the
    plain D forward is bitwise the same as with a precast D."""
    from clip_glass_torch.core.dtypes import map_tree, precast_params

    *_, tbundle = problems
    tprob = GenerationProblem(_config(get_config).replace(compute_dtype="bfloat16"),
                              device="cpu", clip_cfg=tclip.TINY, model_cfg=tsg2.TINY,
                              bundle=tbundle)
    gen = tprob.generator
    d_dtypes, g_dtypes = set(), set()
    map_tree(lambda _, t: d_dtypes.add(t.dtype), gen.d_params)
    map_tree(lambda p, t: g_dtypes.add(t.dtype) if "dlatent_avg" not in p else None,
             gen.g_params)
    assert d_dtypes == {torch.float32} and g_dtypes == {torch.bfloat16}
    img = T(rng.uniform(-1, 1, size=(4, 3, 16, 16)).astype(np.float32))
    a = tsg2.discriminator_apply(gen.d_params, img, tsg2.TINY, policy=BF16)
    b = tsg2.discriminator_apply(precast_params(gen.d_params, BF16), img, tsg2.TINY,
                                 policy=BF16)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


# ------------------------------------------------------------ BigGAN fitness


def _bg_config(get, **kw):
    return get("DeepMindBigGAN512").replace(
        pop_size=POP, dim_z=16, num_classes=10, n_var=26, resolution=8,
        weights="random:0", target="a red flower", compute_dtype="float32", **kw)


@pytest.fixture(scope="module")
def bg_problems():
    """The JAX TINY BigGAN problem with its G redrawn (test_torch_biggan's
    random_tree: no zero term), and the port's on the converted bundle."""
    from clip_glass_tpu.models.biggan import model as jbg
    from test_torch_biggan import random_tree

    jprob = JProblem(_bg_config(jget_config), clip_cfg=jclip.TINY, model_cfg=jbg.TINY)
    jbundle = dict(jprob.generator.bundle)
    jbundle["g"] = jax.tree.map(jnp.asarray, random_tree(jbg.TINY, 5))
    tbundle = from_jax.convert_bundle(jax.tree.map(np.asarray, jbundle))
    assert set(tbundle) == {"clip", "g", "target"}
    return jprob, jbundle, tbundle


def _bg_X(seed):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(POP, 16))
    return np.concatenate([z, rng.uniform(size=(POP, 10)) < 0.3], 1).astype(np.float32)


@pytest.mark.parametrize("s2d_min_res", [2 ** 30, 4])
def test_biggan_eval_population_matches_jax(bg_problems, s2d_min_res):
    """F = -cos of the TINY BigGAN problem, plain (as the configs run it at
    8 px) and with both blocks' mid segments in the s2d domain, against the
    JAX package's fitness on the same bundle (the JAX side plain: its model
    config is the TINY one; the domains are exact rewrites)."""
    from clip_glass_torch.models.biggan import model as tbg

    jprob, jbundle, tbundle = bg_problems
    tprob = GenerationProblem(_bg_config(get_config), device="cpu", clip_cfg=tclip.TINY,
                              model_cfg=dataclasses.replace(tbg.TINY, s2d_min_res=s2d_min_res),
                              bundle=tbundle)
    assert not tprob.generator._s2d_active and tprob.generator.noise is None
    X = _bg_X(6)
    want = np.asarray(jax.jit(jprob.generator.eval_population)(jnp.asarray(X), jbundle))
    got = N(tprob.generator.eval_population(T(X)))
    assert got.shape == (POP, 1) and np.isfinite(got).all()
    assert_close_scaled(got, want, 1e-4)
    imgs = N(tprob.generator.generate(T(X)))
    assert imgs.shape == (POP, 3, 8, 8)
    np.testing.assert_allclose(
        imgs, np.asarray(jax.jit(jprob.generator.generate)(jnp.asarray(X), jbundle)),
        rtol=1e-4, atol=1e-4)


def test_biggan_decode_matches_jax(rng):
    from clip_glass_tpu.fitness import latent as jlatent

    from clip_glass_torch.fitness import latent as tlatent

    X = (3 * rng.normal(size=(POP, 26))).astype(np.float32)
    want = jlatent.decode_biggan(jnp.asarray(X), 16)
    got = tlatent.decode_biggan(T(X), 16)
    np.testing.assert_array_equal(N(got[0]), np.asarray(want[0]))
    np.testing.assert_allclose(N(got[1]), np.asarray(want[1]), rtol=1e-6, atol=1e-7)


def test_biggan_loaders(tmp_path):
    """random:<seed> draws bg.CONFIGS' entry for the config's resolution; a
    converted npz with its _cfg.json gives the same weights; a missing path
    raises FileNotFoundError; the package's .bin loads as the
    `biggan-deep-<resolution>` variant. Staging keeps the running statistics
    fp32 under bf16."""
    import json

    from clip_glass_torch.core import pytree
    from clip_glass_torch.fitness.generator import _load_biggan, load_bundle
    from clip_glass_torch.models.biggan import model as tbg

    cfg = _bg_config(get_config)
    g, mcfg = _load_biggan(cfg.replace(resolution=256), None)
    assert mcfg == tbg.BIGGAN_DEEP_256
    path = tmp_path / "G.npz"
    pytree.save_npz(str(path), tbg.init_tree(torch.Generator().manual_seed(3), tbg.TINY))
    with open(tmp_path / "G_cfg.json", "w") as f:
        json.dump(dataclasses.asdict(tbg.TINY), f)
    bundle, _, got_cfg = load_bundle(cfg.replace(weights=str(path)), clip_cfg=tclip.TINY)
    assert got_cfg == tbg.TINY and set(bundle) == {"clip", "g"}
    want, _ = _load_biggan(cfg.replace(weights="random:3"), tbg.TINY)
    jax.tree.map(lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=0),
                 bundle["g"], want)
    with pytest.raises(FileNotFoundError):
        _load_biggan(cfg.replace(weights=str(tmp_path / "missing.npz")), None)
    from clip_glass_torch.weights import convert_biggan, synthesize

    bin_path = str(tmp_path / "pytorch_model.bin")
    synthesize.write_biggan(bin_path, tbg.TINY, seed=4)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(tbg.CONFIGS, "biggan-deep-8", tbg.TINY)
        got, got_cfg = _load_biggan(cfg.replace(weights=bin_path), None)
    assert got_cfg == tbg.TINY
    want = from_jax.convert_biggan(convert_biggan.load_torch_checkpoint(bin_path, "auto")[0])
    jax.tree.map(lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=0), got, want)
    gen = Generator(cfg.replace(compute_dtype="bfloat16"), device="cpu",
                    clip_cfg=tclip.TINY, model_cfg=tbg.TINY)
    blk = gen.g_params["blocks"][1]["block"]   # TINY: attention first
    assert blk["bn_0"]["running_vars"].dtype == torch.float32
    assert blk["conv_0"]["w"].dtype == torch.bfloat16
    assert set(gen.bundle) == {"clip", "g", "target"}


# ------------------------------------------------------------ GPT-2 img2txt fitness


@pytest.fixture(scope="module")
def g2_problems():
    """The JAX TINY GPT-2 problem (target: the example dog photo) and the
    port's on the converted bundle."""
    from clip_glass_tpu.models.gpt2 import model as jg2

    jprob = JProblem(_g2_config(jget_config), clip_cfg=jclip.TINY, model_cfg=jg2.TINY)
    jbundle = jprob.generator.bundle
    tbundle = from_jax.convert_bundle(jax.tree.map(np.asarray, jbundle))
    assert set(tbundle) == {"clip", "g", "target"}
    return jprob, jbundle, tbundle


def _g2_port(tbundle, **kw):
    return GenerationProblem(_g2_config(get_config, **kw), device="cpu", clip_cfg=tclip.TINY,
                             model_cfg=tg2.TINY, bundle=tbundle)


def _overflow_rows(generate, mark, tail):
    """`generate` with the decode of the rows whose first gene is `mark`
    replaced by `tail` (ids whose caption overflows CLIP's context); traced
    (JAX) and eager (the port) alike."""
    def patched(X, *a):
        ids = generate(X, *a)
        lib = jnp if isinstance(ids, jax.Array) else torch
        cols = np.arange(ids.shape[1]) >= ids.shape[1] - len(tail)
        planted = np.zeros(ids.shape[1], np.int32)
        planted[cols] = tail
        if lib is torch:
            cols, planted = torch.from_numpy(cols), torch.from_numpy(planted)
        return lib.where((X[:, :1] == mark) & cols[None, :], planted[None, :], ids)
    return patched


@pytest.mark.parametrize("mb", [None, 4, 3])
def test_gpt2_eval_population_matches_jax_host_eval(g2_problems, mb):
    """F = -cos of the TINY GPT-2 population against the JAX package's
    host_eval_population (fp32, 1e-5): whole, in two decode chunks, and with
    a microbatch that does not divide the population (one chunk in both)."""
    jprob, jbundle, tbundle = g2_problems
    X = _g2_X(1)
    jgen = JProblem(_g2_config(jget_config, eval_microbatch=mb), clip_cfg=jclip.TINY,
                    model_cfg=jprob.generator.model_cfg).generator
    want = np.asarray(jgen.host_eval_population(jnp.asarray(X), jbundle))
    got = N(_g2_port(tbundle, eval_microbatch=mb).generator.eval_population(T(X)))
    assert got.shape == (POP, 1) and (got != 0).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mb", [None, 4])
def test_gpt2_overflow_zeroes_the_population_as_jax(g2_problems, mb):
    """One caption past CLIP's 77 tokens (in the second chunk when mb = 4)
    zeroes every fitness of the population, in both packages."""
    jprob, jbundle, tbundle = g2_problems
    # GPT-2 id 33454 decodes to 3 CJK characters, 9 CLIP tokens: the caption's
    # 50 characters hold 36 of them, 108 CLIP tokens
    tail = np.full(12, 33454, np.int32)
    X = _g2_X(2)
    X[6, 0] = mark = 12345
    jgen = JProblem(_g2_config(jget_config, eval_microbatch=mb, max_tokens_len=len(tail)),
                    clip_cfg=jclip.TINY, model_cfg=jprob.generator.model_cfg).generator
    tgen = _g2_port(tbundle, eval_microbatch=mb, max_tokens_len=len(tail)).generator
    jgen.generate = _overflow_rows(jgen.generate, mark, tail)
    tgen.generate = _overflow_rows(tgen.generate, mark, tail)
    want = np.asarray(jgen.host_eval_population(jnp.asarray(X), jbundle))
    got = N(tgen.eval_population(T(X)))
    texts = tgen.decode_texts(tgen.generate(T(X)).numpy())
    assert len(texts[6]) == 50 and texts[6].startswith("the picture of")
    np.testing.assert_array_equal(got, want)
    assert (got == 0).all()
    # without the planted row, no caption overflows and no fitness is 0
    clean = _g2_port(tbundle, eval_microbatch=mb, max_tokens_len=len(tail)).generator
    assert (N(clean.eval_population(T(X))) != 0).all()


def test_gpt2_generate_texts_and_save_match_jax(g2_problems, tmp_path):
    """The argmax decode of genome ++ init tokens (token-exact), the
    captions (cut at EOT, init text kept, 50 characters) and the saved
    newline-joined captions, against the JAX package's."""
    jprob, jbundle, tbundle = g2_problems
    tgen = _g2_port(tbundle).generator
    X = _g2_X(3)
    X[1, 2] = 50256                                   # an EOT inside the genome
    want = np.asarray(jax.jit(jprob.generator.generate)(jnp.asarray(X), jbundle))
    got = tgen.generate(T(X)).numpy()
    assert got.shape == (POP, 6 + 3 + 5) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, 6:9], [[1169, 4286, 286]] * POP)
    got[3, 11] = 50256                                # an EOT inside the decode
    texts = tgen.decode_texts(got)
    assert texts == jprob.generator.decode_texts(got)
    assert texts[1] == "" and all(t.startswith("the picture of") for t in texts[2:])
    tgen.save(got, str(tmp_path / "port.txt"))
    jprob.generator.save(got, str(tmp_path / "jax.txt"))
    assert (tmp_path / "port.txt").read_text() == (tmp_path / "jax.txt").read_text()
    np.testing.assert_array_equal(tgen.render(T(X)), want)


def test_gpt2_target_features_match_jax(g2_problems):
    """The port encodes the target image itself (clip_preprocess_pil, then
    the image tower) when the bundle carries no target."""
    jprob, _, tbundle = g2_problems
    bundle = {k: v for k, v in tbundle.items() if k != "target"}
    tgen = _g2_port(bundle).generator
    assert tgen.text_features is None
    assert_close_scaled(N(tgen.image_features), np.asarray(jprob.generator.image_features), 1e-5)


def test_gpt2_loaders(tmp_path):
    """random:<seed> draws the TINY tree; a converted npz with its _cfg.json
    gives the same weights; without the sidecar the geometry comes from the
    shapes (head width 64); a missing path raises FileNotFoundError; the
    reference's legacy .bin loads, its geometry read off the shapes. bf16
    staging keeps the LayerNorm parameters fp32."""
    import json

    from clip_glass_torch.core import pytree
    from clip_glass_torch.fitness.generator import _load_gpt2

    cfg = _g2_config(get_config)
    want, mcfg = _load_gpt2(cfg.replace(weights="random:3"), tg2.TINY)
    assert mcfg == tg2.TINY
    path = tmp_path / "gpt2.npz"
    pytree.save_npz(str(path), tg2.init_tree(torch.Generator().manual_seed(3), tg2.TINY))
    got, got_cfg = _load_gpt2(cfg.replace(weights=str(path)), None)
    assert got_cfg == tg2.GPT2Config(n_positions=128, n_embd=64, n_layer=2, n_head=2)
    jax.tree.map(lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=0), got, want)
    with open(tmp_path / "gpt2_cfg.json", "w") as f:
        json.dump(dataclasses.asdict(dataclasses.replace(tg2.TINY, n_head=4)), f)
    assert _load_gpt2(cfg.replace(weights=str(path)), None)[1].n_head == 4
    with pytest.raises(FileNotFoundError):
        _load_gpt2(cfg.replace(weights=str(tmp_path / "missing.npz")), None)
    from clip_glass_torch.weights import synthesize

    bin_path = str(tmp_path / "gpt2-pytorch_model.bin")
    synthesize.write_gpt2(bin_path, n_embd=64, n_layer=2, seed=3)
    got, got_cfg = _load_gpt2(cfg.replace(weights=bin_path), None)
    assert got_cfg == tg2.GPT2Config(n_embd=64, n_layer=2, n_head=2)
    assert got["blocks"][1]["mlp"]["c_proj_w"].shape == (256, 64)
    gen = Generator(cfg.replace(compute_dtype="bfloat16"), device="cpu",
                    clip_cfg=tclip.TINY, model_cfg=tg2.TINY)
    assert gen.g_params["blocks"][0]["ln_2"]["b"].dtype == torch.float32
    assert gen.g_params["wte"].dtype == gen.g_params["blocks"][1]["attn"]["c_attn_w"].dtype \
        == torch.bfloat16
    assert set(gen.bundle) == {"clip", "g", "target"}
