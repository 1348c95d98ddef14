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
    """GPT-2 is not ported; a checkpoint directory that does not exist
    raises FileNotFoundError, as in the JAX package."""
    with pytest.raises(NotImplementedError):
        GenerationProblem(get_config("GPT2"), device="cpu")
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
