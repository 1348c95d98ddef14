"""Multi-search batching of the port (clip_glass_torch/evolve/batched.py):
K searches of one config and weight set, each with its own target, in one
batched evaluation a generation.

- Against the JAX package (fp32, TINY models, numpy inputs from a seed):
  per-search minibatch-std and D equal JAX's `vmap` over searches (1e-5
  relative to the output's scale), and pooling the concatenated batch
  instead fails that equality; the batched fitness equals
  `jax.vmap(algo.eval_fn, in_axes=(0, _ctx_axes(ctx), 0))` for StyleGAN2
  `_d` in both domains, `_nod` and BigGAN, with and without
  eval_microbatch (1e-4 of each objective's scale, the tolerance of
  tests/test_torch_fitness.py); GPT-2's equals `host_eval_population_batched`
  with search_microbatch None and 2 (1e-5, and an overflow zeroes only its
  own search); `_auto_search_microbatch` equals JAX's for K = 1..32.
- The port against itself: a batched search equals K independent `minimize`
  runs with the batch's target rows and `search_generator(seed, i)` (X
  rtol = atol = 1e-5, F rtol 1e-4 atol 1e-5: tests/test_batched.py's
  tolerances; the evaluation batch differs, so the sums do), GA and
  NSGA-II, BigGAN and GPT-2, with and without search_microbatch; a
  search_microbatch that does not divide K raises.
- The CLI: several --target write `search-NN/` folders with `target.txt`
  and the artifact set, one `ga_state.npz` at the root; a K-search resume is
  bitwise; a checkpoint of another K exits 2.
"""

import dataclasses
import os
import pickle

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import torch

from clip_glass_tpu.config import get_config as jget_config
from clip_glass_tpu.evolve import batched as jbatched
from clip_glass_tpu.fitness.problem import GenerationProblem as JProblem
from clip_glass_tpu.models.clip import model as jclip
from clip_glass_tpu.models.stylegan2 import model as jsg2
from clip_glass_tpu.ops.bias_act import minibatch_std as jminibatch_std

from clip_glass_torch import cli
from clip_glass_torch.config import get_config
from clip_glass_torch.evolve import batched
from clip_glass_torch.evolve.algorithm import minimize
from clip_glass_torch.fitness.problem import GenerationProblem
from clip_glass_torch.models.clip import model as tclip
from clip_glass_torch.models.gpt2 import model as tg2
from clip_glass_torch.models.stylegan2 import model as tsg2
from clip_glass_torch.ops.bias_act import minibatch_std
from clip_glass_torch.weights import from_jax

from torch_parity import N, T, assert_close_scaled

POP = 8
K = 3   # three searches: D's groups of 4 would cross searches if pooled wrong
TARGETS = ["a red flower", "a blue car", "an old house"]
IMG_DIR = os.path.join(os.path.dirname(__file__), "..", "examples", "gpt2_images")
IMAGES = [os.path.join(IMG_DIR, n) for n in ("dog.jpeg", "goldfish.jpeg")]


def _sg2_config(get, name="StyleGAN2_ffhq_d", **kw):
    return get(name).replace(pop_size=POP, dim_z=32, n_var=32, weights="random:0",
                             target=TARGETS[0], compute_dtype="float32", **kw)


def _bg_config(get, **kw):
    return get("DeepMindBigGAN512").replace(
        pop_size=POP, dim_z=16, num_classes=10, n_var=26, resolution=8,
        weights="random:0", target=TARGETS[0], compute_dtype="float32", **kw)


def _g2_config(get, **kw):
    return get("GPT2").replace(**{**dict(
        pop_size=4, dim_z=6, n_var=6, max_tokens_len=5, weights="random:0",
        target=IMAGES[0], compute_dtype="float32"), **kw})



@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread a test: the lane runs six test processes on the
    machine's cores, and these TINY computations gain nothing from more
    threads but lose much to their contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# ------------------------------------------------------------ D per search


@pytest.mark.parametrize("C", [3, 5])
def test_minibatch_std_per_search_matches_jax_vmap(C):
    x = np.random.default_rng(0).normal(size=(K * POP, 4, 4, C)).astype(np.float32)
    want = np.asarray(jax.vmap(jminibatch_std)(jnp.asarray(x.reshape(K, POP, 4, 4, C))))
    got = N(minibatch_std(T(x), 4, n_search=K))
    assert_close_scaled(got, want.reshape(K * POP, 4, 4, C + 1), 1e-6)
    # the guard: the concatenated batch pooled as one crosses searches
    mixed = N(minibatch_std(T(x), 4))
    assert not np.allclose(mixed, want.reshape(mixed.shape), rtol=1e-3, atol=1e-3)


@pytest.fixture(scope="module")
def sg2_d():
    """The JAX TINY D (and its port) on random weights."""
    jprob = JProblem(_sg2_config(jget_config), clip_cfg=jclip.TINY, model_cfg=jsg2.TINY)
    jd = jprob.generator.bundle["d"]
    return jd, from_jax.convert_discriminator(jax.tree.map(np.asarray, jd))


@pytest.mark.parametrize("domain", ["plain", "s2d"])
def test_discriminator_per_search_matches_jax_vmap(sg2_d, domain):
    """D over K searches' images at once equals JAX's D vmapped over the
    searches, in the plain domain and on the s2d-packed input (s2d_min_res
    = 8 at TINY's 16 px); the concatenated batch without n_search does not."""
    jd, td = sg2_d
    kw = {} if domain == "plain" else dict(s2d_min_res=8)
    jcfg, tcfg = (dataclasses.replace(m.TINY, **kw) for m in (jsg2, tsg2))
    img = np.random.default_rng(1).uniform(-1, 1, (K * POP, 3, 16, 16)).astype(np.float32)
    if domain == "s2d":   # D reads the packed image: s2d at lattice 0
        img = img.transpose(0, 2, 3, 1).reshape(K * POP, 8, 2, 8, 2, 3) \
            .transpose(0, 1, 3, 2, 4, 5).reshape(K * POP, 8, 8, 12)
    dkw = {} if domain == "plain" else dict(input_s2d=True)

    def jfn(im):
        return jsg2.discriminator_apply(jd, im, jcfg, **dkw)
    want = np.asarray(jax.vmap(jfn)(jnp.asarray(img.reshape(K, POP, *img.shape[1:]))))
    want = want.reshape(K * POP, 1)
    got = N(tsg2.discriminator_apply(td, T(img), tcfg, n_search=K, **dkw))
    assert_close_scaled(got, want, 1e-5)
    mixed = N(tsg2.discriminator_apply(td, T(img), tcfg, **dkw))
    assert not np.allclose(mixed, want, rtol=1e-3, atol=1e-3)


# ------------------------------------------------------------ batched fitness vs JAX


def _jax_vmapped_F(jprob, ctx, Xb):
    algo = jprob.make_algorithm()
    keys = jax.random.split(jax.random.PRNGKey(0), Xb.shape[0])
    fn = jax.jit(jax.vmap(algo.eval_fn, in_axes=(0, jbatched._ctx_axes(ctx), 0)))
    return np.asarray(fn(jnp.asarray(Xb), ctx, keys))


def _pair(family, mb):
    """(JAX problem, its bundle, port problem on the converted bundle) of a
    TINY family; eval_microbatch `mb` on both."""
    from clip_glass_tpu.models.biggan import model as jbg

    from clip_glass_torch.models.biggan import model as tbg

    if family == "BigGAN":
        from test_torch_biggan import random_tree

        jprob = JProblem(_bg_config(jget_config, eval_microbatch=mb), clip_cfg=jclip.TINY,
                         model_cfg=jbg.TINY)
        jbundle = dict(jprob.generator.bundle)
        jbundle["g"] = jax.tree.map(jnp.asarray, random_tree(jbg.TINY, 5))
        tprob_args = (_bg_config(get_config, eval_microbatch=mb), tbg.TINY)
    else:
        name, kw = {"d": ("StyleGAN2_ffhq_d", {}),
                    "d_s2d": ("StyleGAN2_ffhq_d", dict(s2d_min_res=8)),
                    "nod": ("StyleGAN2_ffhq_nod", {})}[family]
        jprob = JProblem(_sg2_config(jget_config, name, eval_microbatch=mb), clip_cfg=jclip.TINY,
                         model_cfg=dataclasses.replace(jsg2.TINY, **kw))
        # the plain problem's bundle (raw noise planes), which the s2d
        # domain reads too (tests/test_torch_fitness.py's _s2d_problems)
        jbundle = dict(JProblem(_sg2_config(jget_config, name), clip_cfg=jclip.TINY,
                                model_cfg=jsg2.TINY).generator.bundle)
        tprob_args = (_sg2_config(get_config, name, eval_microbatch=mb),
                      dataclasses.replace(tsg2.TINY, **kw))
    tbundle = from_jax.convert_bundle(jax.tree.map(np.asarray, jbundle))
    tprob = GenerationProblem(tprob_args[0], device="cpu", clip_cfg=tclip.TINY,
                              model_cfg=tprob_args[1], bundle=tbundle)
    return jprob, jbundle, tprob


@pytest.mark.parametrize("mb", [None, 4])
@pytest.mark.parametrize("family", ["d", "d_s2d", "nod", "BigGAN"])
def test_batched_fitness_matches_jax_vmap(family, mb):
    """F [K, pop, n_obj] of K populations against K targets: the port's one
    batched evaluation against the JAX package's evaluation vmapped over
    the searches (its batched bundle: the target leaf [K, 1, D])."""
    jprob, jbundle, tprob = _pair(family, mb)
    n_var = jprob.config.n_var
    Xb = np.random.default_rng(3).normal(size=(K, POP, n_var)).astype(np.float32)
    if family == "BigGAN":   # the class genes are bits
        Xb[..., 16:] = Xb[..., 16:] > 0.8
    feats = jprob.generator.encode_targets(TARGETS)
    ctx = {**jbundle, "target": feats[:, None, :]}
    want = _jax_vmapped_F(jprob, ctx, Xb)
    got = N(tprob.generator.eval_population_batched(T(Xb), T(feats)))
    assert got.shape == want.shape == (K, POP, jprob.config.n_obj)
    for j in range(got.shape[-1]):
        assert_close_scaled(got[..., j], want[..., j], 1e-4)
    # the port's own target encoding of the K prompts, one CLIP call
    assert_close_scaled(N(tprob.generator.encode_targets(TARGETS)), np.asarray(feats), 1e-5)


@pytest.fixture(scope="module")
def g2_pair():
    from clip_glass_tpu.models.gpt2 import model as jg2

    jprob = JProblem(_g2_config(jget_config), clip_cfg=jclip.TINY, model_cfg=jg2.TINY)
    tbundle = from_jax.convert_bundle(jax.tree.map(np.asarray, jprob.generator.bundle))
    tprob = GenerationProblem(_g2_config(get_config), device="cpu", clip_cfg=tclip.TINY,
                              model_cfg=tg2.TINY, bundle=tbundle)
    return jprob, tprob


def _g2_Xb(seed, k):
    return np.random.default_rng(seed).integers(0, 50257, (k, 4, 6)).astype(np.float32)


@pytest.mark.parametrize("smb", [None, 2])
def test_gpt2_batched_matches_jax_host_eval_batched(g2_pair, smb):
    """GPT-2 over K = 4 searches (two images, twice): the decode in groups of
    `smb` searches, the round trip per search, one text-tower call; against
    the JAX package's host_eval_population_batched (fp32, 1e-5)."""
    jprob, tprob = g2_pair
    targets = IMAGES * 2
    Xb = _g2_Xb(4, len(targets))
    feats = jprob.generator.encode_targets(targets)
    ctx = {**jprob.generator.bundle, "target": feats[:, None, :]}
    want = np.asarray(jprob.generator.host_eval_population_batched(
        jnp.asarray(Xb), ctx, search_microbatch=smb))
    got = N(tprob.generator.eval_population_batched(T(Xb), T(feats), smb))
    assert got.shape == (4, 4, 1) and (got != 0).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert_close_scaled(N(tprob.generator.encode_targets(targets)), np.asarray(feats), 1e-5)


def test_gpt2_batched_overflow_zeroes_only_its_search(g2_pair):
    """A caption past CLIP's 77 tokens in search 1 zeroes search 1's whole
    population and no other's, as in the JAX package."""
    from test_torch_fitness import _overflow_rows

    jprob, tprob = g2_pair
    tail = np.full(12, 33454, np.int32)   # 3 CJK characters, 9 CLIP tokens each
    jgen = JProblem(_g2_config(jget_config, max_tokens_len=len(tail)), clip_cfg=jclip.TINY,
                    model_cfg=jprob.generator.model_cfg).generator
    tgen = GenerationProblem(_g2_config(get_config, max_tokens_len=len(tail)), device="cpu",
                             clip_cfg=tclip.TINY, model_cfg=tg2.TINY,
                             bundle=tprob.generator.bundle).generator
    Xb = _g2_Xb(5, 2)
    Xb[1, 2, 0] = mark = 12345
    jgen.generate = _overflow_rows(jgen.generate, mark, tail)
    tgen.generate = _overflow_rows(tgen.generate, mark, tail)
    feats = jgen.encode_targets(IMAGES)
    want = np.asarray(jgen.host_eval_population_batched(
        jnp.asarray(Xb), {**jgen.bundle, "target": feats[:, None, :]}))
    got = N(tgen.eval_population_batched(T(Xb), T(feats)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert (got[1] == 0).all() and (want[1] == 0).all() and (got[0] != 0).all()


def test_gpt2_stochastic_evaluates_each_search_alone(g2_pair):
    """With config.stochastic the batched evaluation is each search's own
    `eval_population` in turn (the JAX package keeps the per-search loop
    there: one batched decode would share one sampling key), and
    make_batched leaves the decode grouping unset."""
    _, tprob = g2_pair
    gen = GenerationProblem(_g2_config(get_config, stochastic=True), device="cpu",
                            clip_cfg=tclip.TINY, model_cfg=tg2.TINY,
                            bundle=tprob.generator.bundle).generator
    Xb = T(_g2_Xb(6, 2))
    feats = gen.encode_targets(IMAGES)
    want = torch.stack([gen.eval_population(Xb[i], {**gen.bundle, "target": feats[i:i + 1]})
                        for i in range(2)])
    assert torch.equal(gen.eval_population_batched(Xb, feats), want)
    prob = GenerationProblem(_g2_config(get_config, stochastic=True), device="cpu",
                             clip_cfg=tclip.TINY, model_cfg=tg2.TINY)
    assert batched.make_batched(prob, IMAGES * 2).search_microbatch is None
    assert batched.make_batched(_port_problem("GPT2"), IMAGES * 2).search_microbatch == 2


def test_auto_search_microbatch_matches_jax():
    for k in range(1, 33):
        assert batched._auto_search_microbatch(k) == jbatched._auto_search_microbatch(k), k


# ------------------------------------------------------------ the port against itself


def _port_problem(family):
    if family == "BigGAN":
        from clip_glass_torch.models.biggan import model as tbg
        return GenerationProblem(_bg_config(get_config), device="cpu", clip_cfg=tclip.TINY,
                                 model_cfg=tbg.TINY)
    if family == "GPT2":
        return GenerationProblem(_g2_config(get_config), device="cpu", clip_cfg=tclip.TINY,
                                 model_cfg=tg2.TINY)
    return GenerationProblem(_sg2_config(get_config, family), device="cpu",
                             clip_cfg=tclip.TINY, model_cfg=tsg2.TINY)


@pytest.mark.parametrize("smb", [None, 2])
@pytest.mark.parametrize("family", ["StyleGAN2_ffhq_d", "StyleGAN2_ffhq_nod", "BigGAN",
                                    "GPT2"])
def test_batched_search_equals_independent_searches(family, smb):
    """Search i of a batch of 4 (3 generations) equals a `minimize` of the
    same problem scored against the batch's target row i, with the
    generator search_generator(7, i); each search's X0 is that generator's
    first sample, bitwise."""
    prob = _port_problem(family)
    targets = (IMAGES * 2) if family == "GPT2" else TARGETS + ["a green bird"]
    balgo = batched.make_batched(prob, targets, search_microbatch=smb)
    gens = balgo.generators(7)
    state0 = balgo.init(gens)
    for i in range(len(targets)):
        assert torch.equal(state0.X[i], balgo.sample(batched.search_generator(7, i, "cpu")))
    res_b = batched.minimize_batched(balgo, 3, gens, save_each=2, state=state0)
    gen = prob.generator
    for i, rb in enumerate(res_b):
        row = balgo.targets[i:i + 1]
        algo = dataclasses.replace(
            prob.make_algorithm(),
            eval_fn=lambda X, row=row: gen.eval_population(X, {**gen.bundle, "target": row}))
        ri = minimize(algo, 3, batched.search_generator(7, i, "cpu"))
        assert rb.state.gen == ri.state.gen == 3
        np.testing.assert_allclose(N(rb.pop_X), N(ri.pop_X), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(N(rb.pop_F), N(ri.pop_F), rtol=1e-4, atol=1e-5)


def test_search_microbatch_must_divide_the_searches():
    prob = _port_problem("StyleGAN2_ffhq_nod")
    targets = TARGETS + ["a green bird"]
    with pytest.raises(ValueError, match="must divide"):
        batched.make_batched(prob, targets, search_microbatch=3)
    Xb = torch.zeros(4, POP, 32)
    with pytest.raises(ValueError, match="must divide"):
        prob.generator.eval_population_batched(Xb, torch.zeros(4, 16), 3)
    # as in the JAX package, one at least K evaluates the K searches at once
    assert batched.make_batched(prob, targets, search_microbatch=8).search_microbatch == 8


def test_search_generator_rule():
    """Search 0 is the single search's generator; the indexes give distinct
    streams on the CPU's 32-bit-seeded generator."""
    draw = [torch.randn(4, generator=batched.search_generator(3, i, "cpu")) for i in range(4)]
    assert torch.equal(draw[0], torch.randn(4, generator=torch.Generator().manual_seed(3)))
    assert len({tuple(d.tolist()) for d in draw}) == 4
    assert batched.search_seed(3, 2) == (3 + 2 * batched.SEED_STRIDE) % 2 ** 64


# ------------------------------------------------------------ the CLI


def _cli(folder, generations, *targets, extra=()):
    argv = ["--config", "StyleGAN2_ffhq_d", "--tiny", "--device", "cpu",
            "--pop-size", str(POP), "--generations", str(generations), "--save-each", "2",
            "--tmp-folder", str(folder), "--no-verbose", *extra]
    for t in targets:
        argv += ["--target", t]
    return cli.main(argv)


def _npz(path):
    with np.load(path) as d:
        return {k: d[k] for k in d.files}


def test_cli_multi_target_folders_and_bitwise_resume(tmp_path):
    """Three targets: `search-NN/` with target.txt, the periodic and final
    artifacts each, one ga_state.npz (X [3, pop, n_var], n_search 3, three
    generator states) at the root; 2 generations resumed to 4 equal 4
    straight, bitwise, the state and every search's result."""
    a, b = tmp_path / "a", tmp_path / "b"
    assert _cli(a, 2, *TARGETS) == 0
    assert _cli(a, 4, *TARGETS, extra=["--resume"]) == 0
    assert _cli(b, 4, *TARGETS) == 0
    assert set(os.listdir(a)) == {"ga_state.npz", "search-00", "search-01", "search-02"}
    for i, target in enumerate(TARGETS):
        folder = b / f"search-{i:02d}"
        final = {"target.txt", "genetic-it-final.jpg", "genetic_result", "F.jpg",
                 "ls_result.npz", "output.jpg"}
        assert set(os.listdir(folder)) == final | {"genetic-it-2.jpg"}
        assert set(os.listdir(a / f"search-{i:02d}")) == final   # 2 was A1's final
        assert (folder / "target.txt").read_text() == target
        with open(folder / "genetic_result", "rb") as f, \
                open(b / f"search-{i:02d}" / "genetic_result", "rb") as g:
            ra, rb = pickle.load(f), pickle.load(g)
        for k in ra:
            np.testing.assert_array_equal(ra[k], rb[k])
    sa, sb = _npz(a / "ga_state.npz"), _npz(b / "ga_state.npz")
    assert sa["X"].shape == (3, POP, 32) and int(sa["n_search"]) == 3
    assert sa["rng_state"].shape[0] == 3 and list(sa["gen"]) == [4, 4, 4]
    assert sa.keys() == sb.keys()
    for k in sa:
        np.testing.assert_array_equal(sa[k], sb[k])


@pytest.mark.parametrize("written,resumed", [(2, 3), (1, 2), (2, 1)])
def test_cli_resume_refuses_a_checkpoint_of_another_k(tmp_path, capsys, written, resumed):
    """A ga_state.npz of K searches continues only a run of K: another K,
    and a single search's file for a batch (and back), exit 2."""
    assert _cli(tmp_path, 2, *TARGETS[:written]) == 0
    before = _npz(tmp_path / "ga_state.npz")
    with pytest.raises(SystemExit) as e:
        _cli(tmp_path, 4, *TARGETS[:resumed], extra=["--resume"])
    assert e.value.code == 2
    assert "batched search" in capsys.readouterr().err
    after = _npz(tmp_path / "ga_state.npz")
    assert all(np.array_equal(before[k], after[k]) for k in before)


def test_cli_search_microbatch(tmp_path, capsys):
    """--search-microbatch 2 over 4 targets gives the unchunked run's
    searches (the chunks are scheduling); 3 does not divide 4: exit 2."""
    four = TARGETS + ["a green bird"]
    assert _cli(tmp_path / "a", 2, *four) == 0
    assert _cli(tmp_path / "b", 2, *four, extra=["--search-microbatch", "2"]) == 0
    sa, sb = _npz(tmp_path / "a" / "ga_state.npz"), _npz(tmp_path / "b" / "ga_state.npz")
    np.testing.assert_allclose(sb["X"], sa["X"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(sb["F"], sa["F"], rtol=1e-4, atol=1e-5)
    with pytest.raises(SystemExit) as e:
        _cli(tmp_path / "c", 2, *four, extra=["--search-microbatch", "3"])
    assert e.value.code == 2
    assert "must divide" in capsys.readouterr().err
