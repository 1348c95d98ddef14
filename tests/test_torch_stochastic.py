"""Stochastic fitness (config.stochastic: GPT-2's sampled decode) draws anew
each generation, on the CPU with TINY GPT-2 and TINY CLIP in fp32.

The JAX package splits an evaluation key off in every `vary` and in `init`
(clip_glass_tpu/evolve/algorithm.py), so its sampled decode is a fresh draw
each generation. The port's counterpart is `algorithm.draw_seed`: one seed
from the search's generator after its variation, handed to the evaluation,
which seeds GPT-2's sampling with it. Here: two generations score the same
genomes differently (as JAX's evaluation does under two keys), a search is
still a function of its seed and resumes bitwise, K batched searches and the
server's slots each draw from their own generator, and a fitness that is not
stochastic leaves the generator's draws as they were.
"""

import os

import numpy as np
import pytest

import jax
import torch

from clip_glass_tpu.config import get_config as jget_config
from clip_glass_tpu.fitness.problem import GenerationProblem as JProblem
from clip_glass_tpu.models.clip import model as jclip
from clip_glass_tpu.models.gpt2 import model as jg2

from clip_glass_torch.config import get_config
from clip_glass_torch.evolve import algorithm as alg
from clip_glass_torch.evolve import batched
from clip_glass_torch.evolve.algorithm import GAState, make_step, make_step_halves, minimize
from clip_glass_torch.fitness.problem import GenerationProblem
from clip_glass_torch.models.clip import model as tclip
from clip_glass_torch.models.gpt2 import model as tg2
from clip_glass_torch.serving import SearchServer
from clip_glass_torch.weights import from_jax

IMG_DIR = os.path.join(os.path.dirname(__file__), "..", "examples", "gpt2_images")
IMAGES = [os.path.join(IMG_DIR, n) for n in ("dog.jpeg", "goldfish.jpeg")]
POP = 4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(get, **kw):
    return get("GPT2").replace(**{**dict(
        pop_size=POP, dim_z=6, n_var=6, max_tokens_len=5, weights="random:0",
        target=IMAGES[0], compute_dtype="float32", stochastic=True), **kw})


@pytest.fixture(scope="module")
def pair():
    """The JAX package's stochastic GPT2 problem and the port's on its
    weights."""
    jprob = JProblem(_cfg(jget_config), clip_cfg=jclip.TINY, model_cfg=jg2.TINY)
    bundle = from_jax.convert_bundle(jax.tree.map(np.asarray, jprob.generator.bundle))
    tprob = GenerationProblem(_cfg(get_config), device="cpu", clip_cfg=tclip.TINY,
                              model_cfg=tg2.TINY, bundle=bundle)
    return jprob, tprob


@pytest.fixture(scope="module")
def problem(pair):
    return pair[1]


def _X(seed=3):
    return np.random.default_rng(seed).integers(0, 50257, (POP, 6)).astype(np.float32)


def test_each_generation_scores_with_a_fresh_draw(pair):
    """The seeds the step hands the evaluation differ between generations,
    and the same genomes score differently under them; JAX's evaluation of
    the same genomes under two keys differs likewise. Under one seed the
    port's evaluation repeats itself."""
    jprob, tprob = pair
    seen = []
    algo = tprob.make_algorithm()
    assert algo.stochastic
    evaluate = algo.eval_fn
    algo.eval_fn = lambda X, seed: seen.append(seed) or evaluate(X, seed)
    minimize(algo, 2, 0)
    assert len(seen) == 3 and len(set(seen)) == 3          # init + 2 generations

    X = torch.from_numpy(_X())
    F1, F2 = evaluate(X, seen[1]), evaluate(X, seen[2])
    assert not torch.equal(F1, F2)
    assert torch.equal(F1, evaluate(X, seen[1]))
    ids1 = tprob.generator.generate(X, seed=seen[1])
    ids2 = tprob.generator.generate(X, seed=seen[2])
    assert not torch.equal(ids1, ids2)

    jgen = jprob.generator
    jX = jax.numpy.asarray(_X())
    jF1 = np.asarray(jgen.host_eval_population(jX, key=jax.random.PRNGKey(1)))
    jF2 = np.asarray(jgen.host_eval_population(jX, key=jax.random.PRNGKey(2)))
    assert not np.array_equal(jF1, jF2)


def test_keyless_generate_keeps_config_seed(problem):
    """`generate` with no seed samples from config.seed, as JAX's keyless
    generate does from PRNGKey(config.seed)."""
    X = torch.from_numpy(_X(4))
    gen = problem.generator
    assert torch.equal(gen.generate(X), gen.generate(X, seed=problem.config.seed))


def test_search_is_a_function_of_its_seed(problem):
    a = minimize(problem.make_algorithm(), 3, 5)
    b = minimize(problem.make_algorithm(), 3, 5)
    assert torch.equal(a.pop_F, b.pop_F) and torch.equal(a.pop_X, b.pop_X)


def test_resumed_search_equals_the_uninterrupted_one(problem):
    """Two generations, the generator's state carried over (what the CLI's
    ga_state.npz holds), two more: bitwise the four-generation search."""
    algo = problem.make_algorithm()
    straight = minimize(algo, 4, 7)
    gen = algo.generator(7)
    half = minimize(algo, 2, gen)
    resumed_gen = algo.generator(0)
    resumed_gen.set_state(gen.get_state())
    resumed = minimize(algo, 2, resumed_gen, state=half.state)
    assert resumed.state.gen == 4
    assert torch.equal(resumed.pop_X, straight.pop_X)
    assert torch.equal(resumed.pop_F, straight.pop_F)


def _independent(problem, row, seed, n_gen):
    """Search `seed` of one target alone: its fitness scored against `row`."""
    gen = problem.generator
    algo = problem.make_algorithm()
    algo.eval_fn = lambda X, s: gen.eval_population(X, {**gen.bundle, "target": row}, s)
    return minimize(algo, n_gen, seed)


def test_batched_searches_draw_each_from_their_own_generator(problem):
    """K = 2 batched stochastic searches: search i draws its evaluation seeds
    from search_generator(seed, i), so it is bitwise the search of that
    generator run alone against its target."""
    balgo = batched.make_batched(problem, IMAGES)
    got = batched.minimize_batched(balgo, 2, 11)
    for i, res in enumerate(got):
        want = _independent(problem, balgo.targets[i:i + 1],
                            batched.search_generator(11, i, "cpu"), 2)
        assert torch.equal(res.pop_X, want.pop_X), i
        assert torch.equal(res.pop_F, want.pop_F), i


def test_server_slots_draw_each_from_their_ticket(problem):
    """A stochastic request served through a slot is its ticket's generator's
    search alone."""
    server = SearchServer(problem, n_slots=2, chunk=1, seed=13)
    res = server.map(IMAGES[::-1], 2)
    feats = problem.generator.encode_targets(IMAGES[::-1])
    for t, r in enumerate(res):
        want = _independent(problem, feats[t:t + 1], batched.search_generator(13, t, "cpu"), 2)
        assert torch.equal(r.pop_X, want.pop_X), t
        assert torch.equal(r.pop_F, want.pop_F), t


def test_ranks_seeded_alike_draw_the_same_seeds(problem):
    """Over a mesh every rank steps the whole state with a generator seeded
    alike: two such generators hand their evaluations the same seeds."""
    ops = problem.make_algorithm().ops
    F0 = torch.zeros(POP, 1)

    def seeds_of(gen):
        seen = []
        step = make_step(ops, lambda X, s: seen.append(s) or F0, POP, "ga", stochastic=True)
        state = GAState(ops.sample(gen, POP), F0, 0)
        for _ in range(3):
            state = step(state, gen)
        return seen

    assert seeds_of(torch.Generator().manual_seed(9)) == seeds_of(torch.Generator().manual_seed(9))


@pytest.mark.parametrize("name,algorithm", [("StyleGAN2_ffhq_d", "nsga2"), ("GPT2", "ga")])
def test_deterministic_fitness_draws_as_before(name, algorithm):
    """With stochastic=False a step draws exactly what `vary` draws, nothing
    more: the generator's state after a step equals its state after `vary`
    alone, and init draws the sampling alone."""
    cfg = get_config(name).replace(pop_size=POP, n_var=6, dim_z=6)
    assert not cfg.stochastic
    ops = alg.operators_for_config(cfg)
    n_obj = 2 if algorithm == "nsga2" else 1
    F0 = torch.rand(POP, n_obj, generator=torch.Generator().manual_seed(1))
    algo = alg.make_algorithm(cfg, lambda X: F0[:X.shape[0]], device="cpu")
    assert not algo.stochastic

    a, b = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    state = algo.init(a)
    ops.sample(b, POP)
    assert torch.equal(a.get_state(), b.get_state())

    vary, _ = make_step_halves(ops, POP, algorithm)
    algo.step_fn()(state, a)
    vary(state, b)
    assert torch.equal(a.get_state(), b.get_state())


def test_draw_seed_advances_the_generator():
    gen = torch.Generator().manual_seed(0)
    before = gen.get_state()
    s1, s2 = alg.draw_seed(gen), alg.draw_seed(gen)
    assert s1 != s2 and 0 <= s1 < 2 ** 62
    assert not torch.equal(before, gen.get_state())
