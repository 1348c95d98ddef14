"""clip_glass_torch's GA and NSGA-II operators, sort, survival, result and
decision against the JAX package's. The JAX operators split their keys and draw their uniforms and
permutations; the tests draw exactly those arrays with jax.random and feed
them to the port's core functions, so both sides see the same randomness.

Integer results (ranks, selections) must be equal. Float results use
rtol 1e-5: both sides compute in fp32, but XLA and PyTorch evaluate pow()
with different last-ulp rounding."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import torch

from clip_glass_tpu.evolve import crossover as jxo
from clip_glass_tpu.evolve import mutation as jmut
from clip_glass_tpu.evolve import sampling as jsmp
from clip_glass_tpu.evolve import selection as jsel
from clip_glass_tpu.evolve import decision as jdecision
from clip_glass_tpu.evolve.algorithm import extract_result as jextract
from clip_glass_tpu.evolve.algorithm import resample_duplicates as jresample
from clip_glass_tpu.evolve.nds import crowding_distance as jcrowd
from clip_glass_tpu.evolve.nds import non_dominated_rank as jrank
from clip_glass_tpu.evolve.survival import fitness_survival as jfitness_survival
from clip_glass_tpu.evolve.survival import nsga2_survival as jsurvival

from clip_glass_torch.config import get_config
from clip_glass_torch.evolve import crossover as txo
from clip_glass_torch.evolve import decision as tdecision
from clip_glass_torch.evolve import mutation as tmut
from clip_glass_torch.evolve import sampling as tsmp
from clip_glass_torch.evolve import selection as tsel
from clip_glass_torch.evolve.algorithm import (extract_result, minimize,
                                               resample_duplicates_core)
from clip_glass_torch.evolve.nds import crowding_distance as tcrowd
from clip_glass_torch.evolve.nds import domination_matrix
from clip_glass_torch.evolve.nds import non_dominated_rank as trank
from clip_glass_torch.evolve.survival import fitness_survival as tfitness_survival
from clip_glass_torch.evolve.survival import nsga2_survival as tsurvival
from clip_glass_torch.fitness.problem import GenerationProblem
from clip_glass_torch.models.clip import model as tclip
from clip_glass_torch.models.stylegan2 import model as tsg2

from torch_parity import N, T

FTOL = dict(rtol=1e-5, atol=1e-6)


def _u(key, shape):
    return T(jax.random.uniform(key, shape))


@pytest.mark.parametrize("prob", [1.0, 0.5, 0.0])
def test_sbx_matches_jax(rng, prob):
    m, n_var, xl, xu = 16, 32, -10.0, 10.0
    x1 = rng.uniform(xl, xu, size=(m, n_var)).astype(np.float32)
    x2 = rng.uniform(xl, xu, size=(m, n_var)).astype(np.float32)
    x2[0] = x1[0]  # equal parents stay unchanged
    key = jax.random.PRNGKey(4)
    want = jxo.sbx(key, jnp.asarray(x1), jnp.asarray(x2), xl, xu, eta=3.0,
                   prob=prob)
    k_mate, k_var, k_beta, k_swap = jax.random.split(key, 4)
    got = txo.sbx_core(T(x1), T(x2), xl, xu, _u(k_mate, (m, 1)),
                       _u(k_var, (m, n_var)), _u(k_beta, (m, n_var)),
                       _u(k_swap, (m, n_var)), eta=3.0, prob=prob)
    for g, w in zip(got, want):
        np.testing.assert_allclose(N(g), np.asarray(w), **FTOL)


@pytest.mark.parametrize("prob", [0.5, 1.0])
def test_polynomial_mutation_matches_jax(rng, prob):
    n, n_var, xl, xu = 16, 32, -10.0, 10.0
    x = rng.uniform(xl, xu, size=(n, n_var)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want = jmut.polynomial_mutation(key, jnp.asarray(x), xl, xu, eta=3.0, prob=prob)
    k_do, k_rand = jax.random.split(key)
    got = tmut.polynomial_mutation_core(T(x), xl, xu, _u(k_do, (n, n_var)),
                                        _u(k_rand, (n, n_var)), eta=3.0, prob=prob)
    np.testing.assert_allclose(N(got), np.asarray(want), **FTOL)


def _F(rng, n, n_obj, dup=False):
    F = rng.normal(size=(n, n_obj)).astype(np.float32)
    if dup:  # duplicate objective values and duplicate rows
        F = np.round(F, 1)
        F[1] = F[0]
        F[-1, 0] = F[-2, 0]
    return F


@pytest.mark.parametrize("n,n_obj,dup", [(2, 2, False), (5, 2, True),
                                         (32, 2, False), (32, 2, True),
                                         (24, 3, True)])
def test_non_dominated_rank_and_crowding_match_jax(rng, n, n_obj, dup):
    F = _F(rng, n, n_obj, dup)
    rank_j = np.asarray(jrank(jnp.asarray(F)))
    rank_t = trank(T(F))
    np.testing.assert_array_equal(N(rank_t).astype(np.int64), rank_j)
    want = np.asarray(jcrowd(jnp.asarray(F), jnp.asarray(rank_j)))
    got = N(tcrowd(T(F), rank_t))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], **FTOL)


def test_domination_matrix_simple():
    F = T([[0.0, 0.0], [1.0, 1.0], [0.0, 1.0], [1.0, 0.0], [0.0, 0.0]])
    D = domination_matrix(F)
    assert D[0, 1] and D[0, 2] and D[0, 3] and not D[0, 4] and not D[4, 0]
    assert D[2, 1] and not D[2, 3] and not D[1, 0]


@pytest.mark.parametrize("dup", [False, True])
def test_nsga2_survival_matches_jax(rng, dup):
    n, pop = 32, 16
    F = _F(rng, n, 2, dup)
    X = rng.normal(size=(n, 6)).astype(np.float32)
    want = jsurvival(jnp.asarray(X), jnp.asarray(F), pop)
    got = tsurvival(T(X), T(F), pop)
    np.testing.assert_array_equal(N(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(N(got[1]), np.asarray(want[1]))
    np.testing.assert_array_equal(N(got[2]).astype(np.int64), np.asarray(want[2]))


def test_permutation_pairs_match_jax():
    key = jax.random.PRNGKey(9)
    n_pop, n_pick = 16, 16
    want = np.asarray(jsel._permutation_pairs(key, n_pop, n_pick))
    n_perms = -(-(n_pick * 2) // n_pop)
    perms = jnp.concatenate([jax.random.permutation(k, n_pop)
                             for k in jax.random.split(key, n_perms)])
    got = tsel.pairs_from_perms(torch.as_tensor(np.array(perms)), n_pick)
    np.testing.assert_array_equal(got.numpy(), want)
    # the port's own draw: every index appears equally often
    pairs = tsel._permutation_pairs(torch.Generator().manual_seed(0), n_pop, n_pick)
    assert pairs.shape == (n_pick, 2)
    assert torch.bincount(pairs.flatten(), minlength=n_pop).tolist() == [2] * n_pop


@pytest.mark.parametrize("dup", [False, True])
def test_tournament_nsga2_matches_jax(rng, dup):
    n, n_select = 16, 8
    F = _F(rng, n, 2, dup)
    rank = jrank(jnp.asarray(F))
    crowd = jcrowd(jnp.asarray(F), rank)
    key = jax.random.PRNGKey(6)
    want = np.asarray(jsel.tournament_nsga2(key, jnp.asarray(F), crowd, n_select))
    k_pairs, k_tie = jax.random.split(key)
    cand = jsel._permutation_pairs(k_pairs, n, n_select * 2)
    tie = jax.random.bernoulli(k_tie, 0.5, (n_select * 2,))
    got = tsel.tournament_nsga2_core(T(F), T(crowd), torch.as_tensor(np.array(cand)),
                                     torch.as_tensor(np.array(tie)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dup", [False, True])
def test_tournament_ga_matches_jax(rng, dup):
    """Equal indices, with tied fitness values when dup (the coin decides)."""
    n, n_select = 16, 8
    F = _F(rng, n, 1, dup)
    if dup:
        F[:6] = F[0]
    key = jax.random.PRNGKey(10)
    want = np.asarray(jsel.tournament_ga(key, jnp.asarray(F), n_select))
    k_pairs, k_tie = jax.random.split(key)
    cand = jsel._permutation_pairs(k_pairs, n, n_select * 2)
    tie = jax.random.bernoulli(k_tie, 0.5, (n_select * 2,))
    got = tsel.tournament_ga_core(T(F), torch.as_tensor(np.array(cand)),
                                  torch.as_tensor(np.array(tie)))
    np.testing.assert_array_equal(got.numpy(), want)
    # the port's own draw: [n_select, 2] members of the population
    pairs = tsel.tournament_ga(torch.Generator().manual_seed(0), T(F), n_select)
    assert pairs.shape == (n_select, 2) and 0 <= pairs.min() and pairs.max() < n


@pytest.mark.parametrize("dup", [False, True])
def test_fitness_survival_matches_jax(rng, dup):
    """Stable sort: tied fitness keeps the JAX order; X and F equal."""
    n, pop = 32, 16
    F = _F(rng, n, 1, dup)
    if dup:
        F[::3] = F[0]
    X = rng.normal(size=(n, 6)).astype(np.float32)
    want = jfitness_survival(jnp.asarray(X), jnp.asarray(F), pop)
    got = tfitness_survival(T(X), T(F), pop)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(N(g), np.asarray(w))


@pytest.mark.parametrize("algorithm", ["ga", "nsga2"])
def test_extract_result_matches_jax(rng, algorithm):
    """The GA's single best row (the first of tied minima) and NSGA-II's
    rank-0 front; G and CV zeros of the same shapes: equal."""
    n_obj = 1 if algorithm == "ga" else 2
    F = _F(rng, 16, n_obj, dup=True)
    F[5, 0] = F[11, 0] = F[:, 0].min() - 1.0
    X = rng.normal(size=(16, 6)).astype(np.float32)
    want = jextract(X, F, algorithm, None)
    got = extract_result(T(X), T(F), algorithm, None)
    for name in ("X", "F", "G", "CV", "pop_X", "pop_F"):
        w, g = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w)
    if algorithm == "ga":
        np.testing.assert_array_equal(got.X.numpy(), X[5])


@pytest.mark.parametrize("case", ["front0", "front1", "front2", "degenerate", "single"])
def test_decision_pick_matches_jax(rng, case):
    """Same index: pseudo-weights on random Pareto fronts, the ASF
    fallback on a front whose first objective has no range, and one row."""
    if case == "degenerate":
        F = np.array([[0.3, 1.0], [0.3, 0.2], [0.3, 0.5]], np.float32)
    elif case == "single":
        F = np.array([[0.1, 0.4]], np.float32)
    else:
        u = np.random.default_rng(int(case[-1])).normal(size=(9, 2))
        F = np.stack([np.sort(u[:, 0]), np.sort(u[:, 1])[::-1]], 1).astype(np.float32)
    assert tdecision.pick(F, (0, 1)) == jdecision.pick(F, (0, 1))
    if case == "degenerate":
        with pytest.raises(ValueError):
            tdecision.pseudo_weights(F, (0, 1))
        assert tdecision.pick(F, (0, 1)) == tdecision.asf(F, (0, 1)) == 1


def test_resample_duplicates_matches_jax(rng):
    n, n_var = 8, 5
    pop_X = rng.normal(size=(n, n_var)).astype(np.float32)
    off = rng.normal(size=(n, n_var)).astype(np.float32)
    off[2] = pop_X[4]   # duplicate of a member
    off[6] = off[1]     # duplicate of an earlier sibling
    key = jax.random.PRNGKey(8)

    def sample(k, m):
        return jsmp.normal_sampling(k, m, n_var)

    want = np.asarray(jresample(key, jnp.asarray(off), jnp.asarray(pop_X), sample))
    fresh = T(sample(key, n))
    got = N(resample_duplicates_core(T(off), T(pop_X), fresh))
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got[2], pop_X[4]) and np.array_equal(got[1], off[1])


def test_normal_sampling_shape_and_moments():
    X = tsmp.normal_sampling(torch.Generator().manual_seed(0), 256, 64)
    assert X.shape == (256, 64) and X.dtype == torch.float32
    assert abs(X.mean().item()) < 0.02 and abs(X.std().item() - 1.0) < 0.02


def _tiny_search(seed):
    cfg = get_config("StyleGAN2_ffhq_d").replace(
        pop_size=8, dim_z=32, n_var=32, weights="random:0",
        target="a red flower", compute_dtype="float32")
    problem = GenerationProblem(cfg, device="cpu", clip_cfg=tclip.TINY,
                                model_cfg=tsg2.TINY)
    seen = []
    res = minimize(problem.make_algorithm(), 3, seed,
                   callback=lambda s: seen.append(s.gen), save_each=1)
    return res, seen, cfg


def test_tiny_search_is_deterministic_and_valid():
    a, seen, cfg = _tiny_search(0)
    b, _, _ = _tiny_search(0)
    torch.testing.assert_close(a.pop_X, b.pop_X, rtol=0, atol=0)
    torch.testing.assert_close(a.pop_F, b.pop_F, rtol=0, atol=0)
    assert seen == [1, 2, 3] and a.state.gen == 3
    assert a.pop_X.shape == (8, 32) and a.pop_F.shape == (8, 2)
    assert torch.isfinite(a.pop_F).all() and (a.pop_F[:, 1] >= 0).all()
    assert (a.pop_X >= cfg.xl).all() and (a.pop_X <= cfg.xu).all()
    # the optimum is the rank-0 front of the final population
    assert (trank(a.pop_F) == 0).sum() == a.F.shape[0] == a.X.shape[0]
    c, _, _ = _tiny_search(1)
    assert not torch.equal(a.pop_X, c.pop_X)


@pytest.mark.parametrize("name,item", [("DeepMindBigGAN256", "item 9"),
                                       ("GPT2", "item 10")])
def test_operators_refuse_unported_families(name, item):
    """Both families are ported (items 9 and 10) and get their operators:
    BigGAN's mixed genome (truncnorm z in (-2, 2), 0/1 class bits), GPT-2's
    integer token ids in [0, 50256] that crossover and mutation keep
    integral."""
    from clip_glass_torch.evolve.algorithm import operators_for_config

    config = get_config(name)
    ops = operators_for_config(config)
    gen = torch.Generator().manual_seed(0)
    X = ops.sample(gen, 8)
    o1, o2 = ops.cross(gen, X[:4], X[4:])
    M = ops.mutate(gen, torch.cat([o1, o2]))
    if item == "item 10":
        assert X.shape == (8, config.n_var) == (8, 20)
        for Y in (X, o1, o2, M):
            assert torch.equal(Y, Y.round()) and 0 <= Y.min() and Y.max() <= 50256
        return
    assert X.shape == (8, config.n_var) == (8, 1128)
    z, bits = X[:, :128], X[:, 128:]
    assert z.abs().max() < 2 and set(bits.unique().tolist()) <= {0.0, 1.0}
    assert set(M[:, 128:].unique().tolist()) <= {0.0, 1.0}
    assert (M[:, :128].abs() <= 2).all()


# ------------------------------------------------------------ BigGAN operators


def _bits(rng, m, n_var, p):
    return (rng.uniform(size=(m, n_var)) < p).astype(np.float32)


@pytest.mark.parametrize("prob", [0.2, 1.0])
def test_hux_matches_jax(rng, prob):
    """Equal children: the swapped positions are the same bits."""
    m, n_var = 16, 40
    x1, x2 = _bits(rng, m, n_var, 0.3), _bits(rng, m, n_var, 0.3)
    x2[0] = x1[0]            # no differing bit
    x2[1] = x1[1]
    x2[1, 5] = 1 - x1[1, 5]  # one differing bit: ceil(1/2) = 1 swap
    key = jax.random.PRNGKey(11)
    want = jxo.hux(key, jnp.asarray(x1), jnp.asarray(x2), prob=prob)
    k_mate, k_score = jax.random.split(key)
    got = txo.hux_core(T(x1), T(x2), _u(k_mate, (m, 1)), _u(k_score, (m, n_var)),
                       prob=prob)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(N(g), np.asarray(w))
    if prob == 1.0:  # every mating swaps exactly ceil(n_diff / 2) bits
        n_diff = (x1 != x2).sum(1)
        np.testing.assert_array_equal((N(got[0]) != x1).sum(1), np.ceil(n_diff / 2))


@pytest.mark.parametrize("prob", [0.01, 0.5])
def test_bitflip_matches_jax(rng, prob):
    x = _bits(rng, 16, 40, 0.5)
    key = jax.random.PRNGKey(12)
    want = jmut.bitflip_mutation(key, jnp.asarray(x), prob)
    got = tmut.bitflip_core(T(x), _u(key, x.shape), prob)
    np.testing.assert_array_equal(N(got), np.asarray(want))


def _mixed(rng, m, dim_z=8, n_cls=12):
    z = rng.uniform(-2, 2, size=(m, dim_z)).astype(np.float32)
    x = np.concatenate([z, _bits(rng, m, n_cls, 0.3)], axis=1)
    mask = np.arange(dim_z + n_cls) < dim_z
    return x, mask


def test_mixed_crossover_matches_jax(rng):
    """SBX on the real genes (rtol 1e-5), HUX on the bits (equal)."""
    m = 16
    x1, mask = _mixed(rng, m)
    x2, _ = _mixed(rng, m)
    n_var = x1.shape[1]
    key = jax.random.PRNGKey(13)
    want = jxo.mixed_crossover(key, jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(mask),
                               -2.0, 2.0, eta=3.0, real_prob=1.0, bool_prob=0.2)
    k1, k2 = jax.random.split(key)
    u_sbx = [_u(k, s) for k, s in zip(jax.random.split(k1, 4),
                                      [(m, 1), (m, n_var), (m, n_var), (m, n_var)])]
    ks = jax.random.split(k2)
    u_hux = (_u(ks[0], (m, 1)), _u(ks[1], (m, n_var)))
    got = txo.mixed_crossover_core(T(x1), T(x2), torch.as_tensor(mask), -2.0, 2.0,
                                   u_sbx, u_hux, eta=3.0, real_prob=1.0, bool_prob=0.2)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(N(g)[:, mask], w[:, mask], **FTOL)
        np.testing.assert_array_equal(N(g)[:, ~mask], w[:, ~mask])


def test_mixed_mutation_matches_jax(rng):
    x, mask = _mixed(rng, 16)
    key = jax.random.PRNGKey(14)
    want = np.asarray(jmut.mixed_mutation(key, jnp.asarray(x), jnp.asarray(mask), -2.0,
                                          2.0, eta=3.0, real_prob=0.5, bool_prob=0.1))
    k1, k2 = jax.random.split(key)
    u_pm = [_u(k, x.shape) for k in jax.random.split(k1)]
    got = N(tmut.mixed_mutation_core(T(x), torch.as_tensor(mask), -2.0, 2.0, u_pm,
                                     _u(k2, x.shape), eta=3.0, real_prob=0.5,
                                     bool_prob=0.1))
    np.testing.assert_allclose(got[:, mask], want[:, mask], **FTOL)
    np.testing.assert_array_equal(got[:, ~mask], want[:, ~mask])


def test_truncnorm_core_matches_jax():
    key = jax.random.PRNGKey(15)
    want = np.asarray(jsmp.truncnorm_sampling(key, 64, 128))
    got = N(tsmp.truncnorm_core(_u(key, (64, 128))))
    np.testing.assert_allclose(got, want, **FTOL)
    assert np.abs(got).max() < 2.0


def test_binary_and_mixed_sampling_match_jax():
    """The JAX package's Bernoulli is a uniform below p: equal bits; the
    mixed genome is its truncnorm z ++ the class bits."""
    key = jax.random.PRNGKey(16)
    want = np.asarray(jsmp.binary_sampling(key, 32, 100, 0.05))
    got = (_u(key, (32, 100)) < 0.05).float()
    np.testing.assert_array_equal(N(got), want)
    X = tsmp.mixed_biggan_sampling(torch.Generator().manual_seed(0), 256, 16, 1000)
    assert X.shape == (256, 1016) and X.dtype == torch.float32
    assert set(X[:, 16:].unique().tolist()) == {0.0, 1.0}
    assert abs(X[:, 16:].mean().item() - 0.005) < 0.001   # bool_prob 5/1000
    assert X[:, :16].abs().max() < 2


def test_tiny_biggan_ga_search_is_deterministic_and_valid():
    """The DeepMindBigGAN GA on the TINY model (CPU): seeded, elitist, the
    class genes stay 0/1 and z within [xl, xu]."""
    from clip_glass_torch.models.biggan import model as tbg

    cfg = get_config("DeepMindBigGAN512").replace(
        pop_size=8, dim_z=16, num_classes=10, n_var=26, resolution=8,
        weights="random:0", target="a red flower", compute_dtype="float32")

    def run(seed):
        problem = GenerationProblem(cfg, device="cpu", clip_cfg=tclip.TINY,
                                    model_cfg=tbg.TINY)
        best = []
        res = minimize(problem.make_algorithm(), 3, seed, save_each=1,
                       callback=lambda s: best.append(s.F[:, 0].min().item()))
        return res, best

    a, best = run(0)
    b, _ = run(0)
    assert torch.equal(a.pop_X, b.pop_X) and torch.equal(a.pop_F, b.pop_F)
    assert best == sorted(best, reverse=True) and a.state.gen == 3
    assert a.pop_X.shape == (8, 26) and a.pop_F.shape == (8, 1)
    assert set(a.pop_X[:, 16:].unique().tolist()) <= {0.0, 1.0}
    assert (a.pop_X[:, :16].abs() <= 2).all() and torch.isfinite(a.pop_F).all()


def test_tiny_ga_search_is_elitist_and_valid():
    """The GA branch (the _nod configs): best fitness never rises, the
    result is the population's first best row."""
    cfg = get_config("StyleGAN2_ffhq_nod").replace(
        pop_size=8, dim_z=32, n_var=32, weights="random:0",
        target="a red flower", compute_dtype="float32")
    problem = GenerationProblem(cfg, device="cpu", clip_cfg=tclip.TINY,
                                model_cfg=tsg2.TINY)
    algorithm = problem.make_algorithm()
    assert algorithm.algorithm == "ga"
    best = []
    res = minimize(algorithm, 3, 0, save_each=1,
                   callback=lambda s: best.append(s.F[:, 0].min().item()))
    assert best == sorted(best, reverse=True) and res.state.gen == 3
    assert res.pop_F.shape == (8, 1) and torch.isfinite(res.pop_F).all()
    i = int(res.pop_F[:, 0].argmin())
    assert torch.equal(res.X, res.pop_X[i]) and torch.equal(res.F, res.pop_F[i])
    assert res.G.shape == (1,) and res.CV.shape == (1, 1)


# ------------------------------------------------------------ GPT-2: integer genes

XL, XU = 0, 50256


def _ints(rng, m, n_var):
    return rng.integers(XL, XU + 1, (m, n_var)).astype(np.float32)


def test_int_random_core_and_sampling():
    """Uniforms -> integers on [xl, xu]: u = 0 gives xl, the largest fp32
    uniform below 1 gives xu; the sampler's draws are integral, in range and
    spread over the whole range."""
    u = torch.tensor([[0.0, 0.5, 1.0 - 2.0 ** -24, 1e-6]])
    assert tsmp.int_random_core(u, XL, XU).tolist() == [[0.0, 25128.0, 50256.0, 0.0]]
    X = tsmp.int_random_sampling(torch.Generator().manual_seed(0), 500, 20, XL, XU)
    assert X.dtype == torch.float32 and X.shape == (500, 20)
    assert torch.equal(X, X.round()) and X.min() >= XL and X.max() <= XU
    hist = torch.histc(X, bins=10, min=XL, max=XU + 1)
    assert hist.min() > 0.8 * X.numel() / 10
    # the JAX sampler's law: the same range, integral floats
    J = np.asarray(jsmp.int_random_sampling(jax.random.PRNGKey(0), 500, 20, XL, XU))
    assert J.min() >= XL and J.max() <= XU and np.array_equal(J, np.round(J))


@pytest.mark.parametrize("prob", [1.0, 0.5])
def test_sbx_round_int_matches_jax(rng, prob):
    """GPT-2's SBX on integer parents near both bounds: identical integers
    on the same uniforms (the rounding is half to even on both sides)."""
    m, n_var = 50, 20
    x1, x2 = _ints(rng, m, n_var), _ints(rng, m, n_var)
    x1[:5], x2[5:10] = XU - rng.integers(0, 3, (5, n_var)), rng.integers(0, 3, (5, n_var))
    x2[10] = x1[10]
    key = jax.random.PRNGKey(11)
    want = jxo.sbx(key, jnp.asarray(x1), jnp.asarray(x2), XL, XU, eta=3.0, prob=prob,
                   round_int=True)
    k_mate, k_var, k_beta, k_swap = jax.random.split(key, 4)
    got = txo.sbx_core(T(x1), T(x2), XL, XU, _u(k_mate, (m, 1)), _u(k_var, (m, n_var)),
                       _u(k_beta, (m, n_var)), _u(k_swap, (m, n_var)), eta=3.0, prob=prob,
                       round_int=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(N(g), np.asarray(w))
        assert np.array_equal(N(g), np.round(N(g)))


@pytest.mark.parametrize("prob", [0.5, 1.0])
def test_polynomial_mutation_round_int_matches_jax(rng, prob):
    n, n_var = 100, 20
    x = _ints(rng, n, n_var)
    x[:3], x[3:6] = XU, XL
    key = jax.random.PRNGKey(12)
    want = jmut.polynomial_mutation(key, jnp.asarray(x), XL, XU, eta=3.0, prob=prob,
                                    round_int=True)
    k_do, k_rand = jax.random.split(key)
    got = tmut.polynomial_mutation_core(T(x), XL, XU, _u(k_do, (n, n_var)),
                                        _u(k_rand, (n, n_var)), eta=3.0, prob=prob,
                                        round_int=True)
    np.testing.assert_array_equal(N(got), np.asarray(want))


@pytest.mark.parametrize("tied", ["all", "some"])
def test_ga_step_on_tied_fitness_matches_jax(rng, tied):
    """One GPT-2 GA generation at pop 100 on tied fitness (an overflowed
    batch zeroes every row): the JAX package's step against the port's
    cores in the port's step order (tournament with its tie coin, SBX and
    PM with rounding, duplicate resampling with the int sampler, fitness
    survival) on the same draws; the offspring and the survivors equal."""
    from clip_glass_tpu.config import get_config as jget_config
    from clip_glass_tpu.evolve import algorithm as jalg

    pop, n_var = 100, 20
    jcfg = jget_config("GPT2")
    X = _ints(rng, pop, n_var)
    X[7] = X[3]                                   # a member the offspring may copy
    F = np.zeros((pop, 1), np.float32)
    if tied == "some":
        F[::7] = -0.25

    def F_off(off):  # ties between offspring and with the parents
        return np.where(np.asarray(off)[:, :1] % 3 == 0, -0.25, 0.0).astype(np.float32)

    state = jalg.GAState(jnp.asarray(X), jnp.asarray(F), jax.random.PRNGKey(13), jnp.int32(0))
    vary, survive = jalg.make_step_halves(jalg.operators_for_config(jcfg), pop, "ga")
    off_j, _, key = vary(state)
    want = survive(state, off_j, jnp.asarray(F_off(off_j)), key)

    _, k_sel, k_x, k_m, k_d, _ = jax.random.split(state.key, 6)
    k_pairs, k_tie = jax.random.split(k_sel)
    cand = jsel._permutation_pairs(k_pairs, pop, pop)
    tie = jax.random.bernoulli(k_tie, 0.5, (pop,))
    pairs = tsel.tournament_ga_core(T(F), torch.as_tensor(np.array(cand)),
                                    torch.as_tensor(np.array(tie)))
    x1, x2 = T(X)[pairs[:, 0]], T(X)[pairs[:, 1]]
    m = pop // 2
    k_mate, k_var, k_beta, k_swap = jax.random.split(k_x, 4)
    o1, o2 = txo.sbx_core(x1, x2, XL, XU, _u(k_mate, (m, 1)), _u(k_var, (m, n_var)),
                          _u(k_beta, (m, n_var)), _u(k_swap, (m, n_var)), eta=3.0,
                          prob=1.0, round_int=True)
    k_do, k_rand = jax.random.split(k_m)
    off = tmut.polynomial_mutation_core(torch.cat([o1, o2]), XL, XU, _u(k_do, (pop, n_var)),
                                        _u(k_rand, (pop, n_var)), eta=3.0, prob=0.5,
                                        round_int=True)
    fresh = T(jsmp.int_random_sampling(k_d, pop, n_var, XL, XU))
    off = resample_duplicates_core(off, T(X), fresh)
    np.testing.assert_array_equal(N(off), np.asarray(off_j))
    X_new, F_new = tfitness_survival(torch.cat([T(X), off]),
                                     torch.cat([T(F), torch.from_numpy(F_off(off))]), pop)
    np.testing.assert_array_equal(N(X_new), np.asarray(want.X))
    np.testing.assert_array_equal(N(F_new), np.asarray(want.F))


def test_tiny_gpt2_ga_search_is_deterministic_and_valid():
    """The GPT2 GA on the TINY models (CPU): seeded, elitist, the genes stay
    integral token ids."""
    from clip_glass_torch.models.gpt2 import model as tg2

    dog = "examples/gpt2_images/dog.jpeg"
    cfg = get_config("GPT2").replace(pop_size=8, dim_z=6, n_var=6, max_tokens_len=5,
                                     weights="random:0", target=dog, compute_dtype="float32")

    def run():
        problem = GenerationProblem(cfg, device="cpu", clip_cfg=tclip.TINY, model_cfg=tg2.TINY)
        best = []
        res = minimize(problem.make_algorithm(), 3, 0, save_each=1,
                       callback=lambda s: best.append(s.F[:, 0].min().item()))
        return res, best

    a, best = run()
    b, _ = run()
    assert torch.equal(a.pop_X, b.pop_X) and torch.equal(a.pop_F, b.pop_F)
    assert best == sorted(best, reverse=True) and a.state.gen == 3
    assert a.pop_X.shape == (8, 6) and torch.equal(a.pop_X, a.pop_X.round())
    assert a.pop_X.min() >= XL and a.pop_X.max() <= XU and torch.isfinite(a.pop_F).all()
