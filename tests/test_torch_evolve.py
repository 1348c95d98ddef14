"""clip_glass_torch's NSGA-II operators, sort and survival against the JAX
package's. The JAX operators split their keys and draw their uniforms and
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
from clip_glass_tpu.evolve.algorithm import resample_duplicates as jresample
from clip_glass_tpu.evolve.nds import crowding_distance as jcrowd
from clip_glass_tpu.evolve.nds import non_dominated_rank as jrank
from clip_glass_tpu.evolve.survival import nsga2_survival as jsurvival

from clip_glass_torch.config import get_config
from clip_glass_torch.evolve import crossover as txo
from clip_glass_torch.evolve import mutation as tmut
from clip_glass_torch.evolve import sampling as tsmp
from clip_glass_torch.evolve import selection as tsel
from clip_glass_torch.evolve.algorithm import minimize, resample_duplicates_core
from clip_glass_torch.evolve.nds import crowding_distance as tcrowd
from clip_glass_torch.evolve.nds import domination_matrix
from clip_glass_torch.evolve.nds import non_dominated_rank as trank
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
