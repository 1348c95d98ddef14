"""The port's StyleGAN2 trainer (clip_glass_torch.training) against the JAX
package's on the CPU, fp32, TINY models: the same numpy weights (through
`weights.from_jax`) and the JAX package's own draws, rebuilt from its key
along its split tree (`jax_draws`) and fed to the port's step.

The weights are the JAX init with its dense-layer fault repaired in the
numpy tree (every dense weight divided by sqrt(fan_in), the scale of a
checkpoint; `test_dense_init_has_unit_std_in_both_packages` pins the
fault) and random biases and noise strengths, so no loss saturates.

Tolerances:
- losses and penalties: 1e-6 relative;
- each phase's value 1e-5 relative and its gradients leaf by leaf within a
  relative L2 of 1e-4 (G's gradients are sums with cancellation; the JAX
  package's own jitted and eager gradients differ by 1.4e-4 of their scale,
  tests/test_torch_projector.py). A leaf whose gradient's norm is below 1e-3
  of the phase's largest is held to 1e-4 of that thousandth: R1's bias
  gradients are 1e-12 to 1e-7 of its weights', at the double backward's
  rounding floor, where the JAX package's own jitted and eager gradients
  differ at the first digit (and the port's by as much);
- a whole step: the five logs within 1e-4 relative, Adam's moments as the
  gradients (the second at 2e-4); after a first step every updated
  parameter within 1e-6 of the learning rate of JAX's (plus one fp32
  spacing of the parameter, the rounding of its add), except elements whose
  JAX gradient is below 1e-6 of its leaf's scale: with beta1 = 0 Adam moves
  a weight by lr * g / (|g| + eps), whose sign follows g's rounding there.
  Those elements are counted, printed and must be under 1e-3 of all. After
  a later step Adam divides by its history's second moment, which magnifies
  the gradient's own difference: `_assert_params_moved_as_jax` states the
  bound.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import torch

from clip_glass_tpu.models.stylegan2 import model as jsg2
from clip_glass_tpu.training import losses as jlosses
from clip_glass_tpu.training.trainer import Trainer as JTrainer
from clip_glass_tpu.training.trainer import TrainerConfig as JConfig

from clip_glass_torch.core.dtypes import map_tree, tree_leaves
from clip_glass_torch.core.optim import adam_init, adam_update
from clip_glass_torch.models.stylegan2 import model as tsg2
from clip_glass_torch.training import losses as tlosses
from clip_glass_torch.training import trainer as ttr
from clip_glass_torch.training.logging import TensorboardSink, TrainLogger
from clip_glass_torch.weights import from_jax

from test_torch_autograd import card_branch  # noqa: F401 (a fixture)
from torch_parity import N, T, assert_close_scaled

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MC = jsg2.TINY
# both regularizers at steps 0 and 2, two subdivisions (pl_avg carried
# through them in turn, minibatch-std groups of 2 inside each chunk)
CFG = dict(batch_size=4, subdivisions=2, d_reg_interval=2, g_reg_interval=2,
           checkpoint_every=0)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread a test: the lane runs six test processes on the
    machine's cores, and these TINY computations gain nothing from more
    threads but lose much to their contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _repair_dense(tree):
    """Divide every dense weight ([in, out], 2-D) by sqrt(in): the scale the
    JAX init means to give them."""
    def fix(path, leaf):
        leaf = np.asarray(leaf)
        if getattr(path[-1], "key", None) == "w" and leaf.ndim == 2:
            return leaf / np.sqrt(leaf.shape[0])
        return leaf
    return jax.tree_util.tree_map_with_path(fix, tree)


@pytest.fixture(scope="module")
def weights():
    """(G, D) as numpy JAX-layout trees: the repaired init, biases and noise
    strengths drawn."""
    rng = np.random.default_rng(11)
    g = _repair_dense(jsg2.generator_init(jax.random.PRNGKey(3), MC))
    d = _repair_dense(jsg2.discriminator_init(jax.random.PRNGKey(4), MC))

    def perturb(path, leaf):
        key = getattr(path[-1], "key", None)
        if key == "noise_scale":
            return rng.uniform(0.2, 0.5, np.shape(leaf)).astype(np.float32)
        if key == "b" and "style" not in str(path):
            return (0.1 * rng.normal(size=np.shape(leaf))).astype(np.float32)
        return leaf
    return (jax.tree_util.tree_map_with_path(perturb, g),
            jax.tree_util.tree_map_with_path(perturb, d))


@pytest.fixture(scope="module")
def reals():
    return np.random.default_rng(12).uniform(-1, 1, (4, 3, 16, 16)).astype(np.float32)


@pytest.fixture(scope="module")
def jtrainer(weights):
    """The JAX trainer, built (and its step compiled) once per module."""
    g, d = weights
    return JTrainer(model_cfg=MC, cfg=JConfig(**CFG), g_params=jax.tree.map(jnp.asarray, g),
                    d_params=jax.tree.map(jnp.asarray, d))


def _trainer(weights, **cfg):
    g, d = weights
    return ttr.Trainer(tsg2.TINY, ttr.TrainerConfig(**{**CFG, **cfg}),
                       from_jax.convert_generator(g), from_jax.convert_discriminator(d),
                       device="cpu")


# ------------------------------------------------------------ the JAX draws

def _latents(k_lat, batch):
    k1, k2, k_mix, k_cut = jax.random.split(k_lat, 4)
    return ttr.Latents(T(jax.random.normal(k1, (batch, MC.latent_size))),
                       T(jax.random.normal(k2, (batch, MC.latent_size))),
                       T(jax.random.uniform(k_mix, (batch, 1))),
                       torch.from_numpy(np.asarray(jax.random.randint(
                           k_cut, (batch, 1), 1, MC.num_latents))).long())


def _noise_chunk(key, batch):
    """A D or G chunk's draws: (k_lat, k_noise) = split(key), the noise planes
    from split(k_noise, layers) (the JAX `_noise_list`)."""
    k_lat, k_noise = jax.random.split(key)
    shapes = MC.noise_shapes()
    return ttr.ChunkDraws(_latents(k_lat, batch), [
        T(jax.random.normal(k, s)) for k, s in zip(jax.random.split(k_noise, len(shapes)),
                                                   shapes)])


def _pl_chunk(key, batch):
    k_lat, k_y = jax.random.split(key)
    shape = (batch, MC.data_channels, MC.resolution, MC.resolution)
    return ttr.ChunkDraws(_latents(k_lat, batch), y=T(jax.random.normal(k_y, shape)))


def jax_draws(key, batch: int, S: int, path_length: bool) -> ttr.StepDraws:
    """The draws of the JAX step from its state's key: split(key, 5) into
    (new key, kd, kg, k_avg, kgr), each phase's key split S ways."""
    _, kd, kg, k_avg, kgr = jax.random.split(key, 5)
    sub = batch // S
    return ttr.StepDraws(
        [_noise_chunk(k, sub) for k in jax.random.split(kd, S)],
        [_noise_chunk(k, sub) for k in jax.random.split(kg, S)],
        [_pl_chunk(k, sub) for k in jax.random.split(kgr, S)] if path_length else None,
        T(jax.random.normal(k_avg, (sub, MC.latent_size))))


# ------------------------------------------------------------ comparisons

def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _leaves_of(jtree, convert):
    return [N(t) for t in tree_leaves(convert(_np(jtree)))]


def _assert_grads(got, jgrads, convert, tol=1e-4):
    """Leaf by leaf, the relative L2 error within `tol`; a leaf whose norm is
    below 1e-3 of the largest leaf's is held to `tol` of that thousandth."""
    want = _leaves_of(jgrads, convert)
    assert len(got) == len(want)
    big = max(np.linalg.norm(w) for w in want)
    assert big > 0
    errs = [np.linalg.norm(N(g) - w) / max(np.linalg.norm(w), 1e-3 * big)
            for g, w in zip(got, want)]
    assert max(errs) <= tol, (max(errs), int(np.argmax(errs)))


def _assert_params_moved_as_jax(got_tree, want_jtree, jopt, port_mu, convert, lr, b2,
                                carried=False):
    """Each updated element against JAX's, beside the one rounding of the
    parameter's add (its fp32 spacing), `dlatent_avg` aside (an EMA of the
    mapping, `_check_state`). With beta1 = 0 Adam's first moment is the
    step's gradient g, so JAX's `mu` and the port's give it.

    A first step (carried=False): within 1e-6 * lr, except elements whose
    JAX gradient is below 1e-6 of its leaf's scale (Adam moves them by lr *
    g / (|g| + eps), whose sign follows g's rounding); those that moved apart
    are counted and must be under 1e-3 of all.

    A later step (carried=True): Adam divides g by the root of its second
    moment's history, v_hat, so an element moves by its gradient's own
    difference dg over that root: within 1e-6 * lr + 2 * lr * |dg| /
    (sqrt(v_hat) + eps) everywhere (a moment carried across in the wrong
    layout moves it by O(lr) with a small dg); the elements that needed the
    second term are counted.

    Returns (counted, total)."""
    got = [N(t) for t in tree_leaves(got_tree)]
    want = _leaves_of(want_jtree, convert)
    grads = _leaves_of(jopt.mu, convert)
    nu_hat = [v / (1.0 - np.float32(b2) ** int(jopt.count)) for v in _leaves_of(jopt.nu, convert)]
    names = []
    map_tree(lambda path, _: names.append(path), convert(_np(jopt.mu)))
    counted = total = 0
    for name, g, w, jg, mu, vh in zip(names, got, want, grads, port_mu, nu_hat):
        if name == ("dlatent_avg",):
            continue
        bound = 1e-6 * lr + np.spacing(np.abs(w))
        apart = np.abs(g - w) > bound
        if carried:
            amplified = 2 * lr * np.abs(N(mu) - jg) / (np.sqrt(vh) + 1e-8)
            bad = np.abs(g - w) > bound + amplified
            counted += int(apart.sum())
        else:
            small = np.abs(jg) < 1e-6 * np.abs(jg).max()
            bad = apart & ~small
            counted += int((apart & small).sum())
        assert not bad.any(), (name, np.abs(g - w)[bad].max(), lr)
        total += g.size
    if not carried:
        assert counted <= 1e-3 * total, (counted, total)
    return counted, total


def _assert_logs(got, want, tol=1e-4):
    assert set(got) == set(want)
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=tol), k


# ------------------------------------------------------------ losses

@pytest.mark.parametrize("name", ["g_logistic_ns", "g_logistic", "g_wgan"])
def test_g_losses_match_jax(name):
    s = np.random.default_rng(1).normal(size=(6, 1)).astype(np.float32) * 3
    assert float(getattr(tlosses, name)(T(s))) == pytest.approx(
        float(getattr(jlosses, name)(jnp.asarray(s))), rel=1e-6)


@pytest.mark.parametrize("name", ["d_logistic", "d_wgan"])
def test_d_losses_match_jax(name):
    rng = np.random.default_rng(2)
    a, b = (rng.normal(size=(6, 1)).astype(np.float32) * 3 for _ in range(2))
    assert float(getattr(tlosses, name)(T(a), T(b))) == pytest.approx(
        float(getattr(jlosses, name)(jnp.asarray(a), jnp.asarray(b))), rel=1e-6)


def test_logistic_losses_values():
    zeros = torch.zeros((4, 1))
    assert float(tlosses.g_logistic_ns(zeros)) == pytest.approx(np.log(2), rel=1e-6)
    assert float(tlosses.d_logistic(zeros, zeros)) == pytest.approx(2 * np.log(2), rel=1e-6)
    assert float(tlosses.g_wgan(torch.ones((4, 1)))) == -1.0
    assert float(tlosses.d_wgan(torch.ones((4, 1)), zeros)) == -1.0


def test_r1_penalty_on_quadratic():
    # D(x) = sum(x^2): grad = 2x, ||grad||^2 = 4 sum(x^2)
    pen = tlosses.r1_penalty(lambda p, x: x.square().sum(dim=(1, 2, 3))[:, None], {},
                             torch.ones((2, 1, 2, 2)), gamma=10.0)
    assert float(pen) == pytest.approx(10.0 * 0.5 * 4 * 4, rel=1e-5)


def test_wgan_gp_unit_gradient_is_zero_penalty():
    def d_apply(p, x):   # ||grad|| = 1 everywhere
        return x.sum(dim=(1, 2, 3))[:, None] / np.sqrt(x[0].numel())

    x = torch.ones((4, 1, 2, 2))
    pen = tlosses.d_wgan_gp(d_apply, {}, x, x * 0.5, torch.Generator().manual_seed(0))
    assert float(pen) < 1e-6


@pytest.mark.parametrize("name", ["r1", "r2", "wgan_gp"])
def test_gradient_penalties_match_jax(weights, reals, name):
    jd = jax.tree.map(jnp.asarray, weights[1])
    td = from_jax.convert_discriminator(weights[1])
    x = reals if name != "r2" else reals[::-1].copy()
    if name == "wgan_gp":
        key = jax.random.PRNGKey(5)
        eps = T(jax.random.uniform(key, (4, 1, 1, 1)))
        fakes = np.random.default_rng(3).uniform(-1, 1, x.shape).astype(np.float32)
        want = jlosses.d_wgan_gp(lambda p, v: jsg2.discriminator_apply(p, v, MC), jd,
                                 jnp.asarray(x), jnp.asarray(fakes), key)
        got = tlosses.d_wgan_gp(lambda p, v: tsg2.discriminator_apply(p, v, tsg2.TINY), td,
                                T(x), T(fakes), eps=eps)
    else:
        fn = {"r1": "r1_penalty", "r2": "r2_penalty"}[name]
        want = getattr(jlosses, fn)(lambda p, v: jsg2.discriminator_apply(p, v, MC), jd,
                                    jnp.asarray(x))
        got = getattr(tlosses, fn)(lambda p, v: tsg2.discriminator_apply(p, v, tsg2.TINY),
                                   td, T(x))
    assert float(want) > 0
    assert float(got) == pytest.approx(float(want), rel=1e-6)


def test_path_length_reg_matches_jax(weights):
    jg = jax.tree.map(jnp.asarray, weights[0])
    tg = from_jax.convert_generator(weights[0])
    dl = np.random.default_rng(4).normal(size=(3, MC.num_latents, MC.latent_size))
    dl = dl.astype(np.float32) * 0.5
    key = jax.random.PRNGKey(6)
    pl_avg = np.float32(0.3)
    want, want_avg = jlosses.path_length_reg(
        lambda p, d: jsg2.synthesis_apply(p["synthesis"], d, MC, noise="none", s2d=False),
        jg, jnp.asarray(dl), key, jnp.asarray(pl_avg))
    y = T(jax.random.normal(key, (3, 3, 16, 16)))
    got, got_avg = tlosses.path_length_reg(
        lambda p, d: tsg2.synthesis_apply(p["synthesis"], d, tsg2.TINY, noise=None), tg,
        T(dl), torch.tensor(pl_avg), y=y)
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    assert float(got_avg) == pytest.approx(float(want_avg), rel=1e-6)
    assert float(got_avg) > float(pl_avg)


def test_lazy_lr_scaling():
    lr, b1, b2 = ttr._lazy_lr(2e-3, 0.0, 0.99, 16)
    c = 16 / 17
    np.testing.assert_allclose(lr, 2e-3 * c)
    np.testing.assert_allclose(b2, 0.99 ** c)
    assert ttr._lazy_lr(1.0, 0.5, 0.9, 1) == (1.0, 0.5, 0.9)


# ------------------------------------------------------------ each phase

def _jax_phase(jt, phase, g, d, reals, key, pl_avg):
    """jax.value_and_grad of one phase, written from the JAX trainer's own
    `_gen_dlatents` / `_synthesize` / `_d_apply` and its losses, as its step
    writes them."""
    cfg = jt.cfg
    if phase == "d_loss":
        def fn(dp):
            k_lat, k_noise = jax.random.split(key)
            dl = jt._gen_dlatents(g, k_lat, reals.shape[0])
            fakes = jax.lax.stop_gradient(jt._synthesize(g, dl, k_noise))
            return jlosses.d_logistic(jt._d_apply(dp, reals), jt._d_apply(dp, fakes))
        return jax.jit(jax.value_and_grad(fn))(d)
    if phase == "r1":
        def fn(dp):
            return jlosses.r1_penalty(jt._d_apply, dp, reals, cfg.r1_gamma) * cfg.d_reg_interval
        return jax.jit(jax.value_and_grad(fn))(d)
    if phase == "g_loss":
        def fn(gp):
            k_lat, k_noise = jax.random.split(key)
            dl = jt._gen_dlatents(gp, k_lat, reals.shape[0])
            return jlosses.g_logistic_ns(jt._d_apply(d, jt._synthesize(gp, dl, k_noise)))
        return jax.jit(jax.value_and_grad(fn))(g)

    def fn(gp):
        k_lat, k_y = jax.random.split(key)
        dl = jt._gen_dlatents(gp, k_lat, reals.shape[0])
        pen, new = jlosses.path_length_reg(
            lambda p, dd: jsg2.synthesis_apply(p["synthesis"], dd, MC, noise="none", s2d=False),
            gp, dl, k_y, pl_avg, cfg.pl_decay, cfg.pl_weight)
        return pen * cfg.g_reg_interval
    return jax.jit(jax.value_and_grad(fn))(g)


@pytest.mark.parametrize("phase", ["d_loss", "r1", "g_loss", "path_length"])
def test_phase_gradients_match_jax(weights, reals, jtrainer, phase):
    jg, jd = (jax.tree.map(jnp.asarray, t) for t in weights)
    tr = _trainer(weights)
    g, d = tr.state.g_params, tr.state.d_params
    key = jax.random.PRNGKey(7)
    x = T(reals)
    pl_avg = 0.25
    want, jgrads = _jax_phase(jtrainer, phase, jg, jd, jnp.asarray(reals), key,
                              jnp.float32(pl_avg))
    if phase == "d_loss":
        got, grads = ttr.value_and_grad(lambda p: tr.d_loss(p, g, x, _noise_chunk(key, 4)), d)
    elif phase == "r1":
        got, grads = ttr.value_and_grad(lambda p: tr.d_reg(p, x), d)
    elif phase == "g_loss":
        got, grads = ttr.value_and_grad(lambda p: tr.g_loss(p, d, _noise_chunk(key, 4)), g)
    else:
        got, grads = ttr.value_and_grad(
            lambda p: tr.g_reg(p, _pl_chunk(key, 4), torch.tensor(pl_avg))[0], g)
    convert = (from_jax.convert_discriminator if phase in ("d_loss", "r1")
               else from_jax.convert_generator)
    assert float(want) != 0
    assert float(got) == pytest.approx(float(want), rel=1e-5)
    _assert_grads(grads, jgrads, convert)


def test_style_mixing_matches_jax(weights, jtrainer):
    tr = _trainer(weights)
    key = jax.random.PRNGKey(8)
    want = jtrainer._gen_dlatents(jax.tree.map(jnp.asarray, weights[0]), key, 6)
    got = tr._gen_dlatents(tr.state.g_params, _latents(key, 6))
    assert_close_scaled(N(got), np.asarray(want), 1e-6)
    # both layer sources occur
    assert len({tuple(np.round(r, 4)) for r in N(got)[:, :, 0]}) > 1


# ------------------------------------------------------------ whole steps

def _port_step_vs_jax(weights, reals, jt, jstate, tr):
    """One step of each package from the same state: the JAX draws fed to
    the port. Returns (JAX's new state, the port's logs, JAX's logs)."""
    S = CFG["subdivisions"]
    step = int(jstate.step)
    draws = jax_draws(jstate.key, 4, S, step % CFG["g_reg_interval"] == 0)
    new, jlogs = jt._train_step(jstate, jnp.asarray(reals))
    logs = tr.train_step(T(reals), draws)
    return new, logs, jlogs


def _check_state(tr, new, carried=False):
    st = tr.state
    lr_g, _, b2_g = tr.g_adam
    lr_d, _, b2_d = tr.d_adam
    g_args = (new.g_opt[0], st.g_opt.mu, from_jax.convert_generator, lr_g, b2_g, carried)
    counts = {
        "G": _assert_params_moved_as_jax(st.g_params, new.g_params, *g_args),
        "D": _assert_params_moved_as_jax(st.d_params, new.d_params, new.d_opt[0],
                                         st.d_opt.mu, from_jax.convert_discriminator, lr_d,
                                         b2_d, carried),
        # Gs moves by 1 - ema_beta of G's move, within the same bound
        "Gs": _assert_params_moved_as_jax(st.gs_params, new.gs_params, *g_args)}
    for tree, jtree in ((st.g_params, new.g_params), (st.gs_params, new.gs_params)):
        assert_close_scaled(N(tree["dlatent_avg"]), np.asarray(jtree["dlatent_avg"]), 1e-5)
    assert float(st.pl_avg) == pytest.approx(float(new.pl_avg), rel=1e-4)
    assert st.step == int(new.step) and st.g_opt.count == int(new.g_opt[0].count)
    _assert_grads(st.g_opt.mu, new.g_opt[0].mu, from_jax.convert_generator)
    _assert_grads(st.d_opt.mu, new.d_opt[0].mu, from_jax.convert_discriminator)
    _assert_grads(st.g_opt.nu, new.g_opt[0].nu, from_jax.convert_generator, 2e-4)
    _assert_grads(st.d_opt.nu, new.d_opt[0].nu, from_jax.convert_discriminator, 2e-4)
    print("elements", "apart by a gradient's rounding" if not carried else
          "apart by Adam's division of their gradient's difference", "(counted, of all):",
          counts)


def test_one_step_matches_jax(weights, reals, jtrainer):
    """Step 0 (R1 and the path length penalty, two subdivisions) from the
    same state and draws. With beta1 = 0 Adam's first moment is the step's
    gradient, so JAX's `mu` tells which elements moved by a rounding."""
    tr = _trainer(weights)
    prev = jtrainer.state
    new, logs, jlogs = _port_step_vs_jax(weights, reals, jtrainer, prev, tr)
    _assert_logs(logs, jlogs)
    _check_state(tr, new)


def test_carried_across_state_steps_on_equally(weights, reals, jtrainer):
    """A JAX state after 2 steps, carried across by `from_jax`, then step 2
    (both regularizers again) in each package: the logs, both Adam moments
    as after one step, the parameters by the later step's rule
    (`_assert_params_moved_as_jax`)."""
    jstate = jtrainer.state
    for _ in range(2):
        jstate, _ = jtrainer._train_step(jstate, jnp.asarray(reals))
    tr = _trainer(weights)

    def opt(o):
        return (o[0].count, _np(o[0].mu), _np(o[0].nu))

    tr.load_state(**from_jax.convert_train_state(
        _np(jstate.g_params), _np(jstate.d_params), _np(jstate.gs_params), opt(jstate.g_opt),
        opt(jstate.d_opt), np.asarray(jstate.pl_avg), np.asarray(jstate.step)))
    assert tr.state.step == 2 and tr.state.g_opt.count == 2
    _assert_grads(tr.state.g_opt.nu, jstate.g_opt[0].nu, from_jax.convert_generator, 1e-7)
    new, logs, jlogs = _port_step_vs_jax(weights, reals, jtrainer, jstate, tr)
    _assert_logs(logs, jlogs)
    _check_state(tr, new, carried=True)


# ------------------------------------------------------------ subdivisions

def test_accumulate_value_and_grads_is_exact_chunk_mean():
    """The running sum is exactly the mean of the per-chunk results, and one
    chunk passes through."""
    rng = np.random.default_rng(0)
    params = {"w": T(rng.normal(size=(2, 2))), "b": T(rng.normal(size=2))}
    X = T(rng.normal(size=(4, 8, 2)))
    noise = T(rng.normal(size=(4, 8)))

    def loss(p, i):
        y = torch.tanh(X[i] @ p["w"] + p["b"])
        return ((y[:, 0] - noise[i]) ** 2 + 0.1 * y[:, 1] ** 2).mean()

    def fn(i):
        return ttr.value_and_grad(lambda p: loss(p, i), params)

    v, g = ttr.accumulate_value_and_grads(fn, range(4))
    parts = [fn(i) for i in range(4)]
    assert float(v) == float((((parts[0][0] + parts[1][0]) + parts[2][0]) + parts[3][0]) / 4)
    for j in range(2):
        want = (((parts[0][1][j] + parts[1][1][j]) + parts[2][1][j]) + parts[3][1][j]) / 4
        assert torch.equal(g[j], want)
    v1, g1 = ttr.accumulate_value_and_grads(fn, range(1))
    assert float(v1) == float(parts[0][0])


def test_subdivided_training_runs_and_checks_divisibility(weights):
    tr = _trainer(weights)
    logs = tr.train(_data(), iterations=2)
    assert all(np.isfinite(float(v)) for v in logs.values())
    bad = _trainer(weights, subdivisions=3)
    with pytest.raises(ValueError, match="divisible"):
        bad.train(_data(), iterations=1)


# ------------------------------------------------------------ the trainer

def _data(batch=4, res=16):
    rng = np.random.default_rng(0)
    while True:
        yield rng.uniform(-1, 1, (batch, 3, res, res)).astype(np.float32)


@pytest.fixture
def trainer(weights, tmp_path):
    return _trainer(weights, subdivisions=1, d_reg_interval=16, g_reg_interval=4,
                    checkpoint_dir=str(tmp_path / "ckpt"))


def _first_weight(params):
    return N(params["mapping"]["dense"][0]["w"]).copy()


def test_reg_interval_zero_leaves_the_phase_out(weights, monkeypatch):
    """interval 0 leaves a regularizer out of every step: pl_avg never moves,
    neither penalty runs, and the parameters still move."""
    tr = _trainer(weights, d_reg_interval=0, g_reg_interval=0)
    calls = []
    monkeypatch.setattr(tr, "d_reg", lambda *a: calls.append("r1"))
    monkeypatch.setattr(tr, "g_reg", lambda *a: calls.append("pl"))
    g0 = _first_weight(tr.state.g_params)
    logs = tr.train(_data(), iterations=2)
    assert np.isfinite(float(logs["d_loss"])) and not calls
    assert float(tr.state.pl_avg) == 0.0
    assert not np.allclose(g0, _first_weight(tr.state.g_params))


def test_training_steps_move_params(trainer):
    g0, gs0 = _first_weight(trainer.state.g_params), _first_weight(trainer.state.gs_params)
    logs = trainer.train(_data(), iterations=3)
    assert np.isfinite(float(logs["d_loss"])) and np.isfinite(float(logs["g_loss"]))
    g1, gs1 = _first_weight(trainer.state.g_params), _first_weight(trainer.state.gs_params)
    assert not np.allclose(g0, g1) and not np.allclose(gs0, gs1)
    # the EMA lags the raw params
    assert np.abs(gs1 - g0).max() <= np.abs(g1 - g0).max() + 1e-6
    assert trainer.state.step == 3


def _same_state(a, b):
    for x, y in zip(tree_leaves(a.g_params) + tree_leaves(a.d_params)
                    + tree_leaves(a.gs_params) + a.g_opt.mu + a.g_opt.nu + a.d_opt.mu
                    + a.d_opt.nu,
                    tree_leaves(b.g_params) + tree_leaves(b.d_params)
                    + tree_leaves(b.gs_params) + b.g_opt.mu + b.g_opt.nu + b.d_opt.mu
                    + b.d_opt.nu):
        assert torch.equal(x, y)
    assert (a.step, a.g_opt.count, a.d_opt.count) == (b.step, b.g_opt.count, b.d_opt.count)
    assert torch.equal(a.pl_avg, b.pl_avg)


def test_checkpoint_roundtrip_and_discovery(trainer):
    trainer.train(_data(), iterations=1)
    root = trainer.cfg.checkpoint_dir
    folder = trainer.save_checkpoint()
    assert ttr.Trainer.latest_checkpoint(root) == folder
    assert sorted(os.listdir(folder)) == sorted(ttr.CHECKPOINT_FILES)
    saved = trainer.state
    trainer.train(_data(), iterations=1)   # perturb, then restore
    trainer.load_checkpoint(folder)
    _same_state(trainer.state, saved)
    with open(os.path.join(folder, "kwargs.json")) as f:
        meta = json.load(f)
    assert meta["seen"] == 4 and meta["step"] == 1
    assert meta["trainer"] == dataclasses.asdict(trainer.cfg)


def test_latest_checkpoint_skips_partial_dirs(trainer):
    root = trainer.cfg.checkpoint_dir
    complete = trainer.save_checkpoint()
    # a newer dir missing the optimizer files (a save killed mid-write)
    partial = os.path.join(root, str(10 ** 9))
    os.makedirs(partial)
    for name in ("kwargs.json", "G.npz", "D.npz", "Gs.npz"):
        open(os.path.join(partial, name), "wb").close()
    os.makedirs(os.path.join(root, "not_a_step"))
    assert ttr.Trainer.latest_checkpoint(root) == complete
    assert ttr.Trainer.latest_checkpoint(str(trainer.cfg.checkpoint_dir) + "_none") is None


def test_checkpoint_cadence_is_boundary_crossing(weights, tmp_path):
    """seen = step * batch crossing checkpoint_every fires even when the batch
    does not divide the interval: batch 6, every 10 -> steps 2, 4, 5."""
    tr = _trainer(weights, batch_size=6, subdivisions=1, checkpoint_every=10,
                  checkpoint_dir=str(tmp_path / "ck3"))
    fired = []
    tr.save_checkpoint = lambda folder=None: fired.append(tr.state.step)
    tr.train(_data(batch=6), iterations=5)
    assert fired == [2, 4, 5]


def test_training_continues_after_resume(weights, tmp_path):
    tr = _trainer(weights, checkpoint_dir=str(tmp_path / "ck4"))
    tr.train(_data(), iterations=1)
    folder = tr.save_checkpoint()
    tr2 = _trainer(weights, checkpoint_dir=str(tmp_path / "ck4"))
    tr2.load_checkpoint(folder)
    logs = tr2.train(_data(), iterations=2)
    assert np.isfinite(float(logs["g_loss"]))
    assert tr2.state.step == 3


def test_resumed_step_equals_the_uninterrupted_one(weights, tmp_path):
    """A checkpoint holds everything but the generator: a resumed trainer fed
    the same draws takes the same step bitwise."""
    tr = _trainer(weights, checkpoint_dir=str(tmp_path / "ck5"))
    tr.train(_data(), iterations=1)
    folder = tr.save_checkpoint()
    tr2 = _trainer(weights)
    tr2.load_checkpoint(folder)
    draws = tr.draw(2, 2, path_length=False)
    x = torch.from_numpy(next(_data()))
    tr.train_step(x, draws)
    tr2.train_step(x, draws)
    _same_state(tr.state, tr2.state)


def test_metric_registry(trainer):
    trainer.register_metric("g_norm", lambda s: sum(
        float(t.square().sum()) for t in tree_leaves(s.g_params)))
    vals = trainer.evaluate_metrics()
    assert "g_norm" in vals and vals["g_norm"] > 0


def test_trainer_config_json_overlay(tmp_path):
    p = str(tmp_path / "cfg.json")
    ttr.TrainerConfig(batch_size=6, g_lr=1e-3).to_json(p)
    loaded = ttr.TrainerConfig.from_json(p, d_lr=5e-4)
    assert loaded.batch_size == 6 and loaded.g_lr == 1e-3 and loaded.d_lr == 5e-4
    # the JAX package reads the port's file and the other way round
    assert dataclasses.asdict(JConfig.from_file(p)) == dataclasses.asdict(
        ttr.TrainerConfig.from_file(p))
    assert dataclasses.asdict(ttr.TrainerConfig()) == dataclasses.asdict(JConfig())


def test_trainer_config_yaml_overlay(tmp_path):
    pytest.importorskip("yaml")
    p = str(tmp_path / "cfg.yaml")
    ttr.TrainerConfig(batch_size=6, g_lr=1e-3).to_yaml(p)
    loaded = ttr.TrainerConfig.from_file(p, d_lr=5e-4)
    assert loaded.batch_size == 6 and loaded.g_lr == 1e-3 and loaded.d_lr == 5e-4


def test_trainer_config_rejects_unknown_keys(tmp_path):
    p = tmp_path / "cfg.json"
    p.write_text(json.dumps({"g_lr": 1e-3, "d_reg_intervall": 4}))
    with pytest.raises(ValueError, match="d_reg_intervall"):
        ttr.TrainerConfig.from_file(str(p))


def test_dlatent_avg_tracks_mapping_mean(trainer):
    before = N(trainer.state.g_params["dlatent_avg"]).copy()
    trainer.train(_data(), iterations=2)
    after = N(trainer.state.g_params["dlatent_avg"])
    assert not np.allclose(before, after)
    assert not np.allclose(N(trainer.state.gs_params["dlatent_avg"]), 0.0)
    # its Adam moments took zero gradients: they stay 0
    i = [id(t) for t in tree_leaves(trainer.state.g_params)].index(
        id(trainer.state.g_params["dlatent_avg"]))
    assert not trainer.state.g_opt.mu[i].any() and not trainer.state.g_opt.nu[i].any()


def test_adam_takes_a_missing_gradient_as_zero():
    """optax's moments decay where a gradient is 0: `None` does the same."""
    p = [torch.ones(3)]
    _, st = adam_update([torch.tensor([1.0, -2.0, 3.0])], adam_init(p), 0.1, 0.5, 0.9)
    u_none, a = adam_update([None], st, 0.1, 0.5, 0.9)
    u_zero, b = adam_update([torch.zeros(3)], st, 0.1, 0.5, 0.9)
    assert torch.equal(u_none[0], u_zero[0]) and torch.equal(a.mu[0], b.mu[0])
    assert torch.equal(a.nu[0], b.nu[0]) and a.count == b.count == 2


def test_trainer_refuses_a_mesh_and_needs_a_card(monkeypatch):
    # a mesh of one card a process runs (tests/test_torch_parallel.py); two
    # cards in one process are refused: the trainer runs one process a card
    from clip_glass_torch.parallel import make_mesh

    with pytest.raises(ValueError, match="one process a card"):
        ttr.Trainer(tsg2.TINY, mesh=make_mesh(["cpu", "cpu"]), device="cpu")
    assert ttr.Trainer(tsg2.TINY, mesh=make_mesh(["cpu"])).device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttr.Trainer(tsg2.TINY)


def test_step_refuses_inference_mode(trainer):
    with torch.inference_mode():
        x = torch.zeros((4, 3, 16, 16))
        with pytest.raises(RuntimeError, match="inference_mode"):
            trainer.train_step(x)


# ------------------------------------------------------------ the card branch

def test_path_length_step_through_the_card_branch_equals_the_plain_route(
        weights, card_branch):  # noqa: F811
    """The path length phase's G gradient with every wrapper on its CUDA
    branch (each launch its plain version, through `cuda._KernelGrad`, whose
    second derivative the penalty takes) against the plain route: kernels 2
    and 3 and the FIR under the Function (no noise: kernel 1 is not on this
    path)."""
    tr = _trainer(weights)
    draw = _pl_chunk(jax.random.PRNGKey(9), 2)

    def run():
        return ttr.value_and_grad(
            lambda p: tr.g_reg(p, draw, torch.tensor(0.1))[0], tr.state.g_params)

    got, grads = run()
    launched = dict(card_branch)
    assert launched["function"] > 0 and launched.get("_upsample2x_cuda", 0) > 0 \
        and launched.get("_modulated_matmul_cuda", 0) > 0 \
        and launched.get("_fir_cuda", 0) > 0 and "_noise_bias_lrelu_cuda" not in launched
    from clip_glass_torch.ops import cuda
    cuda.takes_plain = lambda t: True   # restored by the fixture's monkeypatch
    want, plain = run()
    assert card_branch["function"] == launched["function"]
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    for g, w in zip(grads, plain):
        assert_close_scaled(N(g), N(w), 1e-5)


# ------------------------------------------------------------ logging sinks

def test_scalar_and_image_sinks(weights, tmp_path):
    run_dir = str(tmp_path / "run")
    sinks = TrainLogger(run_dir, image_every=2, n_image_latents=4)
    tr = _trainer(weights)
    tr.train(_data(), iterations=4, log_every=1, logger=lambda s, v: None, sinks=sinks)
    rows = sinks.scalars.read()
    assert sorted({s for s, _, _ in rows}) == [1, 2, 3, 4]
    assert {"d_loss", "g_loss", "pl_avg", "g_grad_norm", "d_grad_norm"} == \
        {t for _, t, _ in rows}
    assert all(np.isfinite(v) for _, _, v in rows)
    imgs = sorted(f for f in os.listdir(run_dir) if f.endswith(".jpg"))
    assert imgs == ["fakes_2.jpg", "fakes_4.jpg"]
    from PIL import Image
    assert Image.open(os.path.join(run_dir, "fakes_4.jpg")).size == (2 + 4 * 18, 2 + 18)


def test_tensorboard_sink_roundtrip(weights, tmp_path):
    if not TensorboardSink.available():
        pytest.skip("no tensorboard backend installed")
    ea_mod = pytest.importorskip("tensorboard.backend.event_processing.event_accumulator")
    run_dir = str(tmp_path / "run")
    sinks = TrainLogger(run_dir, image_every=2, n_image_latents=2, tensorboard=True)
    tr = _trainer(weights)
    tr.train(_data(), iterations=2, log_every=1, logger=lambda s, v: None, sinks=sinks)
    sinks.tb.flush()
    sinks.tb.close()
    acc = ea_mod.EventAccumulator(os.path.join(run_dir, "tb"),
                                  size_guidance={ea_mod.SCALARS: 0, ea_mod.IMAGES: 0})
    acc.Reload()
    got = {(e.step, tag): e.value for tag in acc.Tags()["scalars"] for e in acc.Scalars(tag)}
    csv_rows = {(s, t): v for s, t, v in sinks.scalars.read()}
    assert set(got) == set(csv_rows)
    for k, v in csv_rows.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5)
    assert any(t.startswith("fakes") for t in acc.Tags()["images"])


# ------------------------------------------------------------ the init fault

def test_dense_init_has_unit_std_in_both_packages():
    """Pins a fault of the JAX package that the port copies on purpose
    (ROADMAP §3): `_he_coef((in_f,), ...)` takes fan_in = 1 for every dense
    layer, so each dense weight is N(0, 1), not N(0, 1 / in_f)."""
    jw = np.asarray(jsg2._dense_init(jax.random.PRNGKey(0), 512, 512)["w"])
    tw = N(tsg2._dense_init(torch.Generator().manual_seed(0), 512, 512)["w"])
    for w in (jw, tw):
        assert 0.98 < w.std() < 1.02          # not 1 / sqrt(512) = 0.0442
    for lr_mul in (0.01,):   # the mapping layers' equalized-lr scale does not help
        jm = np.asarray(jsg2._dense_init(jax.random.PRNGKey(1), 512, 512, lr_mul)["w"])
        assert 0.98 < jm.std() < 1.02


# ------------------------------------------------------------ the example

def _example(*args, timeout=240):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")   # see _one_torch_thread
    return subprocess.run([sys.executable, os.path.join(ROOT, "examples",
                                                        "train_stylegan2_torch.py"), *args],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=timeout)


def test_example_trains_tiny_on_the_cpu(tmp_path):
    out = str(tmp_path / "ex")
    res = _example("--tiny", "--device", "cpu", "--iterations", "2", "--out", out)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "Gs sample:" in res.stdout and "checkpoint:" in res.stdout
    ck = os.path.join(out, "checkpoints")
    assert ttr.Trainer.latest_checkpoint(ck) == os.path.join(ck, "8")
    assert os.path.exists(os.path.join(out, "logs", "fakes_1.jpg"))
    assert os.path.exists(os.path.join(out, "logs", "scalars.csv"))


def test_example_refuses_a_mesh(tmp_path):
    """--mesh runs now (one rank, a mesh of its card); a bad --distributed
    spec still exits 2."""
    out = str(tmp_path / "ex")
    res = _example("--tiny", "--device", "cpu", "--mesh", "--iterations", "2", "--out", out)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "Gs sample:" in res.stdout
    ck = os.path.join(out, "checkpoints")
    assert ttr.Trainer.latest_checkpoint(ck) == os.path.join(ck, "8")
    res = _example("--tiny", "--device", "cpu", "--distributed", "bad", "--out", out)
    assert res.returncode == 2 and "--distributed" in res.stderr
